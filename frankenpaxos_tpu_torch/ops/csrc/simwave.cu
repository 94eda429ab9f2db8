// K18 link_keep_mask: the geo transport's per-wave link mask.
//
// Replaces frankenpaxos_tpu/ops/simwave.py::link_keep_mask_jit (L79) and
// its jitted gather _link_keep_jax (L107): for each frame i of a delivery
// wave, out[i] = up[src[i], dst[i]], where up is the topology's
// [Z+1, Z+1] bool reachability matrix (its last row and column are the
// always-up sentinel that zone id -1 reaches). The index rule is JAX's
// gather rule, not numpy's: an id below 0 is wrapped once by adding the
// axis length, and the result is clamped to [0, axis - 1], so no id
// reads out of bounds ((5, 0) on a 3x3 matrix reads [2, 0], (-4, 0)
// reads [0, 0]). The JAX twin pads the wave to a power of two only to
// bound XLA's retraces; this kernel takes the wave as it is.
//
// One thread per frame: two int32 loads (neighbouring threads on
// neighbouring addresses), the wrap and the clamp, one byte gathered
// from the matrix and one byte written. Bound on the H100: bytes, 9 per
// frame plus the distinct matrix bytes the wave touches (a wave's frames
// share few zone pairs, so the gathered bytes mostly hit L2). At the
// transport's waves (32 to a few thousand frames) one launch, not the
// work, sets the time; the wrapper keeps the matrix on the card between
// waves so that a wave moves only its ids and its mask.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long jax_index(int32_t id, int size) {
  long long i = id;
  if (i < 0) i += size;
  if (i < 0) i = 0;
  if (i >= size) i = size - 1;
  return i;
}

__global__ void link_keep_mask_kernel(const int32_t* __restrict__ src,
                                      const int32_t* __restrict__ dst,
                                      long long n,
                                      const uint8_t* __restrict__ up,
                                      int rows, int cols,
                                      uint8_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= n) return;
  const long long s = jax_index(src[i], rows);
  const long long d = jax_index(dst[i], cols);
  out[i] = up[s * cols + d] != 0;
}

}  // namespace

extern "C" int fpx_link_keep_mask(void* src, void* dst, long long n,
                                  void* up, int rows, int cols, void* out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  link_keep_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), n,
      static_cast<const uint8_t*>(up), rows, cols,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fpx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
