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
// Bound on the H100: bytes, 9 per frame plus the distinct matrix bytes
// the wave touches (a wave's frames share few zone pairs, and the 1 MB
// matrix of 1000 zones stays in the 50 MB L2). Each thread takes 8
// frames: two 16-byte loads of src and two of dst, 8 one-byte gathers
// through the read-only path (__ldg), all issued before any is used, and
// one 8-byte store of the mask; 64-thread blocks spread a wave over many
// SMs, and a grid-stride loop covers any wave with at most kMaxBlocks
// blocks. (8 frames, not 16: at n = 32768, 16 frames a thread leave
// 2048 threads, 32 blocks of 64, for 132 SMs, and the uncoalesced
// gathers wait on a quarter of them; 8 frames spread them over twice as
// many.) The vector accesses
// need src and dst on 16 bytes and out on 8 at a common frame, which a
// caller's slice need not be: the frames before that frame (the head,
// < 16) and after the last whole group of 8 (the tail, < 8) go to scalar
// threads of the same launch, and when no common frame exists (src and
// dst misaligned against each other, or an int32 pointer off its 4-byte
// grid) every frame is scalar. At the transport's waves (32 to a few
// thousand frames) one launch, not the work, sets the time.
//
// The two launching entry points take their arguments as one packed
// block of int64 (a pointer per slot where the slot is a pointer), which
// ctypes passes for a fraction of what it charges to convert nine
// arguments one by one. fpx_link_keep_mask_staged runs the transport's
// whole wave (ids up from pinned memory, the launch, the mask down into
// pinned memory, a wait on the stream) in one call, so that the Python
// entry pays one ctypes call instead of a torch copy, view or wrapper per
// step.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kFrames = 8;  // frames per thread on the vector path
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ int jax_index(int32_t id, int size) {
  int i = id;
  if (i < 0) i += size;  // id >= INT_MIN and size > 0: no overflow
  if (i < 0) i = 0;
  if (i >= size) i = size - 1;
  return i;
}

__device__ __forceinline__ uint8_t gather(const uint8_t* __restrict__ up,
                                          int32_t s, int32_t d, int rows,
                                          int cols) {
  const long long at = static_cast<long long>(jax_index(s, rows)) * cols
                       + jax_index(d, cols);
  return __ldg(up + at) != 0;
}

// Frames [head, head + 8 * groups) by groups of 8 (src and dst on 16
// bytes, out on 8), then the head and the tail frame by frame.
__global__ void link_keep_mask_kernel(const int32_t* __restrict__ src,
                                      const int32_t* __restrict__ dst,
                                      long long n,
                                      const uint8_t* __restrict__ up,
                                      int rows, int cols,
                                      uint8_t* __restrict__ out,
                                      long long head, long long groups) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = tid; g < groups; g += stride) {
    const long long base = head + g * kFrames;
    const int4* s4 = reinterpret_cast<const int4*>(src + base);
    const int4* d4 = reinterpret_cast<const int4*>(dst + base);
    int32_t s[kFrames], d[kFrames];
#pragma unroll
    for (int k = 0; k < kFrames / 4; ++k) {
      const int4 a = __ldg(s4 + k);
      const int4 b = __ldg(d4 + k);
      s[4 * k] = a.x, s[4 * k + 1] = a.y, s[4 * k + 2] = a.z,
      s[4 * k + 3] = a.w;
      d[4 * k] = b.x, d[4 * k + 1] = b.y, d[4 * k + 2] = b.z,
      d[4 * k + 3] = b.w;
    }
    uint8_t m[kFrames];
#pragma unroll
    for (int k = 0; k < kFrames; ++k) {
      m[k] = gather(up, s[k], d[k], rows, cols);
    }
    uint32_t w[kFrames / 4];
#pragma unroll
    for (int k = 0; k < kFrames / 4; ++k) {
      w[k] = static_cast<uint32_t>(m[4 * k])
             | static_cast<uint32_t>(m[4 * k + 1]) << 8
             | static_cast<uint32_t>(m[4 * k + 2]) << 16
             | static_cast<uint32_t>(m[4 * k + 3]) << 24;
    }
    *reinterpret_cast<uint2*>(out + base) = make_uint2(w[0], w[1]);
  }
  const long long tail_start = head + groups * kFrames;
  const long long scalar = head + (n - tail_start);
  for (long long j = tid; j < scalar; j += stride) {
    const long long i = j < head ? j : tail_start + (j - head);
    out[i] = gather(up, src[i], dst[i], rows, cols);
  }
}

// The first frame at which src and dst sit on 16 bytes and out on 8, or
// -1 (none below 16, or none at all).
long long common_head(const void* src, const void* dst, const void* out,
                      long long n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  for (long long h = 0; h < 16 && h <= n; ++h) {
    if ((s + 4 * h) % 16 == 0 && (d + 4 * h) % 16 == 0 && (o + h) % 8 == 0) {
      return h;
    }
  }
  return -1;
}

cudaError_t select_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

cudaError_t launch(const void* src, const void* dst, long long n,
                   const void* up, int rows, int cols, void* out,
                   cudaStream_t stream) {
  long long head = common_head(src, dst, out, n);
  long long groups = 0;
  if (head < 0) {
    head = n;  // every frame scalar
  } else {
    groups = (n - head) / kFrames;
  }
  const long long scalar = n - groups * kFrames;
  const long long work = groups > scalar ? groups : scalar;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  link_keep_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), n,
      static_cast<const uint8_t*>(up), rows, cols,
      static_cast<uint8_t*>(out), head, groups);
  return cudaGetLastError();
}

template <typename T>
T* pointer(long long slot) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(slot));
}

}  // namespace

// block: src, dst, n, up, rows, cols, out, device, stream.
extern "C" int fpx_link_keep_mask(const void* block) {
  long long a[9];
  std::memcpy(a, block, sizeof a);
  const long long n = a[2];
  cudaError_t err = select_device(static_cast<int>(a[7]));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  return static_cast<int>(launch(pointer<const void>(a[0]),
                                 pointer<const void>(a[1]), n,
                                 pointer<const void>(a[3]),
                                 static_cast<int>(a[4]),
                                 static_cast<int>(a[5]), pointer<void>(a[6]),
                                 pointer<CUstream_st>(a[8])));
}

// The transport's wave in one call. block: host_ids, dev_ids, n,
// dst_offset, up, rows, cols, dev_mask, host_mask, device, stream.
// host_ids holds src at [0, n) and dst at [dst_offset, dst_offset + n)
// (pinned, int32), copied up into dev_ids in one copy; the mask lands in
// dev_mask, then in host_mask (pinned), and the call returns after the
// stream has drained.
extern "C" int fpx_link_keep_mask_staged(const void* block) {
  long long a[11];
  std::memcpy(a, block, sizeof a);
  const void* host_ids = pointer<const void>(a[0]);
  void* dev_ids = pointer<void>(a[1]);
  const long long n = a[2], dst_offset = a[3];
  const void* up = pointer<const void>(a[4]);
  const int rows = static_cast<int>(a[5]), cols = static_cast<int>(a[6]);
  void* dev_mask = pointer<void>(a[7]);
  void* host_mask = pointer<void>(a[8]);
  const cudaStream_t stream = pointer<CUstream_st>(a[10]);
  cudaError_t err = select_device(static_cast<int>(a[9]));
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const cudaStream_t s = stream;
  err = cudaMemcpyAsync(dev_ids, host_ids,
                        static_cast<size_t>(dst_offset + n) * 4,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* ids = static_cast<const int32_t*>(dev_ids);
  err = launch(ids, ids + dst_offset, n, up, rows, cols, dev_mask, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(host_mask, dev_mask, static_cast<size_t>(n),
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(s));
}

extern "C" const char* fpx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
