// K12 quorum_watermark and K13 contiguous_prefix_length: the watermark
// reductions of the GC plane.
//
// K12 replaces frankenpaxos_tpu/ops/watermark.py::quorum_watermark (L17;
// quorum_watermark_vector, L30, calls it on the transposed matrix). For
// each row of n int32 watermarks it returns element `n - q` of the row
// sorted ascending: the largest w that at least q of the row reach. The
// index follows JAX's take_along_axis rules exactly: `n - q` is int32
// arithmetic (it wraps), a negative index counts from the end once, an
// index still outside [0, n) yields the fill value INT32_MIN, and a row
// of n = 0 yields 0 (JAX's gather from an empty axis). q is one scalar
// or one int32 per row.
//
// One thread per row runs a counting selection: the value v of element i
// is the answer iff (#elements < v) <= idx < (#elements <= v), which
// holds for exactly the sorted position idx whatever the ties. n^2
// compares per row, no sort and no scratch. The row is read with element
// and row strides, so the vector form reads the [replicas, leaders]
// matrix's columns in place. Bound on the H100: bytes (B * (4n + 4));
// at the protocol's [2, 3] one launch, not the work, sets the time.
//
// K13 replaces ops/watermark.py::contiguous_prefix_length (L38):
// sum(cumprod(present.astype(int32))) along the last axis. Inputs other
// than 0/1 enter the product as they are ([2, 3, 1, 0] gives 2+6+6 = 14),
// signed types sign-extend and int64 keeps its low 32 bits, as
// astype(int32) does; products and sum wrap as int32 (computed in
// uint32). One warp per row, a running product, and a stop at the first
// zero: each pass takes 32 * kPerLane elements, each lane kPerLane
// consecutive ones, which it folds into (product, sum of running
// products); a shuffle scan combines the lanes' pairs in order ((P, S)
// before (p, s) is (P p, S + P s), associative mod 2^32), and the pass's
// pair carries into the row's. A zero product stays zero, so the loop
// stops after the pass that holds the first zero: the work is the
// prefix's length, not L. A lane's kPerLane loads are independent, so
// one pass waits for one round of memory, not kPerLane. Bound: bytes,
// the prefix read once and one int32 written per row.

#include <climits>

#include "quorum.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kPerLane = 8;

__global__ void quorum_watermark_kernel(const int32_t* __restrict__ w,
                                        long long rows, int n,
                                        long long row_stride,
                                        long long elem_stride,
                                        const int32_t* __restrict__ q,
                                        int q_scalar,
                                        int32_t* __restrict__ out) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= rows) return;
  if (n == 0) {
    out[row] = 0;
    return;
  }
  const int32_t qv = q != nullptr ? q[row] : q_scalar;
  int32_t idx = static_cast<int32_t>(static_cast<uint32_t>(n)
                                     - static_cast<uint32_t>(qv));
  if (idx < 0) idx += n;  // idx >= INT_MIN and n > 0: no overflow
  if (idx < 0 || idx >= n) {
    out[row] = INT_MIN;
    return;
  }
  const int32_t* r = w + row * row_stride;
  for (int i = 0; i < n; ++i) {
    const int32_t v = r[i * elem_stride];
    int less = 0, less_equal = 0;
    for (int j = 0; j < n; ++j) {
      const int32_t u = r[j * elem_stride];
      less += u < v;
      less_equal += u <= v;
    }
    if (less <= idx && idx < less_equal) {
      out[row] = v;
      return;
    }
  }
}

template <typename T>
__global__ void contiguous_prefix_kernel(const T* __restrict__ x,
                                         long long rows, long long length,
                                         long long row_stride,
                                         long long elem_stride,
                                         int32_t* __restrict__ out) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x)
                          + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // uniform over the warp
  const T* r = x + warp * row_stride;
  uint32_t sum = 0;
  uint32_t carry = 1;
  for (long long w0 = 0; w0 < length; w0 += 32 * kPerLane) {
    const long long first = w0 + static_cast<long long>(lane) * kPerLane;
    uint32_t p = 1, s = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const long long w = first + j;
      if (w < length) {
        // astype(int32): sign- or zero-extend, keep the low 32 bits.
        p *= static_cast<uint32_t>(
            static_cast<long long>(r[w * elem_stride]));
        s += p;
      }
    }
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t p_up = __shfl_up_sync(kFullWarp, p, off);
      const uint32_t s_up = __shfl_up_sync(kFullWarp, s, off);
      if (lane >= off) {
        s = s_up + p_up * s;
        p = p_up * p;
      }
    }
    sum += carry * __shfl_sync(kFullWarp, s, 31);
    carry *= __shfl_sync(kFullWarp, p, 31);
    if (carry == 0) break;
  }
  if (lane == 0) out[warp] = static_cast<int32_t>(sum);
}

template <typename T>
void launch_prefix(const void* x, long long rows, long long length,
                   long long row_stride, long long elem_stride, void* out,
                   cudaStream_t stream) {
  const long long blocks = (rows * 32 + FPX_THREADS - 1) / FPX_THREADS;
  contiguous_prefix_kernel<T><<<static_cast<unsigned>(blocks), FPX_THREADS,
                                0, stream>>>(
      static_cast<const T*>(x), rows, length, row_stride, elem_stride,
      static_cast<int32_t*>(out));
}

}  // namespace

extern "C" int fpx_quorum_watermark(const void* w, long long rows, int n,
                                    long long row_stride,
                                    long long elem_stride, const void* q,
                                    int q_scalar, void* out, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + FPX_THREADS - 1) / FPX_THREADS;
  quorum_watermark_kernel<<<static_cast<unsigned>(blocks), FPX_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), rows, n, row_stride, elem_stride,
      static_cast<const int32_t*>(q), q_scalar, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

// elem_kind: 0 uint8 (and bool), 1 int8, 2 int16, 3 int32, 4 int64.
extern "C" int fpx_contiguous_prefix_length(const void* x, int elem_kind,
                                            long long rows, long long length,
                                            long long row_stride,
                                            long long elem_stride, void* out,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind) {
    case 0:
      launch_prefix<uint8_t>(x, rows, length, row_stride, elem_stride, out,
                             s);
      break;
    case 1:
      launch_prefix<int8_t>(x, rows, length, row_stride, elem_stride, out,
                            s);
      break;
    case 2:
      launch_prefix<int16_t>(x, rows, length, row_stride, elem_stride, out,
                             s);
      break;
    case 3:
      launch_prefix<int32_t>(x, rows, length, row_stride, elem_stride, out,
                             s);
      break;
    case 4:
      launch_prefix<long long>(x, rows, length, row_stride, elem_stride,
                               out, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
