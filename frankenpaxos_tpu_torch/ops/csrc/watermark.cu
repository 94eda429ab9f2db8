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
// One warp per row, 8 rows per 256-thread block. Lane j holds elements j,
// j + 32, ... of the row (ceil(n / 32) registers, read in place with the
// element stride, so the vector form reads the transposed [n, depth]
// matrix's columns without a copy), and counts, for each value v it
// holds, the row's elements below v and at or below v by broadcasting
// the row through __shfl_sync: n steps per lane, not n^2. The value of
// the element whose [less, less_equal) holds idx is the answer, whatever
// the ties (every such element has the same value); __ballot_sync picks
// the lowest such lane, which writes it. Rows up to 1024 wide sit in
// registers (ceil(n / 32) <= 32 per lane); a wider row is taken in
// tiles of 1024 against the whole row read again by chunks of 32. Bound
// on the H100: bytes (B * (4n + 4)); at the protocol's [2, 3] one
// launch, not the work, sets the time. fpx_quorum_watermark_staged runs
// the GC roles' whole vector call (the int32 matrix up from pinned
// memory, the launch, the [depth] result down into pinned memory, a
// wait on the stream) in one call. Both K12 entry points take their
// arguments as one packed block of int64, as K18's do.
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
#include <cstring>

#include "quorum.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kPerLane = 8;

constexpr int kRowsPerBlock = FPX_THREADS / 32;

// Adds, for each value v[t] a lane holds, the elements below it and at
// or below it among the first m lanes' `mine`.
template <int PER>
__device__ __forceinline__ void count_chunk(int32_t mine, int m,
                                            const int32_t (&v)[PER],
                                            int (&less)[PER],
                                            int (&less_equal)[PER]) {
  for (int k = 0; k < m; ++k) {
    const int32_t u = __shfl_sync(kFullWarp, mine, k);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      less[t] += u < v[t];
      less_equal[t] += u <= v[t];
    }
  }
}

template <int PER>
__global__ void quorum_watermark_kernel(const int32_t* __restrict__ w,
                                        long long rows, int n,
                                        long long row_stride,
                                        long long elem_stride,
                                        const int32_t* __restrict__ q,
                                        int q_scalar,
                                        int32_t* __restrict__ out) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x)
                         + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform over the warp
  if (n == 0) {
    if (lane == 0) out[row] = 0;
    return;
  }
  const int32_t qv = q != nullptr ? q[row] : q_scalar;
  int32_t idx = static_cast<int32_t>(static_cast<uint32_t>(n)
                                     - static_cast<uint32_t>(qv));
  if (idx < 0) idx += n;  // idx >= INT_MIN and n > 0: no overflow
  if (idx < 0 || idx >= n) {
    if (lane == 0) out[row] = INT_MIN;
    return;
  }
  const int32_t* r = w + row * row_stride;
  for (long long base = 0; base < n; base += 32 * PER) {
    int32_t v[PER];
    int less[PER], less_equal[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const long long e = base + 32 * t + lane;
      v[t] = e < n ? r[e * elem_stride] : 0;
      less[t] = 0;
      less_equal[t] = 0;
    }
    if (n <= 32 * PER) {  // one tile: the row is in the lanes' registers
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        if (32 * t < n) {
          count_chunk<PER>(v[t], min(32, n - 32 * t), v, less, less_equal);
        }
      }
    } else {
      for (long long c = 0; c < n; c += 32) {
        const long long e = c + lane;
        const int32_t u = e < n ? r[e * elem_stride] : 0;
        count_chunk<PER>(u, static_cast<int>(min(32LL, n - c)), v, less,
                         less_equal);
      }
    }
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const long long e = base + 32 * t + lane;
      const bool hit = e < n && less[t] <= idx && idx < less_equal[t];
      const unsigned ballot = __ballot_sync(kFullWarp, hit);
      if (ballot != 0) {
        if (lane == __ffs(ballot) - 1) out[row] = v[t];
        return;
      }
    }
  }
}

template <int PER>
void launch_watermark(const void* w, long long rows, int n,
                      long long row_stride, long long elem_stride,
                      const void* q, int q_scalar, void* out,
                      cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quorum_watermark_kernel<PER><<<static_cast<unsigned>(blocks), FPX_THREADS,
                                 0, stream>>>(
      static_cast<const int32_t*>(w), rows, n, row_stride, elem_stride,
      static_cast<const int32_t*>(q), q_scalar, static_cast<int32_t*>(out));
}

cudaError_t quorum_watermark(const void* w, long long rows, int n,
                             long long row_stride, long long elem_stride,
                             const void* q, int q_scalar, void* out,
                             cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  if (n <= 32) {
    launch_watermark<1>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 64) {
    launch_watermark<2>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 128) {
    launch_watermark<4>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 256) {
    launch_watermark<8>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 512) {
    launch_watermark<16>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                         out, s);
  } else {
    launch_watermark<32>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                         out, s);
  }
  return cudaGetLastError();
}

cudaError_t select_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

template <typename T>
T* pointer(long long slot) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(slot));
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

// block: watermarks, rows, n, row_stride, elem_stride, quorum sizes (or
// 0), quorum size, out, device, stream.
extern "C" int fpx_quorum_watermark(const void* block) {
  long long a[10];
  std::memcpy(a, block, sizeof a);
  const cudaError_t err = select_device(static_cast<int>(a[8]));
  if (err != cudaSuccess) return err;
  return quorum_watermark(pointer<const void>(a[0]), a[1],
                          static_cast<int>(a[2]), a[3], a[4],
                          pointer<const void>(a[5]), static_cast<int>(a[6]),
                          pointer<void>(a[7]), pointer<CUstream_st>(a[9]));
}

// The vector form in one call. block: host_w, dev_w, n, depth, quorum
// size, dev_out, host_out, device, stream. host_w holds the [n, depth]
// int32 matrix (pinned), copied up into dev_w; the columns' watermarks
// land in dev_out, then in host_out (pinned), and the call returns after
// the stream has drained.
extern "C" int fpx_quorum_watermark_staged(const void* block) {
  long long a[9];
  std::memcpy(a, block, sizeof a);
  void* dev_w = pointer<void>(a[1]);
  const int n = static_cast<int>(a[2]);
  const long long depth = a[3];
  void* dev_out = pointer<void>(a[5]);
  const cudaStream_t s = pointer<CUstream_st>(a[8]);
  cudaError_t err = select_device(static_cast<int>(a[7]));
  if (err != cudaSuccess || depth <= 0) return err;
  err = cudaMemcpyAsync(dev_w, pointer<const void>(a[0]),
                        static_cast<size_t>(n) * depth * 4,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  err = quorum_watermark(dev_w, depth, n, 1, depth, nullptr,
                         static_cast<int>(a[4]), dev_out, s);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(pointer<void>(a[6]), dev_out,
                        static_cast<size_t>(depth) * 4,
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
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
