// K6 record_and_check_epochs / check_batch_multi and K7 reshape_columns:
// the epoch-segmented and multi-config checkers.
//
// K6 replaces frankenpaxos_tpu/ops/quorum.py::_record_and_check_epochs
// (L237) and _check_batch_multi (L359):
//
//   * check_batch_multi_kernel, one thread per row: select plane
//     config_idx[b] of the [K, G, N] masks (a negative index counts from
//     the end, one still out of range is clamped, as JAX's gather does),
//     take the int32 weighted count of the row against each group,
//     compare with that plane's thresholds and apply its any/all. There
//     is NO grid branch: the reference's multi-config predicate always
//     counts, so a grid plane is counted too (the uint8 OR/AND chain of
//     quorum.cuh would differ on bytes other than 0/1);
//   * record_and_check_epochs_kernel: the sparse board update of
//     sparse.cuh (shared with K4), then per lane the epoch of its true
//     slot, searchsorted(boundaries, true_slot, side="right") over the
//     int32 boundaries, then the multi-config predicate of that epoch on
//     the lane's column.
//
// K7 replaces _reshape_columns (L441): out[i, :] = block[cmap[i], :], or
// a zero row where cmap[i] < 0 (an index past the end is clamped, as
// jnp.clip does). It writes a NEW tensor: a permutation in place could
// read a row another thread has already overwritten.
//
// Bound on the H100: K6 as K4 (launch- and barrier-bound at 256 lanes);
// check_batch_multi moves (4N + 5) bytes per row; K7 moves (N_new +
// N_old') bytes per column plus the map, bytes-bound at 3.35 TB/s
// (about 2 us for a [3, 2^20] -> [4, 2^20] board). One thread per output
// byte keeps each warp's loads and stores on neighbouring addresses.

#include "sparse.cuh"

namespace {

struct MultiPred {
  const int32_t* masks;       // [k, g, n]
  const int32_t* thresholds;  // [k, g]
  const uint8_t* any;         // [k]
  int k, g, n;
};

// `vote(i)` gives the row's int32 value for universe node i.
template <typename Vote>
__device__ __forceinline__ bool multi_hit(const MultiPred& m, int idx,
                                          Vote vote) {
  if (idx < 0) idx += m.k;
  idx = min(max(idx, 0), m.k - 1);
  const bool any = m.any[idx] != 0;
  bool out = !any;
  for (int gi = 0; gi < m.g; ++gi) {
    const int32_t* mask = m.masks + (static_cast<long long>(idx) * m.g + gi)
                                        * m.n;
    uint32_t count = 0;  // int32 arithmetic, wrapping like XLA's
    for (int i = 0; i < m.n; ++i) {
      count += static_cast<uint32_t>(mask[i]) *
               static_cast<uint32_t>(vote(i));
    }
    const bool sat = static_cast<int32_t>(count) >=
                     m.thresholds[static_cast<long long>(idx) * m.g + gi];
    out = any ? (out || sat) : (out && sat);
  }
  return out;
}

// searchsorted(boundaries, x, side="right") over nondecreasing int32
// boundaries: how many are <= x.
__device__ __forceinline__ int epoch_of(const int32_t* boundaries, int nb,
                                        int32_t x) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (boundaries[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void check_batch_multi_kernel(const int32_t* __restrict__ present,
                                         long long row_stride,
                                         long long col_stride, int b,
                                         const int32_t* __restrict__ idx,
                                         uint8_t* __restrict__ out,
                                         MultiPred m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const int32_t* row = present + static_cast<long long>(j) * row_stride;
  out[j] = multi_hit(m, idx[j], [&](int i) {
    return row[static_cast<long long>(i) * col_stride];
  });
}

__global__ void record_and_check_epochs_kernel(Board bd, Lanes ln,
                                               const int32_t* boundaries,
                                               int nb, uint8_t* newly,
                                               int32_t* scratch,
                                               MultiPred m) {
  sparse_update(bd, ln, scratch);
  choose(bd, ln, newly, scratch, [&](int j) {
    const long long s = ln.col(j);
    return lane_mine(bd, ln, j) &&
           multi_hit(m, epoch_of(boundaries, nb, ln.true_slot(j)),
                     [&](int i) {
                       return static_cast<int32_t>(
                           bd.votes[i * bd.window + s]);
                     });
  });
}

__global__ void reshape_columns_kernel(const uint8_t* __restrict__ block,
                                       int n_old, long long b,
                                       const int32_t* __restrict__ cmap,
                                       uint8_t* __restrict__ out) {
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (col >= b) return;
  const int i = blockIdx.y;
  const int32_t src = cmap[i];
  out[i * b + col] =
      src < 0 ? 0 : block[static_cast<long long>(min(src, n_old - 1)) * b +
                          col];
}

MultiPred make_multi(const void* masks, const void* thresholds,
                     const void* any, int k, int g, int n) {
  return MultiPred{static_cast<const int32_t*>(masks),
                   static_cast<const int32_t*>(thresholds),
                   static_cast<const uint8_t*>(any), k, g, n};
}

}  // namespace

extern "C" int fpx_check_batch_multi(const void* present,
                                     long long row_stride,
                                     long long col_stride, int b,
                                     const void* config_idx, void* out,
                                     const void* masks,
                                     const void* thresholds,
                                     const void* combine_any, int k, int g,
                                     int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  check_batch_multi_kernel<<<(b + FPX_THREADS - 1) / FPX_THREADS,
                             FPX_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(present), row_stride, col_stride, b,
      static_cast<const int32_t*>(config_idx), static_cast<uint8_t*>(out),
      make_multi(masks, thresholds, combine_any, k, g, n));
  return cudaGetLastError();
}

extern "C" int fpx_record_and_check_epochs(
    void* votes, void* rounds, void* chosen, void* owner, long long window,
    const void* lanes, int b, const void* boundaries, int nb, void* newly,
    void* scratch, const void* masks, const void* thresholds,
    const void* combine_any, int k, int g, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  record_and_check_epochs_kernel<<<1, FPX_SPARSE_THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      Board{static_cast<uint8_t*>(votes), static_cast<int32_t*>(rounds),
            static_cast<uint8_t*>(chosen), static_cast<int32_t*>(owner),
            window, n},
      Lanes{static_cast<const int32_t*>(lanes), b, window},
      static_cast<const int32_t*>(boundaries), nb,
      static_cast<uint8_t*>(newly), static_cast<int32_t*>(scratch),
      make_multi(masks, thresholds, combine_any, k, g, n));
  return cudaGetLastError();
}

extern "C" int fpx_reshape_columns(const void* block, int n_old,
                                   long long b, const void* cmap, int n_new,
                                   void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((b + FPX_THREADS - 1) / FPX_THREADS),
                  static_cast<unsigned>(n_new));
  reshape_columns_kernel<<<grid, FPX_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(block), n_old, b,
      static_cast<const int32_t*>(cmap), static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
