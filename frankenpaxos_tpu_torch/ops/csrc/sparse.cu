// K4 record_and_check and K5 release: the sparse half of
// TpuQuorumChecker.
//
// K4 replaces frankenpaxos_tpu/ops/quorum.py::_record_and_check (L214)
// over _apply_sparse_votes (L170): the straggler / out-of-order votes of
// one drain, as lanes (slot % window, true slot, node, round, valid),
// scattered into the vote board IN PLACE, then the quorum predicate of
// quorum.cuh (both branches, as K1) on each touched column and the
// per-lane "slot newly has quorum" mask. The ordered phases run in one
// thread block (sparse.cuh explains why).
//
// K5 replaces _release (L327): for each valid lane, reset the column to
// votes 0, round -1, chosen false, owner -1. One thread per lane; every
// writer of a column stores the same reset values, so duplicate lanes
// need no order. JAX's `.set` leaves the order of a duplicate slot's
// lanes unspecified when their valid flags differ; here the column is
// reset when ANY of its lanes is valid.
//
// Bound on the H100: neither. At the tracker's 256-lane chunks K4 moves
// about 20 bytes of lanes plus ~(2N + 18) bytes per touched column, a
// few kilobytes, and K5 (4096 lanes in the prewarm) about 100 KB: both
// are far below a microsecond of memory time, so the launch and K4's
// nine block-wide barriers set their time. Moving the lanes in one
// packed int32 [5, B] array keeps it to one host-to-device copy per call.

#include "sparse.cuh"

namespace {

__global__ void record_and_check_kernel(Board bd, Lanes ln, uint8_t* newly,
                                        int32_t* scratch, QuorumPred q) {
  sparse_update(bd, ln, scratch);
  choose(bd, ln, newly, scratch, [&](int j) {
    const long long s = ln.col(j);
    return lane_mine(bd, ln, j) && quorum_hit(q, [&](int i) {
             return bd.votes[i * bd.window + s];
           });
  });
}

__global__ void release_kernel(Board bd, const int32_t* slots,
                               const uint8_t* valid, int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b || !valid[j]) return;
  long long s = slots[j];
  // JAX normalises a negative index and drops one out of range.
  if (s < 0) s += bd.window;
  if (s < 0 || s >= bd.window) return;
  for (int i = 0; i < bd.n; ++i) bd.votes[i * bd.window + s] = 0;
  bd.rounds[s] = -1;
  bd.chosen[s] = 0;
  bd.owner[s] = -1;
}

Board make_board(void* votes, void* rounds, void* chosen, void* owner,
                 long long window, int n) {
  return Board{static_cast<uint8_t*>(votes), static_cast<int32_t*>(rounds),
               static_cast<uint8_t*>(chosen), static_cast<int32_t*>(owner),
               window, n};
}

}  // namespace

extern "C" int fpx_record_and_check(void* votes, void* rounds, void* chosen,
                                    void* owner, long long window,
                                    const void* lanes, int b, void* newly,
                                    void* scratch, const void* masks,
                                    const void* thresholds, const void* perm,
                                    int n, int g, int combine_any,
                                    int grid_kind, int rows, int cols,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  record_and_check_kernel<<<1, FPX_SPARSE_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      make_board(votes, rounds, chosen, owner, window, n),
      Lanes{static_cast<const int32_t*>(lanes), b, window},
      static_cast<uint8_t*>(newly), static_cast<int32_t*>(scratch),
      make_pred(masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
                cols));
  return cudaGetLastError();
}

extern "C" int fpx_release(void* votes, void* rounds, void* chosen,
                           void* owner, long long window, int n,
                           const void* slots, const void* valid, int b,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  release_kernel<<<(b + FPX_THREADS - 1) / FPX_THREADS, FPX_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      make_board(votes, rounds, chosen, owner, window, n),
      static_cast<const int32_t*>(slots), static_cast<const uint8_t*>(valid),
      b);
  return cudaGetLastError();
}
