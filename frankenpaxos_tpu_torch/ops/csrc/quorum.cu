// K1 quorum_hit and K2 record_block: the dense half of TpuQuorumChecker.
//
// K1 replaces frankenpaxos_tpu/ops/quorum.py::_check_block (L348) and
// _check_batch (L342), i.e. _predicate_hit (L156) over a vote block:
// one thread per slot column reads the column's N vote bytes through
// the row and column strides it is given (so check_batch's [B, N] input
// needs no transpose copy) and writes one bool.
//
// K2 replaces _record_block (L267): one thread per column of the block
// [start, start + B) runs the reference's ring self-reclaim, round max
// with preemption clear, OR-in of live votes, predicate and
// `newly = hit & ~old_chosen & touched` for its column and writes the
// votes, rounds, chosen and owner columns back IN PLACE (JAX donates the
// board; the port updates it).
//
// Bound on the H100: bytes. Both are column-local passes with a few
// integer operations per byte (K1 at N=3 moves 4 bytes per column, K2
// about 3N+14), far below the card's compute; at the main path's
// B=32768 they move 0.13 MB and 0.75 MB, well under a microsecond at
// 3.35 TB/s, so the launch itself dominates. The design keeps each
// column in one thread (no cross-thread traffic, no atomics) and lets
// neighbouring threads touch neighbouring bytes so every row read is
// coalesced; vector loads and batching launches are later work.

#include "quorum.cuh"

namespace {

__global__ void quorum_hit_kernel(const uint8_t* __restrict__ votes,
                                  long long row_stride, long long col_stride,
                                  int b, uint8_t* __restrict__ out,
                                  QuorumPred q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const uint8_t* col = votes + static_cast<long long>(j) * col_stride;
  out[j] = quorum_hit(q, [&](int i) {
    return col[static_cast<long long>(i) * row_stride];
  });
}

__global__ void record_block_kernel(uint8_t* __restrict__ votes,
                                    int32_t* __restrict__ rounds,
                                    uint8_t* __restrict__ chosen,
                                    int32_t* __restrict__ owner,
                                    long long window,
                                    const uint8_t* __restrict__ block, int b,
                                    int start, int true_start, int vote_round,
                                    uint8_t* __restrict__ newly,
                                    QuorumPred q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const long long c = static_cast<long long>(start) + j;

  bool touched = false;
  for (int i = 0; i < q.n; ++i) {
    touched |= block[static_cast<long long>(i) * b + j] != 0;
  }
  // Ring self-reclaim: claim a column owned by an older slot, drop votes
  // for a slot the column has moved past. slot ids wrap as int32.
  const int32_t slot_id = static_cast<int32_t>(
      static_cast<uint32_t>(true_start) + static_cast<uint32_t>(j));
  const int32_t old_owner = owner[c];
  const bool claim = touched && slot_id > old_owner;
  const bool stale = touched && slot_id < old_owner;
  touched = touched && !stale;
  const int32_t new_owner = claim ? slot_id : old_owner;

  const int32_t old_round = claim ? -1 : rounds[c];
  const int32_t new_round =
      touched ? max(old_round, vote_round) : old_round;
  const bool preempted = new_round > old_round;
  const bool live = touched && vote_round == new_round;
  // The reference ANDs the block with touched and with live as uint8
  // 0/1 masks, so a live vote byte contributes only its low bit.
  const uint8_t keep = live ? 1 : 0;
  for (int i = 0; i < q.n; ++i) {
    uint8_t* cell = votes + static_cast<long long>(i) * window + c;
    uint8_t v = (claim || preempted) ? 0 : *cell;
    v |= block[static_cast<long long>(i) * b + j] & keep;
    *cell = v;
  }
  const bool hit = quorum_hit(q, [&](int i) {
    return votes[static_cast<long long>(i) * window + c];
  });
  const bool old_chosen = claim ? false : chosen[c] != 0;
  newly[j] = hit && !old_chosen && touched;
  chosen[c] = hit || old_chosen;
  rounds[c] = new_round;
  owner[c] = new_owner;
}

inline int blocks_for(int b) { return (b + FPX_THREADS - 1) / FPX_THREADS; }

}  // namespace

extern "C" int fpx_quorum_hit(const void* votes, long long row_stride,
                              long long col_stride, int b, void* out,
                              const void* masks, const void* thresholds,
                              const void* perm, int n, int g,
                              int combine_any, int grid_kind, int rows,
                              int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  quorum_hit_kernel<<<blocks_for(b), FPX_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(votes), row_stride, col_stride, b,
      static_cast<uint8_t*>(out),
      make_pred(masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
                cols));
  return cudaGetLastError();
}

extern "C" int fpx_record_block(void* votes, void* rounds, void* chosen,
                                void* owner, long long window,
                                const void* block, int b, int start,
                                int true_start, int vote_round, void* newly,
                                const void* masks, const void* thresholds,
                                const void* perm, int n, int g,
                                int combine_any, int grid_kind, int rows,
                                int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  record_block_kernel<<<blocks_for(b), FPX_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(votes), static_cast<int32_t*>(rounds),
      static_cast<uint8_t*>(chosen), static_cast<int32_t*>(owner), window,
      static_cast<const uint8_t*>(block), b, start, true_start, vote_round,
      static_cast<uint8_t*>(newly),
      make_pred(masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
                cols));
  return cudaGetLastError();
}
