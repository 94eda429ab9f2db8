// The quorum predicate of one slot column, shared by every kernel of the
// port (K1 quorum_hit, K2 record_block, K3 steady_state_step).
//
// It reproduces whichever branch the JAX reference takes
// (frankenpaxos_tpu/ops/quorum.py::_predicate_hit):
//
//   * generic: counts[g] = sum_n masks[g, n] * int32(votes[n]), the int32
//     weighted count of the `masks @ votes` matmul (NOT a popcount of
//     nonzero bytes), then `>= thresholds[g]`, then any/all over g;
//   * grid (grid_layout != None): the uint8 `|`/`&` chain of
//     _fused_grid_hit over rows and columns of the permuted universe,
//     then `!= 0`.
//
// The two differ on vote bytes other than 0/1 (a write grid with a 2 in
// one row and a 1 in another gives 2 & 1 = 0 in the chain but passes the
// count), so each branch is kept exactly.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Threads per block of every kernel (one thread per slot column).
#define FPX_THREADS 256

struct QuorumPred {
  const int32_t* masks;       // [g, n] group membership weights
  const int32_t* thresholds;  // [g]
  const int32_t* perm;        // [n] row-major grid order -> universe node
  int n;                      // nodes (acceptor rows)
  int g;                      // groups
  int combine_any;            // 1: any over groups, 0: all
  int grid_kind;              // 0 generic, 1 write grid, 2 read grid
  int rows, cols;             // grid shape (grid_kind != 0)
};

inline QuorumPred make_pred(const void* masks, const void* thresholds,
                            const void* perm, int n, int g, int combine_any,
                            int grid_kind, int rows, int cols) {
  return QuorumPred{static_cast<const int32_t*>(masks),
                    static_cast<const int32_t*>(thresholds),
                    static_cast<const int32_t*>(perm),
                    n, g, combine_any, grid_kind, rows, cols};
}

// `vote(i)` returns the uint8 vote byte of universe node i for the column.
template <typename Vote>
__device__ __forceinline__ bool quorum_hit(const QuorumPred& q, Vote vote) {
  if (q.grid_kind != 0) {
    const bool write = q.grid_kind == 1;
    uint8_t acc = 0;
    for (int r = 0; r < q.rows; ++r) {
      uint8_t row = vote(q.perm[r * q.cols]);
      for (int c = 1; c < q.cols; ++c) {
        const uint8_t cell = vote(q.perm[r * q.cols + c]);
        row = write ? (row | cell) : (row & cell);
      }
      acc = r == 0 ? row : (write ? (acc & row) : (acc | row));
    }
    return acc != 0;
  }
  bool out = !q.combine_any;  // any() of nothing is false, all() true
  for (int gi = 0; gi < q.g; ++gi) {
    // int32 matmul arithmetic, wrapping like XLA's (unsigned: no UB).
    uint32_t count = 0;
    for (int i = 0; i < q.n; ++i) {
      count += static_cast<uint32_t>(q.masks[gi * q.n + i]) *
               static_cast<uint32_t>(vote(i));
    }
    const bool sat = static_cast<int32_t>(count) >= q.thresholds[gi];
    out = q.combine_any ? (out || sat) : (out && sat);
  }
  return out;
}

// Every library exports the same error-name lookup for its wrapper.
extern "C" const char* fpx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

