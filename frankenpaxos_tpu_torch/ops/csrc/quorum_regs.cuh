// The quorum predicate in registers, one instantiation per board
// structure: shared by K1 quorum_hit (quorum.cu) and the drain kernels K3
// and K14 (pipeline.cu). quorum.cuh's quorum_hit evaluates any predicate
// with runtime sizes; here every size is a constant, so a column's test
// is straight-line code.
//
// The forms (kCols): for each acceptor count kN of 1 .. kMaxRegN, one
// weighted group against its threshold (kOneGroup: a majority), any other
// count of groups (kGroups: a loop over them, uniform over the grid), and
// one grid per column count kCols dividing kN (kN / kCols rows of kCols
// slots; slot s holds acceptor perm[s]; a write and a read grid share it,
// see hit_regs, and a grid of single-slot rows runs as one row of the
// other kind, see register_form). Form<0, 0> is the runtime loop of
// quorum.cuh, for boards of more than kMaxRegN acceptors.
#pragma once

#include "quorum.cuh"

namespace fpx_regs {

constexpr int kMaxRegN = 16;
constexpr int kOneGroup = 0;
constexpr int kGroups = -1;

// The predicate as the register path reads it: group 0's weights in
// registers, the other groups' read from the predicate's arrays.
template <int kN, int kCols>
struct RegPred {
  uint32_t flip;               // grid: 0xff for a read grid, 0 for a write
  int g, any;                  // groups: their count, the any/all combiner
  uint32_t mask0[kN];          // group 0's weights
  int32_t thr0;
  const int32_t* masks;        // [g, kN]
  const int32_t* thresholds;   // [g]
};

template <int kN, int kCols>
__device__ __forceinline__ RegPred<kN, kCols> reg_pred(const QuorumPred& q) {
  RegPred<kN, kCols> p;
  p.flip = q.grid_kind == 1 ? 0u : 0xffu;  // quorum.cuh: not 1 reads
  p.g = q.g;
  p.any = q.combine_any;
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    p.mask0[s] = (kCols <= 0 && q.g > 0) ? static_cast<uint32_t>(q.masks[s])
                                         : 0u;
  }
  p.thr0 = (kCols <= 0 && q.g > 0) ? q.thresholds[0] : 0;
  p.masks = q.masks;
  p.thresholds = q.thresholds;
  return p;
}

// quorum.cuh's quorum_hit on a column of vote bytes (0 .. 255) in slot
// order, every size and loop a constant. A grid is quorum.cuh's uint8
// chain: a write grid ORs each row's bytes and ANDs the rows; a read grid
// ANDs each row and ORs the rows, which on bytes is the complement of the
// write chain on the complemented bytes (De Morgan), so both run one
// chain with `flip`.
template <int kN, int kCols>
__device__ __forceinline__ bool hit_regs(const uint32_t (&v)[kN],
                                         const RegPred<kN, kCols>& p) {
  if constexpr (kCols > 0) {
    uint32_t acc = 0xffu;
#pragma unroll
    for (int r = 0; r < kN / kCols; ++r) {
      uint32_t row = 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) row |= v[r * kCols + c] ^ p.flip;
      acc &= row;
    }
    return ((acc ^ p.flip) & 0xffu) != 0;
  } else {
    // int32 matmul arithmetic, wrapping like XLA's (unsigned: no UB).
    uint32_t count = 0;
#pragma unroll
    for (int s = 0; s < kN; ++s) count += p.mask0[s] * v[s];
    const bool sat0 = static_cast<int32_t>(count) >= p.thr0;
    if constexpr (kCols == kOneGroup) {
      return sat0;  // any() and all() of one test are the test
    } else {
      // any() of nothing is false, all() true.
      bool out = p.g == 0 ? !p.any : sat0;
      for (int gi = 1; gi < p.g; ++gi) {
        uint32_t c = 0;
#pragma unroll
        for (int s = 0; s < kN; ++s) {
          c += static_cast<uint32_t>(p.masks[gi * kN + s]) * v[s];
        }
        const bool sat = static_cast<int32_t>(c) >= p.thresholds[gi];
        out = p.any ? (out || sat) : (out && sat);
      }
      return out;
    }
  }
}

// Whether `q` has a register form (at most kMaxRegN acceptors, and a
// grid's rows tiling its acceptors). A grid of single-slot rows becomes
// one row of the other kind: a write grid of n rows of one ANDs the n
// votes and a read grid ORs them, which is one row of n of the other
// kind (the same slots).
inline bool register_form(QuorumPred& q) {
  const bool regs = q.n >= 1 && q.n <= kMaxRegN &&
                    (q.grid_kind == 0 ||
                     (q.cols >= 1 && q.rows * q.cols == q.n));
  if (regs && q.grid_kind != 0 && q.cols == 1) {
    q.grid_kind = q.grid_kind == 1 ? 2 : 1;
    q.rows = 1;
    q.cols = q.n;
  }
  return regs;
}

// A form's sizes as a type, for a launcher `f(Form<kN, kCols>{})`.
template <int kN, int kCols>
struct Form {
  static constexpr int n = kN;
  static constexpr int cols = kCols;
};

// The grid forms of kN acceptors: one per divisor kCols of kN but 1.
template <int kN, int kCols, typename F>
cudaError_t dispatch_grid(const QuorumPred& q, F& f) {
  if constexpr (kN == 1) {
    return f(Form<1, 1>{});  // one acceptor: one row of one
  } else if constexpr (kCols > kN) {
    return f(Form<0, 0>{});  // rows * cols != n: unreachable
  } else {
    if constexpr (kN % kCols == 0) {
      if (q.cols == kCols) return f(Form<kN, kCols>{});
    }
    return dispatch_grid<kN, kCols + 1>(q, f);
  }
}

// Calls `f` with the register form of `q`, which register_form accepted.
template <int kN = 1, typename F>
cudaError_t dispatch_regs(const QuorumPred& q, F& f) {
  if constexpr (kN > kMaxRegN) {
    return f(Form<0, 0>{});  // n > kMaxRegN: unreachable
  } else {
    if (q.n != kN) return dispatch_regs<kN + 1>(q, f);
    if (q.grid_kind != 0) return dispatch_grid<kN, 2>(q, f);
    if (q.g == 1) return f(Form<kN, kOneGroup>{});
    return f(Form<kN, kGroups>{});
  }
}

}  // namespace fpx_regs
