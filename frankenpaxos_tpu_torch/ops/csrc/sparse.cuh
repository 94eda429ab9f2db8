// The sparse vote-board update shared by K4 record_and_check
// (sparse.cu) and K6 record_and_check_epochs (epoch.cu): the device
// twin of frankenpaxos_tpu/ops/quorum.py::_apply_sparse_votes (L170).
//
// The reference runs ordered phases, each of which reads every lane's
// "old" value before any lane of that phase scatters:
//
//   1. old_owner = owner[slots];  owner.at[slots].max(valid ? true : -inf)
//   2. reclaimed = owner[slots] > old_owner: clear votes/rounds/chosen
//   3. old_round = rounds[slots]; rounds.at[slots].max(mine ? round : -inf)
//   4. preempted = rounds[slots] > old_round: clear the votes column
//   5. votes.at[nodes, slots].max(live)
//
// A batch may name one slot in many lanes, so a thread per lane with no
// barrier between the phases would let one lane read a value another
// lane has already moved. The update therefore runs in ONE thread block
// that loops over all lanes, with __syncthreads() between the phases
// (it makes the block's global writes visible to the whole block). The
// tracker's scatter chunks are at most 256 lanes, so one block is one
// launch with no idle waves. The int32 maxes are atomicMax; every lane
// of a phase that writes a plain store writes the value every duplicate
// lane writes (per-slot quantities are equal across duplicates), so the
// order of those stores does not matter. The vote max is "store 1 where
// the byte is 0": max(old, 1) for any byte, and in that phase no lane
// stores anything else, so it is exact whatever the board holds.
//
// Padding lanes (valid == 0, slot 0) take part exactly as in the
// reference: their owner and round maxes use -inf, so they change
// nothing, and they are never `mine`, so they record no vote.
//
// A slot outside [0, window) follows JAX's index rules: a negative slot
// counts from the end; one still out of range READS the clamped column
// (gathers clamp) and WRITES nothing (scatters drop). Such a lane can
// still report `newly` for the clamped column, as in the reference.
//
// No board pointer is __restrict__ or read through the read-only cache:
// lanes read what other lanes of the block wrote.
#pragma once

#include "quorum.cuh"

// The reference's _NEG_INF32 = -(2**31) + 1.
#define FPX_NEG_INF32 (-2147483647)

// Threads of the one block that runs a sparse update.
#define FPX_SPARSE_THREADS 256

struct Board {
  uint8_t* votes;   // [n, window]
  int32_t* rounds;  // [window]
  uint8_t* chosen;  // [window] (bool)
  int32_t* owner;   // [window]
  long long window;
  int n;
};

// Lanes packed as int32 [5, b]: slots (% window by every caller), true
// slots, nodes, rounds, valid (0/1).
struct Lanes {
  const int32_t* p;
  int b;
  long long window;
  __device__ long long normalized(int j) const {
    const long long s = p[j];
    return s < 0 ? s + window : s;
  }
  // The column lane j reads (JAX's gather clamps).
  __device__ long long col(int j) const {
    return min(max(normalized(j), 0LL), window - 1);
  }
  // Whether lane j writes its column (JAX's scatter drops the rest).
  __device__ bool writes(int j) const {
    const long long s = normalized(j);
    return s >= 0 && s < window;
  }
  __device__ int32_t true_slot(int j) const { return p[b + j]; }
  __device__ int32_t node(int j) const { return p[2 * b + j]; }
  __device__ int32_t round(int j) const { return p[3 * b + j]; }
  __device__ bool valid(int j) const { return p[4 * b + j] != 0; }
};

#define FPX_LANES(j, lanes) \
  for (int j = threadIdx.x; j < (lanes).b; j += blockDim.x)

// `mine`: the lane is valid and its slot owns the column (after phase 1).
__device__ __forceinline__ bool lane_mine(const Board& bd, const Lanes& ln,
                                          int j) {
  return ln.valid(j) && ln.true_slot(j) == bd.owner[ln.col(j)];
}

// Phases 1-5. `scratch` holds 2*b int32 (old owners, old rounds).
__device__ void sparse_update(const Board& bd, const Lanes& ln,
                              int32_t* scratch) {
  int32_t* old_owner = scratch;
  int32_t* old_round = scratch + ln.b;
  FPX_LANES(j, ln) { old_owner[j] = bd.owner[ln.col(j)]; }
  __syncthreads();
  FPX_LANES(j, ln) {
    if (ln.writes(j)) {
      atomicMax(&bd.owner[ln.col(j)],
                ln.valid(j) ? ln.true_slot(j) : FPX_NEG_INF32);
    }
  }
  __syncthreads();
  // Ring self-reclaim: a newer slot took the column.
  FPX_LANES(j, ln) {
    const long long s = ln.col(j);
    if (ln.writes(j) && bd.owner[s] > old_owner[j]) {
      for (int i = 0; i < bd.n; ++i) bd.votes[i * bd.window + s] = 0;
      bd.rounds[s] = -1;
      bd.chosen[s] = 0;
    }
  }
  __syncthreads();
  FPX_LANES(j, ln) { old_round[j] = bd.rounds[ln.col(j)]; }
  __syncthreads();
  FPX_LANES(j, ln) {
    if (ln.writes(j)) {
      atomicMax(&bd.rounds[ln.col(j)],
                lane_mine(bd, ln, j) ? ln.round(j) : FPX_NEG_INF32);
    }
  }
  __syncthreads();
  // A newer round preempts: the column's older-round votes go.
  FPX_LANES(j, ln) {
    const long long s = ln.col(j);
    if (ln.writes(j) && bd.rounds[s] > old_round[j]) {
      for (int i = 0; i < bd.n; ++i) bd.votes[i * bd.window + s] = 0;
    }
  }
  __syncthreads();
  // votes.at[nodes, slots].max(live): JAX normalises a negative node
  // index (node + n) and drops one that is still out of range.
  FPX_LANES(j, ln) {
    const long long s = ln.col(j);
    int32_t node = ln.node(j);
    if (node < 0) node += bd.n;
    const bool live = lane_mine(bd, ln, j) && ln.round(j) == bd.rounds[s];
    if (live && ln.writes(j) && node >= 0 && node < bd.n) {
      uint8_t* cell = bd.votes + node * bd.window + s;
      if (*cell == 0) *cell = 1;
    }
  }
  __syncthreads();
}

// The predicate phase: newly[j] = hit & ~chosen0[slot], then
// chosen.at[slots].max(hit). `hit_of(j)` gives lane j's hit (already
// ANDed with mine); `flag` holds b int32.
template <typename Hit>
__device__ void choose(const Board& bd, const Lanes& ln, uint8_t* newly,
                       int32_t* flag, Hit hit_of) {
  FPX_LANES(j, ln) {
    const bool hit = hit_of(j);
    newly[j] = hit && bd.chosen[ln.col(j)] == 0;
    flag[j] = hit && ln.writes(j);
  }
  __syncthreads();
  FPX_LANES(j, ln) {
    if (flag[j]) bd.chosen[ln.col(j)] = 1;
  }
}
