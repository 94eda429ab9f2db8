// K3 and K14, its telemetry-on twin: a RUN of drains of the
// device-resident MultiPaxos steady-state pipeline in ONE launch,
// run_steps_kernel<kTelemetry>.
//
// Replaces frankenpaxos_tpu/bench/pipeline.py::run_steps (L341) /
// run_steps_from (L358), unsharded: a jitted lax.fori_loop over
// steady_state_step (L145, with _arrivals L87). A single drain is a run of
// one (fpx_run_steps with iters = 1).
//
// Ownership. In drain i, block lane j touches only column `start + j` of
// the new, old and GC blocks, and every block starts at a multiple of
// block_size, so over a whole run lane j touches only the columns
// k * block_size + j. One thread owns lane j for the whole run and runs
// the reference's order once per drain:
//   propose -> pass 1 (new block) -> pass 2 (old block) -> execute -> GC.
// Outside the scalars it adds to, no lane depends on another, so a run
// needs no grid-wide barrier.
//
// Register carry. Drain i's old block is drain i-1's new block, and with
// num_blocks >= 3 (and the ring contiguous: num_blocks a power of two, or
// the run not crossing the int32 wrap) nothing else touches that column in
// between. So the column's N vote bytes, its chosen byte and its command
// stay in registers from one drain to the next, and are stored only where
// they outlive the run: a column's pass-2 result is zeroed by the next
// drain's GC, so inside a run it is never stored; the run's last drain
// stores its old and new columns. The run's first drain reads both from
// memory, since a run may resume any state. Votes sit in registers in the
// predicate's slot order (slot s holds acceptor perm[s]), so a grid's row
// chains index registers at compile-time positions. The register path is
// one instantiation per board structure, every size a constant: for each
// acceptor count kN of 1 .. 16, one weighted group against its threshold
// (a majority), any other count of groups (a loop over them, uniform over
// the grid), and one grid per column count kCols dividing kN (kN / kCols
// rows; a write and a read grid share it, see hit_regs, and a grid of
// single-slot rows runs as one row of the other kind). So the drain body
// is straight-line code with no slot guard, loop bound or predicate
// branch, but for boards of several non-grid groups.
// At window / block_size of 1 and 2 the new, old and GC blocks alias,
// and those ratios, boards above 16 acceptors and runs whose ring jumps at
// the int32 wrap take the memory path (kN = 0): the same order, each
// pass a read-modify-write of global memory, exact for any aliasing.
//
// Prefetch. Drain k + 2's new column is loaded at the top of drain k:
// with num_blocks >= 5 no drain touches it before, and with 3 or 4 blocks
// a GC zeroes it first. Four columns take turns as a drain's new, old,
// next and ahead columns (the loop is unrolled by four), so a drain never
// waits on a load it issued or copies a register a load still fills.
//
// The predicate is copied into shared memory once per launch (when it
// fits kPredSharedBytes); group 0's weights sit in registers.
//
// The sums. committed and sm_state add up per thread in uint32 and are
// added once per thread block per run (block reduction + atomicAdd):
// bit-identical to int32 wraparound and independent of order. exec_wm is
// written once, with the last drain's value, by one thread.
//
// K14 (kTelemetry = true) also accumulates the telemetry plane, the weave
// of frankenpaxos_tpu/ops/telemetry.py (lag_bucket L99,
// quorum_pass_update L108, drain_update L136) into the reference's step
// at L285-291 and L328-333, into one flat int32 buffer laid out as
// ops/telemetry.py's make_telemetry lays it out for one slot shard:
//   [0] shard_committed, [1] proposed, [2, n+2] occupancy,
//   [n+3, n+18] lag_hist, [n+19] pad_lanes, [n+20] drains,
//   [n+21] scratch: the done-counter below, 0 between launches.
// Occupancy: a lane newly chosen by a pass adds one to bin min(sum of its
// N vote bytes after the OR, n), in registers of its own in the register
// path (in the memory path a warp gathers its bins by ballots, lane b
// holding bin b), added once per run. The lag needs `committed`
// at the end of EVERY drain: each block adds its per-drain newly count
// into `scratch` (an int32 per drain, outside the telemetry buffer, kept
// by the wrapper and zero between launches) through a ring of kRing drains
// in shared memory; the block that finishes last (a done-counter, once
// per launch) recovers the run's starting committed as the final value
// minus the run's sum (mod 2^32), prefix-sums the array, adds every
// drain's lag_bucket sample, the drain count, and zeroes the array. A
// launch runs at most kMaxDrains drains (the wrapper splits longer runs).
//
// Integer hashing uses uint32 arithmetic and casts: signed overflow is
// undefined in CUDA C++, while the reference relies on int32 wraparound.
// The drain index wraps as int32 inside a run.
//
// Bound on the H100: a run reads the state once and writes it once, 2 x
// (N + 9) bytes a window slot (25.2 MB at N=3, W=2^20: 7.5 us), and does
// about 2 (10N + 2GN + 8) + 30 integer operations a lane and drain (118 at
// N=3: 0.058 us a drain at 67 T/s), so a run of 1024 drains or more is
// bound by its operations. The reference's drain moves (5N+17) bytes a
// lane and drain (0.313 us at 3.35 TB/s); the register carry 2N+10 (the
// new column's N+1 bytes read, the command, the result and the GC
// column's N+1 zeros written), and the 12.6 MB state stays in the 50 MB L2.

#include <climits>
#include <cstring>

#include "drain.cuh"
#include "quorum.cuh"

namespace {

using namespace fpx_drain;

constexpr unsigned kFullWarp = 0xffffffffu;
// Drains per launch at most: K14's scratch holds one int32 per drain
// (bench/pipeline.py::MAX_DRAINS).
constexpr long long kMaxDrains = 1 << 16;
// K14: drains a block gathers in shared memory before it adds them into
// the scratch array (two barriers per kRing drains).
constexpr int kRing = 64;
// The predicate goes to shared memory when its arrays fit this many bytes.
constexpr int kPredSharedBytes = 16384;
// The arrival hash's multipliers (lane, acceptor, drain).
constexpr uint32_t kLaneMul = 1103515245u;
constexpr uint32_t kAccMul = 12820163u;
constexpr uint32_t kDrainMul = 22695477u;

// Everything a launch needs besides the predicate.
struct Run {
  uint8_t* votes;
  uint8_t* chosen;
  int32_t* commands;
  int32_t* results;
  int32_t* sm_state;
  int32_t* committed;
  int32_t* exec_wm;
  long long window;
  int block_size;
  int num_blocks;
  int start;           // the first drain's index (int32)
  int iters;           // drains in this launch, 1 .. kMaxDrains
  int32_t* tel;        // K14: the flat counters (n + 22 words)
  uint32_t* scratch;   // K14: [iters] per-drain newly counts
};

__device__ __forceinline__ int pred_words(const QuorumPred& q) {
  return q.g * q.n + q.g + q.n;
}

// The predicate's arrays copied into shared memory (when `smem` is not
// null): the view every thread reads.
__device__ QuorumPred stage_pred(QuorumPred q, int32_t* smem) {
  if (smem == nullptr) return q;
  const int gn = q.g * q.n;
  for (int t = threadIdx.x; t < gn; t += blockDim.x) smem[t] = q.masks[t];
  for (int t = threadIdx.x; t < q.g; t += blockDim.x) {
    smem[gn + t] = q.thresholds[t];
  }
  for (int t = threadIdx.x; t < q.n; t += blockDim.x) {
    smem[gn + q.g + t] = q.perm[t];
  }
  q.masks = smem;
  q.thresholds = smem + gn;
  q.perm = smem + gn + q.g;
  return q;
}

// --- the memory path --------------------------------------------------------

// One quorum pass on column c in global memory: OR in the arrivals, run
// the predicate, mark chosen. Returns whether the column was newly
// chosen; `votes_sum` gets the int32 sum of its vote bytes after the OR.
__device__ __forceinline__ bool pass_memory(const Run& r, long long c,
                                            int lane, int i, bool complement,
                                            const QuorumPred& q,
                                            uint32_t& votes_sum) {
  uint32_t sum = 0;
  for (int n = 0; n < q.n; ++n) {
    uint8_t a = arrives(lane, n, i);
    if (complement) a = 1 - a;
    const uint8_t v = r.votes[n * r.window + c] | a;
    r.votes[n * r.window + c] = v;
    sum += v;
  }
  votes_sum = sum;
  const bool hit =
      quorum_hit(q, [&](int n) { return r.votes[n * r.window + c]; });
  const bool old = r.chosen[c] != 0;
  r.chosen[c] = hit || old;
  return hit && !old;
}

// --- the register path ------------------------------------------------------

// A column in registers: its kN vote bytes in slot order, and chosen.
template <int kN>
struct Column {
  uint32_t v[kN];
  uint32_t chosen;
};

// The register path's predicate forms (kCols): a grid of kN / kCols rows
// of kCols slots (kCols > 0; slot s holds acceptor perm[s]), one weighted
// group (kOneGroup), or any other count of groups (kGroups: a loop over
// them, uniform over the grid).
constexpr int kOneGroup = 0;
constexpr int kGroups = -1;

// The predicate as the register path reads it: group 0's weights in
// registers, the other groups' read from the predicate's (shared) arrays.
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

// quorum.cuh's quorum_hit on a column in slot order, every size and loop a
// constant. A grid is quorum.cuh's uint8 chain: a write grid ORs each
// row's bytes and ANDs the rows; a read grid ANDs each row and ORs the
// rows, which on bytes is the complement of the write chain on the
// complemented bytes (De Morgan), so both run one chain with `flip`.
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

template <int kN>
__device__ __forceinline__ void load_column(const Run& r,
                                            const int (&acc)[kN], long long c,
                                            Column<kN>& col) {
#pragma unroll
  for (int s = 0; s < kN; ++s) col.v[s] = r.votes[acc[s] * r.window + c];
  col.chosen = r.chosen[c] != 0;
}

template <int kN>
__device__ __forceinline__ void store_column(const Run& r,
                                             const int (&acc)[kN],
                                             long long c,
                                             const Column<kN>& col) {
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    r.votes[acc[s] * r.window + c] = static_cast<uint8_t>(col.v[s]);
  }
  r.chosen[c] = static_cast<uint8_t>(col.chosen);
}

// One quorum pass on a column in registers; `hash` holds lane * kLaneMul
// + perm[s] * kAccMul per slot, `drain_hash` the drain index * kDrainMul.
template <int kN, int kCols>
__device__ __forceinline__ bool pass_regs(Column<kN>& col,
                                          const uint32_t (&hash)[kN],
                                          uint32_t drain_hash,
                                          uint32_t complement,
                                          const RegPred<kN, kCols>& p,
                                          uint32_t& votes_sum) {
  uint32_t sum = 0;
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    const uint32_t a =
        ((((hash[s] + drain_hash) >> 7) & 7u) < 7u ? 1u : 0u) ^ complement;
    col.v[s] |= a;
    sum += col.v[s];
  }
  votes_sum = sum;
  const bool hit = hit_regs(col.v, p);
  const bool newly = hit && !col.chosen;
  col.chosen = hit || col.chosen;
  return newly;
}

__device__ __forceinline__ void zero_column(const Run& r, int n,
                                            long long c) {
  for (int a = 0; a < n; ++a) r.votes[a * r.window + c] = 0;
  r.chosen[c] = 0;
}

// The register path's walk through a run: this drain's index, the ring
// positions of its new, old and GC blocks (contiguous), and the old
// column's command.
struct Walk {
  int i;
  int pos_new, pos_old, pos_gc;
  uint32_t old_cmd;
};

template <int kN>
__device__ __forceinline__ void zero_regs(Column<kN>& col) {
#pragma unroll
  for (int s = 0; s < kN; ++s) col.v[s] = 0;
  col.chosen = 0;
}

// Drain k of a run on lane j, in the register path: `fresh` and `old`
// hold its new and old columns; `ahead` receives drain k + 2's new column,
// loaded now (with 3 or 4 blocks a GC zeroes it first), so that the load
// has a whole drain to land and no register it fills is read before the
// drain that needs it.
template <int kN, int kCols>
__device__ __forceinline__ void drain_regs(
    const Run& r, int j, bool live, int k, const int (&acc)[kN],
    const uint32_t (&hash)[kN], const RegPred<kN, kCols>& p, Walk& w,
    Column<kN>& fresh, Column<kN>& old, Column<kN>& ahead, bool& new1,
    bool& new2, uint32_t& sum1, uint32_t& sum2, uint32_t& cmd_sum,
    uint32_t& proposed) {
  const int nb = r.num_blocks;
  const long long b = r.block_size;
  const int pos_next = w.pos_new + 1 == nb ? 0 : w.pos_new + 1;
  new1 = new2 = false;
  sum1 = sum2 = 0;
  if (live) {
    if (k + 2 < r.iters) {
      if (nb >= 5) {
        const int pos_ahead = pos_next + 1 == nb ? 0 : pos_next + 1;
        load_column(r, acc, pos_ahead * b + j, ahead);
      } else {
        zero_regs(ahead);
      }
    }
    const long long c_new = w.pos_new * b + j, c_old = w.pos_old * b + j;
    // Leader: propose lanes*7 + i*13 + 1.
    const uint32_t prop = static_cast<uint32_t>(j) * 7u +
                          static_cast<uint32_t>(w.i) * 13u + 1u;
    r.commands[c_new] = static_cast<int32_t>(prop);
    // Acceptors + ProxyLeader: pass 1 on the new block, pass 2 (the
    // stragglers, the complement of drain i-1's arrivals) on the old.
    const uint32_t drain_hash = static_cast<uint32_t>(w.i) * kDrainMul;
    new1 = pass_regs(fresh, hash, drain_hash, 0u, p, sum1);
    new2 = pass_regs(old, hash, drain_hash - kDrainMul, 1u, p, sum2);
    // Replica: execute the previous block.
    r.results[c_old] = static_cast<int32_t>(w.old_cmd * 3u + 7u);
    cmd_sum += w.old_cmd;
    // GC block i-2 so the ring can wrap.
    zero_column(r, kN, w.pos_gc * b + j);
    // The old column's pass-2 result dies in the next drain's GC and the
    // new column is the next drain's old one: only the run's last drain
    // stores them.
    if (k + 1 == r.iters) {
      store_column(r, acc, c_old, old);
      store_column(r, acc, c_new, fresh);
    }
    w.old_cmd = prop;
    proposed += prop != 0u;
  }
  w.pos_gc = w.pos_old;
  w.pos_old = w.pos_new;
  w.pos_new = pos_next;
  w.i = wrap_add(w.i, 1);
}

// --- K14's counters ---------------------------------------------------------

// K14 in the register path: a newly-chosen lane into this thread's own
// occupancy bins (kN + 1 of them), in registers.
template <int kN>
__device__ __forceinline__ void count_bins(uint32_t (&bins)[kN + 1],
                                           bool newly, uint32_t votes_sum) {
  const uint32_t bin = votes_sum < kN ? votes_sum : kN;
#pragma unroll
  for (int b = 0; b <= kN; ++b) {
    bins[b] += newly && bin == static_cast<uint32_t>(b);
  }
}

// K14 in the memory path: the warp's newly-chosen lanes into the
// occupancy bins: lane b holds bin b (b < 32), larger bins go to the
// block's shared bins. Warp-collective.
__device__ __forceinline__ void add_occupancy(bool newly, uint32_t votes_sum,
                                              int n, uint32_t& mine,
                                              uint32_t* s_occ) {
  const uint32_t top = static_cast<uint32_t>(n);
  const uint32_t bin = votes_sum < top ? votes_sum : top;
  unsigned pending = __ballot_sync(kFullWarp, newly);
  while (pending) {
    const uint32_t b = __shfl_sync(kFullWarp, bin, __ffs(pending) - 1);
    const unsigned same = __ballot_sync(kFullWarp, newly && bin == b);
    const uint32_t lane = threadIdx.x & 31;
    if (b < 32) {
      if (lane == b) mine += __popc(same);
    } else if (lane == 0) {
      atomicAdd(&s_occ[b], static_cast<uint32_t>(__popc(same)));
    }
    pending &= ~same;
  }
}

// The end of drain k: the warp's newly count into the block's ring, and
// every kRing drains (and at the run's last) the ring into the scratch
// array. Block-collective.
__device__ __forceinline__ void ring_add(uint32_t* s_ring, uint32_t* scratch,
                                         int k, int iters, uint32_t newly) {
  const uint32_t warp_newly = __reduce_add_sync(kFullWarp, newly);
  if ((threadIdx.x & 31) == 0 && warp_newly) {
    atomicAdd(&s_ring[k & (kRing - 1)], warp_newly);
  }
  if (((k + 1) & (kRing - 1)) == 0 || k + 1 == iters) {
    __syncthreads();
    const int base = k & ~(kRing - 1);
    const int t = threadIdx.x;
    if (t < kRing && base + t <= k) {
      if (s_ring[t]) atomicAdd(&scratch[base + t], s_ring[t]);
      s_ring[t] = 0;
    }
    __syncthreads();
  }
}

// The last block of a K14 launch: every drain's end-of-drain committed
// from the scratch array's prefix sums, one lag_bucket sample per drain,
// the drain count; the array and the done-counter back to 0.
__device__ void fold_lag(const Run& r, int n, uint32_t* s_scan,
                         uint32_t* s_hist) {
  __threadfence();
  const int t = threadIdx.x, nt = blockDim.x, warps = nt / 32;
  if (t < 16) s_hist[t] = 0;
  const int seg = (r.iters + nt - 1) / nt;
  const int k0 = min(t * seg, r.iters), k1 = min(k0 + seg, r.iters);
  uint32_t local = 0;
  for (int k = k0; k < k1; ++k) local += __ldcg(&r.scratch[k]);
  uint32_t incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullWarp, incl, off);
    if ((t & 31) >= off) incl += y;
  }
  if ((t & 31) == 31) s_scan[t >> 5] = incl;
  __syncthreads();
  if (t == 0) {
    uint32_t run = 0;
    for (int w = 0; w < warps; ++w) {
      const uint32_t x = s_scan[w];
      s_scan[w] = run;
      run += x;
    }
    s_scan[warps] = run;
  }
  __syncthreads();
  const uint32_t final_committed =
      static_cast<uint32_t>(__ldcg(r.committed));
  // The run's starting committed, then this thread's drains before k0.
  uint32_t running = final_committed - s_scan[warps] + s_scan[t >> 5] +
                     (incl - local);
  const uint32_t b = static_cast<uint32_t>(r.block_size);
  for (int k = k0; k < k1; ++k) {
    running += __ldcg(&r.scratch[k]);
    const uint32_t i = static_cast<uint32_t>(r.start) +
                       static_cast<uint32_t>(k);
    const int32_t lag = static_cast<int32_t>((i + 1u) * b - running);
    atomicAdd(&s_hist[lag_bucket(lag)], 1u);
    r.scratch[k] = 0u;
  }
  __syncthreads();
  if (t < 16 && s_hist[t]) bump(&r.tel[n + 3 + t], s_hist[t]);
  if (t == 0) {
    bump(&r.tel[n + 20], static_cast<uint32_t>(r.iters));
    r.tel[n + 21] = 0;
  }
}

// --- the kernel -------------------------------------------------------------

// kN > 0: the register path for kN acceptors in predicate form kCols;
// kN = 0: the memory path.
template <bool kTelemetry, int kN, int kCols>
__global__ void __launch_bounds__(FPX_THREADS)
    run_steps_kernel(Run r, QuorumPred q, int pred_in_shared) {
  // [the predicate's arrays][K14: n + 1 occupancy bins]
  extern __shared__ int32_t smem[];
  __shared__ uint32_t s_ring[kRing];
  __shared__ uint32_t parts[3][FPX_THREADS / 32];
  __shared__ uint32_t s_scan[FPX_THREADS / 32 + 1];
  __shared__ uint32_t s_hist[16];
  __shared__ bool s_last;
  const int words = pred_in_shared ? pred_words(q) : 0;
  q = stage_pred(q, pred_in_shared ? smem : nullptr);
  uint32_t* const s_occ = reinterpret_cast<uint32_t*>(smem + words);
  if constexpr (kTelemetry) {
    for (int t = threadIdx.x; t <= q.n; t += blockDim.x) s_occ[t] = 0;
    for (int t = threadIdx.x; t < kRing; t += blockDim.x) s_ring[t] = 0;
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < r.block_size;
  const long long b = r.block_size;
  const int nb = r.num_blocks;
  const uint32_t uj = static_cast<uint32_t>(j);
  uint32_t newly_sum = 0, cmd_sum = 0, proposed = 0, occ_mine = 0;

  if constexpr (kN > 0) {
    const RegPred<kN, kCols> p = reg_pred<kN, kCols>(q);
    int acc[kN];
    uint32_t hash[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      acc[s] = q.perm[s];
      hash[s] = uj * kLaneMul + static_cast<uint32_t>(acc[s]) * kAccMul;
    }
    Walk w{r.start, floor_mod(r.start, nb),
           floor_mod(wrap_add(r.start, -1), nb),
           floor_mod(wrap_add(r.start, -2), nb), 0u};
    // Four columns take turns as a drain's new, old, next and ahead
    // columns: after a drain the next becomes the new, the new the old,
    // the ahead the next, and the dead old receives the next load. The
    // run's first drain reads its columns (and the next one) from memory.
    Column<kN> c0, c1, c2, c3;
    if (live) {
      load_column(r, acc, w.pos_old * b + j, c1);
      w.old_cmd = static_cast<uint32_t>(r.commands[w.pos_old * b + j]);
      load_column(r, acc, w.pos_new * b + j, c0);
      if (r.iters > 1) {
        if (nb > 3) {
          const int pos_next = w.pos_new + 1 == nb ? 0 : w.pos_new + 1;
          load_column(r, acc, pos_next * b + j, c2);
        } else {
          zero_regs(c2);
        }
      }
    }
    uint32_t bins[kN + 1] = {};  // K14's occupancy, this thread's
    auto drain = [&](int k, Column<kN>& fresh, Column<kN>& old,
                     Column<kN>& ahead) {
      bool new1, new2;
      uint32_t sum1, sum2;
      drain_regs(r, j, live, k, acc, hash, p, w, fresh, old, ahead, new1,
                 new2, sum1, sum2, cmd_sum, proposed);
      const uint32_t newly_k = static_cast<uint32_t>(new1) + new2;
      newly_sum += newly_k;
      if constexpr (kTelemetry) {
        count_bins<kN>(bins, new1, sum1);
        count_bins<kN>(bins, new2, sum2);
        ring_add(s_ring, r.scratch, k, r.iters, newly_k);
      }
    };
    for (int k = 0; k < r.iters; k += 4) {
      drain(k, c0, c1, c3);
      if (k + 1 == r.iters) break;
      drain(k + 1, c2, c0, c1);
      if (k + 2 == r.iters) break;
      drain(k + 2, c3, c2, c0);
      if (k + 3 == r.iters) break;
      drain(k + 3, c1, c3, c2);
    }
    if constexpr (kTelemetry) {
#pragma unroll
      for (int bb = 0; bb <= kN; ++bb) {
        const uint32_t c = __reduce_add_sync(kFullWarp, bins[bb]);
        if ((threadIdx.x & 31) == 0 && c) atomicAdd(&s_occ[bb], c);
      }
    }
  } else {
    int i = r.start;
    for (int k = 0; k < r.iters; ++k, i = wrap_add(i, 1)) {
      bool new1 = false, new2 = false;
      uint32_t sum1 = 0, sum2 = 0;
      if (live) {
        const long long start_new = floor_mod(i, nb) * b;
        const long long start_old = floor_mod(wrap_add(i, -1), nb) * b;
        const long long start_gc = floor_mod(wrap_add(i, -2), nb) * b;
        const uint32_t prop = uj * 7u + static_cast<uint32_t>(i) * 13u + 1u;
        r.commands[start_new + j] = static_cast<int32_t>(prop);
        new1 = pass_memory(r, start_new + j, j, i, false, q, sum1);
        new2 = pass_memory(r, start_old + j, j, wrap_add(i, -1), true, q,
                           sum2);
        const uint32_t cmd = static_cast<uint32_t>(r.commands[start_old + j]);
        r.results[start_old + j] = static_cast<int32_t>(cmd * 3u + 7u);
        cmd_sum += cmd;
        zero_column(r, q.n, start_gc + j);
        if constexpr (kTelemetry) proposed += prop != 0u;
      }
      const uint32_t newly_k = static_cast<uint32_t>(new1) + new2;
      newly_sum += newly_k;
      if constexpr (kTelemetry) {
        add_occupancy(new1, sum1, q.n, occ_mine, s_occ);
        add_occupancy(new2, sum2, q.n, occ_mine, s_occ);
        ring_add(s_ring, r.scratch, k, r.iters, newly_k);
      }
    }
  }

  newly_sum = block_sum(newly_sum, parts[0]);
  cmd_sum = block_sum(cmd_sum, parts[1]);
  const int i_last = wrap_add(r.start, r.iters - 1);
  const int32_t exec_wm =
      i_last >= 1 ? static_cast<int32_t>(static_cast<uint32_t>(i_last) *
                                         static_cast<uint32_t>(r.block_size))
                  : 0;
  if constexpr (!kTelemetry) {
    if (threadIdx.x == 0) {
      if (newly_sum) {
        atomicAdd(reinterpret_cast<unsigned int*>(r.committed), newly_sum);
      }
      if (cmd_sum) {
        atomicAdd(reinterpret_cast<unsigned int*>(r.sm_state), cmd_sum);
      }
      if (blockIdx.x == 0) *r.exec_wm = exec_wm;
    }
  } else {
    proposed = block_sum(proposed, parts[2]);
    const int lane = threadIdx.x & 31;
    if (lane <= q.n && occ_mine) atomicAdd(&s_occ[lane], occ_mine);
    __syncthreads();  // every warp's bins are in s_occ
    for (int t = threadIdx.x; t <= q.n; t += blockDim.x) {
      if (s_occ[t]) {
        atomicAdd(reinterpret_cast<unsigned int*>(&r.tel[2 + t]), s_occ[t]);
      }
    }
    // Every thread's scratch and bin adds are visible before the block
    // counts itself done.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned int* const tel = reinterpret_cast<unsigned int*>(r.tel);
      if (newly_sum) {
        atomicAdd(reinterpret_cast<unsigned int*>(r.committed), newly_sum);
        atomicAdd(&tel[0], newly_sum);
      }
      if (cmd_sum) {
        atomicAdd(reinterpret_cast<unsigned int*>(r.sm_state), cmd_sum);
      }
      if (proposed) atomicAdd(&tel[1], proposed);
      if (blockIdx.x == 0) *r.exec_wm = exec_wm;
      __threadfence();
      s_last = atomicAdd(&tel[q.n + 21], 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last) fold_lag(r, q.n, s_scan, s_hist);
  }
}

// The boards the register path takes: up to this many acceptors.
constexpr int kMaxRegN = 16;

// Everything a launch of one instantiation needs.
struct Launch {
  Run r;
  QuorumPred q;
  int grid, in_shared;
  size_t smem;
  cudaStream_t stream;
};

template <bool kTelemetry, int kN, int kCols>
cudaError_t launch(const Launch& l) {
  run_steps_kernel<kTelemetry, kN, kCols>
      <<<l.grid, FPX_THREADS, l.smem, l.stream>>>(l.r, l.q, l.in_shared);
  return cudaGetLastError();
}

// The grid forms of kN acceptors: one per divisor kCols of kN but 1 (a
// column of single-slot rows is one row of the other kind, see
// run_steps).
template <bool kTelemetry, int kN, int kCols = 2>
cudaError_t launch_grid(const Launch& l) {
  if constexpr (kN == 1) {
    return launch<kTelemetry, 1, 1>(l);  // one acceptor: one row of one
  } else if constexpr (kCols > kN) {
    return launch<kTelemetry, 0, 0>(l);  // rows * cols != n: unreachable
  } else {
    if constexpr (kN % kCols == 0) {
      if (l.q.cols == kCols) return launch<kTelemetry, kN, kCols>(l);
    }
    return launch_grid<kTelemetry, kN, kCols + 1>(l);
  }
}

// The register forms: per acceptor count, one group, other counts of
// groups, and a grid per column count.
template <bool kTelemetry, int kN = 1>
cudaError_t launch_regs(const Launch& l) {
  if constexpr (kN > kMaxRegN) {
    return launch<kTelemetry, 0, 0>(l);  // n > kMaxRegN: unreachable
  } else {
    if (l.q.n != kN) return launch_regs<kTelemetry, kN + 1>(l);
    if (l.q.grid_kind != 0) return launch_grid<kTelemetry, kN>(l);
    if (l.q.g == 1) return launch<kTelemetry, kN, kOneGroup>(l);
    return launch<kTelemetry, kN, kGroups>(l);
  }
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

// block: votes, chosen, commands, results, sm_state, committed, exec_wm,
// window, block_size, start, iters, masks, thresholds, perm, n, g,
// combine_any, grid_kind, rows, cols, telemetry buffer (K14; 0 for K3),
// scratch (K14; 0 for K3), device, stream.
template <bool kTelemetry>
cudaError_t run_steps(const void* block) {
  long long a[24];
  std::memcpy(a, block, sizeof a);
  const long long window = a[7], block_size = a[8], start = a[9];
  const long long iters = a[10];
  if (iters <= 0) return cudaSuccess;
  if (iters > kMaxDrains || block_size <= 0 || block_size > INT_MAX ||
      window % block_size || window / block_size > INT_MAX ||
      start < INT_MIN || start > INT_MAX ||
      (kTelemetry && (a[20] == 0 || a[21] == 0))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[22]));
  if (err != cudaSuccess) return err;
  const int nb = static_cast<int>(window / block_size);
  Run r{pointer<uint8_t>(a[0]), pointer<uint8_t>(a[1]),
        pointer<int32_t>(a[2]), pointer<int32_t>(a[3]),
        pointer<int32_t>(a[4]), pointer<int32_t>(a[5]),
        pointer<int32_t>(a[6]), window, static_cast<int>(block_size), nb,
        static_cast<int>(start), static_cast<int>(iters),
        pointer<int32_t>(a[20]), pointer<uint32_t>(a[21])};
  QuorumPred q = make_pred(
      pointer<const void>(a[11]), pointer<const void>(a[12]),
      pointer<const void>(a[13]), static_cast<int>(a[14]),
      static_cast<int>(a[15]), static_cast<int>(a[16]),
      static_cast<int>(a[17]), static_cast<int>(a[18]),
      static_cast<int>(a[19]));
  // The register carry needs three distinct blocks and a ring that steps
  // by one through the run (always, with a power-of-two ring); a grid's
  // rows must tile its acceptors.
  const bool contiguous =
      (nb & (nb - 1)) == 0 ||
      (start - 2 >= INT_MIN && start + iters - 1 <= INT_MAX);
  const bool regs = nb >= 3 && contiguous && q.n >= 1 && q.n <= kMaxRegN &&
                    (q.grid_kind == 0 ||
                     (q.cols >= 1 && q.rows * q.cols == q.n));
  if (regs && q.grid_kind != 0 && q.cols == 1) {
    // n rows of one: a write grid ANDs the n votes and a read grid ORs
    // them, which is one row of n of the other kind (the same slots).
    q.grid_kind = q.grid_kind == 1 ? 2 : 1;
    q.rows = 1;
    q.cols = q.n;
  }
  const size_t pred_bytes =
      4 * (static_cast<size_t>(q.g) * q.n + q.g + q.n);
  const int in_shared = pred_bytes <= kPredSharedBytes;
  const Launch l{
      r, q,
      static_cast<int>((block_size + FPX_THREADS - 1) / FPX_THREADS),
      in_shared,
      (in_shared ? pred_bytes : 0) +
          (kTelemetry ? 4 * (static_cast<size_t>(q.n) + 1) : 0),
      pointer<CUstream_st>(a[23])};
  return regs ? launch_regs<kTelemetry>(l) : launch<kTelemetry, 0, 0>(l);
}

}  // namespace

// K3: drains start .. start + iters - 1 (the index wraps as int32) in one
// launch; the block's telemetry and scratch slots are 0.
extern "C" int fpx_run_steps(const void* block) {
  return run_steps<false>(block);
}

// K14: the same run with the flat telemetry buffer (n + 22 int32) and the
// [iters] uint32 scratch array, zero between launches.
extern "C" int fpx_run_steps_telemetry(const void* block) {
  return run_steps<true>(block);
}
