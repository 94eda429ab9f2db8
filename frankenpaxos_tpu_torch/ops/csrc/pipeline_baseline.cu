// The PINNED telemetry-off drain: a verbatim copy of K3's chunked drain
// kernel (ops/csrc/pipeline.cu, run_steps_kernel<false>) without the
// telemetry template, re-pinned to the chunked design, with its
// C entry point renamed to fpx_run_steps_baseline (the same packed block
// as fpx_run_steps) so that a later edit of pipeline.cu cannot move the
// baseline arm of bench/telemetry_overhead.py. Replaces the JAX package's
// pinned copy, frankenpaxos_tpu/bench/pipeline_baseline.py::
// steady_state_step (L76), run_steps_from (L201). Do NOT edit the code
// below: it is the measurement. If the live drain's semantics or design
// change on purpose, re-pin a fresh copy and say so in the overhead
// bench's methodology string. The device helpers of drain.cuh it needs
// are copied in too, so that only quorum.cuh (the predicate) is shared.
//
// --- verbatim from ops/csrc/pipeline.cu and ops/csrc/drain.cuh ----------
// One thread owns block lane j for the whole run of drains and runs the
// reference's order once per drain (propose -> pass 1 -> pass 2 ->
// execute -> GC); with num_blocks >= 3 and a contiguous ring the old
// column stays in registers from one drain to the next and drain k + 2's
// new column is loaded in drain k, one instantiation per board structure
// (acceptor count 1 .. 16; one group, other groups, or a grid per column
// count); the
// memory path (kN = 0) takes the aliasing ratios 1 and 2, boards above 16
// acceptors and runs whose ring jumps at the int32 wrap; committed and
// sm_state add up per thread and once per thread block per run.

#include <climits>
#include <cstring>

#include "quorum.cuh"

namespace {

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// _arrivals: ((lane*1103515245 + acc*12820163 + i*22695477) >> 7) & 7 < 7
// in int32. Bits 7..9 of the wrapped sum do not depend on how the shift
// treats the sign, so an unsigned shift is exact.
__device__ __forceinline__ uint8_t arrives(int lane, int acc, int i) {
  const uint32_t h = static_cast<uint32_t>(lane) * 1103515245u +
                     static_cast<uint32_t>(acc) * 12820163u +
                     static_cast<uint32_t>(i) * 22695477u;
  return ((h >> 7) & 7u) < 7u ? 1 : 0;
}

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* shared) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x < blockDim.x / 32) v = shared[threadIdx.x];
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  }
  return v;  // valid in thread 0
}

// Drains per launch at most (bench/pipeline.py::MAX_DRAINS).
constexpr long long kMaxDrains = 1 << 16;
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
};

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

// --- the kernel -------------------------------------------------------------

// kN > 0: the register path for kN acceptors in predicate form kCols;
// kN = 0: the memory path.
template <int kN, int kCols>
__global__ void __launch_bounds__(FPX_THREADS)
    run_steps_kernel(Run r, QuorumPred q, int pred_in_shared) {
  // [the predicate's arrays]
  extern __shared__ int32_t smem[];
  __shared__ uint32_t parts[2][FPX_THREADS / 32];
  q = stage_pred(q, pred_in_shared ? smem : nullptr);
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < r.block_size;
  const long long b = r.block_size;
  const int nb = r.num_blocks;
  const uint32_t uj = static_cast<uint32_t>(j);
  uint32_t newly_sum = 0, cmd_sum = 0, proposed = 0;

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
    auto drain = [&](int k, Column<kN>& fresh, Column<kN>& old,
                     Column<kN>& ahead) {
      bool new1, new2;
      uint32_t sum1, sum2;
      drain_regs(r, j, live, k, acc, hash, p, w, fresh, old, ahead, new1,
                 new2, sum1, sum2, cmd_sum, proposed);
      const uint32_t newly_k = static_cast<uint32_t>(new1) + new2;
      newly_sum += newly_k;
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
      }
      const uint32_t newly_k = static_cast<uint32_t>(new1) + new2;
      newly_sum += newly_k;
    }
  }

  newly_sum = block_sum(newly_sum, parts[0]);
  cmd_sum = block_sum(cmd_sum, parts[1]);
  const int i_last = wrap_add(r.start, r.iters - 1);
  const int32_t exec_wm =
      i_last >= 1 ? static_cast<int32_t>(static_cast<uint32_t>(i_last) *
                                         static_cast<uint32_t>(r.block_size))
                  : 0;
  if (threadIdx.x == 0) {
    if (newly_sum) {
      atomicAdd(reinterpret_cast<unsigned int*>(r.committed), newly_sum);
    }
    if (cmd_sum) {
      atomicAdd(reinterpret_cast<unsigned int*>(r.sm_state), cmd_sum);
    }
    if (blockIdx.x == 0) *r.exec_wm = exec_wm;
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

template <int kN, int kCols>
cudaError_t launch(const Launch& l) {
  run_steps_kernel<kN, kCols>
      <<<l.grid, FPX_THREADS, l.smem, l.stream>>>(l.r, l.q, l.in_shared);
  return cudaGetLastError();
}

// The grid forms of kN acceptors: one per divisor kCols of kN but 1 (a
// column of single-slot rows is one row of the other kind, see
// run_steps).
template <int kN, int kCols = 2>
cudaError_t launch_grid(const Launch& l) {
  if constexpr (kN == 1) {
    return launch<1, 1>(l);  // one acceptor: one row of one
  } else if constexpr (kCols > kN) {
    return launch<0, 0>(l);  // rows * cols != n: unreachable
  } else {
    if constexpr (kN % kCols == 0) {
      if (l.q.cols == kCols) return launch<kN, kCols>(l);
    }
    return launch_grid<kN, kCols + 1>(l);
  }
}

// The register forms: per acceptor count, one group, other counts of
// groups, and a grid per column count.
template <int kN = 1>
cudaError_t launch_regs(const Launch& l) {
  if constexpr (kN > kMaxRegN) {
    return launch<0, 0>(l);  // n > kMaxRegN: unreachable
  } else {
    if (l.q.n != kN) return launch_regs<kN + 1>(l);
    if (l.q.grid_kind != 0) return launch_grid<kN>(l);
    if (l.q.g == 1) return launch<kN, kOneGroup>(l);
    return launch<kN, kGroups>(l);
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
// combine_any, grid_kind, rows, cols, telemetry buffer and scratch
// (unread here), device, stream.
cudaError_t run_steps(const void* block) {
  long long a[24];
  std::memcpy(a, block, sizeof a);
  const long long window = a[7], block_size = a[8], start = a[9];
  const long long iters = a[10];
  if (iters <= 0) return cudaSuccess;
  if (iters > kMaxDrains || block_size <= 0 || block_size > INT_MAX ||
      window % block_size || window / block_size > INT_MAX ||
      start < INT_MIN || start > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[22]));
  if (err != cudaSuccess) return err;
  const int nb = static_cast<int>(window / block_size);
  Run r{pointer<uint8_t>(a[0]), pointer<uint8_t>(a[1]),
        pointer<int32_t>(a[2]), pointer<int32_t>(a[3]),
        pointer<int32_t>(a[4]), pointer<int32_t>(a[5]),
        pointer<int32_t>(a[6]), window, static_cast<int>(block_size), nb,
        static_cast<int>(start), static_cast<int>(iters)};
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
      in_shared ? pred_bytes : 0,
      pointer<CUstream_st>(a[23])};
  return regs ? launch_regs(l) : launch<0, 0>(l);
}

}  // namespace

// Drains start .. start + iters - 1 (the index wraps as int32) in one
// launch: fpx_run_steps's packed block, whose telemetry and scratch
// slots it ignores.
extern "C" int fpx_run_steps_baseline(const void* block) {
  return run_steps(block);
}
