// K19 shard_vote_count, K20 shard_commit and K21 shard_fold: one drain of
// the device-resident MultiPaxos steady-state pipeline on ONE shard of a
// (group, slot) mesh, split at the reference's psums.
//
// Replaces frankenpaxos_tpu/bench/pipeline.py::steady_state_step (L145)
// with `group_axis`/`slot_axis` set, as make_sharded_step (L494) and
// make_sharded_runner (L561) run it under shard_map, with the telemetry
// weave of ops/telemetry.py (quorum_pass_update L108, drain_update L136)
// over slot shards. K3 (pipeline.cu) runs a whole drain in one thread per
// lane; under sharding every psum is a point where the ranks exchange
// data, so the drain splits into three kernels around two all-reduces:
//
//   K19 (one thread per local lane): propose; OR pass 1's arrivals into
//       the new block and write pass 1's partials; OR pass 2's (the
//       complement of drain i-1's) into the old block and write pass 2's.
//       Partials: [2, R, b_local] int32, R = G mask-group counts (the
//       psum'd matmul, L271-275) or 1 missing/full row count (the fused
//       grid path, L246-269, taken only when every group shard holds whole
//       rows), plus one row of vote-byte sums with telemetry on (L287).
//       One instantiation per shard structure (as K3's forms in
//       pipeline.cu): n_local 1-16 with one mask group (a majority's
//       shard), two groups over two acceptors (the 2x3 grid's rows
//       straddling three group shards), whole grid rows of three over
//       three acceptors (the 2x3 grid over two group shards, write and
//       read), each with telemetry off and on; every other structure
//       takes the generic template (runtime sizes, the partials from the
//       stored column). The caller names the form
//       (bench/pipeline.py::shard_form); the entry launches it, or
//       refuses a form it does not instantiate or whose structure is not
//       the shard's. In a form the group shard's mask columns live in
//       registers, and each of the lane's 2 * n_local vote bytes is
//       loaded before its first use, ORed with its arrival bit in
//       registers, stored once and counted from the registers (where the
//       old block is the new one, window / block 1, pass 2 reads pass
//       1's register). CTAs of kVoteThreads = 128 threads: 64 CTAs at
//       b_local 8192 (the old 256 gave 32 of the card's 132 SMs); 64, 128
//       and 256 measured within 0.04 us of each other at b_local 8192
//       and 10923 on the H100, 128 the best at 32768.
//   -- all-reduce SUM of the partials over the group subgroup --
//   K20 (one thread per local lane): the hits of pass 1 then pass 2 from
//       the reduced partials (pad lanes never hit, L276-280), `chosen` and
//       `newly`; execute the old block (pad lanes' results stay 0); GC.
//       The slot partials go into the drain's ROW of the run's slot table
//       (the caller hands the row's address): [S] newly counts (this
//       shard's entry at slot_idx), the cmds_old sum, and with telemetry
//       [n + 1] occupancy bins, valid proposals and pad lanes. One
//       instantiation per shard structure, keyed like K19's forms and
//       chosen here from the kind, the group count and n_local: the mask
//       groups (one for n_local 1-16, two over two acceptors) with their
//       thresholds in registers, or the row count of whole grid rows of
//       three (write and read), each telemetry off and on; every other
//       structure takes the generic template (runtime loops). In a form
//       every load of the lane comes first (both passes' partial rows,
//       both `chosen` bytes, the old command); where the old block is the
//       new one (window / block 1) pass 2 reads pass 1's `chosen` from its
//       register. CTAs of kCommitThreads = 128 (64 CTAs at b_local 8192).
//       Every counter is reduced in one warp step (`__reduce_add_sync`;
//       the occupancy bins by `__ballot_sync` / `__popc` over the bins the
//       warp's newly lanes hold, into the warp's own shared row: no shared
//       atomics) and one barrier, then added once per CTA with one
//       global atomicAdd a nonzero word.
//   -- per drain of a run: K19, the group all-reduce, K20 into row d --
//   -- all-reduce SUM of the run's used rows over the slot subgroup --
//   K21 (one CTA of kFoldThreads = 256, a thread a row): fold the k rows
//       of a run in drain order into committed (the sum of every newly
//       count), sm_state (the cmds_old sums), exec_wm (the last drain's
//       i * GLOBAL block, L313) and the telemetry counters (their column
//       sums, `drains` + k, and each drain's lag bucket from the
//       end-of-drain committed: a block prefix scan of the rows' newly
//       totals, L329-333), then zero the rows. Nothing inside a run reads
//       what the slot all-reduce produces (K19 and K20 read votes, chosen
//       and commands, never committed, sm_state, exec_wm or telemetry),
//       and every folded quantity is a sum, so a run of k drains needs
//       one slot all-reduce and one K21, bit-identical to the reference's
//       per-drain psums inside its fori_loop.
//
// Order where the ring's blocks alias (window / block 1 or 2): every
// effect on local lane j touches only column start + j of the new, old and
// GC blocks, so one thread per lane keeps the reference's order within
// each kernel, and the split keeps it across them: K19 ORs both passes'
// votes (pass 1's partials read before pass 2's OR) before K20's GC clears
// any, and `chosen` changes only in K20, pass 1 before pass 2, its GC
// stores after both passes' (program order of one thread).
//
// Integer arithmetic is uint32 with casts (signed overflow is undefined
// in CUDA C++; the reference wraps int32), the grid row counts uint8 as
// the reference sums them, and the atomics order-free, so every kernel is
// bit-identical to the plain version and to JAX's psums.
//
// Bound on the H100: bytes. Per drain K19 reads and writes 2 * n_local
// vote bytes per lane and writes one command and 8 * R partial bytes
// (under 0.06 us at 3.35 TB/s at b_local 8192: the launch and the chain
// of dependent loads per lane set its time, which the forms shorten); K20
// reads the partials, the old command and `chosen` twice, and writes
// `chosen`, a result and the GC column. At the headline's width split
// four ways (b_local = 8192) each kernel moves under 0.5 MB, under 0.2 us
// at 3.35 TB/s: the launches and the all-reduces between them dominate.
// K21 moves k rows of S + 1 (+ n + 3) words: its launch is its time.

#include <climits>
#include <cstring>

#include "drain.cuh"
#include "quorum.cuh"

namespace {

using namespace fpx_drain;

// The shard's quorum partials: 0 = the psum'd mask matmul, 1 = missing
// write-grid rows, 2 = full read-grid rows.
struct ShardPred {
  int kind;
  int g;                      // mask groups (kind 0)
  int cols;                   // grid row length (kind 1, 2)
  const int32_t* masks;       // [g, n_local]: this group shard's columns
  const int32_t* thresholds;  // [g]
  int combine_any;
};

__device__ __forceinline__ int partial_rows(const ShardPred& q,
                                            bool telemetry) {
  return (q.kind == 0 ? q.g : 1) + (telemetry ? 1 : 0);
}

// K19's CTA size.
constexpr int kVoteThreads = 128;

struct VoteCount {
  uint8_t* votes;
  int32_t* commands;
  long long w_local;
  int i, block_size, b_local, slot_idx, group_idx, n_local;
  ShardPred q;
  int32_t* parts;
};

// The generic template: runtime sizes and loops; each pass ORs its
// arrivals into the board, then counts the stored column.
template <bool kTelemetry>
__device__ __forceinline__ void vote_count_generic(const VoteCount& a,
                                                   int j) {
  uint8_t* votes = a.votes;
  const long long w_local = a.w_local;
  const int n_local = a.n_local, i = a.i;
  const ShardPred& q = a.q;
  const int num_blocks = static_cast<int>(w_local / a.b_local);
  const long long b = a.b_local;
  const long long start_new = floor_mod(i, num_blocks) * b;
  const long long start_old = floor_mod(wrap_add(i, -1), num_blocks) * b;
  const int lane = a.slot_idx * a.b_local + j;
  const bool valid = lane < a.block_size;
  const uint32_t prop = valid ? static_cast<uint32_t>(lane) * 7u +
                                     static_cast<uint32_t>(i) * 13u + 1u
                               : 0u;
  a.commands[start_new + j] = static_cast<int32_t>(prop);
  const int rows = partial_rows(q, kTelemetry);
  for (int p = 0; p < 2; ++p) {
    const long long c = (p == 0 ? start_new : start_old) + j;
    const int drain = p == 0 ? i : wrap_add(i, -1);
    for (int k = 0; k < n_local; ++k) {
      uint8_t arr = arrives(lane, a.group_idx * n_local + k, drain);
      if (p == 1) arr = 1 - arr;
      if (!valid) arr = 0;
      votes[k * w_local + c] |= arr;
    }
    int32_t* out = a.parts + static_cast<long long>(p) * rows * b + j;
    if (q.kind == 0) {
      for (int g = 0; g < q.g; ++g) {
        uint32_t count = 0;
        for (int k = 0; k < n_local; ++k) {
          count += static_cast<uint32_t>(q.masks[g * n_local + k]) *
                   static_cast<uint32_t>(votes[k * w_local + c]);
        }
        out[g * b] = static_cast<int32_t>(count);
      }
    } else {
      const bool write = q.kind == 1;
      uint8_t sum = 0;
      for (int r = 0; r < n_local / q.cols; ++r) {
        uint8_t row = votes[static_cast<long long>(r * q.cols) * w_local + c];
        for (int k = 1; k < q.cols; ++k) {
          const uint8_t cell =
              votes[static_cast<long long>(r * q.cols + k) * w_local + c];
          row = write ? (row | cell) : (row & cell);
        }
        sum = static_cast<uint8_t>(sum + (write ? static_cast<uint8_t>(1 - row)
                                                : row));
      }
      out[0] = sum;
    }
    if constexpr (kTelemetry) {
      uint32_t total = 0;
      for (int k = 0; k < n_local; ++k) total += votes[k * w_local + c];
      out[(rows - 1) * b] = static_cast<int32_t>(total);
    }
  }
}

// One pass's partials from the column in registers: kCols = 0 the kG
// mask-group counts, kCols > 0 the row count of whole grid rows of kCols.
template <bool kTelemetry, int kN, int kG, int kCols>
__device__ __forceinline__ void partials_regs(const uint32_t (&v)[kN],
                                              const uint32_t (&m)[kG][kN],
                                              bool write, int32_t* out,
                                              long long b) {
  constexpr int rows = (kCols > 0 ? 1 : kG) + (kTelemetry ? 1 : 0);
  if constexpr (kCols > 0) {
    uint8_t sum = 0;
#pragma unroll
    for (int r = 0; r < kN / kCols; ++r) {
      uint32_t row = v[r * kCols];
#pragma unroll
      for (int k = 1; k < kCols; ++k) {
        row = write ? (row | v[r * kCols + k]) : (row & v[r * kCols + k]);
      }
      const uint8_t cell = static_cast<uint8_t>(row);
      sum = static_cast<uint8_t>(
          sum + (write ? static_cast<uint8_t>(1 - cell) : cell));
    }
    out[0] = sum;
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      uint32_t count = 0;
#pragma unroll
      for (int k = 0; k < kN; ++k) count += m[g][k] * v[k];
      out[g * b] = static_cast<int32_t>(count);
    }
  }
  if constexpr (kTelemetry) {
    uint32_t total = 0;
#pragma unroll
    for (int k = 0; k < kN; ++k) total += v[k];
    out[(rows - 1) * b] = static_cast<int32_t>(total);
  }
}

// K19, one thread a local lane. kN > 0: the form of kN acceptors (kCols
// = 0: kG mask groups; kCols > 0: whole rows of kCols); kN = 0: the
// generic template.
template <bool kTelemetry, int kN, int kG, int kCols>
__global__ void __launch_bounds__(kVoteThreads)
    shard_vote_count_kernel(const VoteCount a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.b_local) return;
  if constexpr (kN == 0) {
    vote_count_generic<kTelemetry>(a, j);
  } else {
    const long long w_local = a.w_local;
    const int i = a.i;
    const int num_blocks = static_cast<int>(w_local / a.b_local);
    const long long b = a.b_local;
    const long long c_new = floor_mod(i, num_blocks) * b + j;
    const long long c_old = floor_mod(wrap_add(i, -1), num_blocks) * b + j;
    // Every load first: both passes' vote bytes, the mask columns.
    uint32_t v1[kN], v2[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      v1[k] = a.votes[k * w_local + c_new];
      v2[k] = a.votes[k * w_local + c_old];
    }
    uint32_t m[kG][kN];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        m[g][k] = kCols > 0 ? 0u
                            : static_cast<uint32_t>(__ldg(a.q.masks + g * kN
                                                          + k));
      }
    }
    const int lane = a.slot_idx * a.b_local + j;
    const bool valid = lane < a.block_size;
    const uint32_t prop = valid ? static_cast<uint32_t>(lane) * 7u +
                                       static_cast<uint32_t>(i) * 13u + 1u
                                 : 0u;
    a.commands[c_new] = static_cast<int32_t>(prop);
    const int acc0 = a.group_idx * kN;
    const int prev = wrap_add(i, -1);
    const bool alias = c_new == c_old;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const uint32_t arr1 = valid ? arrives(lane, acc0 + k, i) : 0u;
      const uint32_t arr2 = valid ? 1u - arrives(lane, acc0 + k, prev) : 0u;
      v1[k] |= arr1;
      v2[k] = (alias ? v1[k] : v2[k]) | arr2;
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (!alias) a.votes[k * w_local + c_new] = static_cast<uint8_t>(v1[k]);
      a.votes[k * w_local + c_old] = static_cast<uint8_t>(v2[k]);
    }
    constexpr int rows = (kCols > 0 ? 1 : kG) + (kTelemetry ? 1 : 0);
    const bool write = a.q.kind == 1;
    partials_regs<kTelemetry, kN, kG, kCols>(v1, m, write, a.parts + j, b);
    partials_regs<kTelemetry, kN, kG, kCols>(v2, m, write,
                                             a.parts + rows * b + j, b);
  }
}

// A form's sizes as a type.
template <int kN, int kG, int kCols>
struct VoteForm {
  static constexpr int n = kN, g = kG, cols = kCols;
};

// The caller's form: 0 the generic template, 1 mask-group counts in
// registers, 2 whole grid rows in registers.
enum VoteFormKind { kGeneric = 0, kGroups = 1, kRows = 2 };

// Calls `f` with the register form `form` names for the shard's
// structure (1 <= kN <= 16); cudaErrorInvalidValue where there is none.
template <int kN = 1, typename F>
cudaError_t dispatch_vote_form(const VoteCount& a, long long form, F& f) {
  if constexpr (kN > 16) {
    return cudaErrorInvalidValue;
  } else {
    if (a.n_local != kN) return dispatch_vote_form<kN + 1>(a, form, f);
    if (form == kGroups && a.q.kind == 0 && a.q.g == 1) {
      return f(VoteForm<kN, 1, 0>{});
    }
    if constexpr (kN == 2) {
      if (form == kGroups && a.q.kind == 0 && a.q.g == 2) {
        return f(VoteForm<2, 2, 0>{});
      }
    }
    if constexpr (kN == 3) {
      if (form == kRows && a.q.kind != 0 && a.q.cols == 3) {
        return f(VoteForm<3, 1, 3>{});
      }
    }
    return cudaErrorInvalidValue;
  }
}

// K20's CTA size: 64 CTAs at b_local 8192 (the old 256 gave 32 of the
// card's 132 SMs).
constexpr int kCommitThreads = 128;
constexpr int kCommitWarps = kCommitThreads / 32;
constexpr unsigned kFullWarp = ~0u;

// K21's CTA size: a thread a row of the run's slot table, so a run folds
// at most this many drains (bench/pipeline.py's RUN_ROWS).
constexpr int kFoldThreads = 256;

struct Commit {
  uint8_t* votes;
  uint8_t* chosen;
  const int32_t* commands;
  int32_t* results;
  long long w_local;
  int i, block_size, b_local, slot_idx, slot_shards, n_local, n_global;
  ShardPred q;
  const int32_t* parts;
  int32_t* row;  // this drain's row of the slot table
};

// The generic template's hit of one pass: the runtime loop over groups,
// or one grid row count.
__device__ __forceinline__ bool hit_generic(const ShardPred& q,
                                            const int32_t* in, long long b) {
  if (q.kind != 0) return q.kind == 1 ? in[0] == 0 : in[0] > 0;
  bool hit = !q.combine_any;  // any() of nothing is false, all() true
  for (int g = 0; g < q.g; ++g) {
    const bool sat = in[g * b] >= q.thresholds[g];
    hit = q.combine_any ? (hit || sat) : (hit && sat);
  }
  return hit;
}

// A form's hit of one pass from the partial rows in registers: kRows the
// grid row count, else the kG mask-group counts against their thresholds.
template <int kG, bool kRows, int kR>
__device__ __forceinline__ bool hit_regs(const int32_t (&p)[kR],
                                         const int32_t (&th)[kG],
                                         const ShardPred& q) {
  if constexpr (kRows) {
    return q.kind == 1 ? p[0] == 0 : p[0] > 0;
  } else {
    bool any = false, all = true;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const bool sat = p[g] >= th[g];
      any = any || sat;
      all = all && sat;
    }
    return q.combine_any ? any : all;
  }
}

// The warp's occupancy bins of one pass into its shared row (lane 0
// writes: one pass over the distinct bins the warp's newly lanes hold).
// Warp-collective.
__device__ __forceinline__ void warp_bins(bool now, int bin, uint32_t* bins) {
  unsigned pending = __ballot_sync(kFullWarp, now);
  while (pending) {
    const int b = __shfl_sync(kFullWarp, bin, __ffs(pending) - 1);
    const unsigned same = __ballot_sync(kFullWarp, now && bin == b);
    if ((threadIdx.x & 31) == 0) bins[b] += __popc(same);
    pending &= ~same;
  }
}

// K20, one thread a local lane. kN > 0: the form of kN local acceptors
// (kRows: one grid row count; else kG mask groups); kN = 0: the generic
// template. Counters (the shared row of each warp): newly, cmds_old, then
// with telemetry proposals, pad lanes and the n_global + 1 bins.
template <bool kTelemetry, int kN, int kG, bool kRows>
__global__ void __launch_bounds__(kCommitThreads)
    shard_commit_kernel(const Commit a) {
  extern __shared__ uint32_t s_rows[];  // [kCommitWarps][counters]
  const int n = a.n_global;
  const int counters = kTelemetry ? n + 5 : 2;
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  uint32_t* mine = s_rows + warp * counters;
  if constexpr (kTelemetry) {
    for (int t = lane_id; t < counters; t += 32) mine[t] = 0;
    __syncwarp();
  }
  const int j = blockIdx.x * kCommitThreads + threadIdx.x;
  uint32_t newly = 0, cmd_sum = 0, proposed = 0, pads = 0;
  bool now1 = false, now2 = false;
  int bin1 = 0, bin2 = 0;
  if (j < a.b_local) {
    const long long b = a.b_local;
    const int num_blocks = static_cast<int>(a.w_local / b);
    const long long c_new = floor_mod(a.i, num_blocks) * b + j;
    const long long c_old = floor_mod(wrap_add(a.i, -1), num_blocks) * b + j;
    const long long c_gc = floor_mod(wrap_add(a.i, -2), num_blocks) * b + j;
    const int lane = a.slot_idx * a.b_local + j;
    const bool valid = lane < a.block_size;
    bool hit1, hit2;
    int32_t v1 = 0, v2 = 0;
    uint8_t ch_new, ch_old;
    int32_t cmd;
    if constexpr (kN == 0) {
      const int rows = partial_rows(a.q, kTelemetry);
      const int32_t* in1 = a.parts + j;
      const int32_t* in2 = a.parts + rows * b + j;
      ch_new = a.chosen[c_new];
      ch_old = a.chosen[c_old];
      cmd = a.commands[c_old];
      hit1 = hit_generic(a.q, in1, b);
      hit2 = hit_generic(a.q, in2, b);
      if constexpr (kTelemetry) {
        v1 = in1[(rows - 1) * b];
        v2 = in2[(rows - 1) * b];
      }
    } else {
      // Every load first: both passes' partial rows, both `chosen`
      // bytes, the old command; the thresholds once.
      constexpr int kR = (kRows ? 1 : kG) + (kTelemetry ? 1 : 0);
      int32_t p1[kR], p2[kR], th[kG];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        p1[r] = a.parts[r * b + j];
        p2[r] = a.parts[(kR + r) * b + j];
      }
      ch_new = a.chosen[c_new];
      ch_old = a.chosen[c_old];
      cmd = a.commands[c_old];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        th[g] = kRows ? 0 : __ldg(a.q.thresholds + g);
      }
      hit1 = hit_regs<kG, kRows>(p1, th, a.q);
      hit2 = hit_regs<kG, kRows>(p2, th, a.q);
      if constexpr (kTelemetry) {
        v1 = p1[kR - 1];
        v2 = p2[kR - 1];
      }
    }
    // Pass 1 on the new block, pass 2 on the old (pass 1's register
    // where the two are one block).
    const bool alias = c_new == c_old;
    const bool old1 = ch_new != 0;
    const bool chosen1 = (hit1 && valid) || old1;
    now1 = hit1 && valid && !old1;
    const bool old2 = alias ? chosen1 : ch_old != 0;
    const bool chosen2 = (hit2 && valid) || old2;
    now2 = hit2 && valid && !old2;
    if (!alias) a.chosen[c_new] = chosen1;
    a.chosen[c_old] = chosen2;
    newly = static_cast<uint32_t>(now1) + static_cast<uint32_t>(now2);
    // Replica: execute the old block; pad lanes' results stay 0.
    a.results[c_old] =
        valid ? static_cast<int32_t>(static_cast<uint32_t>(cmd) * 3u + 7u) : 0;
    cmd_sum = static_cast<uint32_t>(cmd);
    // GC block i-2 so the ring can wrap (after both passes' stores).
    if constexpr (kN == 0) {
      for (int k = 0; k < a.n_local; ++k) a.votes[k * a.w_local + c_gc] = 0;
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) a.votes[k * a.w_local + c_gc] = 0;
    }
    a.chosen[c_gc] = 0;
    if constexpr (kTelemetry) {
      const uint32_t prop = valid ? static_cast<uint32_t>(lane) * 7u +
                                        static_cast<uint32_t>(a.i) * 13u + 1u
                                  : 0u;
      proposed = prop != 0u;
      pads = !valid;
      bin1 = v1 < 0 ? 0 : (v1 > n ? n : v1);
      bin2 = v2 < 0 ? 0 : (v2 > n ? n : v2);
    }
  }
  // One warp step for every counter, one barrier, one add a CTA.
  newly = __reduce_add_sync(kFullWarp, newly);
  cmd_sum = __reduce_add_sync(kFullWarp, cmd_sum);
  if constexpr (kTelemetry) {
    proposed = __reduce_add_sync(kFullWarp, proposed);
    pads = __reduce_add_sync(kFullWarp, pads);
    warp_bins(now1, bin1, mine + 4);
    warp_bins(now2, bin2, mine + 4);
  }
  if (lane_id == 0) {
    mine[0] = newly;
    mine[1] = cmd_sum;
    if constexpr (kTelemetry) {
      mine[2] = proposed;
      mine[3] = pads;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < counters; t += kCommitThreads) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kCommitWarps; ++w) sum += s_rows[w * counters + t];
    const int s_n = a.slot_shards;
    // newly -> [slot_idx], cmds -> [S], proposals -> [S+n+2], pads ->
    // [S+n+3], bin v -> [S+1+v].
    const int word = t == 0   ? a.slot_idx
                     : t == 1 ? s_n
                     : t == 2 ? s_n + n + 2
                     : t == 3 ? s_n + n + 3
                              : s_n + 1 + (t - 4);
    if (sum) atomicAdd(reinterpret_cast<unsigned int*>(a.row + word), sum);
  }
}

// A K20 form's sizes as a type.
template <int kN, int kG, bool kRows>
struct CommitForm {
  static constexpr int n = kN, g = kG;
  static constexpr bool rows = kRows;
};

// Calls `f` with K20's form for the shard's structure (kind, groups,
// n_local): the mask groups of K19's forms (one group for n_local 1-16,
// two over two acceptors), whole grid rows over three acceptors, or the
// generic template.
template <int kN = 1, typename F>
cudaError_t dispatch_commit_form(int kind, int g, int n_local, F& f) {
  if constexpr (kN > 16) {
    return f(CommitForm<0, 1, false>{});
  } else {
    if (n_local != kN) return dispatch_commit_form<kN + 1>(kind, g, n_local, f);
    if (kind == 0 && g == 1) return f(CommitForm<kN, 1, false>{});
    if constexpr (kN == 2) {
      if (kind == 0 && g == 2) return f(CommitForm<2, 2, false>{});
    }
    if constexpr (kN == 3) {
      if (kind != 0) return f(CommitForm<3, 1, true>{});
    }
    return f(CommitForm<0, 1, false>{});
  }
}

struct FoldRun {
  int32_t* sm_state;
  int32_t* committed;
  int32_t* exec_wm;
  int i, k, block_size, slot_shards, n_global;
  int32_t* table;  // [k][words]: the run's slot-reduced rows
  int32_t* tel;    // the flat telemetry buffer (kTelemetry)
};

// The telemetry word a column of the slot table folds into: the flat
// buffer of ops/telemetry.py for S slot shards: [0, S) shard_committed,
// [S] proposed, [S+1, S+n+2) occupancy, [S+n+2, S+n+18) lag_hist,
// [S+n+18] pad_lanes, [S+n+19] drains.
__device__ __forceinline__ int tel_word(int w, int s_n, int n) {
  if (w < s_n) return w;                    // newly -> shard_committed
  if (w <= s_n + n + 1) return w;           // bins -> occupancy
  return w == s_n + n + 2 ? s_n : s_n + n + 18;  // proposed, pad lanes
}

// K21: one CTA folds the k rows of a run in drain order, thread d row d.
// Every load first (the scalars and the telemetry words it folds into,
// row d's newly words and cmds_old sum, and with telemetry each warp's
// column sums over its 32 rows into shared memory), one barrier, then
// stores only: the scalars, the telemetry words, the lag buckets (one
// atomicAdd per distinct bucket of a warp) and the zeroed rows.
template <bool kTelemetry>
__global__ void __launch_bounds__(kFoldThreads)
    shard_fold_kernel(const FoldRun a) {
  constexpr int kWarps = kFoldThreads / 32;
  __shared__ uint32_t s_newly[kWarps], s_cmds[kWarps];
  extern __shared__ uint32_t s_cols[];  // telemetry: [kWarps][words]
  const int s_n = a.slot_shards, n = a.n_global;
  const int words = s_n + 1 + (kTelemetry ? n + 3 : 0);
  const int d = threadIdx.x, warp = d / 32, lane = d % 32;
  const uint32_t* table = reinterpret_cast<const uint32_t*>(a.table);
  const uint32_t committed0 = static_cast<uint32_t>(*a.committed);
  uint32_t sm0 = 0, drains0 = 0, tel0 = 0;
  if (d == 0) {
    sm0 = static_cast<uint32_t>(*a.sm_state);
    if constexpr (kTelemetry) {
      drains0 = static_cast<uint32_t>(a.tel[s_n + n + 19]);
    }
  }
  if constexpr (kTelemetry) {
    if (d < words && d != s_n) {
      tel0 = static_cast<uint32_t>(a.tel[tel_word(d, s_n, n)]);
    }
  }
  uint32_t newly = 0, cmds = 0;
  if (d < a.k) {
    const uint32_t* row = table + static_cast<long long>(d) * words;
    for (int s = 0; s < s_n; ++s) newly += row[s];
    cmds = row[s_n];
  }
  if constexpr (kTelemetry) {
    // Warp w's column sums over rows 32w .. 32w + 31, lanes over words.
    const int r0 = warp * 32;
    const int rows = a.k - r0 < 32 ? a.k - r0 : 32;
    for (int w = lane; w < words; w += 32) {
      uint32_t sum = 0;
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        sum += table[static_cast<long long>(r0 + r) * words + w];
      }
      s_cols[warp * words + w] = sum;
    }
  }
  // Each drain's newly total, scanned inclusively within the warp.
  uint32_t incl = newly;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t up = __shfl_up_sync(kFullWarp, incl, off);
    if (lane >= off) incl += up;
  }
  cmds = __reduce_add_sync(kFullWarp, cmds);
  if (lane == 31) s_newly[warp] = incl;
  if (lane == 0) s_cmds[warp] = cmds;
  __syncthreads();  // every row read; the warps' sums in shared memory
  for (long long t = d; t < static_cast<long long>(a.k) * words;
       t += kFoldThreads) {
    a.table[t] = 0;
  }
  uint32_t before = 0, total = 0, cmd_total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += s_newly[w];
    total += s_newly[w];
    cmd_total += s_cmds[w];
  }
  if (d == 0) {
    *a.committed = static_cast<int32_t>(committed0 + total);
    *a.sm_state = static_cast<int32_t>(sm0 + cmd_total);
    const int last = wrap_add(a.i, a.k - 1);
    *a.exec_wm = last >= 1 ? static_cast<int32_t>(
                                 static_cast<uint32_t>(last) *
                                 static_cast<uint32_t>(a.block_size))
                           : 0;
    if constexpr (kTelemetry) {
      a.tel[s_n + n + 19] =
          static_cast<int32_t>(drains0 + static_cast<uint32_t>(a.k));
    }
  }
  if constexpr (kTelemetry) {
    // The column sums into their counters (the cmds word is sm_state's).
    for (int t = d; t < words; t += kFoldThreads) {
      if (t == s_n) continue;
      uint32_t sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_cols[w * words + t];
      const int at = tel_word(t, s_n, n);
      const uint32_t old = t == d ? tel0 : static_cast<uint32_t>(a.tel[at]);
      a.tel[at] = static_cast<int32_t>(old + sum);
    }
    // Drain d's lag from its end-of-drain committed, one sample a drain.
    const uint32_t after = committed0 + before + incl;
    const int32_t lag = static_cast<int32_t>(
        (static_cast<uint32_t>(wrap_add(a.i, d)) + 1u) *
            static_cast<uint32_t>(a.block_size) -
        after);
    const int bucket = d < a.k ? lag_bucket(lag) : -1;
    unsigned pending = __ballot_sync(kFullWarp, bucket >= 0);
    while (pending) {
      const int bk = __shfl_sync(kFullWarp, bucket, __ffs(pending) - 1);
      const unsigned same = __ballot_sync(kFullWarp, bucket == bk);
      if (lane == 0) {
        atomicAdd(reinterpret_cast<unsigned int*>(&a.tel[s_n + n + 2 + bk]),
                  static_cast<unsigned int>(__popc(same)));
      }
      pending &= ~same;
    }
  }
}

ShardPred make_shard_pred(int kind, int g, int cols, const void* masks,
                          const void* thresholds, int combine_any) {
  return ShardPred{kind, g, cols, static_cast<const int32_t*>(masks),
                   static_cast<const int32_t*>(thresholds), combine_any};
}

template <typename T>
T* pointer(long long slot) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(slot));
}

cudaError_t select_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

// K19: the local lanes' proposals, both passes' votes and their
// partials. block: votes, commands, w_local, i, block_size, b_local,
// slot_idx, group_idx, n_local, kind, g, cols, local masks, telemetry,
// parts, form (VoteFormKind), device, stream.
extern "C" int fpx_shard_vote_count(const void* block) {
  long long a[18];
  std::memcpy(a, block, sizeof a);
  const long long b_local = a[5], form = a[15];
  if (b_local <= 0 || b_local > INT_MAX || a[2] <= 0 || a[2] % b_local ||
      a[8] <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[16]));
  if (err != cudaSuccess) return err;
  const VoteCount v{pointer<uint8_t>(a[0]), pointer<int32_t>(a[1]), a[2],
                    static_cast<int>(a[3]), static_cast<int>(a[4]),
                    static_cast<int>(b_local), static_cast<int>(a[6]),
                    static_cast<int>(a[7]), static_cast<int>(a[8]),
                    make_shard_pred(static_cast<int>(a[9]),
                                    static_cast<int>(a[10]),
                                    static_cast<int>(a[11]),
                                    pointer<const void>(a[12]), nullptr, 0),
                    pointer<int32_t>(a[14])};
  const unsigned grid =
      static_cast<unsigned>((b_local + kVoteThreads - 1) / kVoteThreads);
  const auto s = pointer<CUstream_st>(a[17]);
  const bool telemetry = a[13] != 0;
  auto go = [&](auto shape) {
    using F = decltype(shape);
    if (telemetry) {
      shard_vote_count_kernel<true, F::n, F::g, F::cols>
          <<<grid, kVoteThreads, 0, s>>>(v);
    } else {
      shard_vote_count_kernel<false, F::n, F::g, F::cols>
          <<<grid, kVoteThreads, 0, s>>>(v);
    }
    return cudaGetLastError();
  };
  if (form == kGeneric) return go(VoteForm<0, 1, 0>{});
  return dispatch_vote_form(v, form, go);
}

// K20: hits, chosen, execution and GC from the group-reduced partials;
// the slot partials added into the drain's row of the slot table, in the
// form the shard's kind, group count and n_local name. block: votes,
// chosen, commands, results, w_local, i, block_size, b_local, slot_idx,
// slot_shards, n_local, n_global, kind, g, thresholds, combine_any,
// telemetry, parts, the drain's row, device, stream.
extern "C" int fpx_shard_commit(const void* block) {
  long long a[21];
  std::memcpy(a, block, sizeof a);
  const long long b_local = a[7];
  if (b_local <= 0 || b_local > INT_MAX || a[4] <= 0 || a[4] % b_local ||
      a[10] <= 0 || a[11] < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[19]));
  if (err != cudaSuccess) return err;
  const Commit c{pointer<uint8_t>(a[0]), pointer<uint8_t>(a[1]),
                 pointer<const int32_t>(a[2]), pointer<int32_t>(a[3]), a[4],
                 static_cast<int>(a[5]), static_cast<int>(a[6]),
                 static_cast<int>(b_local), static_cast<int>(a[8]),
                 static_cast<int>(a[9]), static_cast<int>(a[10]),
                 static_cast<int>(a[11]),
                 make_shard_pred(static_cast<int>(a[12]),
                                 static_cast<int>(a[13]), 0, nullptr,
                                 pointer<const void>(a[14]),
                                 static_cast<int>(a[15])),
                 pointer<const int32_t>(a[17]), pointer<int32_t>(a[18])};
  const unsigned grid =
      static_cast<unsigned>((b_local + kCommitThreads - 1) / kCommitThreads);
  const auto s = pointer<CUstream_st>(a[20]);
  const bool telemetry = a[16] != 0;
  const size_t smem = sizeof(uint32_t) * kCommitWarps *
                      (telemetry ? static_cast<size_t>(c.n_global) + 5 : 2);
  auto go = [&](auto shape) {
    using F = decltype(shape);
    if (telemetry) {
      shard_commit_kernel<true, F::n, F::g, F::rows>
          <<<grid, kCommitThreads, smem, s>>>(c);
    } else {
      shard_commit_kernel<false, F::n, F::g, F::rows>
          <<<grid, kCommitThreads, smem, s>>>(c);
    }
    return cudaGetLastError();
  };
  return dispatch_commit_form(c.q.kind, c.q.g, c.n_local, go);
}

// K21: the k slot-reduced rows of a run (drains i .. i + k - 1) folded
// into the scalars (and the flat telemetry buffer, n_global + slot_shards
// + 21 int32, when not 0), the rows zeroed. block: sm_state, committed,
// exec_wm, i, k, block_size, slot_shards, n_global, the slot table,
// telemetry buffer (or 0), device, stream.
extern "C" int fpx_shard_fold(const void* block) {
  long long a[12];
  std::memcpy(a, block, sizeof a);
  if (a[4] <= 0 || a[4] > kFoldThreads || a[6] <= 0 || a[7] < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[10]));
  if (err != cudaSuccess) return err;
  const auto s = pointer<CUstream_st>(a[11]);
  const FoldRun f{pointer<int32_t>(a[0]), pointer<int32_t>(a[1]),
                  pointer<int32_t>(a[2]), static_cast<int>(a[3]),
                  static_cast<int>(a[4]), static_cast<int>(a[5]),
                  static_cast<int>(a[6]), static_cast<int>(a[7]),
                  pointer<int32_t>(a[8]), pointer<int32_t>(a[9])};
  if (f.tel) {
    const size_t smem = sizeof(uint32_t) * (kFoldThreads / 32) *
                        (static_cast<size_t>(f.slot_shards) + f.n_global + 4);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    shard_fold_kernel<true><<<1, kFoldThreads, smem, s>>>(f);
  } else {
    shard_fold_kernel<false><<<1, kFoldThreads, 0, s>>>(f);
  }
  return cudaGetLastError();
}
