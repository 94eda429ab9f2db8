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
//       Per thread block, one atomicAdd on unsigned per word into the
//       slot-partials buffer: [S] newly counts (this shard's entry at
//       slot_idx), the cmds_old sum, and with telemetry [n + 1] occupancy
//       bins, valid proposals and pad lanes.
//   -- all-reduce SUM of the slot partials over the slot subgroup --
//   K21 (one thread): fold the deltas into committed, sm_state, exec_wm
//       (the GLOBAL block size, L313) and the telemetry counters (the lag
//       from the end-of-drain committed, L329-333), then zero the buffer.
//
// Order where the ring's blocks alias (window / block 1 or 2): every
// effect on local lane j touches only column start + j of the new, old and
// GC blocks, so one thread per lane keeps the reference's order within
// each kernel, and the split keeps it across them: K19 ORs both passes'
// votes (pass 1's partials read before pass 2's OR) before K20's GC clears
// any, and `chosen` changes only in K20, pass 1 before pass 2.
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

__device__ __forceinline__ void add_word(int32_t* word, uint32_t v) {
  if (v) atomicAdd(reinterpret_cast<unsigned int*>(word), v);
}

template <bool kTelemetry>
__global__ void shard_commit_kernel(
    uint8_t* __restrict__ votes, uint8_t* __restrict__ chosen,
    const int32_t* __restrict__ commands, int32_t* __restrict__ results,
    long long w_local, int i, int block_size, int b_local, int slot_idx,
    int slot_shards, int n_local, int n_global, ShardPred q,
    const int32_t* __restrict__ parts, int32_t* slot_buf) {
  __shared__ uint32_t newly_part[FPX_THREADS / 32];
  __shared__ uint32_t cmds_part[FPX_THREADS / 32];
  extern __shared__ uint32_t s_occ[];  // telemetry: [n_global + 1] bins
  if constexpr (kTelemetry) {
    for (int t = threadIdx.x; t <= n_global; t += blockDim.x) s_occ[t] = 0;
    __syncthreads();
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t newly = 0, cmd_sum = 0, proposed = 0, pads = 0;
  if (j < b_local) {
    const int num_blocks = static_cast<int>(w_local / b_local);
    const long long b = b_local;
    const long long start_new = floor_mod(i, num_blocks) * b;
    const long long start_old = floor_mod(wrap_add(i, -1), num_blocks) * b;
    const long long start_gc = floor_mod(wrap_add(i, -2), num_blocks) * b;
    const int lane = slot_idx * b_local + j;
    const bool valid = lane < block_size;
    const int rows = partial_rows(q, kTelemetry);
    for (int p = 0; p < 2; ++p) {
      const long long c = (p == 0 ? start_new : start_old) + j;
      const int32_t* in = parts + static_cast<long long>(p) * rows * b + j;
      bool hit;
      if (q.kind == 0) {
        hit = !q.combine_any;  // any() of nothing is false, all() true
        for (int g = 0; g < q.g; ++g) {
          const bool sat = in[g * b] >= q.thresholds[g];
          hit = q.combine_any ? (hit || sat) : (hit && sat);
        }
      } else {
        hit = q.kind == 1 ? in[0] == 0 : in[0] > 0;
      }
      hit = hit && valid;
      const bool old = chosen[c] != 0;
      chosen[c] = hit || old;
      const bool now = hit && !old;
      newly += now;
      if constexpr (kTelemetry) {
        if (now) {
          const int32_t v = in[(rows - 1) * b];
          atomicAdd(&s_occ[v < 0 ? 0 : (v > n_global ? n_global : v)], 1u);
        }
      }
    }
    // Replica: execute the old block; pad lanes' results stay 0.
    const int32_t cmd = commands[start_old + j];
    results[start_old + j] =
        valid ? static_cast<int32_t>(static_cast<uint32_t>(cmd) * 3u + 7u) : 0;
    cmd_sum = static_cast<uint32_t>(cmd);
    // GC block i-2 so the ring can wrap.
    for (int a = 0; a < n_local; ++a) votes[a * w_local + start_gc + j] = 0;
    chosen[start_gc + j] = 0;
    if constexpr (kTelemetry) {
      const uint32_t prop = valid ? static_cast<uint32_t>(lane) * 7u +
                                        static_cast<uint32_t>(i) * 13u + 1u
                                  : 0u;
      proposed = prop != 0u;
      pads = !valid;
    }
  }
  newly = block_sum(newly, newly_part);
  cmd_sum = block_sum(cmd_sum, cmds_part);
  if constexpr (kTelemetry) {
    __shared__ uint32_t prop_part[FPX_THREADS / 32];
    __shared__ uint32_t pad_part[FPX_THREADS / 32];
    proposed = block_sum(proposed, prop_part);
    pads = block_sum(pads, pad_part);
    __syncthreads();  // every lane's occupancy is in s_occ
    for (int t = threadIdx.x; t <= n_global; t += blockDim.x) {
      add_word(&slot_buf[slot_shards + 1 + t], s_occ[t]);
    }
    if (threadIdx.x == 0) {
      add_word(&slot_buf[slot_shards + n_global + 2], proposed);
      add_word(&slot_buf[slot_shards + n_global + 3], pads);
    }
  }
  if (threadIdx.x == 0) {
    add_word(&slot_buf[slot_idx], newly);
    add_word(&slot_buf[slot_shards], cmd_sum);
  }
}

template <bool kTelemetry>
__global__ void shard_fold_kernel(int32_t* sm_state, int32_t* committed,
                                  int32_t* exec_wm, int i, int block_size,
                                  int slot_shards, int n_global,
                                  int32_t* slot_buf, int32_t* tel) {
  const int s_n = slot_shards;
  const int words = s_n + 1 + (kTelemetry ? n_global + 3 : 0);
  if (threadIdx.x == 0) {
    uint32_t newly = 0;
    for (int s = 0; s < s_n; ++s) newly += static_cast<uint32_t>(slot_buf[s]);
    const uint32_t total = static_cast<uint32_t>(*committed) + newly;
    *committed = static_cast<int32_t>(total);
    bump(sm_state, static_cast<uint32_t>(slot_buf[s_n]));
    *exec_wm = i >= 1 ? static_cast<int32_t>(static_cast<uint32_t>(i) *
                                             static_cast<uint32_t>(block_size))
                      : 0;
    if constexpr (kTelemetry) {
      // The flat buffer of ops/telemetry.py for S slot shards:
      // [0, S) shard_committed, [S] proposed, [S+1, S+n+2) occupancy,
      // [S+n+2, S+n+18) lag_hist, [S+n+18] pad_lanes, [S+n+19] drains.
      for (int s = 0; s < s_n; ++s) {
        bump(&tel[s], static_cast<uint32_t>(slot_buf[s]));
      }
      bump(&tel[s_n], static_cast<uint32_t>(slot_buf[s_n + n_global + 2]));
      for (int k = 0; k <= n_global; ++k) {
        bump(&tel[s_n + 1 + k], static_cast<uint32_t>(slot_buf[s_n + 1 + k]));
      }
      const int32_t lag = static_cast<int32_t>(
          (static_cast<uint32_t>(i) + 1u) * static_cast<uint32_t>(block_size) -
          total);
      bump(&tel[s_n + n_global + 2 + lag_bucket(lag)], 1u);
      bump(&tel[s_n + n_global + 18],
           static_cast<uint32_t>(slot_buf[s_n + n_global + 3]));
      bump(&tel[s_n + n_global + 19], 1u);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < words; t += blockDim.x) slot_buf[t] = 0;
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
// the slot partials added into slot_buf. block: votes, chosen, commands,
// results, w_local, i, block_size, b_local, slot_idx, slot_shards,
// n_local, n_global, kind, g, thresholds, combine_any, telemetry, parts,
// slot_buf, device, stream.
extern "C" int fpx_shard_commit(const void* block) {
  long long a[21];
  std::memcpy(a, block, sizeof a);
  const long long b_local = a[7];
  if (b_local <= 0 || b_local > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = select_device(static_cast<int>(a[19]));
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>((b_local + FPX_THREADS - 1) /
                                    FPX_THREADS);
  const ShardPred q = make_shard_pred(
      static_cast<int>(a[12]), static_cast<int>(a[13]), 0, nullptr,
      pointer<const void>(a[14]), static_cast<int>(a[15]));
  const auto s = pointer<CUstream_st>(a[20]);
  auto* v = pointer<uint8_t>(a[0]);
  auto* ch = pointer<uint8_t>(a[1]);
  auto* cmds = pointer<const int32_t>(a[2]);
  auto* res = pointer<int32_t>(a[3]);
  auto* in = pointer<const int32_t>(a[17]);
  auto* buf = pointer<int32_t>(a[18]);
  const int i = static_cast<int>(a[5]), block_size = static_cast<int>(a[6]),
            slot_idx = static_cast<int>(a[8]),
            slot_shards = static_cast<int>(a[9]),
            n_local = static_cast<int>(a[10]),
            n_global = static_cast<int>(a[11]);
  if (a[16]) {
    const size_t occ_bytes =
        sizeof(uint32_t) * (static_cast<size_t>(n_global) + 1);
    shard_commit_kernel<true><<<grid, FPX_THREADS, occ_bytes, s>>>(
        v, ch, cmds, res, a[4], i, block_size, static_cast<int>(b_local),
        slot_idx, slot_shards, n_local, n_global, q, in, buf);
  } else {
    shard_commit_kernel<false><<<grid, FPX_THREADS, 0, s>>>(
        v, ch, cmds, res, a[4], i, block_size, static_cast<int>(b_local),
        slot_idx, slot_shards, n_local, n_global, q, in, buf);
  }
  return cudaGetLastError();
}

// K21: the slot-reduced deltas folded into the scalars (and the flat
// telemetry buffer, n_global + slot_shards + 21 int32, when not 0).
// block: sm_state, committed, exec_wm, i, block_size, slot_shards,
// n_global, slot_buf, telemetry buffer (or 0), device, stream.
extern "C" int fpx_shard_fold(const void* block) {
  long long a[11];
  std::memcpy(a, block, sizeof a);
  cudaError_t err = select_device(static_cast<int>(a[9]));
  if (err != cudaSuccess) return err;
  const auto s = pointer<CUstream_st>(a[10]);
  auto* sm = pointer<int32_t>(a[0]);
  auto* cm = pointer<int32_t>(a[1]);
  auto* wm = pointer<int32_t>(a[2]);
  auto* buf = pointer<int32_t>(a[7]);
  const int i = static_cast<int>(a[3]), block_size = static_cast<int>(a[4]),
            slot_shards = static_cast<int>(a[5]),
            n_global = static_cast<int>(a[6]);
  if (a[8]) {
    shard_fold_kernel<true><<<1, 32, 0, s>>>(sm, cm, wm, i, block_size,
                                             slot_shards, n_global, buf,
                                             pointer<int32_t>(a[8]));
  } else {
    shard_fold_kernel<false><<<1, 32, 0, s>>>(sm, cm, wm, i, block_size,
                                              slot_shards, n_global, buf,
                                              nullptr);
  }
  return cudaGetLastError();
}
