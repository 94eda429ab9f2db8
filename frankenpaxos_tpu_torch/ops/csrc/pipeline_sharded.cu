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
// vote bytes per lane and writes one command and 8 * R partial bytes; K20
// reads the partials, the old command and `chosen` twice, and writes
// `chosen`, a result and the GC column. At the headline's width split
// four ways (b_local = 8192) each kernel moves under 0.5 MB, under 0.2 us
// at 3.35 TB/s: the launches and the all-reduces between them dominate.

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

template <bool kTelemetry>
__global__ void shard_vote_count_kernel(
    uint8_t* __restrict__ votes, int32_t* __restrict__ commands,
    long long w_local, int i, int block_size, int b_local, int slot_idx,
    int group_idx, int n_local, ShardPred q, int32_t* __restrict__ parts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b_local) return;
  const int num_blocks = static_cast<int>(w_local / b_local);
  const long long b = b_local;
  const long long start_new = floor_mod(i, num_blocks) * b;
  const long long start_old = floor_mod(wrap_add(i, -1), num_blocks) * b;
  const int lane = slot_idx * b_local + j;
  const bool valid = lane < block_size;
  const uint32_t prop = valid ? static_cast<uint32_t>(lane) * 7u +
                                     static_cast<uint32_t>(i) * 13u + 1u
                               : 0u;
  commands[start_new + j] = static_cast<int32_t>(prop);
  const int rows = partial_rows(q, kTelemetry);
  for (int p = 0; p < 2; ++p) {
    const long long c = (p == 0 ? start_new : start_old) + j;
    const int drain = p == 0 ? i : wrap_add(i, -1);
    for (int a = 0; a < n_local; ++a) {
      uint8_t arr = arrives(lane, group_idx * n_local + a, drain);
      if (p == 1) arr = 1 - arr;
      if (!valid) arr = 0;
      votes[a * w_local + c] |= arr;
    }
    int32_t* out = parts + static_cast<long long>(p) * rows * b + j;
    if (q.kind == 0) {
      for (int g = 0; g < q.g; ++g) {
        uint32_t count = 0;
        for (int a = 0; a < n_local; ++a) {
          count += static_cast<uint32_t>(q.masks[g * n_local + a]) *
                   static_cast<uint32_t>(votes[a * w_local + c]);
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
      for (int a = 0; a < n_local; ++a) total += votes[a * w_local + c];
      out[(rows - 1) * b] = static_cast<int32_t>(total);
    }
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

}  // namespace

// K19: the local lanes' proposals, both passes' votes and their partials.
extern "C" int fpx_shard_vote_count(void* votes, void* commands,
                                    long long w_local, int i, int block_size,
                                    int b_local, int slot_idx, int group_idx,
                                    int n_local, int kind, int g, int cols,
                                    const void* masks, int telemetry,
                                    void* parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (b_local + FPX_THREADS - 1) / FPX_THREADS;
  const ShardPred q = make_shard_pred(kind, g, cols, masks, nullptr, 0);
  auto s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<uint8_t*>(votes);
  auto* cmds = static_cast<int32_t*>(commands);
  auto* out = static_cast<int32_t*>(parts);
  if (telemetry) {
    shard_vote_count_kernel<true><<<grid, FPX_THREADS, 0, s>>>(
        v, cmds, w_local, i, block_size, b_local, slot_idx, group_idx,
        n_local, q, out);
  } else {
    shard_vote_count_kernel<false><<<grid, FPX_THREADS, 0, s>>>(
        v, cmds, w_local, i, block_size, b_local, slot_idx, group_idx,
        n_local, q, out);
  }
  return cudaGetLastError();
}

// K20: hits, chosen, execution and GC from the group-reduced partials;
// the slot partials added into slot_buf.
extern "C" int fpx_shard_commit(void* votes, void* chosen, const void* commands,
                                void* results, long long w_local, int i,
                                int block_size, int b_local, int slot_idx,
                                int slot_shards, int n_local, int n_global,
                                int kind, int g, const void* thresholds,
                                int combine_any, int telemetry,
                                const void* parts, void* slot_buf, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (b_local + FPX_THREADS - 1) / FPX_THREADS;
  const ShardPred q =
      make_shard_pred(kind, g, 0, nullptr, thresholds, combine_any);
  auto s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<uint8_t*>(votes);
  auto* ch = static_cast<uint8_t*>(chosen);
  auto* cmds = static_cast<const int32_t*>(commands);
  auto* res = static_cast<int32_t*>(results);
  auto* in = static_cast<const int32_t*>(parts);
  auto* buf = static_cast<int32_t*>(slot_buf);
  if (telemetry) {
    const size_t occ_bytes =
        sizeof(uint32_t) * (static_cast<size_t>(n_global) + 1);
    shard_commit_kernel<true><<<grid, FPX_THREADS, occ_bytes, s>>>(
        v, ch, cmds, res, w_local, i, block_size, b_local, slot_idx,
        slot_shards, n_local, n_global, q, in, buf);
  } else {
    shard_commit_kernel<false><<<grid, FPX_THREADS, 0, s>>>(
        v, ch, cmds, res, w_local, i, block_size, b_local, slot_idx,
        slot_shards, n_local, n_global, q, in, buf);
  }
  return cudaGetLastError();
}

// K21: the slot-reduced deltas folded into the scalars (and the flat
// telemetry buffer, n_global + slot_shards + 21 int32, when not NULL).
extern "C" int fpx_shard_fold(void* sm_state, void* committed, void* exec_wm,
                              int i, int block_size, int slot_shards,
                              int n_global, void* slot_buf, void* tel,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto* sm = static_cast<int32_t*>(sm_state);
  auto* cm = static_cast<int32_t*>(committed);
  auto* wm = static_cast<int32_t*>(exec_wm);
  auto* buf = static_cast<int32_t*>(slot_buf);
  if (tel != nullptr) {
    shard_fold_kernel<true><<<1, 32, 0, s>>>(sm, cm, wm, i, block_size,
                                             slot_shards, n_global, buf,
                                             static_cast<int32_t*>(tel));
  } else {
    shard_fold_kernel<false><<<1, 32, 0, s>>>(sm, cm, wm, i, block_size,
                                              slot_shards, n_global, buf,
                                              nullptr);
  }
  return cudaGetLastError();
}
