// The PINNED sharded drain: a copy of the telemetry-off path of K19
// shard_vote_count, K20 shard_commit and K21 shard_fold
// (ops/csrc/pipeline_sharded.cu) with its device helpers copied in from
// drain.cuh, behind its own C entry points fpx_shard_*_baseline, so that
// a later redesign of the live sharded drain cannot move the mesh form of
// the pinned baseline. Replaces the JAX package's pinned drain with its
// axes, frankenpaxos_tpu/bench/pipeline_baseline.py::steady_state_step
// (L76-80 with group_axis / slot_axis, the psums at L154, L158, L160,
// L169 and L185) as shard_map runs it. Do NOT edit the code below: it is the
// measurement. If the live sharded drain's semantics change on purpose,
// re-pin a fresh copy and say so.
//
// One drain on ONE shard of a (group, slot) mesh, split at the psums:
//
//   K19 copy (one thread per local lane): propose; OR pass 1's arrivals
//       into the new block and write pass 1's partials; OR pass 2's (the
//       complement of drain i-1's) into the old block and write pass 2's.
//       Partials: [2, R, b_local] int32, R = G mask-group counts (the
//       psum'd matmul) or 1 missing/full row count (the fused grid path,
//       taken only when every group shard holds whole rows).
//   -- all-reduce SUM of the partials over the group subgroup --
//   K20 copy (one thread per local lane): the hits of pass 1 then pass 2
//       (pad lanes never hit), `chosen` and `newly`; execute the old block
//       (pad lanes' results stay 0); GC. Per thread block one atomicAdd on
//       unsigned per word into the slot partials: [S] newly counts (this
//       shard's entry at slot_idx) and the cmds_old sum.
//   -- all-reduce SUM of the slot partials over the slot subgroup --
//   K21 copy (one thread): fold them into committed, sm_state and exec_wm
//       (the GLOBAL block size), then zero the buffer.
//
// Every effect on local lane j touches only column start + j of the new,
// old and GC blocks, so one thread per lane keeps the reference's order
// where the ring's blocks alias. Integer arithmetic is uint32 with casts
// (the reference wraps int32) and the atomics are order-free, so each
// kernel is bit-identical to its plain version and to JAX's psums.
//
// Bound on the H100: bytes, as for the live kernels; at the headline's
// width split four ways (b_local = 8192) each kernel moves under 0.5 MB.

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

__device__ __forceinline__ void bump(int32_t* x, uint32_t by) {
  *x = static_cast<int32_t>(static_cast<uint32_t>(*x) + by);
}

__device__ __forceinline__ void add_word(int32_t* word, uint32_t v) {
  if (v) atomicAdd(reinterpret_cast<unsigned int*>(word), v);
}

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

__global__ void shard_vote_count_baseline_kernel(
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
  const int rows = q.kind == 0 ? q.g : 1;
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
  }
}

__global__ void shard_commit_baseline_kernel(
    uint8_t* __restrict__ votes, uint8_t* __restrict__ chosen,
    const int32_t* __restrict__ commands, int32_t* __restrict__ results,
    long long w_local, int i, int block_size, int b_local, int slot_idx,
    int slot_shards, int n_local, ShardPred q,
    const int32_t* __restrict__ parts, int32_t* slot_buf) {
  __shared__ uint32_t newly_part[FPX_THREADS / 32];
  __shared__ uint32_t cmds_part[FPX_THREADS / 32];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t newly = 0, cmd_sum = 0;
  if (j < b_local) {
    const int num_blocks = static_cast<int>(w_local / b_local);
    const long long b = b_local;
    const long long start_new = floor_mod(i, num_blocks) * b;
    const long long start_old = floor_mod(wrap_add(i, -1), num_blocks) * b;
    const long long start_gc = floor_mod(wrap_add(i, -2), num_blocks) * b;
    const int lane = slot_idx * b_local + j;
    const bool valid = lane < block_size;
    const int rows = q.kind == 0 ? q.g : 1;
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
      newly += hit && !old;
    }
    // Replica: execute the old block; pad lanes' results stay 0.
    const int32_t cmd = commands[start_old + j];
    results[start_old + j] =
        valid ? static_cast<int32_t>(static_cast<uint32_t>(cmd) * 3u + 7u) : 0;
    cmd_sum = static_cast<uint32_t>(cmd);
    // GC block i-2 so the ring can wrap.
    for (int a = 0; a < n_local; ++a) votes[a * w_local + start_gc + j] = 0;
    chosen[start_gc + j] = 0;
  }
  newly = block_sum(newly, newly_part);
  cmd_sum = block_sum(cmd_sum, cmds_part);
  if (threadIdx.x == 0) {
    add_word(&slot_buf[slot_idx], newly);
    add_word(&slot_buf[slot_shards], cmd_sum);
  }
}

__global__ void shard_fold_baseline_kernel(int32_t* sm_state,
                                           int32_t* committed,
                                           int32_t* exec_wm, int i,
                                           int block_size, int slot_shards,
                                           int32_t* slot_buf) {
  if (threadIdx.x == 0) {
    uint32_t newly = 0;
    for (int s = 0; s < slot_shards; ++s) {
      newly += static_cast<uint32_t>(slot_buf[s]);
    }
    bump(committed, newly);
    bump(sm_state, static_cast<uint32_t>(slot_buf[slot_shards]));
    *exec_wm = i >= 1 ? static_cast<int32_t>(static_cast<uint32_t>(i) *
                                             static_cast<uint32_t>(block_size))
                      : 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= slot_shards; t += blockDim.x) slot_buf[t] = 0;
}

}  // namespace

// K19 copy: the local lanes' proposals, both passes' votes and partials.
extern "C" int fpx_shard_vote_count_baseline(
    void* votes, void* commands, long long w_local, int i, int block_size,
    int b_local, int slot_idx, int group_idx, int n_local, int kind, int g,
    int cols, const void* masks, void* parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (b_local + FPX_THREADS - 1) / FPX_THREADS;
  const ShardPred q{kind, g, cols, static_cast<const int32_t*>(masks),
                    nullptr, 0};
  shard_vote_count_baseline_kernel<<<grid, FPX_THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(votes), static_cast<int32_t*>(commands), w_local,
      i, block_size, b_local, slot_idx, group_idx, n_local, q,
      static_cast<int32_t*>(parts));
  return cudaGetLastError();
}

// K20 copy: hits, chosen, execution and GC from the group-reduced
// partials; the slot partials added into slot_buf.
extern "C" int fpx_shard_commit_baseline(
    void* votes, void* chosen, const void* commands, void* results,
    long long w_local, int i, int block_size, int b_local, int slot_idx,
    int slot_shards, int n_local, int kind, int g, const void* thresholds,
    int combine_any, const void* parts, void* slot_buf, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (b_local + FPX_THREADS - 1) / FPX_THREADS;
  const ShardPred q{kind, g, 0, nullptr,
                    static_cast<const int32_t*>(thresholds), combine_any};
  shard_commit_baseline_kernel<<<grid, FPX_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(votes), static_cast<uint8_t*>(chosen),
      static_cast<const int32_t*>(commands), static_cast<int32_t*>(results),
      w_local, i, block_size, b_local, slot_idx, slot_shards, n_local, q,
      static_cast<const int32_t*>(parts), static_cast<int32_t*>(slot_buf));
  return cudaGetLastError();
}

// K21 copy: the slot-reduced deltas folded into the three scalars.
extern "C" int fpx_shard_fold_baseline(void* sm_state, void* committed,
                                       void* exec_wm, int i, int block_size,
                                       int slot_shards, void* slot_buf,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  shard_fold_baseline_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(sm_state), static_cast<int32_t*>(committed),
      static_cast<int32_t*>(exec_wm), i, block_size, slot_shards,
      static_cast<int32_t*>(slot_buf));
  return cudaGetLastError();
}
