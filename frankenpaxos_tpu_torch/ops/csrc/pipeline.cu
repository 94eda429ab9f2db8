// K3 steady_state_step and K14, its telemetry-on twin: one drain of the
// device-resident MultiPaxos steady-state pipeline in ONE launch.
//
// Replaces frankenpaxos_tpu/bench/pipeline.py::steady_state_step (L145,
// with _arrivals L87), the body of run_steps (L341) / run_steps_from
// (L358), unsharded. One thread per block lane j < block_size. Every
// effect of a drain on lane j touches only column `start + j` of the
// new, old and GC blocks, so one thread running the reference's order
//   propose -> pass 1 (new block) -> pass 2 (old block) -> execute -> GC
// reproduces the reference for any window / block ratio, including 1
// and 2, where those blocks alias.
//
// The two scalar sums (committed += sum(newly), sm_state +=
// sum(cmds_old)) are block reductions plus one atomicAdd on unsigned int
// per thread block: bit-identical to int32 wraparound and independent of
// order. exec_wm is written once.
//
// Integer hashing uses uint32 arithmetic and casts: signed overflow is
// undefined in CUDA C++, while the reference relies on int32 wraparound.
//
// Bound on the H100: bytes. At N=3, B=32768 a drain moves about 1 MB
// (32 bytes per lane: the new, old and GC columns of votes and chosen,
// one command written, one read, one result), about 0.3 us at
// 3.35 TB/s, and the 13 MB of pipeline state at W=2^20 stays in the
// 50 MB L2. So the per-drain launch dominates; a CUDA graph or a
// persistent kernel over many drains is later work.
//
// K14 (kTelemetry = true) also accumulates the telemetry plane, the
// weave of frankenpaxos_tpu/ops/telemetry.py (lag_bucket L99,
// quorum_pass_update L108, drain_update L136) into the reference's step
// at L285-291 and L328-333, into one flat int32 buffer laid out as
// ops/telemetry.py's make_telemetry lays it out for one slot shard:
//   [0] shard_committed, [1] proposed, [2, n+2] occupancy,
//   [n+3, n+18] lag_hist, [n+19] pad_lanes, [n+20] drains,
//   [n+21] scratch: the done-counter below, 0 between drains.
// Occupancy: a lane newly chosen by a pass adds one to bin
// min(sum of its N vote bytes after the OR, n) -- an int32 sum of bytes,
// not a count of nonzero ones -- pass 1 before pass 2, into a histogram
// per thread block in shared memory, then one atomicAdd per bin. The
// lag needs the END-of-drain `committed`, which only exists once every
// thread block has added its part: each block's thread 0 adds, fences
// and bumps the done-counter; the block that bumps it last reads
// `committed`, adds the lag-bucket sample and the drain, and resets the
// counter. So the telemetry-on drain stays ONE launch. Its extra bytes
// are under 100 (the counters); pad_lanes never changes on one GPU.
// The `false` instantiation is K3 as it was before the telemetry plane.

#include "drain.cuh"
#include "quorum.cuh"

namespace {

using namespace fpx_drain;

// One quorum pass on column c: OR in the arrivals, run the predicate,
// mark chosen. Returns whether the column was newly chosen.
__device__ __forceinline__ bool quorum_pass(uint8_t* votes, uint8_t* chosen,
                                            long long window, long long c,
                                            int lane, int i, bool complement,
                                            const QuorumPred& q) {
  for (int n = 0; n < q.n; ++n) {
    uint8_t a = arrives(lane, n, i);
    if (complement) a = 1 - a;
    votes[n * window + c] |= a;
  }
  const bool hit = quorum_hit(q, [&](int n) { return votes[n * window + c]; });
  const bool old = chosen[c] != 0;
  chosen[c] = hit || old;
  return hit && !old;
}

// The int32 sum of column c's N vote bytes (K14's occupancy count).
__device__ __forceinline__ uint32_t column_votes(const uint8_t* votes,
                                                 long long window,
                                                 long long c, int n) {
  uint32_t sum = 0;
  for (int a = 0; a < n; ++a) sum += votes[a * window + c];
  return sum;
}

__device__ __forceinline__ void count_occupancy(uint32_t* s_occ,
                                                const uint8_t* votes,
                                                long long window,
                                                long long c, int n) {
  const uint32_t v = column_votes(votes, window, c, n);
  atomicAdd(&s_occ[v < static_cast<uint32_t>(n) ? v : n], 1u);
}

template <bool kTelemetry>
__global__ void steady_state_step_kernel(
    uint8_t* __restrict__ votes, uint8_t* __restrict__ chosen,
    int32_t* __restrict__ commands, int32_t* __restrict__ results,
    int32_t* sm_state, int32_t* committed, int32_t* exec_wm,
    long long window, int block_size, int i, QuorumPred q, int32_t* tel) {
  __shared__ uint32_t newly_part[FPX_THREADS / 32];
  __shared__ uint32_t cmds_part[FPX_THREADS / 32];
  extern __shared__ uint32_t s_occ[];  // K14: [n + 1] occupancy bins
  if constexpr (kTelemetry) {
    for (int t = threadIdx.x; t <= q.n; t += blockDim.x) s_occ[t] = 0;
    __syncthreads();
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t newly = 0, cmd_sum = 0, proposed = 0;
  if (j < block_size) {
    const int num_blocks = static_cast<int>(window / block_size);
    const long long b = block_size;
    const long long start_new = floor_mod(i, num_blocks) * b;
    const long long start_old = floor_mod(wrap_add(i, -1), num_blocks) * b;
    const long long start_gc = floor_mod(wrap_add(i, -2), num_blocks) * b;

    // Leader: propose lanes*7 + i*13 + 1.
    const uint32_t prop =
        static_cast<uint32_t>(j) * 7u + static_cast<uint32_t>(i) * 13u + 1u;
    commands[start_new + j] = static_cast<int32_t>(prop);
    // Acceptors + ProxyLeader: pass 1 on the new block, pass 2 (the
    // stragglers, the complement of drain i-1's arrivals) on the old one.
    const bool new1 =
        quorum_pass(votes, chosen, window, start_new + j, j, i, false, q);
    if constexpr (kTelemetry) {
      if (new1) count_occupancy(s_occ, votes, window, start_new + j, q.n);
      proposed = prop != 0u;
    }
    newly += new1;
    const bool new2 = quorum_pass(votes, chosen, window, start_old + j, j,
                                  wrap_add(i, -1), true, q);
    if constexpr (kTelemetry) {
      if (new2) count_occupancy(s_occ, votes, window, start_old + j, q.n);
    }
    newly += new2;
    // Replica: execute the previous block.
    const int32_t cmd = commands[start_old + j];
    results[start_old + j] =
        static_cast<int32_t>(static_cast<uint32_t>(cmd) * 3u + 7u);
    cmd_sum = static_cast<uint32_t>(cmd);
    // GC block i-2 so the ring can wrap.
    for (int n = 0; n < q.n; ++n) votes[n * window + start_gc + j] = 0;
    chosen[start_gc + j] = 0;
  }
  newly = block_sum(newly, newly_part);
  cmd_sum = block_sum(cmd_sum, cmds_part);
  if constexpr (kTelemetry) {
    __shared__ uint32_t prop_part[FPX_THREADS / 32];
    proposed = block_sum(proposed, prop_part);
    __syncthreads();  // every lane's occupancy is in s_occ
    for (int t = threadIdx.x; t <= q.n; t += blockDim.x) {
      if (s_occ[t]) atomicAdd(reinterpret_cast<unsigned int*>(&tel[2 + t]),
                              s_occ[t]);
    }
  }
  if (threadIdx.x == 0) {
    if (newly) atomicAdd(reinterpret_cast<unsigned int*>(committed), newly);
    if (cmd_sum) atomicAdd(reinterpret_cast<unsigned int*>(sm_state), cmd_sum);
    if (blockIdx.x == 0) {
      *exec_wm = i >= 1 ? static_cast<int32_t>(static_cast<uint32_t>(i) *
                                               static_cast<uint32_t>(block_size))
                        : 0;
    }
    if constexpr (kTelemetry) {
      unsigned int* const shard = reinterpret_cast<unsigned int*>(&tel[0]);
      if (newly) atomicAdd(shard, newly);
      if (proposed) atomicAdd(reinterpret_cast<unsigned int*>(&tel[1]),
                              proposed);
      // Last block done: this block's `committed` add is ordered before
      // its done-counter bump, so the block that bumps last sees every
      // block's part.
      unsigned int* const done =
          reinterpret_cast<unsigned int*>(&tel[q.n + 21]);
      __threadfence();
      if (atomicAdd(done, 1u) == gridDim.x - 1) {
        const uint32_t total =
            atomicAdd(reinterpret_cast<unsigned int*>(committed), 0u);
        const int32_t lag = static_cast<int32_t>(
            (static_cast<uint32_t>(i) + 1u) *
                static_cast<uint32_t>(block_size) - total);
        bump(&tel[q.n + 3 + lag_bucket(lag)], 1u);
        bump(&tel[q.n + 20], 1u);
        *done = 0u;
      }
    }
  }
}

}  // namespace

extern "C" int fpx_steady_state_step(void* votes, void* chosen,
                                     void* commands, void* results,
                                     void* sm_state, void* committed,
                                     void* exec_wm, long long window,
                                     int block_size, int i, const void* masks,
                                     const void* thresholds, const void* perm,
                                     int n, int g, int combine_any,
                                     int grid_kind, int rows, int cols,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (block_size + FPX_THREADS - 1) / FPX_THREADS;
  steady_state_step_kernel<false><<<grid, FPX_THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(votes), static_cast<uint8_t*>(chosen),
      static_cast<int32_t*>(commands), static_cast<int32_t*>(results),
      static_cast<int32_t*>(sm_state), static_cast<int32_t*>(committed),
      static_cast<int32_t*>(exec_wm), window, block_size, i,
      make_pred(masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
                cols),
      nullptr);
  return cudaGetLastError();
}

// K14: K3's arguments plus the flat telemetry buffer (n + 22 int32).
extern "C" int fpx_steady_state_step_telemetry(
    void* votes, void* chosen, void* commands, void* results,
    void* sm_state, void* committed, void* exec_wm, long long window,
    int block_size, int i, const void* masks, const void* thresholds,
    const void* perm, int n, int g, int combine_any, int grid_kind,
    int rows, int cols, void* tel, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (block_size + FPX_THREADS - 1) / FPX_THREADS;
  const size_t occ_bytes = sizeof(uint32_t) * (static_cast<size_t>(n) + 1);
  steady_state_step_kernel<true><<<grid, FPX_THREADS, occ_bytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(votes), static_cast<uint8_t*>(chosen),
      static_cast<int32_t*>(commands), static_cast<int32_t*>(results),
      static_cast<int32_t*>(sm_state), static_cast<int32_t*>(committed),
      static_cast<int32_t*>(exec_wm), window, block_size, i,
      make_pred(masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
                cols),
      static_cast<int32_t*>(tel));
  return cudaGetLastError();
}
