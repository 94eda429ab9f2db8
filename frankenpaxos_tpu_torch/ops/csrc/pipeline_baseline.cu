// The PINNED pre-telemetry drain: a verbatim copy of K3
// (ops/csrc/pipeline.cu) as it stood before the telemetry plane, with
// its C entry point renamed to fpx_steady_state_step_baseline so that a
// later edit of pipeline.cu cannot move the baseline arm of
// bench/telemetry_overhead.py. Replaces the JAX package's pinned copy,
// frankenpaxos_tpu/bench/pipeline_baseline.py::steady_state_step (L76),
// run_steps_from (L201). Do NOT edit the code below: it is the
// measurement. If the live drain's semantics change on purpose, re-pin
// a fresh copy and say so in the overhead bench's methodology string.
//
// --- verbatim from ops/csrc/pipeline.cu --------------------------------
// K3 steady_state_step: one drain of the device-resident MultiPaxos
// steady-state pipeline in ONE launch.
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

__global__ void steady_state_step_kernel(
    uint8_t* __restrict__ votes, uint8_t* __restrict__ chosen,
    int32_t* __restrict__ commands, int32_t* __restrict__ results,
    int32_t* sm_state, int32_t* committed, int32_t* exec_wm,
    long long window, int block_size, int i, QuorumPred q) {
  __shared__ uint32_t newly_part[FPX_THREADS / 32];
  __shared__ uint32_t cmds_part[FPX_THREADS / 32];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t newly = 0, cmd_sum = 0;
  if (j < block_size) {
    const int num_blocks = static_cast<int>(window / block_size);
    const long long b = block_size;
    const long long start_new = floor_mod(i, num_blocks) * b;
    const long long start_old = floor_mod(wrap_add(i, -1), num_blocks) * b;
    const long long start_gc = floor_mod(wrap_add(i, -2), num_blocks) * b;

    // Leader: propose lanes*7 + i*13 + 1.
    commands[start_new + j] = static_cast<int32_t>(
        static_cast<uint32_t>(j) * 7u + static_cast<uint32_t>(i) * 13u + 1u);
    // Acceptors + ProxyLeader: pass 1 on the new block, pass 2 (the
    // stragglers, the complement of drain i-1's arrivals) on the old one.
    newly += quorum_pass(votes, chosen, window, start_new + j, j, i, false, q);
    newly += quorum_pass(votes, chosen, window, start_old + j, j,
                         wrap_add(i, -1), true, q);
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
  if (threadIdx.x == 0) {
    if (newly) atomicAdd(reinterpret_cast<unsigned int*>(committed), newly);
    if (cmd_sum) atomicAdd(reinterpret_cast<unsigned int*>(sm_state), cmd_sum);
    if (blockIdx.x == 0) {
      *exec_wm = i >= 1 ? static_cast<int32_t>(static_cast<uint32_t>(i) *
                                               static_cast<uint32_t>(block_size))
                        : 0;
    }
  }
}

}  // namespace

extern "C" int fpx_steady_state_step_baseline(
    void* votes, void* chosen, void* commands, void* results,
    void* sm_state, void* committed, void* exec_wm, long long window,
    int block_size, int i, const void* masks, const void* thresholds,
    const void* perm, int n, int g, int combine_any, int grid_kind,
    int rows, int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (block_size + FPX_THREADS - 1) / FPX_THREADS;
  steady_state_step_kernel<<<grid, FPX_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(votes), static_cast<uint8_t*>(chosen),
      static_cast<int32_t*>(commands), static_cast<int32_t*>(results),
      static_cast<int32_t*>(sm_state), static_cast<int32_t*>(committed),
      static_cast<int32_t*>(exec_wm), window, block_size, i,
      make_pred(masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
                cols));
  return cudaGetLastError();
}
