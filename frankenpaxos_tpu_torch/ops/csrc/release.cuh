// K5's all-valid form: reset the vote-board columns of released slots.
//
// The counterpart of frankenpaxos_tpu/ops/quorum.py::_release (L327) when
// every lane is valid, which is how every checker releases (the slots of
// a watermark advance, taken % window on the host). It reads no `valid`
// array, and each lane's column is spread over a group of threads (the
// next power of two of N + 3, at most 32): thread f of a lane's group
// resets field f of the column (vote row f < N, then the round to -1,
// chosen to false, the owner to -1; fields past the group loop by its
// size), so that a lane's stores go out side by side from one warp
// instruction instead of one after another from one thread (the reset is
// a chain of scattered stores; four lanes a thread measured slower than
// one). Every writer of a column stores the same values, so duplicate
// lanes need no order. A slot outside [0, window) follows JAX's index
// rules as the general form does (sparse.cu): a negative one counts from
// the end, one still out of range is dropped.
//
// The checkers hold their released slots on the host until their next
// board call, and the staged entries of that call (K2's run in quorum.cu,
// K6's run in epoch.cu) launch this kernel ahead of their own launch on
// the same stream; every other board call flushes them first through
// sparse.cu's fpx_release_staged. So the board sees the same sequence of
// resets and updates as with an immediate release, in one launch for all
// the releases between two board calls.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kReleaseThreads = 128;

// The board's four arrays (each source names its own board struct).
struct ReleaseBoard {
  uint8_t* votes;   // [n, window]
  int32_t* rounds;  // [window]
  uint8_t* chosen;  // [window] (bool)
  int32_t* owner;   // [window]
  long long window;
  int n;
};

// 2^shift threads a lane.
__global__ void __launch_bounds__(kReleaseThreads)
    release_all_kernel(ReleaseBoard bd, const int32_t* __restrict__ slots,
                       int r, int shift) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long j = t >> shift;
  if (j >= r) return;
  long long c = __ldg(slots + j);
  if (c < 0) c += bd.window;
  if (c < 0 || c >= bd.window) return;
  const int fields = bd.n + 3;
  for (int f = static_cast<int>(t & ((1 << shift) - 1)); f < fields;
       f += 1 << shift) {
    if (f < bd.n) {
      bd.votes[f * bd.window + c] = 0;
    } else if (f == bd.n) {
      bd.rounds[c] = -1;
    } else if (f == bd.n + 1) {
      bd.chosen[c] = 0;
    } else {
      bd.owner[c] = -1;
    }
  }
}

// K5's all-valid form on `r` device slots, on `stream` (nothing when r is
// 0).
inline cudaError_t launch_release_all(const ReleaseBoard& bd,
                                      const int32_t* slots, long long r,
                                      cudaStream_t stream) {
  if (r <= 0) return cudaSuccess;
  int shift = 0;
  while ((1 << shift) < bd.n + 3 && shift < 5) ++shift;
  const long long threads = r << shift;
  const unsigned grid = static_cast<unsigned>(
      (threads + kReleaseThreads - 1) / kReleaseThreads);
  release_all_kernel<<<grid, kReleaseThreads, 0, stream>>>(
      bd, slots, static_cast<int>(r), shift);
  return cudaGetLastError();
}
