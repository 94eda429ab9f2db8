// K5 release: the column reset of GC'd slots, the sparse half of
// TpuQuorumChecker besides K4 (whose run kernel, sparse.cuh, quorum.cu
// builds: the pipelined drain's staged entry launches it between K2's
// runs).
//
// K5 replaces frankenpaxos_tpu/ops/quorum.py::_release (L327): reset the
// column of each released slot to votes 0, round -1, chosen false, owner
// -1. Two forms. The general one (release_kernel, fpx_release), one
// thread per lane, reads a `valid` array: every writer of a column stores
// the same reset values, so duplicate lanes need no order; JAX's `.set`
// leaves the order of a duplicate slot's lanes unspecified when their
// valid flags differ, and here the column is reset when ANY of its lanes
// is valid. The all-valid one (release.cuh's release_all_kernel, a group
// of threads a lane, no `valid` array) is every checker's: the checkers
// hold released slots on the host until their next board call, whose
// staged entry (K2's run and the drain's run in quorum.cu, K6's run in
// epoch.cu) launches it ahead of its own launch; every other board call
// first flushes them through fpx_release_staged (the slots up from pinned
// memory, the launch, a wait on the caller's stream), and fpx_release_all
// takes device tensors.
//
// Bound on the H100: neither. A few slots a watermark advance, 4096 lanes
// in the prewarm: at most about 100 KB, far below a microsecond of memory
// time, so the launch sets its time.

#include <climits>
#include <cstring>

#include "quorum.cuh"
#include "release.cuh"

namespace {

__global__ void release_kernel(ReleaseBoard bd, const int32_t* slots,
                               const uint8_t* valid, int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b || !valid[j]) return;
  long long s = slots[j];
  // JAX normalises a negative index and drops one out of range.
  if (s < 0) s += bd.window;
  if (s < 0 || s >= bd.window) return;
  for (int i = 0; i < bd.n; ++i) bd.votes[i * bd.window + s] = 0;
  bd.rounds[s] = -1;
  bd.chosen[s] = 0;
  bd.owner[s] = -1;
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

// a[0 .. 5]: votes, rounds, chosen, owner, window, n.
ReleaseBoard release_board(const long long* a) {
  return ReleaseBoard{pointer<uint8_t>(a[0]), pointer<int32_t>(a[1]),
                      pointer<uint8_t>(a[2]), pointer<int32_t>(a[3]), a[4],
                      static_cast<int>(a[5])};
}

}  // namespace

// block: votes, rounds, chosen, owner, window, n, slots, valid, b,
// device, stream.
extern "C" int fpx_release(const void* block) {
  long long a[11];
  std::memcpy(a, block, sizeof a);
  const long long b = a[8];
  if (b < 0 || b > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = select_device(static_cast<int>(a[9]));
  if (err != cudaSuccess || b == 0) return err;
  release_kernel<<<static_cast<unsigned>((b + FPX_THREADS - 1) /
                                         FPX_THREADS),
                   FPX_THREADS, 0, pointer<CUstream_st>(a[10])>>>(
      release_board(a), pointer<const int32_t>(a[6]),
      pointer<const uint8_t>(a[7]), static_cast<int>(b));
  return cudaGetLastError();
}

// The all-valid form on device slots: votes, rounds, chosen, owner,
// window, n, slots, r, device, stream.
extern "C" int fpx_release_all(const void* block) {
  long long a[10];
  std::memcpy(a, block, sizeof a);
  if (a[7] < 0 || a[7] > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = select_device(static_cast<int>(a[8]));
  if (err != cudaSuccess) return err;
  return launch_release_all(release_board(a), pointer<const int32_t>(a[6]),
                            a[7], pointer<CUstream_st>(a[9]));
}

// A checker's held releases flushed ahead of a board call that carries
// none: votes, rounds, chosen, owner, window, n, pinned slots, their
// device copy, r, device, stream. The slots up, the all-valid form, then
// a wait on the stream (the caller's current one, which the board call
// that follows uses too), so that the pinned slots are free again.
extern "C" int fpx_release_staged(const void* block) {
  long long a[11];
  std::memcpy(a, block, sizeof a);
  const long long r = a[8];
  if (r < 0 || r > INT_MAX) return cudaErrorInvalidValue;
  const cudaStream_t s = pointer<CUstream_st>(a[10]);
  cudaError_t err = select_device(static_cast<int>(a[9]));
  if (err != cudaSuccess || r == 0) return err;
  err = cudaMemcpyAsync(pointer<void>(a[7]), pointer<const void>(a[6]),
                        static_cast<size_t>(r) * 4, cudaMemcpyHostToDevice,
                        s);
  if (err != cudaSuccess) return err;
  err = launch_release_all(release_board(a), pointer<const int32_t>(a[7]), r,
                           s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}
