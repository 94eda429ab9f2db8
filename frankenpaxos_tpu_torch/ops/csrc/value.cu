// K8 safe_values: the Leader's Phase-1 recovery reduction, and K15
// count_matching_replies (below).
//
// Replaces frankenpaxos_tpu/ops/value.py::safe_values (L19): for each
// row of an [S, N] int32 vote_rounds matrix (one row per slot of the
// recovery window, one column per acceptor, NO_VOTE = -1 where the
// acceptor reported no vote), the FIRST column holding the row's
// maximum round (jnp.argmax's tie rule: a strict `>` in column order);
// then has_vote[s] = that round > NO_VOTE and value_id[s] =
// value_ids[s, column]. A row with no vote at all still returns
// value_ids[s, 0] with has_vote false, as the reference does; the caller
// substitutes Noop. int32 extremes compare as they are.
//
// Bound on the H100: bytes. The call moves S * (8N + 5) bytes (both
// matrices read once, one bool and one int32 written per row): 1.90 MB
// at S = 2^16, N = 3, 0.57 us at 3.35 TB/s, about half a launch. So the
// design removes round trips to memory, not bytes: a CTA of 256 threads
// takes a tile of 256 rows, whose rounds and ids are two contiguous runs
// of 256 * N int32. Every thread issues its loads of both runs first
// (16-byte words where both matrices start on the 16-byte grid, else
// N scalar loads a run), then stores them into shared memory; after one
// barrier each thread scans its row there and picks the id from the
// same tile: no load depends on another, where the one-thread-a-row
// form paid two DRAM round trips in series (the scan, then the id at
// its result). The Leader's column counts have a form each (N = 3 for
// f = 1; N = 6 for the 2x3 grid or two groups of three), any other
// N <= kTileCols the generic tile form, and rows wider than that (no
// deployment has them) the wide form: a thread a row read from memory.
// The last tile is ragged (the Leader pads to a power of two, 2^13 and
// 2^16 rows on the benches' paths, but a tensor caller may not): its
// word count and its scalar tail are masked.
//
// fpx_safe_values launches on the caller's stream (the lean call: one
// packed block). fpx_safe_values_staged runs the Leader's recovery whole
// on one pinned block holding both matrices side by side and room for
// the result after them: the kernel reads the matrices in place and
// writes value_id and has_vote there (mapped memory: pinned host memory
// is addressable from the card under unified addressing), then the call
// waits on the staging's own stream (every input comes from the host).
// No copy is queued: on an H100 this measured faster than a copy up and
// a copy down around the launch at 2^13 rows and level at 2^16
// (PERF.md section 7).

#include <cstring>

#include "quorum.cuh"

namespace {

constexpr int32_t kNoVote = -1;
// Rows a CTA (a thread a row), and the widest row the generic tile form
// holds in shared memory (2 * 256 * 16 * 4 = 32 KB).
constexpr int kRows = 256;
constexpr int kTileCols = 16;

// KN > 0: N known at compile time; 0: the generic form (N <= kTileCols).
template <int KN, bool kVec>
__global__ void __launch_bounds__(kRows)
    safe_values_kernel(const int32_t* __restrict__ rounds,
                       const int32_t* __restrict__ ids, long long s,
                       int n_rt, uint8_t* __restrict__ has_vote,
                       int32_t* __restrict__ value_id) {
  constexpr int kCols = KN > 0 ? KN : kTileCols;
  // 16-byte words of one run a thread loads at most.
  constexpr int kWords = (kCols + 3) / 4;
  __shared__ __align__(16) int32_t tile[2][kRows * kCols];
  const int n = KN > 0 ? KN : n_rt;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        s - row0));
  const int elems = rows * n;
  const int32_t* r = rounds + row0 * n;
  const int32_t* v = ids + row0 * n;
  const int t = threadIdx.x;
  if constexpr (kVec) {
    // row0 * n * 4 bytes is a multiple of 1024: every tile starts on the
    // grid when the matrices do.
    const int words = elems >> 2;
    const int tail = elems & 3;
    const int4* r4 = reinterpret_cast<const int4*>(r);
    const int4* v4 = reinterpret_cast<const int4*>(v);
    int4 a[kWords], b[kWords];
    int32_t ta = 0, tb = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = t + k * kRows;
      if (w < words) {
        a[k] = r4[w];
        b[k] = v4[w];
      }
    }
    if (t < tail) {
      ta = r[4 * words + t];
      tb = v[4 * words + t];
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int w = t + k * kRows;
      if (w < words) {
        reinterpret_cast<int4*>(tile[0])[w] = a[k];
        reinterpret_cast<int4*>(tile[1])[w] = b[k];
      }
    }
    if (t < tail) {
      tile[0][4 * words + t] = ta;
      tile[1][4 * words + t] = tb;
    }
  } else {
    int32_t a[kCols], b[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int e = t + k * kRows;
      if (e < elems) {
        a[k] = r[e];
        b[k] = v[e];
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int e = t + k * kRows;
      if (e < elems) {
        tile[0][e] = a[k];
        tile[1][e] = b[k];
      }
    }
  }
  __syncthreads();
  if (t >= rows) return;
  const int32_t* mine = tile[0] + t * n;
  int best = 0;
  int32_t best_round = mine[0];
#pragma unroll
  for (int c = 1; c < kCols; ++c) {
    if (KN == 0 && c >= n) break;
    const int32_t x = mine[c];
    if (x > best_round) {
      best_round = x;
      best = c;
    }
  }
  has_vote[row0 + t] = best_round > kNoVote;
  value_id[row0 + t] = tile[1][t * n + best];
}

// Rows wider than kTileCols: a thread a row, its rounds read in column
// order, then the id at the winning column.
__global__ void safe_values_wide_kernel(const int32_t* __restrict__ rounds,
                                        const int32_t* __restrict__ ids,
                                        long long s, int n,
                                        uint8_t* __restrict__ has_vote,
                                        int32_t* __restrict__ value_id) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= s) return;
  const int32_t* r = rounds + row * n;
  int best = 0;
  int32_t best_round = r[0];
  for (int c = 1; c < n; ++c) {
    const int32_t x = r[c];
    if (x > best_round) {
      best_round = x;
      best = c;
    }
  }
  has_vote[row] = best_round > kNoVote;
  value_id[row] = ids[row * n + best];
}

// K15 count_matching_replies: replaces frankenpaxos_tpu/ops/value.py::
// count_matching_replies (L40). For each row of [S, N] int32 reply ids
// under a [S, N] bool mask, the count of column c is the number of valid
// columns whose id equals column c's (c included) when c is valid, and 0
// when it is not -- the row sums of the reference's masked pairwise
// equality matrix. The winner is the FIRST column with the highest count
// (jnp.argmax's tie rule: strict `>` in column order); the outputs are
// its id and its count, so a row with no valid column gives ids[s, 0]
// and 0. One thread per row does the O(N^2) compares in registers.
// Bound on the H100: bytes, 5 * S * N read and 8 * S written (0.64 us at
// S = 2^16, N = 5); N^2 compares a row stay far below the operation
// rate for the small N of a reply set.
__global__ void count_matching_replies_kernel(
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long s, int n, int32_t* __restrict__ modal,
    int32_t* __restrict__ count) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= s) return;
  const int32_t* r = ids + row * n;
  const uint8_t* v = valid + row * n;
  int best = 0;
  int32_t best_count = -1;
  for (int c = 0; c < n; ++c) {
    int32_t k = 0;
    if (v[c]) {
      const int32_t id = r[c];
      for (int d = 0; d < n; ++d) k += (v[d] != 0) & (r[d] == id);
    }
    if (k > best_count) {
      best_count = k;
      best = c;
    }
  }
  modal[row] = r[best];
  count[row] = best_count;
}


bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

template <int KN>
void launch_tile(bool vec, unsigned blocks, const int32_t* rounds,
                 const int32_t* ids, long long s, int n, uint8_t* has_vote,
                 int32_t* value_id, cudaStream_t stream) {
  if (vec) {
    safe_values_kernel<KN, true><<<blocks, kRows, 0, stream>>>(
        rounds, ids, s, n, has_vote, value_id);
  } else {
    safe_values_kernel<KN, false><<<blocks, kRows, 0, stream>>>(
        rounds, ids, s, n, has_vote, value_id);
  }
}

// K8 on [s, n] rows; the form by n and the matrices' alignment.
cudaError_t launch_safe_values(const int32_t* rounds, const int32_t* ids,
                               long long s, int n, uint8_t* has_vote,
                               int32_t* value_id, cudaStream_t stream) {
  if (s <= 0) return cudaSuccess;
  if (n <= 0) return cudaErrorInvalidValue;
  const long long blocks = (s + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  const bool vec = aligned16(rounds) && aligned16(ids);
  if (n == 3) {
    launch_tile<3>(vec, grid, rounds, ids, s, n, has_vote, value_id, stream);
  } else if (n == 6) {
    launch_tile<6>(vec, grid, rounds, ids, s, n, has_vote, value_id, stream);
  } else if (n <= kTileCols) {
    launch_tile<0>(vec, grid, rounds, ids, s, n, has_vote, value_id, stream);
  } else {
    safe_values_wide_kernel<<<grid, kRows, 0, stream>>>(
        rounds, ids, s, n, has_vote, value_id);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fpx_count_matching_replies(const void* ids, const void* valid,
                                          long long s, int n, void* modal,
                                          void* count, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long blocks = (s + FPX_THREADS - 1) / FPX_THREADS;
  count_matching_replies_kernel<<<static_cast<unsigned>(blocks), FPX_THREADS,
                                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(valid), s,
      n, static_cast<int32_t*>(modal), static_cast<int32_t*>(count));
  return cudaGetLastError();
}

// block: rounds, ids, s, n, has_vote, value_id, device, stream.
extern "C" int fpx_safe_values(const void* block) {
  long long a[8];
  std::memcpy(a, block, sizeof a);
  const cudaError_t err = select_device(static_cast<int>(a[6]));
  if (err != cudaSuccess) return err;
  return launch_safe_values(pointer<const int32_t>(a[0]),
                            pointer<const int32_t>(a[1]), a[2],
                            static_cast<int>(a[3]), pointer<uint8_t>(a[4]),
                            pointer<int32_t>(a[5]),
                            pointer<CUstream_st>(a[7]));
}

// The Leader's recovery in one call. block: the pinned block (rounds
// [rows, n], ids [rows, n], then value_id [rows] int32 and has_vote
// [rows] bytes), rows, n, device, stream. The kernel reads and writes
// the block in place; returns after the stream has drained.
extern "C" int fpx_safe_values_staged(const void* block) {
  long long a[5];
  std::memcpy(a, block, sizeof a);
  const long long rows = a[1];
  const int n = static_cast<int>(a[2]);
  cudaError_t err = select_device(static_cast<int>(a[3]));
  if (err != cudaSuccess || rows <= 0) return err;
  if (n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = pointer<CUstream_st>(a[4]);
  void* mapped = nullptr;
  err = cudaHostGetDevicePointer(&mapped, pointer<void>(a[0]), 0);
  if (err != cudaSuccess) return err;
  const int32_t* rounds = static_cast<const int32_t*>(mapped);
  int32_t* value_id = static_cast<int32_t*>(mapped) + 2 * rows * n;
  err = launch_safe_values(rounds, rounds + rows * n, rows, n,
                           reinterpret_cast<uint8_t*>(value_id + rows),
                           value_id, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}
