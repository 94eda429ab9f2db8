// K8 safe_values: the Leader's Phase-1 recovery reduction, and K15
// count_matching_replies (below).
//
// Replaces frankenpaxos_tpu/ops/value.py::safe_values (L19): for each
// row of an [S, N] int32 vote_rounds matrix (one row per slot of the
// recovery window, one column per acceptor, NO_VOTE = -1 where the
// acceptor reported no vote), the FIRST column holding the row's
// maximum round (jnp.argmax's tie rule); then has_vote[s] = that round
// > NO_VOTE and value_id[s] = value_ids[s, column]. A row with no vote
// at all still returns value_ids[s, 0] with has_vote false, as the
// reference does; the caller substitutes Noop.
//
// One thread per row scans its N (3 or 6) rounds in column order with a
// strict `>`, which keeps the first maximum. Bound on the H100: bytes.
// The call moves S * (8N + 5) bytes (both matrices read once, one bool
// and one int32 written per row), 1.90 MB at S = 2^16, N = 3: 0.57 us
// at 3.35 TB/s, below a launch. The row-per-thread reads are strided by
// N ints, so a warp touches 32 * N consecutive ints per column step;
// at these sizes the launch, not the access pattern, sets the time.

#include "quorum.cuh"

namespace {

constexpr int32_t kNoVote = -1;

__global__ void safe_values_kernel(const int32_t* __restrict__ rounds,
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
    const int32_t v = r[c];
    if (v > best_round) {
      best_round = v;
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

extern "C" int fpx_safe_values(const void* rounds, const void* ids,
                               long long s, int n, void* has_vote,
                               void* value_id, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long blocks = (s + FPX_THREADS - 1) / FPX_THREADS;
  safe_values_kernel<<<static_cast<unsigned>(blocks), FPX_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rounds), static_cast<const int32_t*>(ids),
      s, n, static_cast<uint8_t*>(has_vote), static_cast<int32_t*>(value_id));
  return cudaGetLastError();
}
