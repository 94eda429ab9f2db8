// K1 quorum_hit and K2 record_block: the dense half of TpuQuorumChecker.
//
// K1 replaces frankenpaxos_tpu/ops/quorum.py::_check_block (L348) and
// _check_batch (L342), i.e. _predicate_hit (L156) over a vote block
// (_quorum_hit L77, _fused_grid_hit L131): one bool per slot column of an
// [N, B] block of vote bytes. The predicate runs in registers in its
// structure's form (quorum_regs.cuh: one instantiation per acceptor count
// 1 .. 16 for one weighted group, other group counts and each grid; perm
// applied), and a board of more than 16 acceptors takes quorum.cuh's
// runtime loop. On a block whose columns are contiguous and whose rows
// start 16-byte aligned (row stride a multiple of 16), each thread takes
// 16 columns: one 16-byte load per acceptor row and one 16-byte store of
// the 16 results (16 single-byte stores where the output is not aligned
// alike). Every block the synchronous tracker sends has that shape (a
// [N, 64 .. 4096] bucket, or several side by side). The columns before
// the first aligned one (an offset view), the ragged tail and every
// column of a strided view (check_batch's transposed [B, N] rows) take a
// scalar thread each, in the same launch. fpx_quorum_hit_staged runs the
// tracker's whole call (the block up from pinned memory, the launch, the
// hits down into pinned memory, a wait on the stream) in one call; both
// K1 entry points take their arguments as one packed block of int64.
//
// K2 replaces _record_block (L267): one thread per column of the block
// [start, start + B) runs the reference's ring self-reclaim, round max
// with preemption clear, OR-in of live votes, predicate and
// `newly = hit & ~old_chosen & touched` for its column and writes the
// votes, rounds, chosen and owner columns back IN PLACE (JAX donates the
// board; the port updates it).
//
// Bound on the H100: bytes. K1 moves N + 1 bytes per column, K2 about
// 3N + 14, with a few integer operations per byte; at the tracker's
// B = 64 .. 4096 that is under 20 KB, so the launch itself sets K1's time
// (about 1.3 us a launch on the card): the vector path gives a bucket of
// 4096 columns 256 threads. K2 keeps one thread per column; neighbouring
// threads touch neighbouring bytes, so every row read is coalesced.

#include <algorithm>
#include <climits>
#include <cstring>

#include "quorum.cuh"
#include "quorum_regs.cuh"

namespace {

using namespace fpx_regs;

// Columns a thread takes on K1's vector path: one 16-byte load a row.
constexpr int kVec = 16;

// One K1 launch: the block (any strides) and the output, and the
// vector path's extent: columns [head, head + 16 nvec) in vectors (0
// vectors when the block does not take them); out_vec when the output
// is 16-byte aligned at `head` too.
struct Hit {
  const uint8_t* votes;
  long long row_stride, col_stride;
  int b;
  uint8_t* out;
  int head, nvec, out_vec;
};

// kN > 0: the register form (kN acceptors, form kCols); kN = 0: the
// runtime loop, one thread a column.
template <int kN, int kCols>
__global__ void __launch_bounds__(FPX_THREADS)
    quorum_hit_kernel(Hit h, QuorumPred q) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if constexpr (kN == 0) {
    if (t >= h.b) return;
    const uint8_t* col = h.votes + t * h.col_stride;
    h.out[t] = quorum_hit(q, [&](int i) {
      return col[static_cast<long long>(i) * h.row_stride];
    });
  } else {
    const RegPred<kN, kCols> p = reg_pred<kN, kCols>(q);
    long long row[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      row[s] = static_cast<long long>(q.perm[s]) * h.row_stride;
    }
    if (t < h.nvec) {
      const long long c0 = h.head + t * kVec;
      uint32_t w[kN][4];
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        const uint4 x =
            __ldg(reinterpret_cast<const uint4*>(h.votes + row[s] + c0));
        w[s][0] = x.x;
        w[s][1] = x.y;
        w[s][2] = x.z;
        w[s][3] = x.w;
      }
      // Four copies of the predicate (one per word), a loop over a
      // word's bytes: the build stays small, the launch sets the time.
      uint32_t res[4];
#pragma unroll
      for (int word = 0; word < 4; ++word) {
        uint32_t r = 0;
#pragma unroll 1
        for (int byte = 0; byte < 4; ++byte) {
          uint32_t v[kN];
#pragma unroll
          for (int s = 0; s < kN; ++s) {
            v[s] = (w[s][word] >> (8 * byte)) & 0xffu;
          }
          r |= static_cast<uint32_t>(hit_regs(v, p)) << (8 * byte);
        }
        res[word] = r;
      }
      if (h.out_vec) {
        *reinterpret_cast<uint4*>(h.out + c0) =
            make_uint4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          h.out[c0 + k] = static_cast<uint8_t>(res[k / 4] >> (8 * (k % 4)));
        }
      }
      return;
    }
    // Scalar threads: the head's columns, then the tail's.
    const long long k = t - h.nvec;
    const long long j =
        k < h.head ? k : h.head + static_cast<long long>(h.nvec) * kVec +
                             (k - h.head);
    if (j >= h.b) return;
    const uint8_t* col = h.votes + j * h.col_stride;
    uint32_t v[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) v[s] = col[row[s]];
    h.out[j] = hit_regs(v, p);
  }
}

__global__ void record_block_kernel(uint8_t* __restrict__ votes,
                                    int32_t* __restrict__ rounds,
                                    uint8_t* __restrict__ chosen,
                                    int32_t* __restrict__ owner,
                                    long long window,
                                    const uint8_t* __restrict__ block, int b,
                                    int start, int true_start, int vote_round,
                                    uint8_t* __restrict__ newly,
                                    QuorumPred q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const long long c = static_cast<long long>(start) + j;

  bool touched = false;
  for (int i = 0; i < q.n; ++i) {
    touched |= block[static_cast<long long>(i) * b + j] != 0;
  }
  // Ring self-reclaim: claim a column owned by an older slot, drop votes
  // for a slot the column has moved past. slot ids wrap as int32.
  const int32_t slot_id = static_cast<int32_t>(
      static_cast<uint32_t>(true_start) + static_cast<uint32_t>(j));
  const int32_t old_owner = owner[c];
  const bool claim = touched && slot_id > old_owner;
  const bool stale = touched && slot_id < old_owner;
  touched = touched && !stale;
  const int32_t new_owner = claim ? slot_id : old_owner;

  const int32_t old_round = claim ? -1 : rounds[c];
  const int32_t new_round =
      touched ? max(old_round, vote_round) : old_round;
  const bool preempted = new_round > old_round;
  const bool live = touched && vote_round == new_round;
  // The reference ANDs the block with touched and with live as uint8
  // 0/1 masks, so a live vote byte contributes only its low bit.
  const uint8_t keep = live ? 1 : 0;
  for (int i = 0; i < q.n; ++i) {
    uint8_t* cell = votes + static_cast<long long>(i) * window + c;
    uint8_t v = (claim || preempted) ? 0 : *cell;
    v |= block[static_cast<long long>(i) * b + j] & keep;
    *cell = v;
  }
  const bool hit = quorum_hit(q, [&](int i) {
    return votes[static_cast<long long>(i) * window + c];
  });
  const bool old_chosen = claim ? false : chosen[c] != 0;
  newly[j] = hit && !old_chosen && touched;
  chosen[c] = hit || old_chosen;
  rounds[c] = new_round;
  owner[c] = new_owner;
}

inline int blocks_for(int b) { return (b + FPX_THREADS - 1) / FPX_THREADS; }

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

// K1 on `votes` [N, b] (strides in elements) into `out` [b].
cudaError_t launch_quorum_hit(const uint8_t* votes, long long row_stride,
                              long long col_stride, int b, uint8_t* out,
                              QuorumPred q, cudaStream_t stream) {
  if (b <= 0) return cudaSuccess;
  const bool regs = register_form(q);
  Hit h{votes, row_stride, col_stride, b, out, 0, 0, 0};
  if (regs && col_stride == 1 && row_stride % kVec == 0) {
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(votes) %
                                     kVec);
    h.head = std::min((kVec - off) % kVec, b);
    h.nvec = (b - h.head) / kVec;
    h.out_vec = reinterpret_cast<uintptr_t>(out + h.head) % kVec == 0;
  }
  const long long threads =
      h.nvec + (b - static_cast<long long>(h.nvec) * kVec);
  const unsigned grid =
      static_cast<unsigned>((threads + FPX_THREADS - 1) / FPX_THREADS);
  auto go = [&](auto form) {
    using F = decltype(form);
    quorum_hit_kernel<F::n, F::cols><<<grid, FPX_THREADS, 0, stream>>>(h, q);
    return cudaGetLastError();
  };
  return regs ? dispatch_regs(q, go) : go(Form<0, 0>{});
}

// a[first .. first + 8]: masks, thresholds, perm, n, g, combine_any,
// grid_kind, rows, cols.
QuorumPred packed_pred(const long long* a) {
  return make_pred(pointer<const void>(a[0]), pointer<const void>(a[1]),
                   pointer<const void>(a[2]), static_cast<int>(a[3]),
                   static_cast<int>(a[4]), static_cast<int>(a[5]),
                   static_cast<int>(a[6]), static_cast<int>(a[7]),
                   static_cast<int>(a[8]));
}

}  // namespace

// block: votes, row stride, column stride, b, out, the predicate (9),
// device, stream.
extern "C" int fpx_quorum_hit(const void* block) {
  long long a[16];
  std::memcpy(a, block, sizeof a);
  if (a[3] < 0 || a[3] > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = select_device(static_cast<int>(a[14]));
  if (err != cudaSuccess) return err;
  return launch_quorum_hit(pointer<const uint8_t>(a[0]), a[1], a[2],
                           static_cast<int>(a[3]), pointer<uint8_t>(a[4]),
                           packed_pred(a + 5), pointer<CUstream_st>(a[15]));
}

// block: pinned votes [N, b] (contiguous), their device copy, b, device
// out, pinned out, the predicate (9), device, stream. The block up, K1,
// the hits down, then a wait on the stream: the caller's current one, so
// that work the caller queued first (the predicate's tensors) lands
// before the launch reads it.
extern "C" int fpx_quorum_hit_staged(const void* block) {
  long long a[16];
  std::memcpy(a, block, sizeof a);
  const long long b = a[2];
  const QuorumPred q = packed_pred(a + 5);
  if (b < 0 || b > INT_MAX) return cudaErrorInvalidValue;
  const cudaStream_t s = pointer<CUstream_st>(a[15]);
  cudaError_t err = select_device(static_cast<int>(a[14]));
  if (err != cudaSuccess || b == 0) return err;
  void* dev_votes = pointer<void>(a[1]);
  void* dev_out = pointer<void>(a[3]);
  err = cudaMemcpyAsync(dev_votes, pointer<const void>(a[0]),
                        static_cast<size_t>(q.n) * b,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  err = launch_quorum_hit(static_cast<const uint8_t*>(dev_votes), b, 1,
                          static_cast<int>(b), static_cast<uint8_t*>(dev_out),
                          q, s);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(pointer<void>(a[4]), dev_out, static_cast<size_t>(b),
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}

extern "C" int fpx_record_block(void* votes, void* rounds, void* chosen,
                                void* owner, long long window,
                                const void* block, int b, int start,
                                int true_start, int vote_round, void* newly,
                                const void* masks, const void* thresholds,
                                const void* perm, int n, int g,
                                int combine_any, int grid_kind, int rows,
                                int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  record_block_kernel<<<blocks_for(b), FPX_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(votes), static_cast<int32_t*>(rounds),
      static_cast<uint8_t*>(chosen), static_cast<int32_t*>(owner), window,
      static_cast<const uint8_t*>(block), b, start, true_start, vote_round,
      static_cast<uint8_t*>(newly),
      make_pred(masks, thresholds, perm, n, g, combine_any, grid_kind, rows,
                cols));
  return cudaGetLastError();
}
