// K1 quorum_hit, K2 record_block and K4 record_and_check: the board
// kernels of TpuQuorumChecker.
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
// K2 replaces _record_block (L267): for each column of a block [start,
// start + B) the reference's ring self-reclaim, round max with
// preemption clear, OR-in of live votes, predicate and
// `newly = hit & ~old_chosen & touched`, written back IN PLACE (JAX
// donates the board; the port updates it). One launch takes a RUN of
// blocks (record_block_run_kernel, one blockIdx.y a block; the table of
// board column, true start, width, staged column and round travels in
// the kernel's parameters), which the reference applies in order: the
// blocks of one launch are column-disjoint modulo the window, and the
// host starts a new launch at a block that overlaps one before it. A
// thread takes one column: every global load of it is started before the
// first is used (the block's rows, the board's rows, owner, rounds,
// chosen), the new column is built in registers and the predicate runs
// in its register form on those registers (quorum_regs.cuh, as K1; the
// runtime loop past 16 acceptors), and each array is stored once.
// fpx_record_block_run_staged runs a run of dense blocks whole: the
// pinned in-block up, K5's all-valid form on the releases the checker
// held (release.cuh), the run, newly down into pinned memory and an event
// recorded, without waiting; fpx_event_wait waits for the event with the
// GIL released.
//
// K4 replaces _record_and_check (L214) over _apply_sparse_votes (L170):
// sparse.cuh's run kernel, a run of chunks a launch (see there).
// fpx_record_and_check_run takes device lanes; fpx_board_run_staged runs
// a pipelined drain whole in ONE call: an ordered list of segments, each
// a K2 run of dense blocks or a K4 run of sparse chunks, after one copy
// up of the pinned in-block (held releases, the staged dense block, the
// sparse lanes) and K5 on the held releases, then one copy down of both
// kinds of `newly` and an event, without waiting.
//
// Bound on the H100: bytes. K1 moves N + 1 bytes per column, K2 about
// 3N + 19, with a few integer operations per byte; at the trackers'
// B = 64 .. 4096 that is under 100 KB, so the launch and the chain of
// dependent memory round trips set the time (about 1.3 us a launch on
// the card): K1's vector path gives a bucket of 4096 columns 256
// threads; K2 keeps a thread a column (see run_column). K4: sparse.cuh.

#include <algorithm>
#include <climits>
#include <cstring>

#include "quorum.cuh"
#include "quorum_regs.cuh"
#include "release.cuh"
#include "sparse.cuh"

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

// --- K2: a run of dense blocks ---------------------------------------------

// Blocks of one K2 launch at most: the table travels in the kernel's
// parameters (1.3 KB of the 4 KB they may take), and the entry
// starts another launch past it.
constexpr int kMaxRunBlocks = 64;
// Fields of a row of the host table: board column, true start, width,
// staged column, round, and 1 where the block starts a new launch.
constexpr int kRunFields = 6;

struct RunBlock {
  int col;         // board column of the block's first column
  int true_start;  // the slot of that column (int32)
  int width;
  int at;          // the block's first column in the staged block / newly
  int round;
};

// One launch: the board, the staged [n, stride] block rows, `newly` at
// the staged columns, and the launch's blocks (blockIdx.y picks one).
struct Run {
  uint8_t* votes;
  int32_t* rounds;
  uint8_t* chosen;
  int32_t* owner;
  long long window;
  const uint8_t* blocks;
  long long stride;
  uint8_t* newly;
  int perm_identity;  // perm[s] == s: the rows need no lookup
  RunBlock blk[kMaxRunBlocks];
};

// A column's ring self-reclaim, round max and preemption (the
// reference's _record_block L288-304), from whether the block has a vote
// byte for it.
struct Step {
  bool claim, clear, live, touched;
  int32_t owner, round;
};

__device__ __forceinline__ Step column_step(bool touched, int32_t slot_id,
                                            int32_t old_owner,
                                            int32_t round_now,
                                            int32_t vote_round) {
  Step st;
  // Claim a column owned by an older slot; drop votes for a slot the
  // column has moved past.
  st.claim = touched && slot_id > old_owner;
  const bool stale = touched && slot_id < old_owner;
  st.touched = touched && !stale;
  st.owner = st.claim ? slot_id : old_owner;
  const int32_t old_round = st.claim ? -1 : round_now;
  st.round = st.touched ? max(old_round, vote_round) : old_round;
  st.clear = st.claim || st.round > old_round;  // reclaimed or preempted
  st.live = st.touched && vote_round == st.round;
  return st;
}

// One column a thread: every load started first (the block's N bytes
// through the read-only cache, the board's N bytes, owner, round,
// chosen), the new column built in registers, the predicate in its
// register form on those registers, each array stored once. (Several
// columns a thread, with 16-byte accesses, measured slower at every
// width: the chain of per-column work a thread runs grows with them,
// and at these sizes that chain, not the bytes, sets the time.)
template <int kN, int kCols>
__device__ __forceinline__ void run_column(const Run& r, const RunBlock& b,
                                           const RegPred<kN, kCols>& p,
                                           const long long (&row_b)[kN],
                                           const long long (&row_v)[kN],
                                           int j) {
  const long long c = static_cast<long long>(b.col) + j;
  const long long s = static_cast<long long>(b.at) + j;
  uint32_t blk[kN], v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    blk[i] = __ldg(r.blocks + row_b[i] + s);
    v[i] = r.votes[row_v[i] + c];
  }
  const int32_t own = r.owner[c], rnd = r.rounds[c];
  const bool ch = r.chosen[c] != 0;
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) any |= blk[i];
  const Step st = column_step(
      any != 0,
      static_cast<int32_t>(static_cast<uint32_t>(b.true_start) +
                           static_cast<uint32_t>(j)),
      own, rnd, b.round);
  const uint32_t keep = st.live ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = (st.clear ? 0u : v[i]) | (blk[i] & keep);
  const bool hit = hit_regs(v, p);
  const bool old_chosen = !st.claim && ch;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    r.votes[row_v[i] + c] = static_cast<uint8_t>(v[i]);
  }
  r.newly[s] = hit && !old_chosen && st.touched;
  r.chosen[c] = hit || old_chosen;
  r.rounds[c] = st.round;
  r.owner[c] = st.owner;
}

// Boards of more than kMaxRegN acceptors: quorum.cuh's runtime loop on
// the new column, computed from the board's old bytes and the block's
// (the board is written after the predicate).
__device__ __forceinline__ void run_runtime(const Run& r, const RunBlock& b,
                                            const QuorumPred& q, int j) {
  const long long c = static_cast<long long>(b.col) + j;
  const long long s = static_cast<long long>(b.at) + j;
  const int32_t own = r.owner[c], rnd = r.rounds[c];
  const bool ch = r.chosen[c] != 0;
  bool any = false;
  for (int i = 0; i < q.n; ++i) any |= r.blocks[i * r.stride + s] != 0;
  const Step st = column_step(
      any,
      static_cast<int32_t>(static_cast<uint32_t>(b.true_start) +
                           static_cast<uint32_t>(j)),
      own, rnd, b.round);
  const uint8_t keep = st.live ? 1 : 0;
  auto vote = [&](int i) -> uint8_t {
    const uint8_t old = st.clear ? 0 : r.votes[i * r.window + c];
    return old | (r.blocks[i * r.stride + s] & keep);
  };
  const bool hit = quorum_hit(q, vote);
  for (int i = 0; i < q.n; ++i) r.votes[i * r.window + c] = vote(i);
  const bool old_chosen = !st.claim && ch;
  r.newly[s] = hit && !old_chosen && st.touched;
  r.chosen[c] = hit || old_chosen;
  r.rounds[c] = st.round;
  r.owner[c] = st.owner;
}

// K2 (the reference's _record_block L267) on a run of blocks, one
// blockIdx.y a block, a thread a column. kN = 0: the runtime loop.
template <int kN, int kCols>
__global__ void __launch_bounds__(FPX_THREADS)
    record_block_run_kernel(const __grid_constant__ Run r, QuorumPred q) {
  const RunBlock& b = r.blk[blockIdx.y];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b.width) return;
  if constexpr (kN == 0) {
    run_runtime(r, b, q, j);
  } else {
    const RegPred<kN, kCols> p = reg_pred<kN, kCols>(q);
    long long row_b[kN], row_v[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const long long node = r.perm_identity ? s : q.perm[s];
      row_b[s] = node * r.stride;
      row_v[s] = node * r.window;
    }
    run_column<kN, kCols>(r, b, p, row_b, row_v, j);
  }
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

// K2's launches for the table's blocks (`table` [nb, kRunFields] in host
// memory; `r` carries the board, the staged block and newly): a new
// launch where a row's flag says (a block that overlaps a column of the
// launch before it, modulo the window: the blocks must be applied in
// order) or past kMaxRunBlocks.
cudaError_t launch_run(Run& r, const int32_t* table, long long nb,
                       QuorumPred q, cudaStream_t stream) {
  if (nb <= 0) return cudaSuccess;
  const bool regs = register_form(q);
  for (long long first = 0; first < nb;) {
    long long last = first + 1;
    while (last < nb && last - first < kMaxRunBlocks &&
           table[last * kRunFields + 5] == 0) {
      ++last;
    }
    long long width = 1;
    for (long long k = first; k < last; ++k) {
      const int32_t* row = table + k * kRunFields;
      RunBlock& b = r.blk[k - first];
      b = RunBlock{row[0], row[1], row[2], row[3], row[4]};
      if (b.col < 0 || b.width < 0 || b.at < 0 ||
          b.col + static_cast<long long>(b.width) > r.window ||
          b.at + static_cast<long long>(b.width) > r.stride) {
        return cudaErrorInvalidValue;
      }
      width = std::max(width, static_cast<long long>(b.width));
    }
    const dim3 grid(
        static_cast<unsigned>((width + FPX_THREADS - 1) / FPX_THREADS),
        static_cast<unsigned>(last - first));
    auto go = [&](auto form) {
      using F = decltype(form);
      record_block_run_kernel<F::n, F::cols>
          <<<grid, FPX_THREADS, 0, stream>>>(r, q);
      return cudaGetLastError();
    };
    const cudaError_t err = regs ? dispatch_regs(q, go) : go(Form<0, 0>{});
    if (err != cudaSuccess) return err;
    first = last;
  }
  return cudaSuccess;
}

// a[0 .. 5]: votes, rounds, chosen, owner, window, n.
Run make_run(const long long* a, const uint8_t* blocks, long long stride,
             uint8_t* newly, long long perm_identity) {
  Run r;
  r.votes = pointer<uint8_t>(a[0]);
  r.rounds = pointer<int32_t>(a[1]);
  r.chosen = pointer<uint8_t>(a[2]);
  r.owner = pointer<int32_t>(a[3]);
  r.window = a[4];
  r.blocks = blocks;
  r.stride = stride;
  r.newly = newly;
  r.perm_identity = perm_identity != 0;
  return r;
}

// A staged run's call: the board, the predicate, the segments (kind 0 a
// K2 run of table rows [first, last), kind 1 a K4 run of chunks [first,
// last)), and the pinned in-block / out-block with their device copies.
struct Staged {
  long long a[6];  // votes, rounds, chosen, owner, window, n
  long long perm_identity;
  QuorumPred q;
  const int32_t* segs;
  long long nseg;
  const int32_t* table;
  long long nb;
  const int32_t* bounds;
  long long nchunks;
  const void* host_in;
  uint8_t* dev_in;
  long long held, dense_off, stride, lanes_off, lanes;
  uint8_t* dev_out;
  void* host_out;
  long long newly_off, out_bytes;
  long long event;
  cudaStream_t stream;
};

// The in-block up, K5's all-valid form on the held slots, each segment's
// launch in order, `out_bytes` of newly down into pinned memory, then the
// event (if any) is recorded; it does not wait.
cudaError_t run_staged(const Staged& st) {
  const long long n = st.a[5];
  if (st.a[4] <= 0 || st.a[4] > INT_MAX || n != st.q.n || st.nseg < 0 ||
      st.nb < 0 || st.nchunks < 0 || st.held < 0 || st.held > INT_MAX ||
      st.stride < 0 || st.stride > INT_MAX || st.lanes < 0 ||
      st.lanes > INT_MAX || st.dense_off < 4 * st.held ||
      st.dense_off % 16 != 0 ||
      (st.lanes > 0 && (st.lanes_off < st.dense_off + n * st.stride ||
                        st.lanes_off % 16 != 0)) ||
      st.newly_off < st.stride ||
      (st.lanes > 0 && st.newly_off + st.lanes > st.out_bytes)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = st.stream;
  const size_t in_bytes = static_cast<size_t>(
      st.lanes > 0 ? st.lanes_off + 20 * st.lanes
                   : (st.nb > 0 ? st.dense_off + n * st.stride
                                : 4 * st.held));
  cudaError_t err = cudaSuccess;
  if (in_bytes) {
    err = cudaMemcpyAsync(st.dev_in, st.host_in, in_bytes,
                          cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
  }
  const ReleaseBoard rb{pointer<uint8_t>(st.a[0]), pointer<int32_t>(st.a[1]),
                        pointer<uint8_t>(st.a[2]), pointer<int32_t>(st.a[3]),
                        st.a[4], static_cast<int>(n)};
  err = launch_release_all(rb, reinterpret_cast<const int32_t*>(st.dev_in),
                           st.held, s);
  if (err != cudaSuccess) return err;
  Run r = make_run(st.a, st.dev_in + st.dense_off, st.stride, st.dev_out,
                   st.perm_identity);
  const fpx_sparse::SparseBoard bd{rb.votes, rb.rounds, rb.chosen, rb.owner,
                                   rb.window, rb.n};
  for (long long k = 0; k < st.nseg; ++k) {
    const int32_t kind = st.segs[3 * k], first = st.segs[3 * k + 1],
                  last = st.segs[3 * k + 2];
    if (kind == 0 && 0 <= first && first <= last && last <= st.nb) {
      err = launch_run(r, st.table + first * kRunFields, last - first, st.q,
                       s);
    } else if (kind == 1 && 0 <= first && first <= last &&
               last <= st.nchunks) {
      err = fpx_sparse::launch_sparse_run(
          bd, reinterpret_cast<const int32_t*>(st.dev_in + st.lanes_off),
          st.lanes, st.dev_out + st.newly_off, st.bounds, first, last,
          static_cast<int>(st.perm_identity), st.q, s);
    } else {
      err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  if (st.out_bytes > 0) {
    err = cudaMemcpyAsync(st.host_out, st.dev_out,
                          static_cast<size_t>(st.out_bytes),
                          cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return err;
  }
  if (st.event) return cudaEventRecord(pointer<CUevent_st>(st.event), s);
  return cudaSuccess;
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

// K2 on device tensors: block votes, rounds, chosen, owner, window, n, the
// host table [nb, 6] (see launch_run), nb, the staged block [n, stride]
// (device), stride, newly [stride] (device), perm identity, the predicate
// (9), device, stream. A single record_block call is a run of one block.
extern "C" int fpx_record_block_run(const void* block) {
  long long a[23];
  std::memcpy(a, block, sizeof a);
  if (a[4] <= 0 || a[4] > INT_MAX || a[9] < 0 || a[9] > INT_MAX ||
      a[5] != a[15]) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[21]));
  if (err != cudaSuccess) return err;
  Run r = make_run(a, pointer<const uint8_t>(a[8]), a[9],
                   pointer<uint8_t>(a[10]), a[11]);
  return launch_run(r, pointer<const int32_t>(a[6]), a[7],
                    packed_pred(a + 12), pointer<CUstream_st>(a[22]));
}

// A run of dense blocks in one call, with the releases the checker held
// since its last board call: board (6), the host table, nb, the pinned
// in-block and its device copy (the r held slots as int32 at offset 0,
// the staged [n, stride] block at `blocks offset`), r, blocks offset,
// stride, device newly, pinned newly, the bytes of newly to copy down,
// perm identity, the predicate (9), an event (0: none), device, stream.
// The drain's run (run_staged) with one dense segment: the in-block up,
// K5's all-valid form on the held slots, K2's run, newly down into pinned
// memory, then the event is recorded; it does not wait. All on the
// caller's current stream, behind the work queued there (K7's reshapes).
extern "C" int fpx_record_block_run_staged(const void* block) {
  long long a[29];
  std::memcpy(a, block, sizeof a);
  cudaError_t err = select_device(static_cast<int>(a[27]));
  if (err != cudaSuccess) return err;
  const int32_t seg[3] = {0, 0, static_cast<int32_t>(
      std::min<long long>(std::max<long long>(a[7], 0), INT_MAX))};
  Staged st{};
  std::memcpy(st.a, a, sizeof st.a);
  st.perm_identity = a[16];
  st.q = packed_pred(a + 17);
  st.segs = seg;
  st.nseg = a[7] > 0 ? 1 : 0;
  st.table = pointer<const int32_t>(a[6]);
  st.nb = a[7];
  st.host_in = pointer<const void>(a[8]);
  st.dev_in = pointer<uint8_t>(a[9]);
  st.held = a[10];
  st.dense_off = a[11];
  st.stride = a[12];
  st.dev_out = pointer<uint8_t>(a[13]);
  st.host_out = pointer<void>(a[14]);
  st.newly_off = a[12];
  st.out_bytes = a[15];
  st.event = a[26];
  st.stream = pointer<CUstream_st>(a[28]);
  return run_staged(st);
}

// An event for a staged run: a[0] device, a[1] the address of an int64
// that receives the handle. Timing off: it orders, it does not time.
extern "C" int fpx_event_create(const void* block) {
  long long a[2];
  std::memcpy(a, block, sizeof a);
  cudaError_t err = select_device(static_cast<int>(a[0]));
  if (err != cudaSuccess) return err;
  cudaEvent_t e = nullptr;
  err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
  if (err == cudaSuccess) {
    *pointer<long long>(a[1]) =
        static_cast<long long>(reinterpret_cast<uintptr_t>(e));
  }
  return err;
}

// Wait for an event (a[0]); called with the GIL released.
extern "C" int fpx_event_wait(const void* block) {
  long long a[1];
  std::memcpy(a, block, sizeof a);
  return cudaEventSynchronize(pointer<CUevent_st>(a[0]));
}

extern "C" int fpx_event_destroy(const void* block) {
  long long a[1];
  std::memcpy(a, block, sizeof a);
  return cudaEventDestroy(pointer<CUevent_st>(a[0]));
}

// K4 on device lanes: votes, rounds, chosen, owner, window, n, lanes
// [5, stride], stride, the host chunk bounds [nchunks + 1] (lane offsets,
// nondecreasing), nchunks, newly [stride] (device), perm identity, the
// predicate (9), device, stream. A single record_and_check call is a run
// of one chunk.
extern "C" int fpx_record_and_check_run(const void* block) {
  long long a[23];
  std::memcpy(a, block, sizeof a);
  if (a[7] < 0 || a[7] > INT_MAX || a[9] < 0 || a[5] != a[15]) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[21]));
  if (err != cudaSuccess) return err;
  const fpx_sparse::SparseBoard bd{
      pointer<uint8_t>(a[0]), pointer<int32_t>(a[1]), pointer<uint8_t>(a[2]),
      pointer<int32_t>(a[3]), a[4], static_cast<int>(a[5])};
  return fpx_sparse::launch_sparse_run(
      bd, pointer<const int32_t>(a[6]), a[7], pointer<uint8_t>(a[10]),
      pointer<const int32_t>(a[8]), 0, a[9], static_cast<int>(a[11]),
      packed_pred(a + 12), pointer<CUstream_st>(a[22]));
}

// A pipelined drain in one call. block: the board (6), perm identity, the
// predicate (9), the host segment table [nseg, 3] (kind: 0 a K2 run of
// table rows [first, last), 1 a K4 run of chunks [first, last)), nseg,
// K2's host table [nb, 6] (see launch_run), nb, the host chunk bounds
// [nchunks + 1] (lane offsets), nchunks, the pinned in-block and its
// device copy (the r held slots as int32 at offset 0, the staged
// [n, stride] block at `dense offset`, the lanes [5, lanes] at `lanes
// offset`), r, dense offset, stride, lanes offset, lanes, the device out
// and the pinned out (the dense newly [stride] at 0, the lanes' newly at
// `newly offset`), newly offset, the bytes of out to copy down, an event
// (0: none), device, stream. run_staged: the in-block up, K5's all-valid
// form on the held slots, each segment's launch in order, both newly
// down into pinned memory, then the event is recorded; it does not wait.
// All on the caller's current stream, behind the work queued there.
extern "C" int fpx_board_run_staged(const void* block) {
  long long a[36];
  std::memcpy(a, block, sizeof a);
  cudaError_t err = select_device(static_cast<int>(a[34]));
  if (err != cudaSuccess) return err;
  Staged st{};
  std::memcpy(st.a, a, sizeof st.a);
  st.perm_identity = a[6];
  st.q = packed_pred(a + 7);
  st.segs = pointer<const int32_t>(a[16]);
  st.nseg = a[17];
  st.table = pointer<const int32_t>(a[18]);
  st.nb = a[19];
  st.bounds = pointer<const int32_t>(a[20]);
  st.nchunks = a[21];
  st.host_in = pointer<const void>(a[22]);
  st.dev_in = pointer<uint8_t>(a[23]);
  st.held = a[24];
  st.dense_off = a[25];
  st.stride = a[26];
  st.lanes_off = a[27];
  st.lanes = a[28];
  st.dev_out = pointer<uint8_t>(a[29]);
  st.host_out = pointer<void>(a[30]);
  st.newly_off = a[31];
  st.out_bytes = a[32];
  st.event = a[33];
  st.stream = pointer<CUstream_st>(a[35]);
  return run_staged(st);
}
