// K4 record_and_check: the sparse scatter of straggler votes, as a RUN of
// chunks in one launch. Included by quorum.cu, whose staged drain entry
// launches it between K2's runs (a pipelined drain's parts, in order).
//
// Replaces frankenpaxos_tpu/ops/quorum.py::_record_and_check (L214) over
// _apply_sparse_votes (L170), and the pipelined tracker's loop that calls
// it once per chunk of up to 256 votes
// (frankenpaxos_tpu/protocols/multipaxos/quorum_tracker.py, the scatter
// path of the pipelined drain): each chunk is exactly one call of the
// reference's scatter, and the chunks run strictly in order. Duplicate
// lanes inside a chunk each report `newly`; a chunk sees the board the
// chunks before it left (their `chosen` bits). A single call is a run of
// one chunk. The chunks' lane offsets travel in the kernel's parameters.
//
// The chunk body (run_chunk) is shared with K6's run kernel (epoch.cu,
// record_and_check_epochs_run_kernel), which passes its epoch planes'
// predicate where K4 passes its single plane's. Every phase of the
// reference's
// scatter is per column, so a launch's blocks split the COLUMNS: block p
// of P (one per 32 lanes of the largest chunk, at most 8) takes the lanes
// whose column c has c % P == p and runs every chunk on them in order;
// the blocks never meet. Inside a block a chunk's lanes are loaded once
// (each thread's first lane a chunk ahead), and each DISTINCT column gets
// one entry of a table keyed by column (open addressing in shared
// memory): every lane reads its column's owner, round, chosen byte and N
// vote bytes before it looks for the entry (all loads issued before the
// first use), the lane that inserts the entry stores them there, every
// phase works on the entry, and the inserting lane writes it back once.
// The scatter-max phases are atomicMax on the entries, never on the
// board. Six barriers a chunk (the one-block kernel this replaces had
// nine, each phase re-reading the board from global memory):
//   1. lanes: read the column, insert it, owner max (valid ? true : -inf);
//   2. lanes: `mine` (valid, and the column's owner after the max), round
//      max;
//   3. entries: a newer owner reclaims the column (votes 0, round -1,
//      chosen 0); the new round; a newer round preempts (votes 0);
//   4. lanes: a live vote sets its byte to max(byte, 1);
//   5. lanes: hit = mine and the predicate on the entry's votes, newly =
//      hit & ~chosen0, and the entry's chosen;
//   6. entries: written back, and the table cleared for the next chunk.
// The predicate runs on the entry's votes in registers, in the register
// form of the board's structure (quorum_regs.cuh, one instantiation per
// form as K1 and K2; quorum.cuh's runtime loop past 16 acceptors, both of
// its branches: the mask-group count and the fused grid).
//
// JAX's index rules are kept: a negative slot counts from the end; one
// still out of range reads the clamped column and writes nothing (its
// scatters are dropped, and an entry no writing lane names is written
// back unchanged); a negative node is normalised and one still out of
// range records nothing. Padding lanes (valid 0, slot 0) change nothing
// and report nothing (unless column 0's owner is INT32_MIN, which no
// board reaches), so a run takes its lanes unpadded.
//
// Bound on the H100: neither. A 256-lane chunk moves 20 bytes a lane,
// one `newly` byte and (N + 9) bytes per distinct column read and
// written, a few KB; the launch and the chunk's six barriers (each a
// dependent round trip through shared memory) set its time, and a run of
// chunks is one launch, not one a chunk.
#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "quorum.cuh"
#include "quorum_regs.cuh"

namespace fpx_sparse {

using namespace fpx_regs;

// The reference's _NEG_INF32 = -(2**31) + 1.
constexpr int32_t kNegInf32 = -2147483647;
// Threads of each block at most (a chunk of more lanes gives a thread
// several).
constexpr int kRunThreads = 512;
// A launch's blocks, each taking a share of the columns: one for each
// kLanesPerPart lanes of the largest chunk, at most kMaxParts (a power of
// two).
constexpr int kMaxParts = 8;
constexpr int kLanesPerPart = 32;
// A chunk's workspace in shared memory when it fits this many bytes.
constexpr int kWorkSharedBytes = 160 * 1024;
// Chunks of one launch at most: their lane offsets travel in the kernel's
// parameters (1 KB of the 4 KB they may take); a longer run takes more
// launches, in order.
constexpr int kMaxRunChunks = 256;

struct SparseBoard {
  uint8_t* votes;   // [n, window]
  int32_t* rounds;  // [window]
  uint8_t* chosen;  // [window] (bool)
  int32_t* owner;   // [window]
  long long window;
  int n;
};

// One launch: the board, the lanes [5, stride] (slot % window, true
// slot, node, round, valid), `newly` at lane index, the workspace, and
// the chunks [bounds[k], bounds[k + 1]) of this launch.
struct ChunkRun {
  SparseBoard bd;
  const int32_t* lanes;
  long long stride;
  uint8_t* newly;
  uint8_t* work;          // device workspace, one a block (not shared)
  long long work_stride;
  int shared;             // 1: the workspace in shared memory
  int cap;                // the largest chunk (sizes the table)
  int perm_identity;
  int nchunks;
  int bounds[kMaxRunChunks + 1];
};

// A chunk's table: a power of two, at least twice the chunk (so a probe
// ends soon) and at least 32.
__host__ __device__ inline int table_size(int chunk) {
  int h = 32;
  while (h < 2 * chunk) h <<= 1;
  return h;
}

// The workspace's bytes.
inline long long work_bytes(int chunk, int n) {
  const long long h = table_size(chunk);
  return 4 * (5LL * chunk + 5 * h) + chunk + h * (2 + n);
}

// One chunk's lanes and its table of distinct columns.
struct Work {
  int32_t* col;          // [chunk] the column a lane reads (clamped)
  int32_t* tslot;        // [chunk] true slot
  int32_t* node;         // [chunk] normalised node
  int32_t* round;        // [chunk]
  int32_t* entry;        // [chunk] the lane's table entry
  int32_t* key;          // [h] the entry's column, -1 when free
  int32_t* owner;        // [h] owner max, then the column's owner
  int32_t* board_owner;  // [h] the column's owner on the board
  int32_t* round0;       // [h] the column's round (-1 after a reclaim)
  int32_t* rnd;          // [h] round max, then the column's round
  uint8_t* flags;        // [chunk] 1 valid, 2 writes, 4 mine, 8 inserted,
                         // 16 this block's column (the other bits 0 else)
  uint8_t* chosen0;      // [h] chosen (0 after a reclaim)
  uint8_t* hit;          // [h] a writing lane hit
  uint8_t* votes;        // [h, n]
};

__device__ __forceinline__ Work carve(uint8_t* base, int chunk, int h) {
  Work w;
  int32_t* p = reinterpret_cast<int32_t*>(base);
  w.col = p;
  w.tslot = p + chunk;
  w.node = p + 2 * chunk;
  w.round = p + 3 * chunk;
  w.entry = p + 4 * chunk;
  p += 5 * chunk;
  w.key = p;
  w.owner = p + h;
  w.board_owner = p + 2 * h;
  w.round0 = p + 3 * h;
  w.rnd = p + 4 * h;
  uint8_t* q = reinterpret_cast<uint8_t*>(p + 5 * h);
  w.flags = q;
  w.chosen0 = q + chunk;
  w.hit = q + chunk + h;
  w.votes = q + chunk + 2 * h;
  return w;
}

// One lane as packed: slot, true slot, node, round, valid.
struct Lane {
  int32_t slot, tslot, node, round, valid;
};

__device__ __forceinline__ Lane load_lane(const int32_t* lanes,
                                          long long stride, long long j) {
  return Lane{lanes[j], lanes[stride + j], lanes[2 * stride + j],
              lanes[3 * stride + j], lanes[4 * stride + j]};
}

__device__ __forceinline__ void clear_entry(const Work& w, int e) {
  w.key[e] = -1;
  w.owner[e] = INT_MIN;
  w.rnd[e] = INT_MIN;
  w.hit[e] = 0;
}

// A column of the board as a lane reads it: every load issued before
// anything is stored, so the column costs one round trip to memory, not
// N + 3. kN > 0: exactly kN vote rows; kN = 0: the first kHeld rows here,
// the rest read in store_column.
constexpr int kHeld = 16;
template <int kN>
struct Column {
  static constexpr int rows = kN > 0 ? kN : kHeld;
  int32_t owner, round;
  uint8_t chosen;
  uint8_t v[rows];
};

template <int kN>
__device__ __forceinline__ Column<kN> load_column(const SparseBoard& bd,
                                                  int32_t col) {
  Column<kN> c;
  c.owner = bd.owner[col];
  c.round = bd.rounds[col];
  c.chosen = bd.chosen[col];
#pragma unroll
  for (int i = 0; i < Column<kN>::rows; ++i) {
    c.v[i] = (kN > 0 || i < bd.n) ? bd.votes[i * bd.window + col] : 0;
  }
  return c;
}

template <int kN>
__device__ __forceinline__ void store_column(const SparseBoard& bd,
                                             int32_t col,
                                             const Column<kN>& c,
                                             const Work& w, int e) {
  const int n = kN > 0 ? kN : bd.n;
  w.board_owner[e] = c.owner;
  w.round0[e] = c.round;
  w.chosen0[e] = c.chosen;
#pragma unroll
  for (int i = 0; i < Column<kN>::rows; ++i) {
    if (kN > 0 || i < n) w.votes[e * n + i] = c.v[i];
  }
  if constexpr (kN == 0) {
    for (int i = kHeld; i < n; ++i) {
      w.votes[e * n + i] = bd.votes[i * bd.window + col];
    }
  }
}

// Entry e back into the board's column `col`, and the entry cleared:
// every load from the table first, then the stores.
template <int kN>
__device__ __forceinline__ void write_column(const SparseBoard& bd,
                                             int32_t col, const Work& w,
                                             int e) {
  const long long window = bd.window;
  const int n = kN > 0 ? kN : bd.n;
  const int32_t owner = w.owner[e];
  const int32_t round = w.rnd[e];
  const uint8_t chosen = w.chosen0[e] | w.hit[e];
  constexpr int rows = Column<kN>::rows;
  uint8_t v[rows];
#pragma unroll
  for (int i = 0; i < rows; ++i) {
    v[i] = (kN > 0 || i < n) ? w.votes[e * n + i] : 0;
  }
  if constexpr (kN == 0) {
    for (int i = kHeld; i < n; ++i) {
      bd.votes[i * window + col] = w.votes[e * n + i];
    }
  }
  clear_entry(w, e);
  bd.owner[col] = owner;
  bd.rounds[col] = round;
  bd.chosen[col] = chosen;
#pragma unroll
  for (int i = 0; i < rows; ++i) {
    if (kN > 0 || i < n) bd.votes[i * window + col] = v[i];
  }
}

// The register predicate of a form; the runtime loop (kN = 0) holds none
// (a one-acceptor stand-in, never read).
template <int kN, int kCols>
struct PredOf {
  using type = RegPred<kN, kCols>;
};
template <>
struct PredOf<0, 0> {
  using type = RegPred<1, kOneGroup>;
};

// The predicate on an entry's votes: kN > 0 the register form (slot s
// holds acceptor perm[s]), kN = 0 quorum.cuh's runtime loop.
template <int kN, int kCols>
__device__ __forceinline__ bool entry_hit(
    const uint8_t* v, const QuorumPred& q,
    const typename PredOf<kN, kCols>::type& p,
    const int (&perm)[kN > 0 ? kN : 1]) {
  if constexpr (kN == 0) {
    return quorum_hit(q, [&](int i) { return v[i]; });
  } else {
    uint32_t x[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) x[s] = v[perm[s]];
    return hit_regs(x, p);
  }
}

// One chunk of a sparse run, phases 1-6 (the list at the top), on a
// block's share of the columns (those c with c & parts_mask == part):
// lanes [c0, c0 + lanes_here) of `lanes` [5, stride], `mine_first` the
// thread's first lane (loaded ahead), the block's workspace `w` (a table
// of h entries, h = 2^(33 - shift), cleared). `hit(l, votes)` is lane
// l's predicate on its entry's vote bytes; `newly` is written at lane
// index. Shared by K4's run kernel below and K6's (epoch.cu), whose
// predicates differ. kN > 0: boards of exactly kN acceptor rows.
template <int kN, typename Hit>
__device__ __forceinline__ void run_chunk(const SparseBoard& bd,
                                          const Work& w, int h, int shift,
                                          const int32_t* lanes,
                                          long long stride, int c0,
                                          int lanes_here,
                                          const Lane& mine_first, int part,
                                          int parts_mask, uint8_t* newly,
                                          Hit hit) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long window = bd.window;
  const int n = kN > 0 ? kN : bd.n;
  // 1. Lanes: read the column, find its entry (the lane that inserts the
  // entry stores the column there), owner max.
  for (int l = tid; l < lanes_here; l += nt) {
    const Lane in = l == tid ? mine_first : load_lane(lanes, stride, c0 + l);
    long long s = in.slot;
    if (s < 0) s += window;
    const bool writes = s >= 0 && s < window;
    const int32_t col = static_cast<int32_t>(min(max(s, 0LL), window - 1));
    if ((col & parts_mask) != part) {  // another block's column
      w.flags[l] = 0;
      continue;
    }
    // Issued before the insert, so the read overlaps it.
    const Column<kN> column = load_column<kN>(bd, col);
    int32_t node = in.node;
    if (node < 0) node += n;
    uint32_t e = (static_cast<uint32_t>(col) * 0x9E3779B1u) >> shift;
    int32_t prev;
    while ((prev = atomicCAS(&w.key[e], -1, col)) != -1 && prev != col) {
      e = (e + 1) & (h - 1);
    }
    uint8_t f = 16 | (in.valid != 0 ? 1 : 0) | (writes ? 2 : 0);
    if (prev == -1) {
      store_column<kN>(bd, col, column, w, e);
      f |= 8;
    }
    w.col[l] = col;
    w.tslot[l] = in.tslot;
    w.node[l] = node;
    w.round[l] = in.round;
    w.entry[l] = static_cast<int32_t>(e);
    w.flags[l] = f;
    if (writes) {
      atomicMax(&w.owner[e], in.valid != 0 ? in.tslot : kNegInf32);
    }
  }
  __syncthreads();
  // 2. Lanes: `mine` (valid, and the column's owner after the max), round
  // max.
  for (int l = tid; l < lanes_here; l += nt) {
    const uint8_t f = w.flags[l];
    const int e = w.entry[l];  // read only where f is not 0
    const bool mine =
        (f & 1) && w.tslot[l] == max(w.board_owner[e], w.owner[e]);
    if (mine) w.flags[l] = f | 4;
    if (f & 2) atomicMax(&w.rnd[e], mine ? w.round[l] : kNegInf32);
  }
  __syncthreads();
  // 3. Entries, each by the lane that inserted it: a newer owner reclaims
  // the column (round -1, chosen 0, votes 0); the column's new round; a
  // newer round preempts (votes 0).
  for (int l = tid; l < lanes_here; l += nt) {
    if (!(w.flags[l] & 8)) continue;
    const int e = w.entry[l];
    const int32_t owner = max(w.board_owner[e], w.owner[e]);
    const bool reclaimed = owner > w.board_owner[e];
    const int32_t round0 = reclaimed ? -1 : w.round0[e];
    const int32_t rd = max(round0, w.rnd[e]);
    w.owner[e] = owner;
    w.rnd[e] = rd;
    if (reclaimed) w.chosen0[e] = 0;
    if (reclaimed || rd > round0) {
      for (int i = 0; i < n; ++i) w.votes[e * n + i] = 0;
    }
  }
  __syncthreads();
  // 4. Lanes: votes.at[nodes, slots].max(live).
  for (int l = tid; l < lanes_here; l += nt) {
    const int e = w.entry[l];
    const uint8_t f = w.flags[l];
    const int32_t node = w.node[l];
    if ((f & 4) && (f & 2) && w.round[l] == w.rnd[e] && node >= 0 &&
        node < n && w.votes[e * n + node] == 0) {
      w.votes[e * n + node] = 1;
    }
  }
  __syncthreads();
  // 5. Lanes: hit (mine, and the predicate on the entry's votes), newly,
  // the entry's chosen.
  for (int l = tid; l < lanes_here; l += nt) {
    const uint8_t f = w.flags[l];
    if (!(f & 16)) continue;  // another block reports it
    const int e = w.entry[l];
    const bool got = (f & 4) && hit(l, w.votes + e * n);
    newly[c0 + l] = got && w.chosen0[e] == 0;
    if (got && (f & 2)) w.hit[e] = 1;
  }
  __syncthreads();
  // 6. Entries, each by the lane that inserted it: written back once; the
  // table cleared.
  for (int l = tid; l < lanes_here; l += nt) {
    if (w.flags[l] & 8) write_column<kN>(bd, w.col[l], w, w.entry[l]);
  }
  __syncthreads();
}

// K4 on the chunks of `r`, one blockIdx.x a share of the columns.
template <int kN, int kCols>
__global__ void __launch_bounds__(kRunThreads)
    record_and_check_run_kernel(const __grid_constant__ ChunkRun r,
                                QuorumPred q) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  // Each thread's first lane of a chunk is loaded a chunk ahead.
  Lane ahead{};
  if (r.bounds[0] + tid < r.bounds[1]) {
    ahead = load_lane(r.lanes, r.stride, r.bounds[0] + tid);
  }
  typename PredOf<kN, kCols>::type p;
  int perm[kN > 0 ? kN : 1];
  if constexpr (kN > 0) {
    p = reg_pred<kN, kCols>(q);
#pragma unroll
    for (int s = 0; s < kN; ++s) perm[s] = r.perm_identity ? s : q.perm[s];
  }
  const int h = table_size(r.cap);
  const int shift = 32 - __ffs(h) + 1;  // h = 2^(33 - shift)
  const Work w = carve(r.shared ? smem : r.work + blockIdx.x * r.work_stride,
                       r.cap, h);
  for (int e = tid; e < h; e += nt) clear_entry(w, e);
  __syncthreads();
  for (int k = 0; k < r.nchunks; ++k) {
    const int c0 = r.bounds[k];
    const Lane mine_first = ahead;
    if (k + 1 < r.nchunks && r.bounds[k + 1] + tid < r.bounds[k + 2]) {
      ahead = load_lane(r.lanes, r.stride, r.bounds[k + 1] + tid);
    }
    run_chunk<kN>(r.bd, w, h, shift, r.lanes, r.stride, c0,
                  r.bounds[k + 1] - c0, mine_first, blockIdx.x,
                  gridDim.x - 1, r.newly,
                  [&](int, const uint8_t* v) {
                    return entry_hit<kN, kCols>(v, q, p, perm);
                  });
  }
}

// K4's launches for chunks [first, last) of `bounds` (host memory, lane
// offsets into `lanes` [5, stride], nondecreasing), one launch per
// kMaxRunChunks chunks, on `stream`. A workspace too large for shared
// memory is allocated on the stream and freed after the launch. A
// template (Pred is QuorumPred), so that a source that includes this
// header for the chunk body alone (epoch.cu) compiles none of K4's forms.
template <typename Pred>
cudaError_t launch_sparse_run(const SparseBoard& bd, const int32_t* lanes,
                              long long stride, uint8_t* newly,
                              const int32_t* bounds, long long first,
                              long long last, int perm_identity, Pred q,
                              cudaStream_t stream) {
  if (bd.window <= 0 || bd.window > INT_MAX || bd.n <= 0 || stride < 0) {
    return cudaErrorInvalidValue;
  }
  const bool regs = register_form(q);
  for (long long k0 = first; k0 < last; k0 += kMaxRunChunks) {
    const long long k1 = k0 + kMaxRunChunks < last ? k0 + kMaxRunChunks
                                                   : last;
    ChunkRun r;
    r.bd = bd;
    r.lanes = lanes;
    r.stride = stride;
    r.newly = newly;
    r.perm_identity = perm_identity;
    r.nchunks = static_cast<int>(k1 - k0);
    int cap = 0;
    for (long long k = k0; k <= k1; ++k) {
      const int32_t at = bounds[k];
      if (at < 0 || at > stride || (k > k0 && at < bounds[k - 1])) {
        return cudaErrorInvalidValue;
      }
      r.bounds[k - k0] = at;
      if (k > k0) cap = std::max(cap, static_cast<int>(at - bounds[k - 1]));
    }
    if (cap == 0) continue;  // every chunk empty
    r.cap = cap;
    const long long need = work_bytes(cap, bd.n);
    r.shared = need <= kWorkSharedBytes;
    r.work_stride = (need + 15) & ~15LL;
    int threads = 64;
    while (threads < cap && threads < kRunThreads) threads <<= 1;
    int parts = 1;
    while (parts < kMaxParts && parts * kLanesPerPart < cap) parts <<= 1;
    const size_t smem = r.shared ? static_cast<size_t>(need) : 0;
    void* work = nullptr;
    if (!r.shared) {
      cudaError_t err = cudaMallocAsync(
          &work, static_cast<size_t>(r.work_stride * parts), stream);
      if (err != cudaSuccess) return err;
    }
    r.work = static_cast<uint8_t*>(work);
    auto go = [&](auto form) {
      using F = decltype(form);
      auto kernel = record_and_check_run_kernel<F::n, F::cols>;
      if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
      }
      kernel<<<parts, threads, smem, stream>>>(r, q);
      return cudaGetLastError();
    };
    cudaError_t err = regs ? dispatch_regs(q, go) : go(Form<0, 0>{});
    if (work != nullptr) {
      const cudaError_t freed = cudaFreeAsync(work, stream);
      if (err == cudaSuccess) err = freed;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace fpx_sparse
