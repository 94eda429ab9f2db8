// K6 record_and_check_epochs / check_batch_multi and K7 reshape_columns:
// the epoch-segmented and multi-config checkers.
//
// K6 replaces frankenpaxos_tpu/ops/quorum.py::_record_and_check_epochs
// (L237, over _apply_sparse_votes L170) and _check_batch_multi (L359),
// and the tracker's loop over 256-vote chunks that calls it
// (frankenpaxos_tpu/reconfig/tracker.py:161-165):
//
//   * the stateless check (check_batch_multi, below): each row selects
//     plane config_idx[b] of the [K, G, N] masks (a negative index counts
//     from the end, one still out of range is clamped, as JAX's gather
//     does), takes the int32 weighted count against each group, compares
//     with that plane's thresholds and applies its any/all. There is NO
//     grid branch: the reference's multi-config predicate always counts,
//     so a grid plane is counted too (the uint8 OR/AND chain of
//     quorum.cuh would differ on bytes other than 0/1);
//   * record_and_check_epochs_run_kernel: a RUN of chunks of lanes in one
//     launch, each chunk one call of the reference's scatter, strictly in
//     order: duplicates inside a chunk each report `newly`, and a chunk
//     sees the board the chunks before it left (their `chosen` bits). A
//     single call is a run of one chunk.
//
// The chunk body is sparse.cuh's run_chunk, shared with K4 (its design
// and its six barriers a chunk are set out there): the blocks of a launch
// split the COLUMNS (block p of P, one per 32 lanes of a chunk, at most
// 8, takes the columns c with c % P == p and runs every chunk in order on
// them), each chunk's distinct columns get one entry each of a
// shared-memory table, and a lane's epoch plane is
// searchsorted(boundaries, true_slot, side="right") over the int32
// boundaries, its predicate in phase 5.
// JAX's index rules are kept: a negative slot counts from the end, one
// still out of range reads the clamped column and writes nothing (its
// scatters are dropped, and an entry no writing lane names is written
// back unchanged); a negative node is normalised and one still out of
// range records nothing. Padding lanes (valid 0, slot 0) change nothing
// and report nothing, so a run takes its lanes unpadded.
// The [K, G, N] planes, thresholds, any flags and boundaries are copied
// into each block's shared memory once a launch (when they fit 16 KB; one
// round trip), and the workspace (lanes and table) lives there too when
// it fits 160 KB (a chunk of 256 lanes at N = 4 takes about 17 KB); a
// larger chunk's workspace, one a block, is allocated on the stream for
// the launch.
//
// K7 replaces _reshape_columns (L441): out[i, :] = block[cmap[i], :], or
// a zero row where cmap[i] < 0 (an index past the end is clamped, as
// jnp.clip does). It writes a NEW tensor (or the caller's out, which may
// not overlap the block): a permutation in place could read a row
// another thread has already overwritten.
//
// Bound on the H100: K6 moves 20 bytes of lanes and one `newly` byte per
// lane, the planes, and each distinct column's N + 9 bytes read and
// written (about 1.2 KB of columns for a 256-lane chunk): a few
// nanoseconds at 3.35 TB/s, so the launch and the chunks' barriers set
// its time; a run of 48 chunks is one launch, not 48.
// check_batch_multi moves (4N + 5) bytes per row. K7 moves N_old' + N_new
// bytes a column (N_old' the distinct source rows read), bytes-bound at
// 3.35 TB/s: 2.19 us for a [3, 2^20] -> [4, 2^20] board, 0.034 us for the
// epoch board's [3, 2^14], where one launch sets the time. So a thread
// moves a 16-byte word of one output row (a zero row only stores), where
// every row starts on the 16-byte grid (B a multiple of 16, both tensors
// aligned; every board), else 16 bytes one at a time (any B, its tail
// included); a row of the grid's y axis reads its source row from the
// map. The map of up to kMapMax rows (far past any acceptor universe)
// crosses in the call's packed block and reaches the kernel as a
// parameter, so a handover queues no copy ahead of the launch; a longer
// map, or a map already on the card, is read from device memory.

#include <algorithm>
#include <climits>
#include <cstring>

#include "quorum.cuh"
#include "release.cuh"
#include "sparse.cuh"

namespace {

using namespace fpx_sparse;

struct MultiPred {
  const int32_t* masks;       // [k, g, n]
  const int32_t* thresholds;  // [k, g]
  const uint8_t* any;         // [k]
  int k, g, n;
};

// `vote(i)` gives the row's int32 value for universe node i.
template <typename Vote>
__device__ __forceinline__ bool multi_hit(const MultiPred& m, int idx,
                                          Vote vote) {
  if (idx < 0) idx += m.k;
  idx = min(max(idx, 0), m.k - 1);
  const bool any = m.any[idx] != 0;
  bool out = !any;
  for (int gi = 0; gi < m.g; ++gi) {
    const int32_t* mask = m.masks + (static_cast<long long>(idx) * m.g + gi)
                                        * m.n;
    uint32_t count = 0;  // int32 arithmetic, wrapping like XLA's
    for (int i = 0; i < m.n; ++i) {
      count += static_cast<uint32_t>(mask[i]) *
               static_cast<uint32_t>(vote(i));
    }
    const bool sat = static_cast<int32_t>(count) >=
                     m.thresholds[static_cast<long long>(idx) * m.g + gi];
    out = any ? (out || sat) : (out && sat);
  }
  return out;
}

// searchsorted(boundaries, x, side="right") over nondecreasing int32
// boundaries: how many are <= x.
__device__ __forceinline__ int epoch_of(const int32_t* boundaries, int nb,
                                        int32_t x) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (boundaries[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Planes in shared memory when they fit this many bytes.
constexpr int kPlaneSharedBytes = 16384;

inline int plane_bytes(const MultiPred& m, int nb) {
  const long long words =
      static_cast<long long>(m.k) * m.g * m.n + m.k * m.g + nb;
  const long long bytes = 4 * words + m.k;
  return bytes > kPlaneSharedBytes ? -1 : static_cast<int>((bytes + 15) & ~15);
}

// kShared: the workspace in shared memory (after the planes, when those
// are there too), else block p's at `global_work + p * work_stride`.
// Block p of the grid's P (a power of two) takes the columns c with
// c % P == p: every phase is per column, so the blocks never meet, and
// each keeps the chunks' order on its own columns.
template <bool kShared>
__global__ void __launch_bounds__(kRunThreads)
    record_and_check_epochs_run_kernel(SparseBoard bd, const int32_t* lanes,
                                       int b, int chunk,
                                       const int32_t* boundaries, int nb,
                                       MultiPred m, uint8_t* newly,
                                       uint8_t* global_work,
                                       long long work_stride,
                                       int planes_shared) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int part = blockIdx.x, parts_mask = gridDim.x - 1;
  // Each thread's first lane of a chunk is loaded a chunk ahead (the
  // first chunk's while the planes are copied).
  Lane ahead{};
  if (tid < min(chunk, b)) ahead = load_lane(lanes, b, tid);
  uint8_t* base = smem;
  if (planes_shared > 0) {
    // One word of the planes per thread and round, its load before any
    // store (the stores may alias the planes as far as the compiler
    // knows), so the copy costs one round trip to memory, not four.
    const int gn = m.k * m.g * m.n, kg = m.k * m.g, words = gn + kg + nb;
    int32_t* sp = reinterpret_cast<int32_t*>(smem);
    uint8_t* sa = reinterpret_cast<uint8_t*>(sp + words);
    for (int t0 = 0; t0 < max(words, m.k); t0 += nt) {
      const int t = t0 + tid;
      int32_t word = 0;
      uint8_t any = 0;
      if (t < gn) {
        word = m.masks[t];
      } else if (t < gn + kg) {
        word = m.thresholds[t - gn];
      } else if (t < words) {
        word = boundaries[t - gn - kg];
      }
      if (t < m.k) any = m.any[t];
      if (t < words) sp[t] = word;
      if (t < m.k) sa[t] = any;
    }
    m.masks = sp;
    m.thresholds = sp + gn;
    boundaries = sp + gn + kg;
    m.any = sa;
    base += planes_shared;
  }
  const int h = table_size(chunk);
  const int shift = 32 - __ffs(h) + 1;  // h = 2^(33 - shift)
  const Work w = carve(kShared ? base : global_work + part * work_stride,
                       chunk, h);
  for (int e = tid; e < h; e += nt) clear_entry(w, e);
  __syncthreads();

  for (long long first = 0; first < b; first += chunk) {
    const int c0 = static_cast<int>(first);
    const Lane mine_first = ahead;
    if (first + chunk + tid < b) {
      ahead = load_lane(lanes, b, static_cast<int>(first + chunk + tid));
    }
    // The chunk (sparse.cuh); a lane's hit is its epoch plane's
    // predicate on the entry's votes.
    run_chunk<0>(bd, w, h, shift, lanes, b, c0, min(chunk, b - c0),
                 mine_first, part, parts_mask, newly,
                 [&](int l, const uint8_t* v) {
                   return multi_hit(
                       m, epoch_of(boundaries, nb, w.tslot[l]),
                       [&](int i) { return static_cast<int32_t>(v[i]); });
                 });
  }
}

// The longest map K7's packed block carries (ops/quorum.py asks it of
// fpx_reshape_columns_map_max).
constexpr int kMapMax = 64;
constexpr int kReshapeThreads = 256;

struct ColumnMap {
  int32_t src[kMapMax];
};

// kVec: 16-byte words (every row on the grid); kInParams: the map is
// `map`, else `dmap` on the card.
template <bool kVec, bool kInParams>
__global__ void __launch_bounds__(kReshapeThreads)
    reshape_columns_kernel(const uint8_t* __restrict__ block, int n_old,
                           long long b, int n_new, const ColumnMap map,
                           const int32_t* __restrict__ dmap,
                           uint8_t* __restrict__ out) {
  const long long first = (static_cast<long long>(blockIdx.x) *
                           kReshapeThreads + threadIdx.x) * 16;
  if (first >= b) return;
  for (int i = blockIdx.y; i < n_new; i += gridDim.y) {
    const int32_t src = kInParams ? map.src[i] : dmap[i];
    const uint8_t* from =
        block + static_cast<long long>(min(src, n_old - 1)) * b + first;
    uint8_t* to = out + static_cast<long long>(i) * b + first;
    if constexpr (kVec) {
      const uint4 word = src < 0 ? make_uint4(0, 0, 0, 0)
                                 : *reinterpret_cast<const uint4*>(from);
      *reinterpret_cast<uint4*>(to) = word;
    } else {
      const int len = static_cast<int>(min(16LL, b - first));
      uint8_t bytes[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        bytes[k] = src >= 0 && k < len ? from[k] : 0;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k < len) to[k] = bytes[k];
      }
    }
  }
}

MultiPred make_multi(const void* masks, const void* thresholds,
                     const void* any, int k, int g, int n) {
  return MultiPred{static_cast<const int32_t*>(masks),
                   static_cast<const int32_t*>(thresholds),
                   static_cast<const uint8_t*>(any), k, g, n};
}

}  // namespace

namespace {

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

// block: votes, rounds, chosen, owner, window, n, lanes [5, b] (device),
// b, chunk, boundaries, nb, newly (device), masks, thresholds, any, k, g,
// device, stream. A workspace too large for shared memory is allocated
// on the stream and freed after the launch.
cudaError_t run_epochs(const long long* a) {
  const long long window = a[4], b = a[7], chunk = a[8];
  const int n = static_cast<int>(a[5]);
  if (b <= 0) return cudaSuccess;
  if (window <= 0 || window > INT_MAX || b > INT_MAX || chunk <= 0 ||
      chunk > (INT_MAX >> 2) || n <= 0 || a[10] < 0 || a[15] <= 0 ||
      a[16] < 0) {
    return cudaErrorInvalidValue;
  }
  const int c = static_cast<int>(std::min(chunk, b));
  const SparseBoard bd{pointer<uint8_t>(a[0]), pointer<int32_t>(a[1]),
                       pointer<uint8_t>(a[2]), pointer<int32_t>(a[3]), window,
                       n};
  const MultiPred m = make_multi(pointer<const void>(a[12]),
                                 pointer<const void>(a[13]),
                                 pointer<const void>(a[14]),
                                 static_cast<int>(a[15]),
                                 static_cast<int>(a[16]), n);
  const int nb = static_cast<int>(a[10]);
  const int planes = plane_bytes(m, nb);
  const long long need = work_bytes(c, n);
  const bool shared = need <= kWorkSharedBytes;
  int threads = 64;
  while (threads < c && threads < kRunThreads) threads <<= 1;
  int parts = 1;
  while (parts < kMaxParts && parts * kLanesPerPart < c) parts <<= 1;
  const size_t smem = (planes > 0 ? planes : 0) + (shared ? need : 0);
  const cudaStream_t s = pointer<CUstream_st>(a[18]);
  const long long stride = (need + 15) & ~15LL;
  void* work = nullptr;
  if (!shared) {
    cudaError_t err =
        cudaMallocAsync(&work, static_cast<size_t>(stride * parts), s);
    if (err != cudaSuccess) return err;
  }
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<parts, threads, smem, s>>>(
        bd, pointer<const int32_t>(a[6]), static_cast<int>(b), c,
        pointer<const int32_t>(a[9]), nb, m, pointer<uint8_t>(a[11]),
        static_cast<uint8_t*>(work), stride, planes > 0 ? planes : 0);
    return cudaGetLastError();
  };
  if (shared) return go(record_and_check_epochs_run_kernel<true>);
  const cudaError_t err = go(record_and_check_epochs_run_kernel<false>);
  const cudaError_t freed = cudaFreeAsync(work, s);
  return err != cudaSuccess ? err : freed;
}

// --- K6 stateless: check_batch_multi ------------------------------------
//
// The reference's _check_batch_multi (L359) on the Fast Paxos and Fast
// MultiPaxos quorum checks (runs/quorums.py's SpecChecker over a
// MultiConfigQuorumChecker): ONE row a check, [1, 3] at f = 1 and [1, 5]
// at f = 2, one plane of one group. Its bound there is ~20 bytes, so a
// call is the launch plus whatever the kernel waits on; the design takes
// every wait it can off the kernel's path:
//
//   * the planes ride in the launch's parameters (MultiArgs::cells) where
//     they fit, as K7's map does: no global load before the first count;
//   * a host batch (the checkers' rows, written into one reused pinned
//     block by ops/quorum.py::MultiCheck) is read in place through mapped
//     memory, and the answer bytes are written back into the same block;
//     a batch small enough rides in the parameters too (this entry copies
//     it out of the pinned block on the host), so the kernel reads nothing
//     across the host link and only posts its answer bytes there; the
//     call then waits on the staging's own stream, which holds only this
//     call's work (the same as an event at its end), with the GIL
//     released;
//   * a SpecChecker's one 0/1 row (N <= 32) arrives packed, a 32-bit word,
//     and counts as __popc(row & mask) against a plane whose masks are all
//     0 or 1; batches keep int32 rows and the multiply-add, whose wrap
//     stays bit-identical to the reference's (packing a batch's 0/1 rows
//     into words on the host, after a numpy min / max, measured slower
//     than the int32 copy at 256 and 2^16 rows on an H100's host);
//   * every batch takes a thread a row (planes from the parameters, or
//     from the card through the read-only path). A tile form that read a
//     CTA's 256 contiguous rows into shared memory in 16-byte words before
//     the first count was built and measured: at [2^16, 5] it read
//     2.50-2.58 us where a thread a row read 2.24-2.36, in turns, on an
//     H100, so it went.
//
// The form is chosen here, by the packing and by whether the planes and
// the batch fit the parameters. A tensor caller (rows on the card)
// launches on its current stream and does not wait.

// int32 cells a launch carries (a 4 KB parameter block measured ~28 us
// more host time a call on an H100 than mapped reads of the same rows).
constexpr int kParamCells = 32;
constexpr int kMultiThreads = 256;

// `rows`, `cfg` and the planes' three pointers are null where their values
// ride in `cells` (the planes' masks, thresholds and any bytes from cell
// 0, a batch's rows at rows_at and its config indices at cfg_at).
struct MultiArgs {
  const int32_t* rows;
  long long row_stride, col_stride;  // cells
  const int32_t* cfg;
  uint8_t* out;
  const int32_t* masks;
  const int32_t* thr;
  const uint8_t* any;
  int b, n, k, g, rows_at, cfg_at;
  int32_t cells[kParamCells];
};

struct PlaneView {
  const int32_t* masks;
  const int32_t* thr;
  const uint8_t* any;
};

template <bool kBits>
__device__ __forceinline__ PlaneView planes_of(const MultiArgs& a) {
  if (a.masks != nullptr) return PlaneView{a.masks, a.thr, a.any};
  const int kg = a.k * a.g, mcells = kBits ? kg : kg * a.n;
  return PlaneView{a.cells, a.cells + mcells,
                   reinterpret_cast<const uint8_t*>(a.cells + mcells + kg)};
}

__device__ __forceinline__ int plane_index(const MultiArgs& a,
                                           long long j) {
  if (a.k == 1) return 0;  // every index clamps to the one plane
  int idx = a.cfg != nullptr ? a.cfg[j]
                             : a.cells[a.cfg_at + static_cast<int>(j)];
  if (idx < 0) idx += a.k;
  return min(max(idx, 0), a.k - 1);
}

// A plane's value: kCard, the planes on the card, read through the
// read-only path; else from the parameters.
template <bool kCard, typename T>
__device__ __forceinline__ T plane_value(const T* ptr) {
  if constexpr (kCard) {
    return __ldg(ptr);
  } else {
    return *ptr;
  }
}

// One row under plane idx: a 32-bit word (kBits) or `vote(i)` for node i.
template <bool kBits, bool kCard = false, typename Vote>
__device__ __forceinline__ bool plane_hit(const PlaneView& p, int g, int n,
                                          int idx, uint32_t word,
                                          Vote vote) {
  const bool any = plane_value<kCard>(p.any + idx) != 0;
  bool out = !any;
  for (int gi = 0; gi < g; ++gi) {
    const int at = idx * g + gi;
    uint32_t count = 0;  // int32 arithmetic, wrapping like XLA's
    if constexpr (kBits) {
      count = __popc(word &
                     static_cast<uint32_t>(plane_value<kCard>(p.masks + at)));
    } else {
      const int32_t* mask = p.masks + static_cast<long long>(at) * n;
      for (int i = 0; i < n; ++i) {
        count += static_cast<uint32_t>(plane_value<kCard>(mask + i)) *
                 static_cast<uint32_t>(vote(i));
      }
    }
    const bool sat =
        static_cast<int32_t>(count) >= plane_value<kCard>(p.thr + at);
    out = any ? (out || sat) : (out && sat);
  }
  return out;
}

// A thread a row, from memory (any strides) or from the parameters;
// kCard: the planes on the card (else in the parameters).
template <bool kBits, bool kCard>
__global__ void __launch_bounds__(kMultiThreads)
    multi_row_kernel(const __grid_constant__ MultiArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.b) return;
  const PlaneView p = planes_of<kBits>(a);
  const int idx = plane_index(a, j);
  bool hit;
  if constexpr (kBits) {
    const uint32_t word = static_cast<uint32_t>(
        a.rows != nullptr ? a.rows[j * a.row_stride]
                          : a.cells[a.rows_at + j]);
    hit = plane_hit<true, kCard>(p, a.g, a.n, idx, word,
                                 [](int) { return 0; });
  } else if (a.rows != nullptr) {
    const int32_t* row = a.rows + j * a.row_stride;
    const long long cs = a.col_stride;
    hit = plane_hit<false, kCard>(p, a.g, a.n, idx, 0u,
                                  [&](int i) { return row[i * cs]; });
  } else {
    const int32_t* row = a.cells + a.rows_at + j * a.n;
    hit = plane_hit<false, kCard>(p, a.g, a.n, idx, 0u,
                                  [&](int i) { return row[i]; });
  }
  a.out[j] = hit;
}

// The call's fields, every value read from memory: `rows`, `cfg` and
// `out` moved by `delta` (mapped memory), the planes on the card.
void fields(MultiArgs& m, const long long* a, long long delta) {
  m.rows = pointer<const int32_t>(a[0] + delta);
  m.row_stride = a[1];
  m.col_stride = a[2];
  m.cfg = a[5] == 0 ? nullptr : pointer<const int32_t>(a[5] + delta);
  m.out = pointer<uint8_t>(a[6] + delta);
  m.masks = pointer<const int32_t>(a[10]);
  m.thr = pointer<const int32_t>(a[11]);
  m.any = pointer<const uint8_t>(a[12]);
  m.b = static_cast<int>(a[3]);
  m.n = static_cast<int>(a[4]);
  m.k = static_cast<int>(a[13]);
  m.g = static_cast<int>(a[14]);
  m.rows_at = m.cfg_at = 0;
}

// Carry the planes' host cells, and with `host_rows` the batch (its rows
// at any strides, then its indices), in `m`'s parameters; false, `m`
// unchanged, where there are no host cells or they do not fit.
bool carry(MultiArgs& m, const int32_t* host_cells,
           long long ncells, const int32_t* host_rows, long long rs,
           long long cs, const int32_t* host_cfg, bool bits) {
  const long long rc = bits ? 1 : m.n;
  const long long need =
      ncells + (host_rows != nullptr
                    ? m.b * rc + (host_cfg != nullptr ? m.b : 0) : 0);
  if (host_cells == nullptr || ncells < 0 || need > kParamCells) {
    return false;
  }
  std::memcpy(m.cells, host_cells, static_cast<size_t>(ncells) * 4);
  m.masks = m.thr = nullptr;
  m.any = nullptr;
  if (host_rows == nullptr) return true;
  m.rows = nullptr;
  m.rows_at = static_cast<int>(ncells);
  for (long long j = 0; j < m.b; ++j) {
    for (long long i = 0; i < rc; ++i) {
      m.cells[ncells + j * rc + i] = host_rows[j * rs + i * cs];
    }
  }
  if (host_cfg != nullptr) {
    m.cfg = nullptr;
    m.cfg_at = static_cast<int>(ncells + m.b * rc);
    std::memcpy(m.cells + m.cfg_at, host_cfg, static_cast<size_t>(m.b) * 4);
  }
  return true;
}

template <bool kBits>
cudaError_t launch_rows(const MultiArgs& m, cudaStream_t s) {
  const int threads = m.b < kMultiThreads ? ((m.b + 31) & ~31)
                                          : kMultiThreads;
  const int ctas = (m.b + threads - 1) / threads;
  if (m.masks != nullptr) {
    multi_row_kernel<kBits, true><<<ctas, threads, 0, s>>>(m);
  } else {
    multi_row_kernel<kBits, false><<<ctas, threads, 0, s>>>(m);
  }
  return cudaGetLastError();
}

}  // namespace

// K6 stateless, every caller's one entry. block: rows (in the pinned
// block when mapped, else on the card), row stride and col stride
// (cells), b, n, config indices (0 where k == 1), out, flags (1: the rows
// are packed 32-bit words; 2: mapped: rows, indices and out lie in the
// pinned block at `base`, read and written in place, and the call waits
// on `stream`), the planes' host cells (0: none) and their count, the
// planes on the card in the same form (masks, thresholds, any), k, g,
// base, device, stream.
extern "C" int fpx_check_batch_multi_staged(const void* block) {
  long long a[18];
  std::memcpy(a, block, sizeof a);
  const long long b = a[3], n = a[4], k = a[13], g = a[14];
  const bool bits = (a[7] & 1) != 0, mapped = (a[7] & 2) != 0;
  if (b < 0 || b > INT_MAX || n <= 0 || n > INT_MAX || k <= 0 ||
      k > INT_MAX || g < 0 || k * g > INT_MAX || (bits && n > 32) ||
      (mapped && a[15] == 0)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = select_device(static_cast<int>(a[16]));
  if (err != cudaSuccess || b == 0) return err;
  const cudaStream_t s = pointer<CUstream_st>(a[17]);
  long long delta = 0;
  if (mapped) {
    void* dev = nullptr;
    err = cudaHostGetDevicePointer(&dev, pointer<void>(a[15]), 0);
    if (err != cudaSuccess) return err;
    delta = static_cast<long long>(reinterpret_cast<uintptr_t>(dev)) - a[15];
  }
  const auto* host_cells = pointer<const int32_t>(a[8]);
  const long long ncells = a[9];
  auto finish = [&](cudaError_t e) {
    if (e != cudaSuccess || !mapped) return e;
    return cudaStreamSynchronize(s);
  };
  // A thread a row: the planes and, for a mapped batch, its rows and
  // indices ride in the parameters where they fit.
  const auto* host_rows = mapped ? pointer<const int32_t>(a[0]) : nullptr;
  const auto* host_cfg =
      mapped && a[5] != 0 ? pointer<const int32_t>(a[5]) : nullptr;
  auto launch = [&](const MultiArgs& m) {
    return finish(bits ? launch_rows<true>(m, s) : launch_rows<false>(m, s));
  };
  {
    MultiArgs m;
    fields(m, a, delta);
    if (carry(m, host_cells, ncells, host_rows, a[1], a[2], host_cfg,
              bits) ||
        host_rows == nullptr) {
      return launch(m);
    }
  }
  MultiArgs m;
  fields(m, a, delta);
  carry(m, host_cells, ncells, nullptr, 0, 0, nullptr, bits);
  return launch(m);
}

// K6, a run of chunks in one launch (a single call: chunk = b); the
// packed block of run_epochs.
extern "C" int fpx_record_and_check_epochs(const void* block) {
  long long a[19];
  std::memcpy(a, block, sizeof a);
  cudaError_t err = select_device(static_cast<int>(a[17]));
  if (err != cudaSuccess) return err;
  return run_epochs(a);
}

// The tracker's drain in one call: run_epochs's block, then the pinned
// lanes [5, b] and the pinned newly [b], then r, the releases the checker
// held since its last board call (r int32 slots right after the lanes,
// in the same pinned buffer and device copy). The lanes and slots up,
// K5's all-valid form on the slots (release.cuh), the run, newly down,
// then a wait on the stream. The stream is the caller's current one: the
// board is state on the card, and work the caller queued before (K7's
// reshape, the board's fill) must land first.
extern "C" int fpx_record_and_check_epochs_staged(const void* block) {
  long long a[22];
  std::memcpy(a, block, sizeof a);
  const long long b = a[7], held = a[21];
  const cudaStream_t s = pointer<CUstream_st>(a[18]);
  if (held < 0 || held > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = select_device(static_cast<int>(a[17]));
  if (err != cudaSuccess || b <= 0) return err;
  err = cudaMemcpyAsync(pointer<void>(a[6]), pointer<const void>(a[19]),
                        static_cast<size_t>(5 * b + held) * 4,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  const ReleaseBoard bd{pointer<uint8_t>(a[0]), pointer<int32_t>(a[1]),
                        pointer<uint8_t>(a[2]), pointer<int32_t>(a[3]), a[4],
                        static_cast<int>(a[5])};
  err = launch_release_all(bd, pointer<const int32_t>(a[6]) + 5 * b, held,
                           s);
  if (err != cudaSuccess) return err;
  err = run_epochs(a);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(pointer<void>(a[20]), pointer<const void>(a[11]),
                        static_cast<size_t>(b), cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}

extern "C" int fpx_reshape_columns_map_max() { return kMapMax; }

// K7. block: the board's votes [n_old, b], n_old, b, n_new, out
// [n_new, b], the map on the card (0: the map follows the block as n_new
// int32, n_new <= kMapMax), device, stream.
extern "C" int fpx_reshape_columns(const void* packed) {
  long long a[8];
  std::memcpy(a, packed, sizeof a);
  const long long b = a[2], n_new = a[3];
  const int n_old = static_cast<int>(a[1]);
  if (b <= 0 || n_new <= 0) return cudaSuccess;
  if (n_old <= 0 || n_new > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = select_device(static_cast<int>(a[6]));
  if (err != cudaSuccess) return err;
  const auto* block = pointer<const uint8_t>(a[0]);
  auto* out = pointer<uint8_t>(a[4]);
  const auto* dmap = pointer<const int32_t>(a[5]);
  ColumnMap map{};
  if (dmap == nullptr) {
    if (n_new > kMapMax) return cudaErrorInvalidValue;
    std::memcpy(map.src, static_cast<const char*>(packed) + sizeof a,
                static_cast<size_t>(n_new) * 4);
  }
  const long long words = (b + 15) / 16;
  const long long blocks = (words + kReshapeThreads - 1) / kReshapeThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(std::min(n_new, 65535LL)));
  const bool vec = b % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(block) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const cudaStream_t s = pointer<CUstream_st>(a[7]);
  const int nn = static_cast<int>(n_new);
  auto go = [&](auto kernel) {
    kernel<<<grid, kReshapeThreads, 0, s>>>(block, n_old, b, nn, map, dmap,
                                            out);
  };
  if (vec) {
    dmap == nullptr ? go(reshape_columns_kernel<true, true>)
                    : go(reshape_columns_kernel<true, false>);
  } else {
    dmap == nullptr ? go(reshape_columns_kernel<false, true>)
                    : go(reshape_columns_kernel<false, false>);
  }
  return cudaGetLastError();
}
