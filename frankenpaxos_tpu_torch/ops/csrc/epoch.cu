// K6 record_and_check_epochs / check_batch_multi and K7 reshape_columns:
// the epoch-segmented and multi-config checkers.
//
// K6 replaces frankenpaxos_tpu/ops/quorum.py::_record_and_check_epochs
// (L237, over _apply_sparse_votes L170) and _check_batch_multi (L359),
// and the tracker's loop over 256-vote chunks that calls it
// (frankenpaxos_tpu/reconfig/tracker.py:161-165):
//
//   * check_batch_multi_kernel, one thread per row: select plane
//     config_idx[b] of the [K, G, N] masks (a negative index counts from
//     the end, one still out of range is clamped, as JAX's gather does),
//     take the int32 weighted count of the row against each group,
//     compare with that plane's thresholds and apply its any/all. There
//     is NO grid branch: the reference's multi-config predicate always
//     counts, so a grid plane is counted too (the uint8 OR/AND chain of
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

__global__ void check_batch_multi_kernel(const int32_t* __restrict__ present,
                                         long long row_stride,
                                         long long col_stride, int b,
                                         const int32_t* __restrict__ idx,
                                         uint8_t* __restrict__ out,
                                         MultiPred m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const int32_t* row = present + static_cast<long long>(j) * row_stride;
  out[j] = multi_hit(m, idx[j], [&](int i) {
    return row[static_cast<long long>(i) * col_stride];
  });
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

extern "C" int fpx_check_batch_multi(const void* present,
                                     long long row_stride,
                                     long long col_stride, int b,
                                     const void* config_idx, void* out,
                                     const void* masks,
                                     const void* thresholds,
                                     const void* combine_any, int k, int g,
                                     int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  check_batch_multi_kernel<<<(b + FPX_THREADS - 1) / FPX_THREADS,
                             FPX_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(present), row_stride, col_stride, b,
      static_cast<const int32_t*>(config_idx), static_cast<uint8_t*>(out),
      make_multi(masks, thresholds, combine_any, k, g, n));
  return cudaGetLastError();
}

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

}  // namespace

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
