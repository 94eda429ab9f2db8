// K12 quorum_watermark and K13 contiguous_prefix_length: the watermark
// reductions of the GC plane.
//
// K12 replaces frankenpaxos_tpu/ops/watermark.py::quorum_watermark (L17;
// quorum_watermark_vector, L30, calls it on the transposed matrix). For
// each row of n int32 watermarks it returns element `n - q` of the row
// sorted ascending: the largest w that at least q of the row reach. The
// index follows JAX's take_along_axis rules exactly: `n - q` is int32
// arithmetic (it wraps), a negative index counts from the end once, an
// index still outside [0, n) yields the fill value INT32_MIN, and a row
// of n = 0 yields 0 (JAX's gather from an empty axis). q is one scalar
// or one int32 per row.
//
// One warp per row, 8 rows per 256-thread block. Lane j holds elements j,
// j + 32, ... of the row (ceil(n / 32) registers, read in place with the
// element stride, so the vector form reads the transposed [n, depth]
// matrix's columns without a copy), and counts, for each value v it
// holds, the row's elements below v and at or below v by broadcasting
// the row through __shfl_sync: n steps per lane, not n^2. The value of
// the element whose [less, less_equal) holds idx is the answer, whatever
// the ties (every such element has the same value); __ballot_sync picks
// the lowest such lane, which writes it. Rows up to 1024 wide sit in
// registers (ceil(n / 32) <= 32 per lane); a wider row is taken in
// tiles of 1024 against the whole row read again by chunks of 32. Bound
// on the H100: bytes (B * (4n + 4)); at the protocol's [2, 3] one
// launch, not the work, sets the time. fpx_quorum_watermark_staged runs
// the GC roles' whole vector call (the int32 matrix up from pinned
// memory, the launch, the [depth] result down into pinned memory, a
// wait on the stream) in one call. Both K12 entry points take their
// arguments as one packed block of int64, as K18's do.
//
// K13 replaces ops/watermark.py::contiguous_prefix_length (L38):
// sum(cumprod(present.astype(int32))) along the last axis. Inputs other
// than 0/1 enter the product as they are ([2, 3, 1, 0] gives 2+6+6 = 14),
// signed types sign-extend and int64 keeps its low 32 bits, as
// astype(int32) does; products and sum wrap as int32 (computed in
// uint32). An empty last axis gives 0. Bound: bytes, the prefix through
// its first zero read once and one int32 written per row; at the paths'
// shapes one launch and one round trip to memory set the time. The form
// is chosen in C (prefix_form, named in Python by
// ops/watermark.py::prefix_form) from the row length and the element
// stride:
//   * thread (L <= 16: the smoke's [4096, 3]): a thread a row, every
//     load issued at once, then the (product, sum) fold in registers;
//   * warp (16 < L <= 512: [1024, 40]): a warp a row, each lane 16
//     consecutive elements folded into (product, sum), a shuffle scan
//     combines the lanes' pairs in order ((P, S) before (p, s) is
//     (P p, S + P s), associative mod 2^32);
//   * cta (L > 512: libbench's [4096], the all-true [64, 100003]): a
//     512-thread CTA a row (a run of rows past kCtaGridMax), tile by tile.
//     Where the element stride is 1 the tiles are aligned 16-byte words,
//     one load each (a row that starts off the 16-byte grid reads its
//     head word, and every row its tail word, element by element): one
//     word a thread where the row fits (libbench's [4096]: one tile),
//     else four (32 KB of a byte row); strided rows take scalar loads,
//     eight elements a thread. Every thread issues its loads for the
//     tile first (and the next tile's before the barrier), then reduces
//     its elements to two indices: its first zero and its first element
//     outside {0, 1} (one SIMD compare a 32-bit word of bytes or
//     halves). A __reduce_min_sync per warp, one barrier and a second
//     __reduce_min_sync over the warps' minima give the tile's.
//     Where no element outside {0, 1} comes before the first zero (every
//     0/1 row, libbench's bool row), the answer is the first zero's
//     index, or L: the loop stops at the tile that holds the first zero.
//     Otherwise the same launch scans (product, sum) pairs from that tile
//     on (a warp reduction in order, then the warps' totals in order
//     through shared memory) and stops once the product is 0.
// fpx_contiguous_prefix_length takes one packed block of int64, as K12's
// entries; fpx_contiguous_prefix_form returns the form its block would
// launch, without launching.

#include <algorithm>
#include <climits>
#include <cstring>
#include <type_traits>

#include "quorum.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

constexpr int kRowsPerBlock = FPX_THREADS / 32;

// Adds, for each value v[t] a lane holds, the elements below it and at
// or below it among the first m lanes' `mine`.
template <int PER>
__device__ __forceinline__ void count_chunk(int32_t mine, int m,
                                            const int32_t (&v)[PER],
                                            int (&less)[PER],
                                            int (&less_equal)[PER]) {
  for (int k = 0; k < m; ++k) {
    const int32_t u = __shfl_sync(kFullWarp, mine, k);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      less[t] += u < v[t];
      less_equal[t] += u <= v[t];
    }
  }
}

template <int PER>
__global__ void quorum_watermark_kernel(const int32_t* __restrict__ w,
                                        long long rows, int n,
                                        long long row_stride,
                                        long long elem_stride,
                                        const int32_t* __restrict__ q,
                                        int q_scalar,
                                        int32_t* __restrict__ out) {
  const long long row = (blockIdx.x * static_cast<long long>(blockDim.x)
                         + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform over the warp
  if (n == 0) {
    if (lane == 0) out[row] = 0;
    return;
  }
  const int32_t qv = q != nullptr ? q[row] : q_scalar;
  int32_t idx = static_cast<int32_t>(static_cast<uint32_t>(n)
                                     - static_cast<uint32_t>(qv));
  if (idx < 0) idx += n;  // idx >= INT_MIN and n > 0: no overflow
  if (idx < 0 || idx >= n) {
    if (lane == 0) out[row] = INT_MIN;
    return;
  }
  const int32_t* r = w + row * row_stride;
  for (long long base = 0; base < n; base += 32 * PER) {
    int32_t v[PER];
    int less[PER], less_equal[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const long long e = base + 32 * t + lane;
      v[t] = e < n ? r[e * elem_stride] : 0;
      less[t] = 0;
      less_equal[t] = 0;
    }
    if (n <= 32 * PER) {  // one tile: the row is in the lanes' registers
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        if (32 * t < n) {
          count_chunk<PER>(v[t], min(32, n - 32 * t), v, less, less_equal);
        }
      }
    } else {
      for (long long c = 0; c < n; c += 32) {
        const long long e = c + lane;
        const int32_t u = e < n ? r[e * elem_stride] : 0;
        count_chunk<PER>(u, static_cast<int>(min(32LL, n - c)), v, less,
                         less_equal);
      }
    }
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const long long e = base + 32 * t + lane;
      const bool hit = e < n && less[t] <= idx && idx < less_equal[t];
      const unsigned ballot = __ballot_sync(kFullWarp, hit);
      if (ballot != 0) {
        if (lane == __ffs(ballot) - 1) out[row] = v[t];
        return;
      }
    }
  }
}

template <int PER>
void launch_watermark(const void* w, long long rows, int n,
                      long long row_stride, long long elem_stride,
                      const void* q, int q_scalar, void* out,
                      cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quorum_watermark_kernel<PER><<<static_cast<unsigned>(blocks), FPX_THREADS,
                                 0, stream>>>(
      static_cast<const int32_t*>(w), rows, n, row_stride, elem_stride,
      static_cast<const int32_t*>(q), q_scalar, static_cast<int32_t*>(out));
}

cudaError_t quorum_watermark(const void* w, long long rows, int n,
                             long long row_stride, long long elem_stride,
                             const void* q, int q_scalar, void* out,
                             cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  if (n <= 32) {
    launch_watermark<1>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 64) {
    launch_watermark<2>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 128) {
    launch_watermark<4>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 256) {
    launch_watermark<8>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                        out, s);
  } else if (n <= 512) {
    launch_watermark<16>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                         out, s);
  } else {
    launch_watermark<32>(w, rows, n, row_stride, elem_stride, q, q_scalar,
                         out, s);
  }
  return cudaGetLastError();
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

// K13's forms (prefix_form) and their sizes.
enum PrefixForm {
  kPrefixThread = 0,
  kPrefixWarp = 1,
  kPrefixCtaScalar = 2,
  kPrefixCtaVector = 3
};
constexpr int kThreadMaxLength = 16;
constexpr int kWarpPerLane = 16;
constexpr int kWarpMaxLength = 32 * kWarpPerLane;
constexpr int kCtaThreads = 512;
constexpr int kCtaWarps = kCtaThreads / 32;
// 16-byte chunks (vector) or elements (scalar) a thread loads a tile; a
// row that fits one tile of one chunk a thread takes that tile.
constexpr int kCtaVectorChunks = 4;
constexpr int kCtaScalarChunks = 8;
// CTAs of a launch: four per SM of the H100; more rows loop.
constexpr long long kCtaGridMax = 4 * 132;
constexpr int kNoIndex = INT_MAX;

int prefix_form(long long length, long long elem_stride) {
  if (length <= kThreadMaxLength) return kPrefixThread;
  if (length <= kWarpMaxLength) return kPrefixWarp;
  return elem_stride == 1 ? kPrefixCtaVector : kPrefixCtaScalar;
}

// astype(int32): sign- or zero-extend, keep the low 32 bits.
template <typename T>
__device__ __forceinline__ uint32_t as_u32(T v) {
  return static_cast<uint32_t>(static_cast<long long>(v));
}

template <typename T>
__global__ void prefix_thread_kernel(const T* __restrict__ x, long long rows,
                                     int length, long long row_stride,
                                     long long elem_stride,
                                     int32_t* __restrict__ out) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= rows) return;
  const T* r = x + row * row_stride;
  uint32_t v[kThreadMaxLength];
#pragma unroll
  for (int e = 0; e < kThreadMaxLength; ++e) {
    v[e] = e < length ? as_u32(r[e * elem_stride]) : 0u;
  }
  uint32_t p = 1, s = 0;
#pragma unroll
  for (int e = 0; e < kThreadMaxLength; ++e) {
    p *= v[e];  // past the row: 0, which adds nothing
    s += p;
  }
  out[row] = static_cast<int32_t>(s);
}

template <typename T>
__global__ void prefix_warp_kernel(const T* __restrict__ x, long long rows,
                                   int length, long long row_stride,
                                   long long elem_stride,
                                   int32_t* __restrict__ out) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x)
                          + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // uniform over the warp
  const T* r = x + warp * row_stride;
  const int first = lane * kWarpPerLane;
  uint32_t v[kWarpPerLane];
#pragma unroll
  for (int j = 0; j < kWarpPerLane; ++j) {
    v[j] = first + j < length ? as_u32(r[(first + j) * elem_stride]) : 0u;
  }
  uint32_t p = 1, s = 0;
#pragma unroll
  for (int j = 0; j < kWarpPerLane; ++j) {
    p *= v[j];
    s += p;
  }
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t p_up = __shfl_up_sync(kFullWarp, p, off);
    const uint32_t s_up = __shfl_up_sync(kFullWarp, s, off);
    if (lane >= off) {
      s = s_up + p_up * s;
      p = p_up * p;
    }
  }
  if (lane == 31) out[warp] = static_cast<int32_t>(s);
}

// The offsets of the first zero and the first element outside {0, 1}
// among the elements of one 32-bit word of kSize-byte elements (the
// element at offset `at` first; kSize 4 is one element, or the low word
// of an int64), written where the word holds one: called on a chunk's
// words from the last to the first, the offsets end as the chunk's
// first. One SIMD compare per word for bytes and halves: a byte or half
// outside {0, 1} compares above 1 unsigned, as its sign-extended int32
// does.
template <int kSize>
__device__ __forceinline__ void word_firsts(uint32_t w, int at, int& zero,
                                            int& other) {
  if constexpr (kSize == 1) {
    const uint32_t z = __vcmpeq4(w, 0u), o = __vcmpgtu4(w, 0x01010101u);
    if (z) zero = at + ((__ffs(z) - 1) >> 3);
    if (o) other = at + ((__ffs(o) - 1) >> 3);
  } else if constexpr (kSize == 2) {
    const uint32_t z = __vcmpeq2(w, 0u), o = __vcmpgtu2(w, 0x00010001u);
    if (z) zero = at + ((__ffs(z) - 1) >> 4);
    if (o) other = at + ((__ffs(o) - 1) >> 4);
  } else {
    if (w == 0) zero = at;
    if (w > 1) other = at;
  }
}

// A tile of the CTA form: kChunks chunks a thread of kPer elements, chunk
// j of thread t at offset o = (j * kCtaThreads + t) * kPer of the tile. A
// tile starts at element `lo` of the row; in the vector form lo = base -
// h, where the row starts h elements past a 16-byte boundary, so that
// every chunk is one aligned 16-byte word: a word wholly inside the row
// is one load, the head and tail words element by element. A scalar
// chunk is one element (lo = base). Elements outside the row hold 1,
// which is neither a zero nor outside {0, 1}.
template <typename T, bool kVector, int kChunkCount>
struct Tile {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kPer = kVector ? 16 / kSize : 1;
  static constexpr int kChunks = kChunkCount;
  static constexpr long long kElems =
      static_cast<long long>(kCtaThreads) * kChunks * kPer;
  using Raw = typename std::conditional<kVector, uint4, T>::type;
  Raw raw[kChunks];

  // Element e of chunk j, as astype(int32) gives it.
  __device__ __forceinline__ uint32_t at(int j, int e) const {
    if constexpr (kVector) {
      const uint4 c = raw[j];
      const int k = kSize == 8 ? 2 * e : e * kSize / 4;
      const uint32_t w = k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
      if constexpr (kSize >= 4) {
        return w;
      } else {
        const int shift = 8 * ((e * kSize) & 3);
        const uint32_t bits = (w >> shift) & ((1u << (8 * kSize)) - 1);
        return as_u32(static_cast<T>(bits));
      }
    } else {
      return as_u32(raw[j]);
    }
  }

  // A 16-byte word of ones of T.
  static __device__ __forceinline__ uint4 ones() {
    constexpr uint32_t w = kSize == 1 ? 0x01010101u
                           : kSize == 2 ? 0x00010001u : 1u;
    return kSize == 8 ? make_uint4(1, 0, 1, 0) : make_uint4(w, w, w, w);
  }

  // The tile at element `lo` of row r; elements outside [0, length) are
  // never read.
  __device__ __forceinline__ void load(const T* r, long long lo,
                                       long long length,
                                       long long elem_stride) {
    const int t = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const long long first =
          lo + static_cast<long long>(j * kCtaThreads + t) * kPer;
      if constexpr (kVector) {
        if (first >= 0 && first + kPer <= length) {
          raw[j] = *reinterpret_cast<const uint4*>(r + first);
        } else if (first >= length || first + kPer <= 0) {
          raw[j] = ones();
        } else {
          T elems[kPer];
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const long long i = first + e;
            elems[e] = i >= 0 && i < length ? r[i] : T(1);
          }
          memcpy(&raw[j], elems, 16);
        }
      } else {
        raw[j] = first < length ? r[first * elem_stride] : T(1);
      }
    }
  }

  // This thread's tile offsets of its first zero and its first element
  // outside {0, 1} (kNoIndex where it holds none).
  __device__ __forceinline__ void firsts(int& zero, int& other) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int j = kChunks - 1; j >= 0; --j) {
      const int o = (j * kCtaThreads + t) * kPer;
      if constexpr (kVector) {
        const uint4 c = raw[j];
        if constexpr (kSize == 8) {
          word_firsts<4>(c.z, o + 1, zero, other);
          word_firsts<4>(c.x, o, zero, other);
        } else {
          constexpr int kWord = 4 / kSize;  // elements a word
          word_firsts<kSize>(c.w, o + 3 * kWord, zero, other);
          word_firsts<kSize>(c.z, o + 2 * kWord, zero, other);
          word_firsts<kSize>(c.y, o + kWord, zero, other);
          word_firsts<kSize>(c.x, o, zero, other);
        }
      } else {
        word_firsts<4>(as_u32(raw[j]), o, zero, other);
      }
    }
  }
};

// The ordered (product, sum) pair of a row from the tile in `tile` (at
// element lo) on: folded chunk by chunk (chunk j of every thread, in
// thread order, before chunk j + 1) into the row's carry, tile after
// tile, until the product is 0 or the row ends. The elements before the
// tile are ones (the caller's tiles held no zero and nothing outside
// {0, 1}). Uniform over the CTA.
template <typename Tl, typename T>
__device__ uint32_t prefix_scan_rest(Tl& tile, const T* r, long long lo,
                                     long long length, long long elem_stride,
                                     uint32_t (&scan)[2][kCtaWarps]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t p_row = 1, s_row = static_cast<uint32_t>(lo > 0 ? lo : 0);
  for (;;) {
#pragma unroll
    for (int j = 0; j < Tl::kChunks; ++j) {
      const long long first =
          lo + static_cast<long long>(j * kCtaThreads + t) * Tl::kPer;
      // The chunk's elements inside the row: [e_lo, e_hi).
      const int e_lo = static_cast<int>(min(max(-first, 0LL),
                                            static_cast<long long>(Tl::kPer)));
      const int e_hi = static_cast<int>(min(max(length - first, 0LL),
                                            static_cast<long long>(Tl::kPer)));
      uint32_t p = 1, s = 0;
#pragma unroll
      for (int e = 0; e < Tl::kPer; ++e) {
        if (e >= e_lo && e < e_hi) {
          p *= tile.at(j, e);
          s += p;
        }
      }
      // The warp's lanes in order: lane i's span [i, i + off) before
      // [i + off, i + 2 off); lane 0 ends with the warp's pair.
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t p_dn = __shfl_down_sync(kFullWarp, p, off);
        const uint32_t s_dn = __shfl_down_sync(kFullWarp, s, off);
        s += p * s_dn;
        p *= p_dn;
      }
      if (lane == 0) {
        scan[0][warp] = p;
        scan[1][warp] = s;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kCtaWarps; ++w) {
        s_row += p_row * scan[1][w];
        p_row *= scan[0][w];
      }
      __syncthreads();  // read before the next chunk writes
      if (p_row == 0) return s_row;
    }
    lo += Tl::kElems;
    if (lo >= length) return s_row;
    tile.load(r, lo, length, elem_stride);
  }
}

template <typename T, bool kVector, int kChunks>
__global__ void __launch_bounds__(kCtaThreads)
prefix_cta_kernel(const T* __restrict__ x, long long rows, long long length,
                  long long row_stride, long long elem_stride,
                  int32_t* __restrict__ out) {
  using Tl = Tile<T, kVector, kChunks>;
  // [parity][first zero, first other][warp]: a tile writes one parity,
  // so one barrier a tile suffices.
  __shared__ int first[2][2][kCtaWarps];
  __shared__ uint32_t scan[2][kCtaWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int parity = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* r = x + row * row_stride;
    long long lo = 0;
    if constexpr (kVector) {
      lo = -static_cast<long long>((reinterpret_cast<uintptr_t>(r) & 15)
                                   / sizeof(T));
    }
    Tl cur, next;
    cur.load(r, lo, length, elem_stride);
    long long answer = -1;
    for (;;) {
      // Tile offsets of the first zero and the first element outside
      // {0, 1} (row index lo + offset).
      int zero = kNoIndex, other = kNoIndex;
      cur.firsts(zero, other);
      const bool more = lo + Tl::kElems < length;
      if (more) next.load(r, lo + Tl::kElems, length, elem_stride);
      zero = __reduce_min_sync(kFullWarp, zero);
      other = __reduce_min_sync(kFullWarp, other);
      if (lane == 0) {
        first[parity][0][warp] = zero;
        first[parity][1][warp] = other;
      }
      __syncthreads();
      // Every warp takes the minima over the warps' (lane l reads warp
      // l mod kCtaWarps's).
      zero = __reduce_min_sync(kFullWarp, first[parity][0][lane % kCtaWarps]);
      other = __reduce_min_sync(kFullWarp,
                                first[parity][1][lane % kCtaWarps]);
      parity ^= 1;
      if (other < zero) break;  // the scan, from this tile on
      if (zero != kNoIndex) {
        answer = lo + zero;
        break;
      }
      if (!more) {
        answer = length;
        break;
      }
      lo += Tl::kElems;
      cur = next;
    }
    const uint32_t got =
        answer >= 0 ? static_cast<uint32_t>(answer)
                    : prefix_scan_rest(cur, r, lo, length, elem_stride,
                                       scan);
    if (t == 0) out[row] = static_cast<int32_t>(got);
  }
}

template <typename T>
cudaError_t launch_prefix(int form, const void* x, long long rows,
                          long long length, long long row_stride,
                          long long elem_stride, void* out,
                          cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  auto* o = static_cast<int32_t*>(out);
  // The thread and warp forms' rows are at most 512 long.
  const int len = static_cast<int>(length);
  const unsigned grid = static_cast<unsigned>(std::min(rows, kCtaGridMax));
  switch (form) {
    case kPrefixThread:
      prefix_thread_kernel<T><<<static_cast<unsigned>(
          (rows + FPX_THREADS - 1) / FPX_THREADS), FPX_THREADS, 0, stream>>>(
          xt, rows, len, row_stride, elem_stride, o);
      break;
    case kPrefixWarp:
      prefix_warp_kernel<T><<<static_cast<unsigned>(
          (rows * 32 + FPX_THREADS - 1) / FPX_THREADS), FPX_THREADS, 0,
          stream>>>(xt, rows, len, row_stride, elem_stride, o);
      break;
    case kPrefixCtaScalar:
      prefix_cta_kernel<T, false, kCtaScalarChunks><<<grid, kCtaThreads, 0,
                                                      stream>>>(
          xt, rows, length, row_stride, elem_stride, o);
      break;
    default:
      // A row of up to (kCtaThreads - 1) words fits one tile of one word
      // a thread, whatever its head.
      if (length <= static_cast<long long>(kCtaThreads - 1)
                        * (16 / static_cast<int>(sizeof(T)))) {
        prefix_cta_kernel<T, true, 1><<<grid, kCtaThreads, 0, stream>>>(
            xt, rows, length, row_stride, elem_stride, o);
      } else {
        prefix_cta_kernel<T, true, kCtaVectorChunks><<<grid, kCtaThreads, 0,
                                                       stream>>>(
            xt, rows, length, row_stride, elem_stride, o);
      }
      break;
  }
  return cudaGetLastError();
}
}  // namespace

// block: watermarks, rows, n, row_stride, elem_stride, quorum sizes (or
// 0), quorum size, out, device, stream.
extern "C" int fpx_quorum_watermark(const void* block) {
  long long a[10];
  std::memcpy(a, block, sizeof a);
  const cudaError_t err = select_device(static_cast<int>(a[8]));
  if (err != cudaSuccess) return err;
  return quorum_watermark(pointer<const void>(a[0]), a[1],
                          static_cast<int>(a[2]), a[3], a[4],
                          pointer<const void>(a[5]), static_cast<int>(a[6]),
                          pointer<void>(a[7]), pointer<CUstream_st>(a[9]));
}

// The vector form in one call. block: host_w, dev_w, n, depth, quorum
// size, dev_out, host_out, device, stream. host_w holds the [n, depth]
// int32 matrix (pinned), copied up into dev_w; the columns' watermarks
// land in dev_out, then in host_out (pinned), and the call returns after
// the stream has drained.
extern "C" int fpx_quorum_watermark_staged(const void* block) {
  long long a[9];
  std::memcpy(a, block, sizeof a);
  void* dev_w = pointer<void>(a[1]);
  const int n = static_cast<int>(a[2]);
  const long long depth = a[3];
  void* dev_out = pointer<void>(a[5]);
  const cudaStream_t s = pointer<CUstream_st>(a[8]);
  cudaError_t err = select_device(static_cast<int>(a[7]));
  if (err != cudaSuccess || depth <= 0) return err;
  err = cudaMemcpyAsync(dev_w, pointer<const void>(a[0]),
                        static_cast<size_t>(n) * depth * 4,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  err = quorum_watermark(dev_w, depth, n, 1, depth, nullptr,
                         static_cast<int>(a[4]), dev_out, s);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(pointer<void>(a[6]), dev_out,
                        static_cast<size_t>(depth) * 4,
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(s);
}

// block: present, elem_kind (0 uint8 and bool, 1 int8, 2 int16, 3 int32,
// 4 int64), rows, length, row_stride, elem_stride, out, device, stream.
extern "C" int fpx_contiguous_prefix_length(const void* block) {
  long long a[9];
  std::memcpy(a, block, sizeof a);
  if (a[1] < 0 || a[1] > 4) return cudaErrorInvalidValue;
  const cudaError_t err = select_device(static_cast<int>(a[7]));
  if (err != cudaSuccess || a[2] <= 0) return err;
  const void* x = pointer<const void>(a[0]);
  const int form = prefix_form(a[3], a[5]);
  void* out = pointer<void>(a[6]);
  const cudaStream_t s = pointer<CUstream_st>(a[8]);
  switch (a[1]) {
    case 0:
      return launch_prefix<uint8_t>(form, x, a[2], a[3], a[4], a[5], out, s);
    case 1:
      return launch_prefix<int8_t>(form, x, a[2], a[3], a[4], a[5], out, s);
    case 2:
      return launch_prefix<int16_t>(form, x, a[2], a[3], a[4], a[5], out, s);
    case 3:
      return launch_prefix<int32_t>(form, x, a[2], a[3], a[4], a[5], out, s);
    default:
      return launch_prefix<long long>(form, x, a[2], a[3], a[4], a[5], out,
                                      s);
  }
}

// The form fpx_contiguous_prefix_length launches for the same block
// (PrefixForm), or -1 for an unknown element kind. Launches nothing.
extern "C" int fpx_contiguous_prefix_form(const void* block) {
  long long a[9];
  std::memcpy(a, block, sizeof a);
  if (a[1] < 0 || a[1] > 4) return -1;
  return prefix_form(a[3], a[5]);
}
