// K9-K11, K16 and K17: the dependency-set algebra of EPaxos on the card.
//
// Replaces frankenpaxos_tpu/ops/depset.py:
//   K9  normalized    (L74): every (b, l) row of a [B, L, W] batch to its
//       IntPrefixSet canonical form (depset.cuh), into new tensors;
//   K10 union_reduce  (L97) and conflict_max (L168): the max over B of
//       the watermarks and of the tail bytes (max, as the reference's
//       `tails.max(axis=0)`, not OR), the one row normalized, and in
//       seq mode the max of the replies' int32 sequence numbers -- one
//       launch for the EPaxos slow path's quorum aggregation;
//   K11 all_equal     (L114): whether every normalized row (b, l) equals
//       row (0, l), watermark and bytes -- the fast path's test.
//
// Bound on the H100: bytes. Each kernel reads the batch once
// (B * L * (4 + W) bytes) and writes its output once; the integer work
// is a few operations per byte. At the cluster's shapes (B <= 5, L = 5,
// W = 8-2048) that is at most 52 KB, 16 ns at 3.35 TB/s: the launch sets
// the time. K9 gives each row one warp, whose lanes stride over the
// bytes (coalesced) and share the run's scan (depset.cuh).
//
// K10 gives each leader column one CTA, or, when the column's B * W
// bytes pass kClusterBytes, a thread-block cluster of up to 8 CTAs that
// split its rows. It reads rows in words of VEC bytes (16 where the
// width and the tails' address allow it, else 8, 4, 2 or 1: one width
// for the whole launch, so every row's words line up) and takes the
// byte max with __vmaxu4 in registers, with no atomics. Every global
// load of a CTA (the tail words, the first watermarks, the base, the
// first sequence numbers) is issued before the first is waited on, so
// the launch waits for memory about once. At the cluster paths' shapes
// (a power of two of words, at most 32, and a few rows) the CTA is ONE
// warp: its lanes split the rows and the words, fold by shuffles and
// normalize, with no block barrier. Otherwise each thread owns a word
// and folds its share of the rows; threads that own one word fold their
// partial words by warp shuffles (a power of two of words under 32) or
// through shared memory; in a cluster, CTA 0 reads its peers' rows and
// watermark maxima over distributed shared memory after cluster.sync().
// The union row (kUnionChunk bytes at a time) sits in shared memory;
// rows wider than that go through the output row in global memory, chunk
// by chunk. Warp 0 of CTA 0 normalizes the row (depset.cuh) and writes
// it once. In seq mode the last warp of the first CTA takes the max of
// `seqs` by warp shuffles, in the same launch.
//
// K11 is one CTA, or one cluster of up to 8 CTAs when the batch passes
// kEqualClusterBytes, and nothing else on the stream (no memset). A
// batch of up to kEqualPrefetch bytes is first read into shared memory
// in one round of loads. The CTA normalizes row (0, l) of every column
// once (its warps split the columns) into a shared table of watermarks;
// then each warp takes rows (b >= 1, l), normalizes the row's watermark,
// and where it equals row (0, l)'s compares the two rows' raw bytes word
// by word, a byte counting where its id is at or past that watermark
// (normalization clears the bytes below it and keeps the rest). The
// answer is reduced by __syncthreads_or (and across a cluster over
// distributed shared memory) and stored by one thread.
//
// The staged entries (fpx_depset_union_staged, fpx_depset_all_equal_
// staged) run a protocol decision whole in one call: the packed input
// block (seqs, watermarks, base, then the tails at a 16-byte offset) from
// pinned host memory to the device, the launch, the packed output block
// (seq, [L] watermarks, then the [L, W] tails at a 16-byte offset; or
// K11's answer byte) back to pinned memory, and a wait on the stream.
// Every K10 / K11 entry point takes one packed block of int64 arguments.
//
// K16 union (L49) is its own kernel, elementwise over the flat batch:
// max of the watermarks, OR of the tail bytes, NOT normalized (as the
// reference), a's tail base. Thread i takes tail bytes [16 i, 16 i + 16)
// (one 16-byte word where the three tail pointers are 16-byte aligned,
// byte loads at the ragged end or where they are not) and watermarks
// [4 i, 4 i + 4) (one int4 likewise), and issues every load before its
// first store, so one round trip to memory and one of stores set the
// time. When a and b are the same tensors (libbench's union(deps, deps))
// the kernel reads them once: the union is the batch itself. The output
// may be a or b themselves (each thread reads its own elements before it
// writes them), so nothing is __restrict__. With an out= batch whose
// tail base is another tensor, thread 0 copies a's base into it. Bound:
// bytes, 2 * B * L * (4 + W) read (once when aliased) and B * L * (4 + W)
// written. fpx_depset_union takes one packed block of int64.
//
// K16 depset_pair (intersect L181, compact L213) and K17 depset_query
// (equal L129, size L161, _contains_kernel L137 under contains L148) are
// the rest of the algebra, rowwise over [B, L, W]:
//   K16 intersect ids below both watermarks stay prefix (min); an id is
//                 in a set if below its watermark or its byte is > 0;
//                 the 0/1 bytes of `in both and >= min` are written, then
//                 normalized in place (K9's scan over the written row);
//       compact   max(watermark, executed) -- `executed` broadcast over
//                 [B, L] through strides (0 for a broadcast axis) --
//                 then normalized, as K9 with the raised watermark.
//     One warp per (b, l) row, the lanes striding over the W bytes. The
//     inputs may alias (intersect(deps, deps)): nothing is __restrict__.
//     Bound: bytes, 2 * B * L * (4 + W) read (compact: one batch and
//     `executed`) and B * L * (4 + W) written.
//   K17 equal     every watermark and byte of row b equal (bytes, not
//                 sets: callers pass normalized rows);
//       size      the int32 (wrapping) sum of row b's watermarks plus the
//                 sum of its tail byte VALUES (not a count of nonzero
//                 bytes), a uint32 warp sum;
//       contains  leader[b] (negative counts from the end, then clamped
//                 to [0, L-1]) and vid[b], each broadcast by a stride of
//                 0 or 1: vid < watermark, or the byte at the clamped
//                 offset vid - base (int32, wrapping) is > 0 and the
//                 offset lies in [0, W).
//     One warp per row b for equal and size (the lanes over L * W bytes),
//     one thread per row for contains. Bound: bytes, B * L * (4 + W)
//     read (2x for equal; contains reads one watermark and one byte a
//     row), 1 or 4 bytes written per row.

#include <algorithm>
#include <climits>
#include <cstring>

#include <cooperative_groups.h>

#include "depset.cuh"
#include "quorum.cuh"

namespace cg = cooperative_groups;

namespace {

// K10: threads per CTA; union-row bytes a CTA holds in shared memory; a
// column's rows (B * W bytes) per CTA before it takes a cluster.
constexpr int kUnionThreads = 256;
constexpr int kUnionChunk = 8192;
constexpr long long kClusterBytes = 16384;
constexpr int kMaxCluster = 8;
// K11: threads of its CTA; columns whose row-0 watermark the shared table
// holds at a time; the batch bytes it reads into shared memory first;
// batch bytes per CTA before it takes a cluster.
constexpr int kEqualThreads = 512;
constexpr int kEqualTile = 1024;
constexpr int kEqualPrefetch = 16384;
constexpr long long kEqualClusterBytes = 65536;

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

__global__ void depset_normalized_kernel(const int32_t* __restrict__ wm,
                                         const uint8_t* __restrict__ tails,
                                         const int32_t* __restrict__ base_p,
                                         long long rows, int width,
                                         int32_t* __restrict__ out_wm,
                                         uint8_t* __restrict__ out_tails) {
  // One warp per row; blockDim is a multiple of 32, so `row` is uniform
  // across the warp and a warp returns as a whole.
  const long long row =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int32_t base = *base_p;
  const uint8_t* t = tails + row * width;
  const int32_t new_wm = fpx_normalized_watermark(wm[row], base, t, width);
  uint8_t* o = out_tails + row * width;
  for (int w = lane; w < width; w += 32) {
    o[w] = fpx_normalized_byte(t, w, base, new_wm);
  }
  if (lane == 0) out_wm[row] = new_wm;
}

// VEC tail bytes as 32-bit words (1 and 2 bytes zero-extended into one).
template <int VEC>
struct Word {
  uint32_t v[VEC >= 4 ? VEC / 4 : 1];
};

template <int VEC>
__device__ __forceinline__ Word<VEC> word_zero() {
  Word<VEC> w;
#pragma unroll
  for (auto& x : w.v) x = 0;
  return w;
}

template <int VEC>
__device__ __forceinline__ Word<VEC> load_word(const uint8_t* p) {
  Word<VEC> w;
  if constexpr (VEC == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w.v[0] = x.x; w.v[1] = x.y; w.v[2] = x.z; w.v[3] = x.w;
  } else if constexpr (VEC == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w.v[0] = x.x; w.v[1] = x.y;
  } else if constexpr (VEC == 4) {
    w.v[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (VEC == 2) {
    w.v[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w.v[0] = *p;
  }
  return w;
}

template <int VEC>
__device__ __forceinline__ void store_word(uint8_t* p, const Word<VEC>& w) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w.v[0], w.v[1], w.v[2],
                                              w.v[3]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w.v[0], w.v[1]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(p) = w.v[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w.v[0]);
  } else {
    *p = static_cast<uint8_t>(w.v[0]);
  }
}

// Bytewise max, four bytes an instruction.
template <int VEC>
__device__ __forceinline__ Word<VEC> word_max(const Word<VEC>& a,
                                              const Word<VEC>& b) {
  Word<VEC> m;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(m.v) / 4); ++i) {
    m.v[i] = __vmaxu4(a.v[i], b.v[i]);
  }
  return m;
}

template <int VEC>
__device__ __forceinline__ Word<VEC> word_shfl_xor(const Word<VEC>& a,
                                                   int off) {
  Word<VEC> m;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(m.v) / 4); ++i) {
    m.v[i] = __shfl_xor_sync(FPX_FULL_WARP, a.v[i], off);
  }
  return m;
}

// Whether the words of two rows at byte w0 differ in a byte whose id is
// at or past `wm` (a byte that normalization to `wm` keeps).
template <int VEC>
__device__ __forceinline__ bool word_differs(const Word<VEC>& a,
                                             const Word<VEC>& b, int w0,
                                             int32_t base, int32_t wm) {
  bool differ = false;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(a.v) / 4); ++i) {
    const uint32_t x = a.v[i] ^ b.v[i];
    if (x == 0) continue;
#pragma unroll
    for (int q = 0; q < (VEC < 4 ? VEC : 4); ++q) {
      differ |= ((x >> (8 * q)) & 0xffu) != 0
                && fpx_tail_id(base, w0 + 4 * i + q) >= wm;
    }
  }
  return differ;
}

// The word at byte w0 of a row with the bytes whose id lies below `wm`
// cleared (normalization to `wm`).
template <int VEC>
__device__ __forceinline__ Word<VEC> word_clear_below(Word<VEC> a, int w0,
                                                      int32_t base,
                                                      int32_t wm) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(a.v) / 4); ++i) {
#pragma unroll
    for (int q = 0; q < (VEC < 4 ? VEC : 4); ++q) {
      if (fpx_tail_id(base, w0 + 4 * i + q) < wm) {
        a.v[i] &= ~(0xffu << (8 * q));
      }
    }
  }
  return a;
}

// One CTA's fold of rows [r0, r1) of a column over `nwords` words: the
// bytewise max lands in `s_row` (shared), and every thread of the CTA
// reaches the barrier at the end. Threads own words; when the words are
// fewer than the threads, groups of `nwords` threads split the rows and
// their partial words fold by warp shuffles (a power of two under 32
// words: the lanes that own one word are `nwords` apart) or through
// `s_red`.
//
// With `s_part`, each warp's max of the threads' `wpart` (their share of
// the watermarks) lands in s_part[warp] before the same barrier.
__device__ __forceinline__ void warp_part(int32_t wpart, int32_t* s_part) {
  if (s_part == nullptr) return;
  for (int off = 16; off > 0; off >>= 1) {
    wpart = max(wpart, __shfl_xor_sync(FPX_FULL_WARP, wpart, off));
  }
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = wpart;
}

template <int VEC>
__device__ void fold_rows(const uint8_t* __restrict__ col,
                          long long row_stride, int r0, int r1, int nwords,
                          uint8_t* s_row, Word<VEC>* s_red, int32_t wpart,
                          int32_t* s_part) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int rows = r1 - r0;
  if (nwords >= threads || rows <= 1) {
    for (int k = tid; k < nwords; k += threads) {
      Word<VEC> acc = word_zero<VEC>();
      const uint8_t* p = col + r0 * row_stride + k * VEC;
#pragma unroll 4
      for (int i = 0; i < rows; ++i, p += row_stride) {
        acc = word_max(acc, load_word<VEC>(p));
      }
      store_word<VEC>(s_row + k * VEC, acc);
    }
    warp_part(wpart, s_part);
    __syncthreads();
    return;
  }
  const int groups = min(threads / nwords, rows);
  const int g = tid / nwords;
  const int k = tid % nwords;
  Word<VEC> acc = word_zero<VEC>();  // 0 is the max's identity on bytes
  if (g < groups) {
    const uint8_t* p = col + (r0 + g) * row_stride + k * VEC;
    const long long step = groups * row_stride;
#pragma unroll 4
    for (int i = r0 + g; i < r1; i += groups, p += step) {
      acc = word_max(acc, load_word<VEC>(p));
    }
  }
  int parts = groups;
  if ((nwords & (nwords - 1)) == 0 && nwords < 32) {  // uniform
    for (int off = 16; off >= nwords; off >>= 1) {
      acc = word_max(acc, word_shfl_xor(acc, off));
    }
    const int lane = tid & 31;
    if (lane < nwords) s_red[(tid >> 5) * nwords + lane] = acc;
    parts = (groups * nwords + 31) / 32;
  } else if (g < groups) {
    s_red[tid] = acc;  // index g * nwords + k
  }
  warp_part(wpart, s_part);
  __syncthreads();
  for (int kk = tid; kk < nwords; kk += threads) {
    Word<VEC> m = s_red[kk];
    for (int j = 1; j < parts; ++j) m = word_max(m, s_red[j * nwords + kk]);
    store_word<VEC>(s_row + kk * VEC, m);
  }
  __syncthreads();
}

// K10 on column l: the fold of this CTA's rows (by warp 0 alone on the
// warp path, a CTA of one warp; else fold_rows), the cluster's exchange,
// then CTA 0's warp 0 normalizes the union row and writes it. Every
// global load of the launch is issued before the first one is waited on.
template <int VEC>
__device__ __forceinline__ void union_column(
    const int32_t* __restrict__ wm, const uint8_t* __restrict__ tails,
    int32_t base, int b, int l_count, int width,
    int32_t* __restrict__ out_wm, uint8_t* out_tails, int csize, int l,
    int rank, uint8_t* s_row, Word<VEC>* s_red, int32_t* s_part,
    int32_t* s_wm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (b + csize - 1) / csize;
  const int r0 = min(b, rank * per);
  const int r1 = min(b, r0 + per);
  // The warp path's first watermark load, not waited on until after the
  // fold (the block path loads its own below).
  const int wi = r0 + lane;
  int wmax = blockDim.x == 32 && wi < r1
                 ? wm[static_cast<long long>(wi) * l_count + l] : INT_MIN;
  const long long row_stride = static_cast<long long>(l_count) * width;
  const uint8_t* col = tails + static_cast<long long>(l) * width;
  uint8_t* out_row = out_tails + static_cast<long long>(l) * width;
  const bool whole = width <= kUnionChunk;
  if (blockDim.x == 32) {  // the warp path: one CTA, a power of two of words
    const int nwords = width / VEC;
    if (nwords > 0) {
      const int shift = __ffs(nwords) - 1;  // nwords is a power of two
      const int groups = 32 >> shift;
      const int k = lane & (nwords - 1);
      const int g = lane >> shift;
      Word<VEC> acc = word_zero<VEC>();
      const uint8_t* p = col + (r0 + g) * row_stride + k * VEC;
#pragma unroll 4
      for (int i = r0 + g; i < r1; i += groups, p += groups * row_stride) {
        acc = word_max(acc, load_word<VEC>(p));
      }
      for (int off = 16; off >= nwords; off >>= 1) {
        acc = word_max(acc, word_shfl_xor(acc, off));
      }
      if (lane < nwords) store_word<VEC>(s_row + k * VEC, acc);
    }
    __syncwarp();
  } else {
    // Every thread's first watermark load, issued with the fold's.
    const int threads = blockDim.x;
    int wpart = r0 + tid < r1
                    ? wm[static_cast<long long>(r0 + tid) * l_count + l]
                    : INT_MIN;
    for (int c0 = 0; c0 < width; c0 += kUnionChunk) {
      const int nwords = min(kUnionChunk, width - c0) / VEC;
      if (c0 > 0) __syncthreads();  // s_row and s_red free again
      if (c0 == 0) {
#pragma unroll 4
        for (int i = r0 + tid + threads; i < r1; i += threads) {
          wpart = max(wpart, wm[static_cast<long long>(i) * l_count + l]);
        }
      }
      fold_rows<VEC>(col + c0, row_stride, r0, r1, nwords, s_row, s_red,
                     wpart, c0 == 0 ? s_part : nullptr);
      if (c0 == 0 && warp == 0) {
        wmax = lane < threads / 32 ? s_part[lane] : INT_MIN;
        for (int off = 16; off > 0; off >>= 1) {
          wmax = max(wmax, __shfl_xor_sync(FPX_FULL_WARP, wmax, off));
        }
        if (lane == 0) *s_wm = wmax;
      }
      if (csize > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every CTA's row (and watermark max) written
        if (rank == 0) {  // the peers' words read together, then folded
          for (int k = tid; k < nwords; k += blockDim.x) {
            Word<VEC> acc = load_word<VEC>(s_row + k * VEC);
#pragma unroll
            for (int r = 1; r < kMaxCluster; ++r) {
              if (r < csize) {
                acc = word_max(acc, load_word<VEC>(
                    cluster.map_shared_rank(s_row, r) + k * VEC));
              }
            }
            store_word<VEC>(s_row + k * VEC, acc);
          }
          if (c0 == 0 && tid == 0) {
            int32_t m = *s_wm;
#pragma unroll
            for (int r = 1; r < kMaxCluster; ++r) {
              if (r < csize) m = max(m, *cluster.map_shared_rank(s_wm, r));
            }
            *s_wm = m;
          }
        }
        cluster.sync();  // CTA 0 is done with its peers' memory
      }
      if (rank == 0 && !whole) {
        for (int k = tid; k < nwords; k += blockDim.x) {
          store_word<VEC>(out_row + c0 + k * VEC,
                          load_word<VEC>(s_row + k * VEC));
        }
      }
    }
    if (rank != 0) return;
    if (!whole) __syncthreads();  // the raw union row is in out_row
    if (warp != 0) return;
    if (csize > 1) wmax = *s_wm;  // else every lane of warp 0 holds it
  }
  if (warp == 0 && blockDim.x == 32) {
#pragma unroll 8
    for (int i = wi + 32; i < r1; i += 32) {  // independent loads
      wmax = max(wmax, wm[static_cast<long long>(i) * l_count + l]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      wmax = max(wmax, __shfl_xor_sync(FPX_FULL_WARP, wmax, off));
    }
  }
  const uint8_t* row = whole ? s_row : out_row;
  const int32_t new_wm = fpx_normalized_watermark(wmax, base, row, width);
  for (int k = lane; k < width / VEC; k += 32) {
    store_word<VEC>(out_row + k * VEC,
                    word_clear_below(load_word<VEC>(row + k * VEC), k * VEC,
                                     base, new_wm));
  }
  if (lane == 0) out_wm[l] = new_wm;
}

template <int VEC>
__global__ void __launch_bounds__(kUnionThreads)
    depset_union_reduce_kernel(const int32_t* __restrict__ wm,
                               const uint8_t* __restrict__ tails,
                               const int32_t* __restrict__ base_p, int b,
                               int l_count, int width,
                               const int32_t* __restrict__ seqs, int s,
                               int32_t* __restrict__ out_wm,
                               uint8_t* out_tails,
                               int32_t* __restrict__ out_seq, int csize) {
  __shared__ __align__(16) uint8_t s_row[kUnionChunk];
  __shared__ Word<VEC> s_red[kUnionThreads];
  __shared__ int32_t s_part[kUnionThreads / 32];
  __shared__ int32_t s_wm;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x / csize;
  const int32_t base = *base_p;  // waited on only at the normalization
  // The seq warp (the last warp of the first CTA) issues its first load
  // now and reduces at the end.
  const bool seq_warp = seqs != nullptr && blockIdx.x == 0
                        && (threadIdx.x >> 5) == blockDim.x / 32 - 1;
  int seq = seq_warp && lane < s ? seqs[lane] : INT_MIN;
  if (l < l_count) {  // uniform across a cluster (one column)
    union_column<VEC>(wm, tails, base, b, l_count, width, out_wm, out_tails,
                      csize, l, blockIdx.x % csize, s_row, s_red, s_part,
                      &s_wm);
  }
  if (seq_warp) {
    for (int i = lane + 32; i < s; i += 32) seq = max(seq, seqs[i]);
    for (int off = 16; off > 0; off >>= 1) {
      seq = max(seq, __shfl_xor_sync(FPX_FULL_WARP, seq, off));
    }
    if (lane == 0) *out_seq = seq;
  }
}

// K11 on a batch held in shared memory (one CTA): every row's normalized
// watermark in one pass of the warps (row (0, l) once per column, like
// every row), then every row (b >= 1, l) against row (0, l) in a second.
template <int VEC>
__device__ __forceinline__ bool rows_differ_held(
    const int32_t* __restrict__ wm, const uint8_t* __restrict__ tails,
    int32_t base, int b, int l_count, int width, uint8_t* s_batch,
    int32_t* s_nw) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = kEqualThreads / 32;
  const int cells = b * l_count;
  const int nwords = width / VEC;
  auto* s_w = reinterpret_cast<int32_t*>(s_batch);
  uint8_t* s_t = s_batch + ((4 * cells + 15) & ~15);
  for (int i = tid; i < cells; i += kEqualThreads) s_w[i] = wm[i];
  for (int k = tid; k < cells * nwords; k += kEqualThreads) {
    store_word<VEC>(s_t + k * VEC, load_word<VEC>(tails + k * VEC));
  }
  __syncthreads();
  for (int row = warp; row < cells; row += warps) {
    const int32_t nw = fpx_normalized_watermark(s_w[row], base,
                                                s_t + row * width, width);
    if (lane == 0) s_nw[row] = nw;
  }
  __syncthreads();
  bool differ = false;
  for (int row = l_count + warp; row < cells && !differ; row += warps) {
    const int l = row % l_count;
    const int32_t nw = s_nw[row];
    bool d = nw != s_nw[l];
    const uint8_t* t = s_t + row * width;
    const uint8_t* t0 = s_t + l * width;
    for (int k = lane; !d && k < nwords; k += 32) {
      d = word_differs<VEC>(load_word<VEC>(t + k * VEC),
                            load_word<VEC>(t0 + k * VEC), k * VEC, base, nw);
    }
    differ = __any_sync(FPX_FULL_WARP, d);
  }
  return differ;
}

// K11 on a batch in global memory (one CTA or one cluster): the row-0
// watermarks of up to kEqualTile columns at a time in a shared table,
// then the rows (b >= 1, l) of those columns split over the warps of
// every CTA, a warp stopping once any has found a difference.
template <int VEC>
__device__ __forceinline__ bool rows_differ(
    const int32_t* __restrict__ wm, const uint8_t* __restrict__ tails,
    int32_t base, int b, int l_count, int width, int csize, int32_t* s_wm0,
    int* s_found) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = kEqualThreads / 32;
  const int rank = blockIdx.x;  // the grid is one cluster (or one CTA)
  const int nwords = width / VEC;
  bool differ = false;
  for (int l0 = 0; l0 < l_count; l0 += kEqualTile) {
    const int lt = min(kEqualTile, l_count - l0);
    __syncthreads();  // s_found set; the table free again
    for (int i = warp; i < lt; i += warps) {
      const int l = l0 + i;
      const int32_t nw = fpx_normalized_watermark(
          wm[l], base, tails + static_cast<long long>(l) * width, width);
      if (lane == 0) s_wm0[i] = nw;
    }
    __syncthreads();
    const long long rows = static_cast<long long>(b - 1) * lt;
    for (long long r = static_cast<long long>(rank) * warps + warp; r < rows;
         r += static_cast<long long>(csize) * warps) {
      if (*static_cast<volatile int*>(s_found)) break;  // one warp-wide read
      const int i = static_cast<int>(r % lt);
      const long long row = (1 + r / lt) * l_count + l0 + i;
      const uint8_t* t = tails + row * width;
      const uint8_t* t0 = tails + static_cast<long long>(l0 + i) * width;
      const int32_t nw = fpx_normalized_watermark(wm[row], base, t, width);
      bool d = nw != s_wm0[i];
      for (int k = lane; !d && k < nwords; k += 32) {
        d = word_differs<VEC>(load_word<VEC>(t + k * VEC),
                              load_word<VEC>(t0 + k * VEC), k * VEC, base,
                              nw);
      }
      if (__any_sync(FPX_FULL_WARP, d)) {
        differ = true;
        if (lane == 0) *s_found = 1;
      }
    }
  }
  return differ;
}

template <int VEC>
__global__ void __launch_bounds__(kEqualThreads)
    depset_all_equal_kernel(const int32_t* __restrict__ wm,
                            const uint8_t* __restrict__ tails,
                            const int32_t* __restrict__ base_p, int b,
                            int l_count, int width, uint8_t* out,
                            int csize) {
  __shared__ int32_t s_table[kEqualTile];
  __shared__ __align__(16) uint8_t s_batch[kEqualPrefetch];
  __shared__ int s_found;
  const int tid = threadIdx.x;
  const int32_t base = *base_p;
  const long long cells = static_cast<long long>(b) * l_count;
  // A small batch is read into shared memory first, in one round of
  // independent loads.
  const bool held = csize == 1 && cells <= kEqualTile
                    && ((4 * cells + 15) & ~15LL) + cells * width
                           <= kEqualPrefetch;
  if (tid == 0) s_found = 0;
  bool differ = false;
  if (b > 1 && held) {
    differ = rows_differ_held<VEC>(wm, tails, base, b, l_count, width,
                                   s_batch, s_table);
  } else if (b > 1) {
    differ = rows_differ<VEC>(wm, tails, base, b, l_count, width, csize,
                              s_table, &s_found);
  }
  differ = __syncthreads_or(differ);
  if (csize > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) s_found = differ;
    cluster.sync();
    if (blockIdx.x == 0 && tid == 0) {
      int any = s_found;
      for (int r = 1; r < csize; ++r) {
        any |= *cluster.map_shared_rank(&s_found, r);
      }
      *out = !any;
    }
    cluster.sync();  // the peers' memory stays until CTA 0 has read it
  } else if (tid == 0) {
    *out = !differ;
  }
}

// The widest word (16, 8, 4, 2 or 1 bytes) that divides the row width
// and the tails' address, so every row's words are aligned.
int vec_for(const void* tails, int width) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(tails);
  for (int v = 16; v > 1; v >>= 1) {
    if (width % v == 0 && a % v == 0) return v;
  }
  return 1;
}

int clamp_cluster(long long bytes, long long per_cta, int rows) {
  long long c = (bytes + per_cta - 1) / per_cta;
  if (c > kMaxCluster) c = kMaxCluster;
  if (c > rows) c = rows;
  return c < 1 ? 1 : static_cast<int>(c);
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, unsigned grid, unsigned threads,
                           int csize, cudaStream_t stream, Args... args) {
  if (csize <= 1) {
    kernel<<<grid, threads, 0, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

cudaError_t union_reduce(const void* wm, const void* tails, const void* base,
                         int b, int l, int width, const void* seqs, int s,
                         void* out_wm, void* out_tails, void* out_seq,
                         cudaStream_t stream) {
  const int csize =
      l > 0 ? clamp_cluster(static_cast<long long>(b) * width,
                            kClusterBytes, b)
            : 1;
  const unsigned grid = static_cast<unsigned>((l > 0 ? l : 1) * csize);
  const int vec = vec_for(tails, width);
  const int nwords = width / vec;
  // The warp path: one warp folds each column's few rows, with no block
  // barrier (a power of two of words, at most four rows a lane).
  // (A row of no bytes takes it at any B: it folds only watermarks.)
  const bool warp_path = width == 0
                         || (csize == 1 && width <= kUnionChunk
                             && nwords <= 32 && (nwords & (nwords - 1)) == 0
                             && b <= 4 * (32 / nwords));
  const unsigned threads = warp_path ? 32 : kUnionThreads;
  const auto* w = static_cast<const int32_t*>(wm);
  const auto* t = static_cast<const uint8_t*>(tails);
  const auto* bp = static_cast<const int32_t*>(base);
  const auto* sq = static_cast<const int32_t*>(seqs);
  auto* ow = static_cast<int32_t*>(out_wm);
  auto* ot = static_cast<uint8_t*>(out_tails);
  auto* os = static_cast<int32_t*>(out_seq);
  switch (vec) {
#define FPX_UNION(V)                                                        \
  case V:                                                                   \
    return launch_cluster(depset_union_reduce_kernel<V>, grid, threads,     \
                          csize, stream, w, t, bp, b, l, width, sq, s, ow,  \
                          ot, os, csize);
    FPX_UNION(16)
    FPX_UNION(8)
    FPX_UNION(4)
    FPX_UNION(2)
    FPX_UNION(1)
#undef FPX_UNION
  }
  return cudaErrorInvalidValue;
}

cudaError_t all_equal(const void* wm, const void* tails, const void* base,
                      int b, int l, int width, void* out,
                      cudaStream_t stream) {
  const int csize = clamp_cluster(
      static_cast<long long>(b) * l * (4 + width), kEqualClusterBytes, b);
  const auto* w = static_cast<const int32_t*>(wm);
  const auto* t = static_cast<const uint8_t*>(tails);
  const auto* bp = static_cast<const int32_t*>(base);
  auto* o = static_cast<uint8_t*>(out);
  switch (vec_for(tails, width)) {
#define FPX_EQUAL(V)                                                        \
  case V:                                                                   \
    return launch_cluster(depset_all_equal_kernel<V>,                       \
                          static_cast<unsigned>(csize), kEqualThreads,      \
                          csize, stream, w, t, bp, b, l, width, o, csize);
    FPX_EQUAL(16)
    FPX_EQUAL(8)
    FPX_EQUAL(4)
    FPX_EQUAL(2)
    FPX_EQUAL(1)
#undef FPX_EQUAL
  }
  return cudaErrorInvalidValue;
}

unsigned warp_blocks(long long rows) {
  return static_cast<unsigned>((rows * 32 + FPX_THREADS - 1) / FPX_THREADS);
}

// K16 union: thread i takes tail word i and watermark quad i.
template <bool kAlias>
__global__ void depset_union_kernel(const int32_t* a_wm,
                                    const uint8_t* a_tails,
                                    const int32_t* b_wm,
                                    const uint8_t* b_tails, int32_t* out_wm,
                                    uint8_t* out_tails, const int32_t* a_base,
                                    int32_t* out_base, long long n_wm,
                                    long long n_bytes, bool vec_wm,
                                    bool vec_tails) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long t0 = 16 * i, w0 = 4 * i;
  const bool full_t = vec_tails && t0 + 16 <= n_bytes;
  const bool full_w = vec_wm && w0 + 4 <= n_wm;
  // Loads: every one before the first store.
  uint4 ta = make_uint4(0, 0, 0, 0), tb = ta;
  int4 wa = make_int4(0, 0, 0, 0), wb = wa;
  if (full_t) {
    ta = *reinterpret_cast<const uint4*>(a_tails + t0);
    if (!kAlias) tb = *reinterpret_cast<const uint4*>(b_tails + t0);
  } else if (t0 < n_bytes) {
    uint8_t xa[16], xb[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      xa[k] = t0 + k < n_bytes ? a_tails[t0 + k] : 0;
      xb[k] = !kAlias && t0 + k < n_bytes ? b_tails[t0 + k] : 0;
    }
    memcpy(&ta, xa, 16);
    memcpy(&tb, xb, 16);
  }
  if (full_w) {
    wa = *reinterpret_cast<const int4*>(a_wm + w0);
    if (!kAlias) wb = *reinterpret_cast<const int4*>(b_wm + w0);
  } else if (w0 < n_wm) {
    int32_t ya[4], yb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ya[k] = w0 + k < n_wm ? a_wm[w0 + k] : 0;
      yb[k] = !kAlias && w0 + k < n_wm ? b_wm[w0 + k] : 0;
    }
    memcpy(&wa, ya, 16);
    memcpy(&wb, yb, 16);
  }
  const bool copy_base = i == 0 && out_base != nullptr;
  const int32_t base = copy_base ? *a_base : 0;
  if (!kAlias) {
    ta.x |= tb.x;
    ta.y |= tb.y;
    ta.z |= tb.z;
    ta.w |= tb.w;
    wa.x = max(wa.x, wb.x);
    wa.y = max(wa.y, wb.y);
    wa.z = max(wa.z, wb.z);
    wa.w = max(wa.w, wb.w);
  }
  // Stores.
  if (full_t) {
    *reinterpret_cast<uint4*>(out_tails + t0) = ta;
  } else if (t0 < n_bytes) {
    uint8_t xo[16];
    memcpy(xo, &ta, 16);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (t0 + k < n_bytes) out_tails[t0 + k] = xo[k];
    }
  }
  if (full_w) {
    *reinterpret_cast<int4*>(out_wm + w0) = wa;
  } else if (w0 < n_wm) {
    int32_t yo[4];
    memcpy(yo, &wa, 16);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (w0 + k < n_wm) out_wm[w0 + k] = yo[k];
    }
  }
  if (copy_base) *out_base = base;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Mode 0 was union, now depset_union_kernel.
enum PairMode { kIntersect = 1, kCompact = 2 };

__global__ void depset_pair_kernel(int mode, const int32_t* a_wm,
                                   const uint8_t* a_tails,
                                   const int32_t* b_wm,
                                   const uint8_t* b_tails,
                                   const int32_t* executed,
                                   long long ex_stride_b,
                                   long long ex_stride_l,
                                   const int32_t* base_p, long long rows,
                                   int l_count, int width, int32_t* out_wm,
                                   uint8_t* out_tails) {
  const long long row =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (row >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int32_t base = *base_p;
  const uint8_t* ta = a_tails + row * width;
  uint8_t* o = out_tails + row * width;
  const int32_t wa = a_wm[row];
  if (mode == kCompact) {
    const long long b = row / l_count, l = row % l_count;
    const int32_t raised =
        max(wa, executed[b * ex_stride_b + l * ex_stride_l]);
    const int32_t new_wm =
        fpx_normalized_watermark(raised, base, ta, width);
    for (int w = lane; w < width; w += 32) {
      o[w] = fpx_normalized_byte(ta, w, base, new_wm);
    }
    if (lane == 0) out_wm[row] = new_wm;
    return;
  }
  // kIntersect: the 0/1 membership bytes, then K9's scan over them.
  const uint8_t* tb = b_tails + row * width;
  const int32_t wb = b_wm[row];
  const int32_t low = min(wa, wb);
  for (int w = lane; w < width; w += 32) {
    const int32_t id = fpx_tail_id(base, w);
    const bool in_a = id < wa || ta[w] > 0;
    const bool in_b = id < wb || tb[w] > 0;
    o[w] = in_a && in_b && id >= low;
  }
  __syncwarp();  // the lanes' bytes are visible to the whole warp
  const int32_t new_wm = fpx_normalized_watermark(low, base, o, width);
  for (int w = lane; w < width; w += 32) {
    if (fpx_tail_id(base, w) < new_wm) o[w] = 0;
  }
  if (lane == 0) out_wm[row] = new_wm;
}

enum QueryMode { kEqual = 0, kSize = 1, kContains = 2 };

__global__ void depset_query_kernel(int mode, const int32_t* a_wm,
                                    const uint8_t* a_tails,
                                    const int32_t* b_wm,
                                    const uint8_t* b_tails,
                                    const int32_t* leader,
                                    long long leader_stride,
                                    const int32_t* vid, long long vid_stride,
                                    const int32_t* base_p, int b_count,
                                    int l_count, int width, void* out) {
  const long long bytes = static_cast<long long>(l_count) * width;
  if (mode == kContains) {
    const long long b =
        blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    if (b >= b_count) return;
    int col = leader[b * leader_stride];
    if (col < 0) col += l_count;
    col = min(max(col, 0), l_count - 1);
    const int32_t v = vid[b * vid_stride];
    const int32_t off = static_cast<int32_t>(static_cast<uint32_t>(v) -
                                             static_cast<uint32_t>(*base_p));
    const int off_c = min(max(off, 0), width - 1);
    const long long r = b * l_count + col;
    const bool in_prefix = v < a_wm[r];
    const bool in_tail =
        a_tails[r * width + off_c] > 0 && off >= 0 && off < width;
    static_cast<uint8_t*>(out)[b] = in_prefix || in_tail;
    return;
  }
  const long long b =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (b >= b_count) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int32_t* wa = a_wm + b * l_count;
  const uint8_t* ta = a_tails + b * bytes;
  if (mode == kSize) {
    uint32_t sum = 0;
    for (int l = lane; l < l_count; l += 32) sum += static_cast<uint32_t>(wa[l]);
    for (long long w = lane; w < bytes; w += 32) sum += ta[w];
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(FPX_FULL_WARP, sum, off);
    }
    if (lane == 0) static_cast<int32_t*>(out)[b] = static_cast<int32_t>(sum);
    return;
  }
  // kEqual
  const int32_t* wb = b_wm + b * l_count;
  const uint8_t* tb = b_tails + b * bytes;
  bool differ = false;
  for (int l = lane; l < l_count && !differ; l += 32) differ = wa[l] != wb[l];
  for (long long w = lane; w < bytes && !differ; w += 32) {
    differ = ta[w] != tb[w];
  }
  const bool any = __any_sync(FPX_FULL_WARP, differ);
  if (lane == 0) static_cast<uint8_t*>(out)[b] = !any;
}

}  // namespace

extern "C" int fpx_depset_normalized(const void* wm, const void* tails,
                                     const void* base, long long rows,
                                     int width, void* out_wm,
                                     void* out_tails, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  depset_normalized_kernel<<<warp_blocks(rows), FPX_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wm), static_cast<const uint8_t*>(tails),
      static_cast<const int32_t*>(base), rows, width,
      static_cast<int32_t*>(out_wm), static_cast<uint8_t*>(out_tails));
  return cudaGetLastError();
}

// block: watermarks, tails, tail_base, b, l, width, seqs (or 0), s,
// out_wm, out_tails, out_seq (or 0), device, stream.
extern "C" int fpx_depset_union_reduce(const void* block) {
  long long a[13];
  std::memcpy(a, block, sizeof a);
  const cudaError_t err = select_device(static_cast<int>(a[11]));
  if (err != cudaSuccess) return err;
  return union_reduce(pointer<const void>(a[0]), pointer<const void>(a[1]),
                      pointer<const void>(a[2]), static_cast<int>(a[3]),
                      static_cast<int>(a[4]), static_cast<int>(a[5]),
                      pointer<const void>(a[6]), static_cast<int>(a[7]),
                      pointer<void>(a[8]), pointer<void>(a[9]),
                      pointer<void>(a[10]), pointer<CUstream_st>(a[12]));
}

// block: watermarks, tails, tail_base, b, l, width, out (one bool byte),
// device, stream.
extern "C" int fpx_depset_all_equal(const void* block) {
  long long a[9];
  std::memcpy(a, block, sizeof a);
  const cudaError_t err = select_device(static_cast<int>(a[7]));
  if (err != cudaSuccess) return err;
  return all_equal(pointer<const void>(a[0]), pointer<const void>(a[1]),
                   pointer<const void>(a[2]), static_cast<int>(a[3]),
                   static_cast<int>(a[4]), static_cast<int>(a[5]),
                   pointer<void>(a[6]), pointer<CUstream_st>(a[8]));
}

// One K10 decision in one call. block: host_in, dev_in, in_bytes,
// host_out, dev_out, out_bytes, b, l, width, s (0: no seq mode), then the
// byte offsets in the input block of seqs, watermarks, base and tails and
// in the output block of seq, watermarks and tails, device, stream. The
// input block goes up, the kernel runs, the output block comes down, and
// the call returns after the stream has drained.
extern "C" int fpx_depset_union_staged(const void* block) {
  long long a[19];
  std::memcpy(a, block, sizeof a);
  auto* dev_in = pointer<uint8_t>(a[1]);
  auto* dev_out = pointer<uint8_t>(a[4]);
  const int s = static_cast<int>(a[9]);
  const cudaStream_t stream = pointer<CUstream_st>(a[18]);
  cudaError_t err = select_device(static_cast<int>(a[17]));
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(dev_in, pointer<const void>(a[0]),
                        static_cast<size_t>(a[2]), cudaMemcpyHostToDevice,
                        stream);
  if (err != cudaSuccess) return err;
  err = union_reduce(dev_in + a[11], dev_in + a[13], dev_in + a[12],
                     static_cast<int>(a[6]), static_cast<int>(a[7]),
                     static_cast<int>(a[8]), s > 0 ? dev_in + a[10] : nullptr,
                     s, dev_out + a[15], dev_out + a[16],
                     s > 0 ? dev_out + a[14] : nullptr, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(pointer<void>(a[3]), dev_out,
                        static_cast<size_t>(a[5]), cudaMemcpyDeviceToHost,
                        stream);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(stream);
}

// One K11 decision in one call. block: host_in, dev_in, in_bytes,
// host_out, dev_out (the answer byte), b, l, width, the byte offsets of
// watermarks, base and tails in the input block, device, stream.
extern "C" int fpx_depset_all_equal_staged(const void* block) {
  long long a[13];
  std::memcpy(a, block, sizeof a);
  auto* dev_in = pointer<uint8_t>(a[1]);
  const cudaStream_t stream = pointer<CUstream_st>(a[12]);
  cudaError_t err = select_device(static_cast<int>(a[11]));
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(dev_in, pointer<const void>(a[0]),
                        static_cast<size_t>(a[2]), cudaMemcpyHostToDevice,
                        stream);
  if (err != cudaSuccess) return err;
  err = all_equal(dev_in + a[8], dev_in + a[10], dev_in + a[9],
                  static_cast<int>(a[5]), static_cast<int>(a[6]),
                  static_cast<int>(a[7]), pointer<void>(a[4]), stream);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(pointer<void>(a[3]), pointer<const void>(a[4]), 1,
                        cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(stream);
}

// K16 union. block: a watermarks, a tails, b watermarks, b tails, out
// watermarks, out tails, a's tail_base, out's tail_base (or 0: not
// copied), rows (B * L), width, aliased (a and b the same tensors),
// device, stream.
extern "C" int fpx_depset_union(const void* block) {
  long long a[13];
  std::memcpy(a, block, sizeof a);
  const long long rows = a[8];
  if (rows <= 0) return cudaSuccess;
  const cudaError_t err = select_device(static_cast<int>(a[11]));
  if (err != cudaSuccess) return err;
  const auto* aw = pointer<const int32_t>(a[0]);
  const auto* at = pointer<const uint8_t>(a[1]);
  const auto* bw = pointer<const int32_t>(a[2]);
  const auto* bt = pointer<const uint8_t>(a[3]);
  auto* ow = pointer<int32_t>(a[4]);
  auto* ot = pointer<uint8_t>(a[5]);
  const long long n_bytes = rows * a[9];
  const bool aliased = a[10] != 0;
  const bool vec_wm = aligned16(aw) && aligned16(bw) && aligned16(ow);
  const bool vec_tails = aligned16(at) && aligned16(bt) && aligned16(ot);
  const long long threads = std::max((n_bytes + 15) / 16, (rows + 3) / 4);
  const unsigned blocks =
      static_cast<unsigned>((threads + FPX_THREADS - 1) / FPX_THREADS);
  const cudaStream_t s = pointer<CUstream_st>(a[12]);
  if (aliased) {
    depset_union_kernel<true><<<blocks, FPX_THREADS, 0, s>>>(
        aw, at, bw, bt, ow, ot, pointer<const int32_t>(a[6]),
        pointer<int32_t>(a[7]), rows, n_bytes, vec_wm, vec_tails);
  } else {
    depset_union_kernel<false><<<blocks, FPX_THREADS, 0, s>>>(
        aw, at, bw, bt, ow, ot, pointer<const int32_t>(a[6]),
        pointer<int32_t>(a[7]), rows, n_bytes, vec_wm, vec_tails);
  }
  return cudaGetLastError();
}

extern "C" int fpx_depset_pair(int mode, const void* a_wm, const void* a_tails,
                               const void* b_wm, const void* b_tails,
                               const void* executed, long long ex_stride_b,
                               long long ex_stride_l, const void* base,
                               int b, int l, int width, void* out_wm,
                               void* out_tails, int device, void* stream) {
  if (mode != kIntersect && mode != kCompact) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(b) * l;
  depset_pair_kernel<<<warp_blocks(rows), FPX_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const int32_t*>(a_wm),
      static_cast<const uint8_t*>(a_tails), static_cast<const int32_t*>(b_wm),
      static_cast<const uint8_t*>(b_tails),
      static_cast<const int32_t*>(executed), ex_stride_b, ex_stride_l,
      static_cast<const int32_t*>(base), rows, l, width,
      static_cast<int32_t*>(out_wm), static_cast<uint8_t*>(out_tails));
  return cudaGetLastError();
}

extern "C" int fpx_depset_query(int mode, const void* a_wm,
                                const void* a_tails, const void* b_wm,
                                const void* b_tails, const void* leader,
                                long long leader_stride, const void* vid,
                                long long vid_stride, const void* base,
                                int b, int l, int width, void* out,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      mode == kContains
          ? static_cast<unsigned>((b + FPX_THREADS - 1) / FPX_THREADS)
          : warp_blocks(b);
  depset_query_kernel<<<blocks, FPX_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const int32_t*>(a_wm),
      static_cast<const uint8_t*>(a_tails), static_cast<const int32_t*>(b_wm),
      static_cast<const uint8_t*>(b_tails),
      static_cast<const int32_t*>(leader), leader_stride,
      static_cast<const int32_t*>(vid), vid_stride,
      static_cast<const int32_t*>(base), b, l, width, out);
  return cudaGetLastError();
}
