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
// the time. The design is the simple one: no shared-memory tiling, no
// TMA. K9 and K11 give each row one warp, whose lanes stride over the
// bytes (coalesced) and share the run's scan (depset.cuh). K10 gives
// each leader column one block: its threads split the B rows into
// groups and the W bytes among a group, keep a running max in a
// register, and fold it into a shared int array with shared atomicMax
// (order-free, so the result is deterministic), 2048 bytes at a time;
// warp 0 then normalizes the row and all threads clear it in place.
//
// K16 depset_pair (union L49, intersect L181, compact L213) and K17
// depset_query (equal L129, size L161, _contains_kernel L137 under
// contains L148) are the rest of the algebra, rowwise over [B, L, W]:
//   K16 union     max of the watermarks, OR of the tail bytes, NOT
//                 normalized (as the reference);
//       intersect ids below both watermarks stay prefix (min); an id is
//                 in a set if below its watermark or its byte is > 0;
//                 the 0/1 bytes of `in both and >= min` are written, then
//                 normalized in place (K9's scan over the written row);
//       compact   max(watermark, executed) -- `executed` broadcast over
//                 [B, L] through strides (0 for a broadcast axis) --
//                 then normalized, as K9 with the raised watermark.
//     One warp per (b, l) row, the lanes striding over the W bytes. The
//     inputs may alias (union(deps, deps)): nothing is __restrict__.
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

#include <climits>

#include "depset.cuh"
#include "quorum.cuh"

namespace {

constexpr int kChunk = 2048;  // tail bytes reduced per shared pass (K10)
// K10's threads per block: one block per leader column has to keep many
// loads in flight on its SM (at depset_lt's [4096, 3, 32] a column is
// 128 KB read by one block).
constexpr int kUnionThreads = 512;

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

__global__ void depset_union_reduce_kernel(
    const int32_t* __restrict__ wm, const uint8_t* __restrict__ tails,
    const int32_t* __restrict__ base_p, int b, int l_count, int width,
    const int32_t* __restrict__ seqs, int s, int32_t* __restrict__ out_wm,
    uint8_t* out_tails, int32_t* __restrict__ out_seq) {
  __shared__ int s_max[kChunk];
  __shared__ int s_wm;
  __shared__ int s_seq;
  __shared__ int32_t s_new_wm;
  const int l = blockIdx.x;
  if (threadIdx.x == 0) {
    s_wm = INT_MIN;
    s_seq = INT_MIN;
  }
  __syncthreads();
  if (seqs != nullptr && l == 0) {
    int m = INT_MIN;
    for (int i = threadIdx.x; i < s; i += blockDim.x) m = max(m, seqs[i]);
    atomicMax(&s_seq, m);
  }
  if (l < l_count) {  // uniform across the block
    int m = INT_MIN;
    for (int i = threadIdx.x; i < b; i += blockDim.x) {
      m = max(m, wm[static_cast<long long>(i) * l_count + l]);
    }
    atomicMax(&s_wm, m);
    uint8_t* row = out_tails + static_cast<long long>(l) * width;
    const long long row_stride = static_cast<long long>(l_count) * width;
    const uint8_t* col = tails + static_cast<long long>(l) * width;
    for (int c0 = 0; c0 < width; c0 += kChunk) {
      const int cw = min(kChunk, width - c0);
      // `lanes` threads along the bytes; `groups` of them split the rows.
      const int lanes = cw < static_cast<int>(blockDim.x)
                            ? cw : static_cast<int>(blockDim.x);
      const int groups = blockDim.x / lanes;
      const int g = threadIdx.x / lanes;
      const int lane = threadIdx.x % lanes;
      for (int w = threadIdx.x; w < cw; w += blockDim.x) s_max[w] = 0;
      __syncthreads();
      if (g < groups) {
        for (int w = lane; w < cw; w += lanes) {
          int bm = 0;
          for (int bi = g; bi < b; bi += groups) {
            bm = max(bm, static_cast<int>(col[bi * row_stride + c0 + w]));
          }
          atomicMax(&s_max[w], bm);
        }
      }
      __syncthreads();
      for (int w = threadIdx.x; w < cw; w += blockDim.x) {
        row[c0 + w] = static_cast<uint8_t>(s_max[w]);
      }
      __syncthreads();
    }
    __syncthreads();  // s_wm complete (and the row, when width == 0)
    const int32_t base = *base_p;
    if (threadIdx.x < 32) {
      const int32_t new_wm =
          fpx_normalized_watermark(s_wm, base, row, width);
      if (threadIdx.x == 0) s_new_wm = new_wm;
    }
    __syncthreads();
    const int32_t new_wm = s_new_wm;
    for (int w = threadIdx.x; w < width; w += blockDim.x) {
      if (fpx_tail_id(base, w) < new_wm) row[w] = 0;
    }
    if (threadIdx.x == 0) out_wm[l] = new_wm;
  }
  if (seqs != nullptr && l == 0) {  // uniform across the block
    __syncthreads();
    if (threadIdx.x == 0) *out_seq = s_seq;
  }
}

__global__ void depset_all_equal_kernel(const int32_t* __restrict__ wm,
                                        const uint8_t* __restrict__ tails,
                                        const int32_t* __restrict__ base_p,
                                        int l_count, long long rows,
                                        int width, uint8_t* out) {
  // One warp per row (b >= 1, l), held against row (0, l); `rows` is
  // (B - 1) * L and row-major index b * L + l is l_count + r.
  const long long r =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long row = l_count + r;
  const long long row0 = row % l_count;
  const int32_t base = *base_p;
  const uint8_t* t = tails + row * width;
  const uint8_t* t0 = tails + row0 * width;
  const int32_t new_wm = fpx_normalized_watermark(wm[row], base, t, width);
  const int32_t new_wm0 =
      fpx_normalized_watermark(wm[row0], base, t0, width);
  bool differ = new_wm != new_wm0;
  for (int w = lane; w < width && !differ; w += 32) {
    differ = fpx_normalized_byte(t, w, base, new_wm)
             != fpx_normalized_byte(t0, w, base, new_wm0);
  }
  // Every writer stores the same 0, so the race between warps is benign.
  if (__any_sync(FPX_FULL_WARP, differ) && lane == 0) *out = 0;
}

unsigned warp_blocks(long long rows) {
  return static_cast<unsigned>((rows * 32 + FPX_THREADS - 1) / FPX_THREADS);
}

enum PairMode { kUnion = 0, kIntersect = 1, kCompact = 2 };

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
  if (mode == kUnion) {
    const uint8_t* tb = b_tails + row * width;
    for (int w = lane; w < width; w += 32) o[w] = ta[w] | tb[w];
    if (lane == 0) out_wm[row] = max(wa, b_wm[row]);
    return;
  }
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

extern "C" int fpx_depset_union_reduce(const void* wm, const void* tails,
                                       const void* base, int b, int l,
                                       int width, const void* seqs, int s,
                                       void* out_wm, void* out_tails,
                                       void* out_seq, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(l > 0 ? l : 1);
  depset_union_reduce_kernel<<<blocks, kUnionThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wm), static_cast<const uint8_t*>(tails),
      static_cast<const int32_t*>(base), b, l, width,
      static_cast<const int32_t*>(seqs), s, static_cast<int32_t*>(out_wm),
      static_cast<uint8_t*>(out_tails), static_cast<int32_t*>(out_seq));
  return cudaGetLastError();
}

extern "C" int fpx_depset_all_equal(const void* wm, const void* tails,
                                    const void* base, int b, int l,
                                    int width, void* out, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // The answer starts true; a differing row stores 0.
  err = cudaMemsetAsync(out, 1, 1, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(b - 1) * l;
  if (rows > 0) {
    depset_all_equal_kernel<<<warp_blocks(rows), FPX_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(wm),
        static_cast<const uint8_t*>(tails),
        static_cast<const int32_t*>(base), l, rows, width,
        static_cast<uint8_t*>(out));
  }
  return cudaGetLastError();
}

extern "C" int fpx_depset_pair(int mode, const void* a_wm, const void* a_tails,
                               const void* b_wm, const void* b_tails,
                               const void* executed, long long ex_stride_b,
                               long long ex_stride_l, const void* base,
                               int b, int l, int width, void* out_wm,
                               void* out_tails, int device, void* stream) {
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
