// The IntPrefixSet normalization of one dependency-set row, shared by
// K9 normalized, K10 union_reduce / conflict_max and K11 all_equal
// (csrc/depset.cu).
//
// It reproduces frankenpaxos_tpu/ops/depset.py::normalized for one
// (b, l) row of W tail bytes at watermark `wm` and window base `base`:
//
//   ids[w]       = int32(base + w), wrapping (uint32 add, then a cast);
//   present_from = ids[w] >= wm ? tails[w] : 1        (uint8);
//   run          = sum_w cumprod(present_from)[w]     (uint8 product
//                  wrapping mod 256, uint32 sum);
//   new_wm       = wm >= base ? max(wm, int32(base + run)) : wm;
//   out[w]       = ids[w] < new_wm ? 0 : tails[w].
//
// The comparisons are signed int32, so ids past 2^31 - 1 wrap negative
// and count as covered, as in the reference. Bytes other than 0/1 enter
// the product as they are: [2, 3, 1, 0] at wm = base gives run 2+6+6 = 14.
//
// A warp computes `run` together: each pass takes 32 bytes, and the
// last lane's product carries into the next pass. When the pass's
// factors are all 0 or 1 (every batch built from sets), the products are
// the carry up to the first zero and 0 from there, so one __ballot_sync
// and __ffs give the pass's sum. Otherwise a shuffle scan forms the
// products mod 256 and a shuffle sum adds them. Once the product is 0 it
// stays 0 (0 * x = 0, also when 16 * 16 wraps to 0), so the loop stops
// there: the work is the length of the run, not W. The `wm - base` ids
// below the watermark are factors of 1 and are counted without a pass.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FPX_FULL_WARP 0xffffffffu

__device__ __forceinline__ int32_t fpx_tail_id(int32_t base, int w) {
  return static_cast<int32_t>(static_cast<uint32_t>(base)
                              + static_cast<uint32_t>(w));
}

// The normalized watermark of one row. Every lane of the warp calls it
// with the same arguments and gets the same result. `tails` is not
// __restrict__: K10 passes the row it has just written.
__device__ __forceinline__ int32_t fpx_normalized_watermark(
    int32_t wm, int32_t base, const uint8_t* tails, int width) {
  if (wm < base) return wm;
  const int lane = threadIdx.x & 31;
  const long long gap = static_cast<long long>(wm) - base;
  const int start = gap >= width ? width : static_cast<int>(gap);
  uint32_t run = static_cast<uint32_t>(start);
  uint32_t carry = 1;
  for (int w0 = start; w0 < width; w0 += 32) {
    const int w = w0 + lane;
    uint32_t p = 1;
    if (w < width) {
      p = fpx_tail_id(base, w) >= wm ? tails[w] : 1u;
    }
    if (__all_sync(FPX_FULL_WARP, p <= 1u)) {
      // Lanes past the row hold 1, so a zero lies inside the row.
      const unsigned zeros = __ballot_sync(FPX_FULL_WARP, p == 0u);
      if (zeros == 0) {
        const int valid = width - w0 < 32 ? width - w0 : 32;
        run += carry * static_cast<uint32_t>(valid);
        continue;
      }
      run += carry * static_cast<uint32_t>(__ffs(zeros) - 1);
      break;
    }
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t q = __shfl_up_sync(FPX_FULL_WARP, p, off);
      if (lane >= off) p = (p * q) & 0xffu;
    }
    p = (p * carry) & 0xffu;
    uint32_t s = w < width ? p : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FPX_FULL_WARP, s, off);
    }
    run += s;
    carry = __shfl_sync(FPX_FULL_WARP, p, 31);
    if (carry == 0) break;
  }
  const int32_t raised =
      static_cast<int32_t>(static_cast<uint32_t>(base) + run);
  return raised > wm ? raised : wm;
}

// Tail byte w of a row after normalization to `new_wm`.
__device__ __forceinline__ uint8_t fpx_normalized_byte(
    const uint8_t* tails, int w, int32_t base, int32_t new_wm) {
  return fpx_tail_id(base, w) < new_wm ? 0 : tails[w];
}
