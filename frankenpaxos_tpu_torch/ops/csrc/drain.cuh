// Device helpers of the drain kernels (K3 and K14 in pipeline.cu, K19-K21
// in pipeline_sharded.cu): the ring's floor modulus, int32 wraparound
// arithmetic, the reference's vote-arrival hash, a block reduction and the
// telemetry plane's lag bucket.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fpx_drain {

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// _arrivals: ((lane*1103515245 + acc*12820163 + i*22695477) >> 7) & 7 < 7
// in int32. Bits 7..9 of the wrapped sum do not depend on how the shift
// treats the sign, so an unsigned shift is exact.
__device__ __forceinline__ uint8_t arrives(int lane, int acc, int i) {
  const uint32_t h = static_cast<uint32_t>(lane) * 1103515245u +
                     static_cast<uint32_t>(acc) * 12820163u +
                     static_cast<uint32_t>(i) * 22695477u;
  return ((h >> 7) & 7u) < 7u ? 1 : 0;
}

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* shared) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x < blockDim.x / 32) v = shared[threadIdx.x];
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  }
  return v;  // valid in thread 0
}

// lag_bucket: how many of 2^0 .. 2^14 the signed lag reaches.
__device__ __forceinline__ int lag_bucket(int32_t lag) {
  int bucket = 0;
  for (int k = 0; k < 15; ++k) bucket += lag >= (1 << k);
  return bucket;
}

__device__ __forceinline__ void bump(int32_t* x, uint32_t by) {
  *x = static_cast<int32_t>(static_cast<uint32_t>(*x) + by);
}

}  // namespace fpx_drain
