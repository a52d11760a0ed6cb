// The block scan shared by the StreamVByte kernels (w2_codec.cu, w4_codec.cu,
// v1_codec.cu) and the probe's prefix sum, sm_90a: an exclusive scan of one
// value per thread inside a block, the step each one-pass kernel takes
// before its look-back (lookback.cuh) carries the sum across tiles.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Everything here has internal linkage (static, constexpr, inline), so each
// source that includes it owns its copy.
namespace vbz {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// Exclusive scan (mod 2^32) of one value per thread over a block of NT
// threads; *total receives the block's sum. smem holds NT/32 words.
template <int NT>
static __device__ __forceinline__ uint32_t
block_exclusive_scan(uint32_t v, uint32_t* total, uint32_t* smem) {
  static_assert(NT % 32 == 0 && NT <= 1024, "one warp scans the warp sums");
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? smem[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFullMask, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) smem[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp > 0 ? smem[warp - 1] : 0u;
  *total = smem[kWarps - 1];
  __syncthreads();  // smem may be reused by the caller's next scan
  return before + x - v;
}

static __device__ __forceinline__ int clamp_len(int n, int N) {
  return n < 0 ? 0 : (n > N ? N : n);
}

}  // namespace vbz
