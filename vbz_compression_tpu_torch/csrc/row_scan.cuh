// Scans shared by the StreamVByte kernels (w2_codec.cu, w4_codec.cu,
// v1_codec.cu) and the probe's prefix sum, sm_90a.
//
// block_exclusive_scan serves every kernel. The multi-pass kernels (V1E,
// V1D) split a batch of B rows into tiles of kTile values, four
// consecutive values (one key byte) per thread. The TPU kernels carried the
// running byte offset and the un-delta sum from one grid step to the next;
// CUDA blocks run in no order, so in these kernels each carry is a per-row
// scan over tile totals: a block scan inside the tile, row_exclusive_scan
// over the tiles of a row, and add_row_carry to add each tile's carry to its
// decoded values. The one-pass kernels carry by look-back (lookback.cuh).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

// Everything here has internal linkage (static, constexpr, inline), so each
// source that includes it owns its copy.
namespace vbz {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 4;
constexpr int kScanThreads = 1024;
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

// Exclusive scan of in[b, 0:T] into out[b, 0:T], one block per row; the
// row's sum goes to totals[b] when totals is not null.
static __global__ void row_exclusive_scan(const uint32_t* in, uint32_t* out,
                                          uint32_t* totals, int T) {
  __shared__ uint32_t smem[kScanThreads / 32];
  const size_t row = static_cast<size_t>(blockIdx.x) * T;
  uint32_t carry = 0;
  for (int base = 0; base < T; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const uint32_t v = t < T ? in[row + t] : 0u;
    uint32_t sum;
    const uint32_t e = block_exclusive_scan<kScanThreads>(v, &sum, smem);
    if (t < T) out[row + t] = carry + e;
    carry += sum;
  }
  if (totals != nullptr && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// out[b, i] += carry[b, tile of i] (mod 2^bits of X) for i < counts[b]:
// the un-delta sum of the row's earlier tiles. Grid (T, B), kThreads.
template <typename X>
static __global__ void add_row_carry(X* out, const int* counts,
                                     const uint32_t* carry, int N, int T) {
  using U = std::make_unsigned_t<X>;
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int count = clamp_len(counts[b], N);
  if (base >= count) return;
  const uint32_t c = carry[static_cast<size_t>(b) * T + blockIdx.x];
  if (c == 0) return;
  X* orow = out + static_cast<size_t>(b) * N;
  const int i0 = base + 4 * threadIdx.x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + k;
    if (i < count) {
      orow[i] = static_cast<X>(static_cast<U>(static_cast<U>(orow[i]) + c));
    }
  }
}

// Launches the two passes that finish an un-delta: row scan of the tiles'
// delta sums, then add_row_carry. scratch holds B*T u32.
template <typename X>
static int finish_undelta(X* out, const int* counts, const uint32_t* tile_sum,
                          uint32_t* tile_carry, int B, int N, int T,
                          cudaStream_t s) {
  row_exclusive_scan<<<B, kScanThreads, 0, s>>>(tile_sum, tile_carry, nullptr,
                                                T);
  int err = cudaGetLastError();
  if (err != 0) return err;
  add_row_carry<X><<<dim3(T, B), kThreads, 0, s>>>(out, counts, tile_carry, N,
                                                   T);
  return cudaGetLastError();
}

}  // namespace vbz
