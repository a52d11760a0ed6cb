// Blocked copy (kernel CP) for Hopper, sm_90a.
//
// Replaces vbz_compression_tpu/utils/roofline.py copy_blocked (pallas_call
// at :68, _copy_kernel at :60): a [R, 128] int32 array copied through blocks
// of (rows, 128), timed to measure the bandwidth that the codec kernels'
// shares are reckoned against.
//
// What bounds it: bytes, 4 read and 4 written per value; there is no
// arithmetic. Design: the tiles of (rows, 128) lie back to back, so the copy
// is one of tiles * rows * 32 int4 vectors, and the tile height decides
// nothing about how the SMs share the work (one block per tile, as the TPU
// grid had it, left most SMs idle when the tiles were few and large). Each
// thread moves one 16-byte vector per pass, neighbouring threads neighbouring
// vectors, over a grid that covers the whole array up to kMaxGrid blocks and
// strides beyond it. A grid sized to the SMs, each thread looping over
// several vectors, read a few percent below cudaMemcpy on the H100; this one
// matches it. Registers stand in for the TPU's VMEM block: nothing is staged
// in shared memory. The caller guarantees that R is a multiple of rows (the
// TPU kernel's grid of R // rows left a ragged tail unwritten).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr long long kMaxGrid = 1LL << 20;        // 2^28 vectors per pass
constexpr long long kVecsPerRow = 128 * 4 / 16;  // int4 vectors in 128 int32

__global__ void __launch_bounds__(kCopyThreads)
    copy_vecs(const int4* __restrict__ x, int4* __restrict__ out,
              long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kCopyThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kCopyThreads) +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = x[i];
  }
}

}  // namespace

extern "C" {

// x, out: [tiles * rows, 128] int32, 16-byte aligned, not overlapping.
int vbz_copy_blocked(const void* x, void* out, long long tiles, int rows,
                     void* stream) {
  if (tiles <= 0 || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = tiles * rows * kVecsPerRow;
  const long long blocks = (n + kCopyThreads - 1) / kCopyThreads;
  const long long grid = blocks < kMaxGrid ? blocks : kMaxGrid;
  copy_vecs<<<static_cast<unsigned>(grid), kCopyThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
