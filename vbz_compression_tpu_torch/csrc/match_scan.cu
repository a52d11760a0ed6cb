// Bounded-offset match scan (kernel M) for Hopper, sm_90a.
//
// Replaces vbz_compression_tpu/ops/zstd_match_tpu.py match_candidates (:37,
// a jitted jnp function of shifted compares, not a pallas_call): for every
// position i of a byte buffer of n bytes, off[i] is the first offset o of
// the caller's list, in the caller's order, such that i >= o, i + 4 <= n and
// buf[i..i+4) == buf[i-o..i-o+4); 0 when there is none. The caller cuts the
// list at its first o with o + 4 > n, as the JAX function's `break` does.
// The host's greedy assembler (ops/zstd_seq.py find_sequences) extends each
// candidate to its true length, so the scan only certifies 4-byte matches.
//
// What bounds it: bytes, n read and 4n written (the int32 map); the compares,
// at most one per offset and position, stay below that at the card's integer
// rate. On the H100 each position's walk down the offset list, not the
// bytes, takes most of the time (PERF.md, the kernel table's row 18).
//
// Design: one block per tile of kTile positions. The tile's bytes, the
// kHaloCap bytes behind it at most (as far back as the list's largest offset
// reaches) and the 3 bytes ahead of it are staged in shared memory once,
// with bytes past n read as 0, and turned into one 32-bit window per
// position, so a compare is one shared load. Thread t takes positions t,
// t + kThreads, ... of the tile, so a warp's loads at one offset fall on
// consecutive words (no bank conflicts) and its stores of off are coalesced.
// Each position walks the list in order and stops at its first match. An
// offset beyond the staged halo compares against a window read from global
// memory (the JAX function takes any offset list). The list travels by value
// in the launch's parameters, so a launch allocates nothing and copies
// nothing to the card, and launches from several host threads, each on its
// own current stream, share no state.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                  // positions per block
constexpr int kPer = kTile / kThreads;       // positions per thread
constexpr int kHaloCap = 4096;               // bytes staged behind a tile
constexpr int kMaxOffsets = 256;             // offsets in one launch

struct OffsetList {
  int count;
  int halo;  // min(largest offset, kHaloCap)
  int32_t o[kMaxOffsets];
};

__device__ __forceinline__ uint32_t window_global(const uint8_t* buf,
                                                  long long p) {
  return static_cast<uint32_t>(buf[p]) |
         (static_cast<uint32_t>(buf[p + 1]) << 8) |
         (static_cast<uint32_t>(buf[p + 2]) << 16) |
         (static_cast<uint32_t>(buf[p + 3]) << 24);
}

__global__ void __launch_bounds__(kThreads)
    match_scan(const uint8_t* __restrict__ buf, int32_t* __restrict__ off,
               long long n, const OffsetList list) {
  __shared__ uint8_t bytes[kHaloCap + kTile + 4];
  __shared__ uint32_t win[kHaloCap + kTile];
  __shared__ int32_t offs[kMaxOffsets];

  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long base = t0 > list.halo ? t0 - list.halo : 0;
  const int span = static_cast<int>(t0 + kTile - base);  // windows staged
  for (int j = threadIdx.x; j < span + 3; j += kThreads) {
    const long long p = base + j;
    bytes[j] = p < n ? buf[p] : 0;
  }
  for (int k = threadIdx.x; k < list.count; k += kThreads) {
    offs[k] = list.o[k];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += kThreads) {
    win[j] = static_cast<uint32_t>(bytes[j]) |
             (static_cast<uint32_t>(bytes[j + 1]) << 8) |
             (static_cast<uint32_t>(bytes[j + 2]) << 16) |
             (static_cast<uint32_t>(bytes[j + 3]) << 24);
  }
  __syncthreads();

  const int halo = list.halo;
  const int count = list.count;
#pragma unroll 4
  for (int k = 0; k < kPer; ++k) {
    const long long i = t0 + threadIdx.x + k * kThreads;
    if (i >= n) {
      break;
    }
    int32_t best = 0;
    if (i + 4 <= n) {
      const int local = static_cast<int>(i - base);
      const uint32_t w = win[local];
      for (int q = 0; q < count; ++q) {
        const int o = offs[q];
        if (o > i) {
          continue;  // a later offset of an unsorted list may still fit
        }
        const uint32_t src = o <= halo ? win[local - o]
                                       : window_global(buf, i - o);
        if (src == w) {
          best = o;
          break;
        }
      }
    }
    off[i] = best;
  }
}

}  // namespace

extern "C" {

// buf: [n] uint8; off: [n] int32 (written whole); offsets: a host array of
// n_offsets offsets, each >= 1, already cut at the first o with o + 4 > n.
int vbz_match_candidates(const void* buf, void* off, long long n,
                         const int32_t* offsets, int n_offsets,
                         void* stream) {
  if (n <= 0 || n_offsets < 0 || n_offsets > kMaxOffsets ||
      (n_offsets > 0 && offsets == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OffsetList list;
  list.count = n_offsets;
  list.halo = 0;
  for (int k = 0; k < n_offsets; ++k) {
    if (offsets[k] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    list.o[k] = offsets[k];
    if (offsets[k] > list.halo) {
      list.halo = offsets[k] < kHaloCap ? offsets[k] : kHaloCap;
    }
  }
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  match_scan<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<int32_t*>(off), n, list);
  return static_cast<int>(cudaGetLastError());
}

// The positions each block takes, for tests that place lengths on tile
// edges.
int vbz_match_tile() { return kTile; }

// The bytes behind a tile held in shared memory; larger offsets are read
// from device memory.
int vbz_match_halo() { return kHaloCap; }

}  // extern "C"
