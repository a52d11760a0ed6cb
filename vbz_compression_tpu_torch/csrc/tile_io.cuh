// Tile loads, stores and staging shared by the one-pass StreamVByte kernels
// (w2_codec.cu: E and D; w4_codec.cu: E4 and D4; v1_codec.cu: V1E and V1D),
// sm_90a.
//
// A one-pass kernel owns a tile of kThreads x kPerThread values of one row,
// taken by the ticket of lookback.cuh. Each thread holds 16 consecutive
// values: one 32-bit key word, and its values packed into 32-bit words
// (kLanes values of X per word). The tile's data bytes move between device
// memory and a staging buffer in shared memory as 16-byte vectors.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "row_scan.cuh"

// Everything here has internal linkage (static, constexpr), so each source
// that includes it owns its copy.
namespace vbz {

constexpr int kPerThread = 16;  // values per thread: 4 key bytes
constexpr int kPassTile = kThreads * kPerThread;  // values per tile

// A thread's values live packed in 32-bit words: kLanes values of X each.
template <typename X>
constexpr int kLanes = 4 / static_cast<int>(sizeof(X));
template <typename X>
constexpr int kWords = kPerThread / kLanes<X>;

// Value k of a thread's packed words, sign-extended.
template <typename X>
static __device__ __forceinline__ int lane_value(const uint32_t* w, int k) {
  using U = std::make_unsigned_t<X>;
  return static_cast<X>(static_cast<U>(
      w[k / kLanes<X>] >> (8 * sizeof(X) * (k % kLanes<X>))));
}

// Values i0..i0+15 of a row of N as packed words (0 past N). kAligned: the
// tensor starts on a word of 4 values (16 bytes of int32, 8 of int16, 4 of
// int8), and so does every row, since N % 4 == 0; whole runs of 16 then move
// as 16-byte vectors where the address allows, else as such words.
// Otherwise (a view at an odd storage offset), and at a row's end, one value
// at a time. The launch picks kAligned from the tensor's address, so the
// common case pays no check for the rare one.
template <typename X, bool kAligned>
static __device__ __forceinline__ void load_words(const X* row, int i0, int N,
                                                  uint32_t w[kWords<X>]) {
  const X* p = row + i0;
  if (!kAligned || i0 + kPerThread > N) {
    using U = std::make_unsigned_t<X>;
#pragma unroll
    for (int q = 0; q < kWords<X>; ++q) w[q] = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (i0 + k < N) {
        w[k / kLanes<X>] |= static_cast<uint32_t>(static_cast<U>(p[k]))
                            << (8 * sizeof(X) * (k % kLanes<X>));
      }
    }
  } else if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kWords<X> / 4; ++q) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = a.x;
      w[4 * q + 1] = a.y;
      w[4 * q + 2] = a.z;
      w[4 * q + 3] = a.w;
    }
  } else if constexpr (sizeof(X) == 2) {
#pragma unroll
    for (int q = 0; q < kWords<X> / 2; ++q) {
      const uint2 a = reinterpret_cast<const uint2*>(p)[q];
      w[2 * q] = a.x;
      w[2 * q + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWords<X>; ++q) {
      w[q] = reinterpret_cast<const uint32_t*>(p)[q];
    }
  }
}

// Stores packed words as values i0..i0+15 of a row of N (none past N).
// kAligned: the tensor starts on a word of 4 values, and so does every row
// (N % 4 == 0); whole runs of 16 then move as 16-byte vectors where the
// address allows, else as 8- or 4-byte words. Otherwise (a view at an odd
// storage offset), and at a row's end, one value at a time. The launch picks
// kAligned from the tensor's address (word_aligned), so the common case pays
// no check for the rare one.
template <typename X, bool kAligned>
static __device__ __forceinline__ void store_words(X* row, int i0, int N,
                                                   const uint32_t* w) {
  X* p = row + i0;
  if (!kAligned || i0 + kPerThread > N) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (i0 + k < N) p[k] = static_cast<X>(lane_value<X>(w, k));
    }
  } else if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kWords<X> / 4; ++q) {
      reinterpret_cast<uint4*>(p)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  } else if constexpr (sizeof(X) == 2) {
#pragma unroll
    for (int q = 0; q < kWords<X> / 2; ++q) {
      reinterpret_cast<uint2*>(p)[q] = make_uint2(w[2 * q], w[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWords<X>; ++q) {
      reinterpret_cast<uint32_t*>(p)[q] = w[q];
    }
  }
}

// Whether a tensor of X starts on a word of 4 values (kAligned above).
template <typename X>
static bool word_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(X)) == 0;
}

// The 4 key bytes of values i0..i0+15 of a row of N (0 past N): one 32-bit
// access where the key row allows (N % 16 == 0), else byte by byte.
static __device__ __forceinline__ uint32_t load_keys(const uint8_t* krow,
                                                     int i0, int N) {
  const uint8_t* p = krow + i0 / 4;
  if (i0 + kPerThread <= N && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  uint32_t key = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + 4 * j < N) key |= static_cast<uint32_t>(p[j]) << (8 * j);
  }
  return key;
}

// Stores the 4 key bytes of values i0..i0+15 (none past N), as load_keys
// reads them.
static __device__ __forceinline__ void store_keys(uint8_t* krow, int i0,
                                                  int N, uint32_t key) {
  uint8_t* p = krow + i0 / 4;
  if (i0 + kPerThread <= N && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = key;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + 4 * j < N) p[j] = static_cast<uint8_t>(key >> (8 * j));
  }
}

// Moves the byte span [lo, hi) of device memory to (kToShared) or from the
// staging buffer, which holds it from stage + lo % 16: both sides agree mod
// 16, so every whole 16-byte word of the span moves as one vector. The bytes
// before the first whole word move one per thread on threads 0-31, those
// after the last on threads 32-47. Nothing outside [lo, hi) is touched.
template <bool kToShared>
static __device__ __forceinline__ void move_span(uint8_t* stage, uintptr_t lo,
                                                 uintptr_t hi) {
  const uintptr_t base = lo & ~uintptr_t{15};
  uintptr_t va = (lo + 15) & ~uintptr_t{15};
  uintptr_t vb = hi & ~uintptr_t{15};
  if (va >= vb) va = vb = hi;  // no whole word: the head takes all (< 32)
  for (uintptr_t a = va + 16 * threadIdx.x; a < vb; a += 16 * blockDim.x) {
    uint4* g = reinterpret_cast<uint4*>(a);
    uint4* s = reinterpret_cast<uint4*>(stage + (a - base));
    if constexpr (kToShared) {
      *s = *g;
    } else {
      *g = *s;
    }
  }
  const uintptr_t a = threadIdx.x < 32 ? lo + threadIdx.x
                                       : vb + (threadIdx.x - 32);
  const uintptr_t end = threadIdx.x < 32 ? va : hi;
  if (threadIdx.x < 48 && a < end) {
    uint8_t* g = reinterpret_cast<uint8_t*>(a);
    uint8_t* s = stage + (a - base);
    if constexpr (kToShared) {
      *s = *g;
    } else {
      *g = *s;
    }
  }
}

// How many of a thread's values lie before the row's length, and the mask
// of their 2-bit key fields.
static __device__ __forceinline__ int live_values(int len, int i0) {
  const int n = len - i0;
  return n < 0 ? 0 : (n > kPerThread ? kPerThread : n);
}

static __device__ __forceinline__ uint32_t live_key_mask(int live) {
  return live >= kPerThread ? ~0u : (1u << (2 * live)) - 1u;
}

// Tiles of a [B, N] batch, or 0 when they do not fit one grid.
static int grid_tiles(int B, int N) {
  const long long tiles =
      static_cast<long long>(B) * ((N + kPassTile - 1) / kPassTile);
  return tiles > INT_MAX ? 0 : static_cast<int>(tiles);
}

// Row b and tile t of a ticket: tickets run across the rows first (ticket
// t * B + b), so the rows' look-back chains advance side by side, and every
// tile a look-back waits on (same row, lower t) holds a lower ticket.
static __device__ __forceinline__ void tile_of_ticket(uint32_t ticket, int T,
                                                      int* b, int* t) {
  const uint32_t B = gridDim.x / T;
  *t = static_cast<int>(ticket / B);
  *b = static_cast<int>(ticket - static_cast<uint32_t>(*t) * B);
}

}  // namespace vbz
