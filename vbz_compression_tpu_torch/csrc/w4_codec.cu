// W4 StreamVByte encode (kernel E4) and decode (kernel D4) for Hopper,
// sm_90a.
//
// W4 is the v0 StreamVByte stage for the flavors whose values take 1-4
// bytes: "zz32" (int32, 32-bit wrapped delta, then zig-zag) and the
// no-zig-zag flavors "none32", "none16" and "none8", which SIGN-EXTEND their
// int32/int16/int8 input to 32 bits (negative values take 4 bytes) and
// encode it as it is. Each value v takes code
// c = (v > 0xFF) + (v > 0xFFFF) + (v > 0xFFFFFF): key byte i/4 holds c at bit
// 2*(i%4), and the data section holds the low c + 1 bytes of v,
// little-endian, at the exclusive prefix sum of (c + 1).
//
// Replaces the TPU kernels pallas_codec3.encode_w4 / decode_w4 (chunks under
// 16384 values) and pallas_w4.encode_w4_dense / decode_w4_dense with
// byte_offsets_from_keys_w4 (longer chunks). The TPU needed two pairs for
// block-size limits and a deletion-compaction network because Mosaic has no
// scatter or gather; here each thread writes or gathers its own bytes at a
// scanned offset, so one pair covers every length and every content.
//
// What bounds them is bytes: 1-4 read per input value, 0.25 key bytes plus
// 1-4 data bytes written (encode), the reverse on decode.
//   E4: one launch with kernel E's design (w2_codec.cu): tiles of kPassTile
//       values taken by ticket (lookback.cuh), 16 values per thread loaded
//       once with 16-byte vectors (zz32 takes the previous sample from the
//       neighbouring thread through shared memory), codes and byte counts by
//       popcount, a block scan, one 32-bit key store per thread, a look-back
//       for the tile's byte offset, the thread's data bytes packed into
//       aligned words in registers and staged in shared memory, and the
//       tile's span stored with 16-byte vectors (each data byte belongs to
//       one thread and one tile, so no atomics).
//   D4: one launch with the same design: tiles by ticket, one 32-bit key
//       word per
//       thread and byte counts by popcount, a block scan and a look-back for
//       the tile's byte offset, the span staged in shared memory (clipped at
//       D) with 16-byte vectors, each value's 1 + code bytes taken through a
//       window of two aligned shared words. zz32 then un-zig-zags, sums in
//       the thread, block-scans and looks back a second time for the row's
//       un-delta carry; the none flavors carry nothing more. The output is
//       written once, truncated to X, with 16-byte stores where aligned.
//
// Layout: a batch is B rows of N values (N % 4 == 0) with a per-row length.
// Keys are [B, N/4] u8, encode data is [B, 4N] u8 (each row dense from byte
// 0), decode data is [B, D] u8 for any D. Values at or past a row's length
// take code 0, write no data, and decode to 0 (whatever their key bits
// say); decode never reads a byte at or past D. Entry points launch on the
// given stream, allocate nothing (the caller passes the zeroed look-back
// state) and return cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "lookback.cuh"
#include "tile_io.cuh"

namespace {

using namespace vbz;

__device__ __forceinline__ uint32_t w4_code(uint32_t v) {
  return (v > 0xFFu) + (v > 0xFFFFu) + (v > 0xFFFFFFu);
}

// Blocks an SM holds at once for E4: 8 x 256 threads cap registers at 32
// (spilling 8-28 bytes a thread); 4-7 blocks measured no faster (PERF.md).
constexpr int kMinBlocksE4 = 8;
// Staged data: at most 4 bytes per value, after up to 15 bytes that align
// the shared buffer with the span's address mod 16.
constexpr int kStageBytesE4 = 4 * kPassTile + 16;

// Value k of a thread's 16 as the stream stores it: zz32's words hold the
// zig-zag values already, the none flavors' their packed input, which is
// sign-extended here.
template <typename X, bool kZigzag>
__device__ __forceinline__ uint32_t stored_value(const uint32_t* w, int k) {
  if constexpr (kZigzag) {
    return w[k];
  } else {
    return static_cast<uint32_t>(lane_value<X>(w, k));
  }
}

// Writes a thread's data bytes into the staging buffer from byte pos on:
// value k's low 1 + code bytes, none for values at or past the row's length
// (whose code is 0). A value's bytes above its code are 0, so the bytes are
// packed into aligned words in registers by shifts alone; each whole word is
// one 32-bit store, and the partial words at either end, which the
// neighbouring threads share, are stored byte by byte. Storing every value's
// 4 bytes one by one, the later values overwriting the extra ones, measured
// up to 2.4x slower (PERF.md).
template <typename X, bool kZigzag>
__device__ __forceinline__ void stage_values(uint8_t* stage, uint32_t pos,
                                             const uint32_t* w, uint32_t code,
                                             int live) {
  uint32_t* s32 = reinterpret_cast<uint32_t*>(stage);
  uint32_t wi = pos >> 2;
  uint32_t head = pos & 3u;  // bytes of word wi before the thread's first
  uint32_t fill = head;      // bytes of word wi taken, < 4
  uint32_t cur = 0;          // word wi's bytes from this thread
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const bool on = k < live;
    const uint32_t v = on ? stored_value<X, kZigzag>(w, k) : 0u;
    const uint32_t n = on ? 1u + ((code >> (2 * k)) & 3u) : 0u;
    const uint32_t low = cur | (v << (8 * fill));
    const uint32_t high = __funnelshift_l(v, 0u, 8 * fill);  // 0 for fill 0
    fill += n;
    if (fill >= 4) {  // word wi is complete: at most one per value
      if (head == 0) {
        s32[wi] = low;
      } else {
#pragma unroll
        for (uint32_t j = 1; j < 4; ++j) {
          if (j >= head) {
            stage[4 * wi + j] = static_cast<uint8_t>(low >> (8 * j));
          }
        }
        head = 0;
      }
      ++wi;
      fill -= 4;
      cur = high;
    } else {
      cur = low;
    }
  }
#pragma unroll
  for (uint32_t j = 0; j < 3; ++j) {
    if (j >= head && j < fill) {
      stage[4 * wi + j] = static_cast<uint8_t>(cur >> (8 * j));
    }
  }
}

template <typename X, bool kZigzag, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocksE4)
    encode_w4(const X* x, const int* lens, uint8_t* keys, uint8_t* data,
              int* data_len, StatusWord* scratch, int N, int T) {
  static_assert(!kZigzag || sizeof(X) == 4, "zz32 encodes int32");
  __shared__ uint32_t scan[kThreads / 32];
  __shared__ uint32_t last[kZigzag ? kThreads : 1];
  __shared__ uint32_t tile_off;
  __shared__ __align__(16) uint8_t stage[kStageBytesE4];
  int b, t;
  tile_of_ticket(take_ticket(scratch), T, &b, &t);
  const int base = t * kPassTile;
  const int len = clamp_len(lens[b], N);
  const int i0 = base + kPerThread * threadIdx.x;
  uint8_t* krow = keys + static_cast<size_t>(b) * (N / 4);
  StatusWord* status = scratch + kLookbackHeader + static_cast<size_t>(b) * T;
  if (base >= len) {  // past the row's length: zero keys, no data
    store_keys(krow, i0, N, 0u);
    if (threadIdx.x == 0) {
      publish_status(status + t, kStatusAggregate, 0u);
      if (t == 0) data_len[b] = 0;
    }
    return;
  }
  const X* row = x + static_cast<size_t>(b) * N;
  uint32_t w[kWords<X>];
  load_words<X, kAligned>(row, i0, N, w);
  if constexpr (kZigzag) {
    // The previous sample: the neighbouring thread's last, the tile's
    // predecessor in the row, or 0 at the row's start.
    last[threadIdx.x] = w[kPerThread - 1];
    __syncthreads();
    uint32_t prev = threadIdx.x > 0 ? last[threadIdx.x - 1]
                    : (base > 0 ? static_cast<uint32_t>(row[base - 1]) : 0u);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t d = w[k] - prev;  // wraps at 32 bits
      prev = w[k];
      w[k] = (d << 1) ^ static_cast<uint32_t>(static_cast<int32_t>(d) >> 31);
    }
  }
  // Value k's code at bits 2k, 0 for the values at or past the length.
  const int live = live_values(len, i0);
  uint32_t code = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    code |= w4_code(stored_value<X, kZigzag>(w, k)) << (2 * k);
  }
  code &= live_key_mask(live);
  uint32_t agg;
  const uint32_t in_tile = block_exclusive_scan<kThreads>(
      static_cast<uint32_t>(live) + __popc(code & 0x55555555u) +
          2u * __popc(code & 0xAAAAAAAAu),
      &agg, scan);
  if (threadIdx.x == 0) publish_aggregate(status, t, agg);
  store_keys(krow, i0, N, code);
  if (threadIdx.x < 32) {
    const uint32_t off = resolve_prefix(status, t, agg);
    if (threadIdx.x == 0) tile_off = off;
  }
  __syncthreads();
  const uint32_t off = tile_off;
  const uintptr_t lo =
      reinterpret_cast<uintptr_t>(data + static_cast<size_t>(b) * 4 * N + off);
  stage_values<X, kZigzag>(stage, static_cast<uint32_t>(lo & 15) + in_tile, w,
                           code, live);
  __syncthreads();
  move_span<false>(stage, lo, lo + agg);
  if (threadIdx.x == 0 && t == (len - 1) / kPassTile) {
    data_len[b] = static_cast<int>(off + agg);
  }
}

// Blocks an SM holds at once: 8 x 256 threads cap registers at 32. The
// int32 flavors hold 16 words of values (zz32 spills 36 bytes), yet 4, 5
// and 6 blocks (up to 64 registers, no spills) measured slower than 8.
constexpr int kMinBlocksD4 = 8;
// Staged data: at most 4 bytes per value, after up to 15 bytes that align
// the shared buffer with the span's address mod 16, and room for the decode
// window to read past the span (one byte per value past the count, and the
// word read ahead).
constexpr int kStageBytesD4 = 4 * kPassTile + 48;

// Places the low bits of v as value k of a thread's packed words.
template <typename X>
__device__ __forceinline__ void put_value(uint32_t* w, int k, uint32_t v) {
  if constexpr (sizeof(X) == 4) {
    w[k] = v;
  } else {
    constexpr uint32_t kMask = (1u << (8 * sizeof(X))) - 1u;
    if (k % kLanes<X> == 0) w[k / kLanes<X>] = 0;
    w[k / kLanes<X>] |= (v & kMask) << (8 * sizeof(X) * (k % kLanes<X>));
  }
}

template <typename X, bool kZigzag, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocksD4)
    decode_w4(const uint8_t* keys, const uint8_t* data, const int* counts,
              X* out, StatusWord* scratch, int N, int T, int D) {
  static_assert(!kZigzag || sizeof(X) == 4, "zz32 decodes to int32");
  __shared__ uint32_t scan[kThreads / 32];
  __shared__ uint32_t tile_off, tile_carry;
  __shared__ __align__(16) uint8_t stage[kStageBytesD4];
  int b, t;
  tile_of_ticket(take_ticket(scratch), T, &b, &t);
  const int base = t * kPassTile;
  const int count = clamp_len(counts[b], N);
  const int i0 = base + kPerThread * threadIdx.x;
  // Status arrays of B * T (= gridDim.x) words: offsets, then (zz32) sums.
  StatusWord* offsets = scratch + kLookbackHeader + static_cast<size_t>(b) * T;
  StatusWord* sums = offsets + gridDim.x;
  X* orow = out + static_cast<size_t>(b) * N;
  uint32_t w[kWords<X>] = {};
  if (base >= count) {  // past the row's count: zeros
    store_words<X, kAligned>(orow, i0, N, w);
    if (threadIdx.x == 0) {
      publish_status(offsets + t, kStatusAggregate, 0u);
      if constexpr (kZigzag) publish_status(sums + t, kStatusAggregate, 0u);
    }
    return;
  }
  // Value k's code at bits 2k, 0 for the values at or past the count.
  const int live = live_values(count, i0);
  const uint32_t code =
      load_keys(keys + static_cast<size_t>(b) * (N / 4), i0, N) &
      live_key_mask(live);
  uint32_t agg;
  const uint32_t in_tile = block_exclusive_scan<kThreads>(
      static_cast<uint32_t>(live) + __popc(code & 0x55555555u) +
          2u * __popc(code & 0xAAAAAAAAu),
      &agg, scan);
  if (threadIdx.x == 0) publish_aggregate(offsets, t, agg);
  if (threadIdx.x < 32) {
    const uint32_t off = resolve_prefix(offsets, t, agg);
    if (threadIdx.x == 0) tile_off = off;
  }
  __syncthreads();
  // The tile's span of the data row, clipped at D: in-tile byte o exists
  // when o < avail.
  const uint32_t off = tile_off;
  const uint32_t limit = static_cast<uint32_t>(D);
  const uint32_t first = off < limit ? off : limit;
  const uint32_t end = off + agg < limit ? off + agg : limit;
  const uint32_t avail = end - first;
  const uint8_t* drow = data + static_cast<size_t>(b) * D;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(drow + first);
  move_span<true>(stage, lo, reinterpret_cast<uintptr_t>(drow + end));
  __syncthreads();
  // Decode the thread's values (zz32: un-zig-zag and sum them) into w.
  const uint32_t head = static_cast<uint32_t>(lo & 15) + in_tile;
  uint32_t sum = 0;
  if (avail == agg) {
    // Every byte of the tile is there: a window of two aligned words slides
    // along the thread's bytes, and value k is its low 1 + code bytes at
    // byte sh (none at or past the count, whose code is 0: the window moves
    // one byte past the span for each). The word read ahead may lie past
    // the span, inside the buffer. The branch is the tile's, not the
    // thread's: with a branch on the thread's live values as well, the
    // none flavors' values past the count came out nonzero on the card.
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(stage);
    uint32_t wi = head >> 2, sh = head & 3u;
    uint32_t cur = s32[wi], nxt = s32[wi + 1];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t c = (code >> (2 * k)) & 3u;
      const uint32_t mask = k < live ? 0xFFFFFFFFu >> (24 - 8 * c) : 0u;
      const uint32_t v = __funnelshift_r(cur, nxt, 8 * sh) & mask;
      if constexpr (kZigzag) {
        sum += (v >> 1) ^ (0u - (v & 1u));
        put_value<X>(w, k, sum);
      } else {
        put_value<X>(w, k, v);
      }
      if (k + 1 < kPerThread) {
        sh += 1 + c;
        const uint32_t step = sh >> 2;  // at most one word per value
        sh &= 3u;
        wi += step;
        cur = step ? nxt : cur;
        nxt = s32[wi + 1];
      }
    }
  } else {
    // A data row cut short: byte by byte, missing bytes read as 0.
    const uint8_t* s = stage + (lo & 15);
    uint32_t o = in_tile;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t n = k < live ? 1u + ((code >> (2 * k)) & 3u) : 0u;
      uint32_t v = 0;
#pragma unroll
      for (uint32_t j = 0; j < 4; ++j) {
        if (j < n && o + j < avail) {
          v |= static_cast<uint32_t>(s[o + j]) << (8 * j);
        }
      }
      o += n;
      if constexpr (kZigzag) {
        sum += (v >> 1) ^ (0u - (v & 1u));  // 0 for a missing value
        put_value<X>(w, k, sum);
      } else {
        put_value<X>(w, k, v);
      }
    }
  }
  if constexpr (kZigzag) {
    uint32_t total;
    const uint32_t before = block_exclusive_scan<kThreads>(sum, &total, scan);
    if (threadIdx.x == 0) publish_aggregate(sums, t, total);
    if (threadIdx.x < 32) {
      const uint32_t carry = resolve_prefix(sums, t, total);
      if (threadIdx.x == 0) tile_carry = carry;
    }
    __syncthreads();
    const uint32_t add = tile_carry + before;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      w[k] = k < live ? w[k] + add : 0u;  // zeros after the row's count
    }
  }
  store_words<X, kAligned>(orow, i0, N, w);
}

template <typename X, bool kZigzag>
int encode_launch(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, StatusWord* scratch, int B,
                  int N, cudaStream_t s) {
  const int tiles = grid_tiles(B, N);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = word_aligned<X>(x) ? encode_w4<X, kZigzag, true>
                                         : encode_w4<X, kZigzag, false>;
  kernel<<<tiles, kThreads, 0, s>>>(static_cast<const X*>(x), lens, keys,
                                    data, data_len, scratch, N, tiles / B);
  return cudaGetLastError();
}

template <typename X, bool kZigzag>
int decode_launch(const uint8_t* keys, const uint8_t* data, const int* counts,
                  void* out, StatusWord* scratch, int B, int N, int D,
                  cudaStream_t s) {
  const int tiles = grid_tiles(B, N);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = word_aligned<X>(out) ? decode_w4<X, kZigzag, true>
                                           : decode_w4<X, kZigzag, false>;
  kernel<<<tiles, kThreads, 0, s>>>(keys, data, counts, static_cast<X*>(out),
                                    scratch, N, tiles / B, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Values per tile of E4 and of D4, T = ceil(N / tile) tiles per row. Their
// scratch is 8-byte words, zeroed before each call: E4's 1 + B * T (the
// byte offset); D4's 1 + 2 * B * T for zz32 (the byte offset and the
// un-delta sum), 1 + B * T for the none flavors.
int vbz_w4_encode_tile() { return kPassTile; }
int vbz_w4_decode_tile() { return kPassTile; }

// x: [B, N] int32 (elem_bytes 4; zz32 with zigzag 1, none32 with 0), int16
// (elem_bytes 2, none16) or int8 (elem_bytes 1, none8); lens: [B] i32.
// Writes keys [B, N/4], data [B, 4N], data_len [B] i32.
int vbz_w4_encode(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, StatusWord* scratch, int B,
                  int N, int elem_bytes, int zigzag, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4 && zigzag) {
    return encode_launch<int32_t, true>(x, lens, keys, data, data_len,
                                        scratch, B, N, s);
  }
  if (zigzag) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 4) {
    return encode_launch<int32_t, false>(x, lens, keys, data, data_len,
                                         scratch, B, N, s);
  }
  if (elem_bytes == 2) {
    return encode_launch<int16_t, false>(x, lens, keys, data, data_len,
                                         scratch, B, N, s);
  }
  if (elem_bytes == 1) {
    return encode_launch<int8_t, false>(x, lens, keys, data, data_len,
                                        scratch, B, N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys: [B, N/4] u8, data: [B, D] u8, counts: [B] i32. Writes out [B, N] of
// the flavor's type (as for encode).
int vbz_w4_decode(const uint8_t* keys, const uint8_t* data, const int* counts,
                  void* out, StatusWord* scratch, int B, int N, int D,
                  int elem_bytes, int zigzag, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4 && zigzag) {
    return decode_launch<int32_t, true>(keys, data, counts, out, scratch, B, N,
                                        D, s);
  }
  if (zigzag) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 4) {
    return decode_launch<int32_t, false>(keys, data, counts, out, scratch, B,
                                         N, D, s);
  }
  if (elem_bytes == 2) {
    return decode_launch<int16_t, false>(keys, data, counts, out, scratch, B,
                                         N, D, s);
  }
  if (elem_bytes == 1) {
    return decode_launch<int8_t, false>(keys, data, counts, out, scratch, B,
                                        N, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
