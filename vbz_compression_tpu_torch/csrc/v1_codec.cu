// v1 half-byte StreamVByte encode (kernel V1E) and decode (kernel V1D) for
// Hopper, sm_90a.
//
// v1 is the StreamVByte stage of the VBZ v1 format for int8 input: "zz8"
// (32-bit delta, then zig-zag: values <= 510) and "none8" (the value
// sign-extended to 32 bits). Each value v takes code 0 when v == 0, 1 when
// v < 16, 2 when v < 256 and 3 otherwise, stored as 0, 1, 2 or 4 nibbles
// (code 3 keeps the low 16 bits). Key byte i/4 holds the code at bit
// 2*(i%4); the data section is the nibble stream, low nibble of each byte
// first, its byte length (nibbles + 1) / 2 with an odd last nibble padded
// by 0.
//
// Replaces the TPU kernels pallas_v1.encode_v1 / decode_v1 and
// nib_offsets_from_keys (a deletion-compaction network on the TPU, which
// has no scatter or gather, and only for chunks of 16384 values or more;
// shorter ones went to the CPU). Here one pair covers every length.
//
// What bounds them is bytes: 1 read per input value, 0.25 key bytes plus
// 0-2 data bytes written on encode, the reverse on decode. So each is one
// launch with the design of E4 and D4 (w4_codec.cu): tiles of kPassTile
// values taken by ticket, 16 values and one 32-bit key word per thread,
// nibble counts by popcount, a block scan, and the decoupled look-back of
// lookback.cuh for the tile's nibble offset in the row.
//   V1E: loads its input once (16-byte vectors where aligned; zz8 takes the
//        previous sample from the neighbouring thread through shared
//        memory), stores one key word per thread, packs each thread's
//        nibbles into aligned words in registers and stages them in shared
//        memory, then stores the tile's span with 16-byte vectors.
//   V1D: stages the tile's span (clipped at D) with 16-byte vectors, takes
//        each value's nibbles through a window of two aligned shared words;
//        zz8 then un-zig-zags, sums in the thread, block-scans and looks back
//        a second time for the row's un-delta carry. The output is written
//        once with 16-byte stores.
//
// The trap is the shared half-byte: where a tile's nibble offset is odd, its
// first nibble is the high half of a byte whose low half is the last nibble
// written before it in the row, any number of tiles back (code-0 values and
// whole code-0 tiles write none). V1E carries that nibble through the
// look-back beside the offset (look_back_tagged), so a byte is written by
// the tile that holds its high nibble, whole, with no zeroing pass and no
// atomics in device memory: a tile whose offset is odd writes its first
// byte with the carried nibble as the low half, and a tile whose end is odd
// leaves its last byte to the next tile with nibbles. The tile that holds
// the row's last live value writes the row's last byte (high half 0 when
// the count is odd) and data_len. Inside a tile, the words that neighbouring
// threads share are ORed into the stage with shared-memory atomics.
//
// Layout: a batch is B rows of N values (N % 4 == 0) with a per-row length.
// Keys are [B, N/4] u8, encode data is [B, 2N] u8 (each row dense from byte
// 0), decode data is [B, D] u8 for any D. Values at or past a row's length
// take code 0 and decode to 0; decode never reads a byte at or past D.
// data_len is in bytes. Entry points launch on the given stream, allocate
// nothing (the caller passes the zeroed look-back state) and return
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"
#include "tile_io.cuh"

namespace {

using namespace vbz;

// Blocks an SM holds at once (4-8 measured, PERF.md). 8 x 256
// threads cap registers at 32, where V1E zz8 spills 68-76 bytes a thread
// and runs 10% slower than at 6 (40 registers); V1E none8 and V1D are
// fastest at 7-8 (7 also compiles to 32 registers).
template <bool kZigzag>
constexpr int kMinBlocksV1E = kZigzag ? 6 : 8;
constexpr int kMinBlocksV1D = 8;
// Staged data: at most 2 bytes per value and the carried byte, after up to
// 15 bytes that align the shared buffer with the span's address mod 16.
constexpr int kStageBytesV1E = 2 * kPassTile + 16;
// The same, and room for the decode window's word read ahead past the span.
constexpr int kStageBytesV1D = 2 * kPassTile + 48;

__device__ __forceinline__ uint32_t v1_code(uint32_t v) {
  return v == 0 ? 0u : (v < 16u ? 1u : (v < 256u ? 2u : 3u));
}

// Nibbles of a code: 0, 1, 2, 4.
__device__ __forceinline__ uint32_t v1_nibbles(uint32_t code) {
  return (1u << code) >> 1;
}

// Nibbles of a thread's 16 codes (2 bits each), by popcount.
__device__ __forceinline__ uint32_t key_nibbles(uint32_t code) {
  const uint32_t m = code & 0x55555555u;
  const uint32_t h = (code >> 1) & 0x55555555u;
  return __popc(m & ~h) + 2u * __popc(h & ~m) + 4u * __popc(m & h);
}

// Value k of a thread's 16 packed int8 as the stream stores it: zz8 the
// zig-zag of its 32-bit delta from the value before (prev before value 0),
// none8 the value sign-extended.
template <bool kZigzag>
__device__ __forceinline__ uint32_t stored_value(const uint32_t* w, int k,
                                                 int prev) {
  const int cur = lane_value<int8_t>(w, k);
  if constexpr (kZigzag) {
    const int d = cur - (k > 0 ? lane_value<int8_t>(w, k - 1) : prev);
    return (static_cast<uint32_t>(d) << 1) ^ static_cast<uint32_t>(d >> 31);
  } else {
    return static_cast<uint32_t>(cur);
  }
}

// Writes a thread's nibbles into the stage from nibble q0 on: value k's low
// nibbles by its code (none for values at or past the length, whose code is
// 0), packed into aligned words in registers by shifts. A word the thread
// fills alone is one plain store; the words at either end, which the
// neighbouring threads share down to a nibble, are ORed into the zeroed
// stage.
template <bool kZigzag>
__device__ __forceinline__ void stage_nibbles(uint32_t* s32, uint32_t q0,
                                              const uint32_t* w, int prev,
                                              uint32_t code) {
  uint32_t wi = q0 >> 3;
  uint32_t fill = q0 & 7u;  // nibbles of word wi taken, < 8
  bool shared_head = fill != 0;
  uint32_t cur = 0;         // word wi's nibbles from this thread
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const uint32_t m = v1_nibbles((code >> (2 * k)) & 3u);
    const uint32_t v =
        stored_value<kZigzag>(w, k, prev) & ((1u << (4 * m)) - 1u);
    const uint32_t low = cur | (v << (4 * fill));
    const uint32_t high = __funnelshift_l(v, 0u, 4 * fill);  // 0 for fill 0
    fill += m;
    if (fill >= 8) {  // word wi is complete: at most one per value
      if (shared_head) {
        atomicOr(&s32[wi], low);
        shared_head = false;
      } else {
        s32[wi] = low;
      }
      ++wi;
      fill -= 8;
      cur = high;
    } else {
      cur = low;
    }
  }
  if (cur != 0) atomicOr(&s32[wi], cur);
}

template <bool kZigzag, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocksV1E<kZigzag>)
    encode_v1(const int8_t* x, const int* lens, uint8_t* keys, uint8_t* data,
              int* data_len, StatusWord* scratch, int N, int T) {
  __shared__ uint32_t scan[kThreads / 32];
  __shared__ uint32_t warp_last[kThreads / 32];
  __shared__ int last[kZigzag ? kThreads : 1];
  __shared__ uint32_t tile_off, tile_carry;
  __shared__ __align__(16) uint32_t stage[kStageBytesV1E / 4];
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
  for (int i = threadIdx.x; i < kStageBytesV1E / 16; i += kThreads) {
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int8_t* row = x + static_cast<size_t>(b) * N;
  uint32_t w[4];
  load_words<int8_t, kAligned>(row, i0, N, w);
  int prev = 0;
  if constexpr (kZigzag) {
    // The previous sample: the neighbouring thread's last, the tile's
    // predecessor in the row, or 0 at the row's start.
    last[threadIdx.x] = lane_value<int8_t>(w, kPerThread - 1);
    __syncthreads();
    prev = threadIdx.x > 0 ? last[threadIdx.x - 1]
                           : (base > 0 ? static_cast<int>(row[base - 1]) : 0);
  }
  // Value k's code at bits 2k (0 at or past the length), and the thread's
  // last nibble as a tag (kNibbleHas | nibble, 0 when it has none).
  const int live = live_values(len, i0);
  uint32_t code = 0, tag = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const uint32_t v = stored_value<kZigzag>(w, k, prev);
    const uint32_t c = k < live ? v1_code(v) : 0u;
    code |= c << (2 * k);
    if (c) tag = kNibbleHas | ((v >> (4 * (v1_nibbles(c) - 1))) & 0xFu);
  }
  // The tile's last nibble: that of its last thread with one. The warps'
  // maxima become visible to warp 0 through the block scan's barriers.
  const uint32_t key = tag ? ((threadIdx.x + 1) << 8) | tag : 0u;
  const uint32_t warp_max = __reduce_max_sync(kFullMask, key);
  if ((threadIdx.x & 31) == 0) warp_last[threadIdx.x >> 5] = warp_max;
  uint32_t agg;
  const uint32_t in_tile =
      block_exclusive_scan<kThreads>(key_nibbles(code), &agg, scan);
  store_keys(krow, i0, N, code);
  if (threadIdx.x < 32) {
    const uint32_t tile_tag =
        __reduce_max_sync(kFullMask, threadIdx.x < kThreads / 32
                                         ? warp_last[threadIdx.x]
                                         : 0u) & 0xFFu;
    if (threadIdx.x == 0) publish_aggregate_tagged(status, t, agg, tile_tag);
    uint32_t carried;
    const uint32_t off =
        resolve_prefix_tagged(status, t, agg, tile_tag, &carried);
    if (threadIdx.x == 0) {
      tile_off = off;
      tile_carry = carried;
    }
  }
  __syncthreads();
  // The bytes the tile writes: from the one that holds its first nibble
  // (shared with the carried nibble when off is odd) up to the one that
  // holds its last, unless the next tile with nibbles shares that byte; the
  // tile of the row's last live value writes the row's last byte.
  const uint32_t off = tile_off;
  const uint32_t end = off + agg;
  const bool row_end = t == (len - 1) / kPassTile;
  uint8_t* drow = data + static_cast<size_t>(b) * 2 * N;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(drow + (off >> 1));
  const uint32_t stop = row_end ? (end + 1) >> 1 : end >> 1;
  const uintptr_t hi = reinterpret_cast<uintptr_t>(drow + stop);
  const uint32_t head = 2 * static_cast<uint32_t>(lo & 15) + (off & 1u);
  stage_nibbles<kZigzag>(stage, head + in_tile, w, prev, code);
  if (threadIdx.x == 0 && (off & 1u)) {
    atomicOr(&stage[(lo & 15) >> 2],
             (tile_carry & 0xFu) << (8 * static_cast<uint32_t>(lo & 3)));
  }
  __syncthreads();
  move_span<false>(reinterpret_cast<uint8_t*>(stage), lo, hi);
  if (threadIdx.x == 0 && row_end) {
    data_len[b] = static_cast<int>((end + 1) >> 1);
  }
}

// Mask of the live bytes of word q of a thread's 16 packed int8 values.
__device__ __forceinline__ uint32_t live_bytes(int live, int q) {
  const int n = live - 4 * q;
  return n >= 4 ? ~0u : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

template <bool kZigzag>
__global__ void __launch_bounds__(kThreads, kMinBlocksV1D)
    decode_v1(const uint8_t* keys, const uint8_t* data, const int* counts,
              int8_t* out, StatusWord* scratch, int N, int T, int D) {
  __shared__ uint32_t scan[kThreads / 32];
  __shared__ uint32_t tile_off, tile_carry;
  __shared__ __align__(16) uint8_t stage[kStageBytesV1D];
  int b, t;
  tile_of_ticket(take_ticket(scratch), T, &b, &t);
  const int base = t * kPassTile;
  const int count = clamp_len(counts[b], N);
  const int i0 = base + kPerThread * threadIdx.x;
  // Status arrays of B * T (= gridDim.x) words: offsets, then (zz8) sums.
  StatusWord* offsets = scratch + kLookbackHeader + static_cast<size_t>(b) * T;
  StatusWord* sums = offsets + gridDim.x;
  int8_t* orow = out + static_cast<size_t>(b) * N;
  uint32_t w[4] = {};
  if (base >= count) {  // past the row's count: zeros
    store_words<int8_t, true>(orow, i0, N, w);
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
  const uint32_t in_tile =
      block_exclusive_scan<kThreads>(key_nibbles(code), &agg, scan);
  if (threadIdx.x == 0) publish_aggregate(offsets, t, agg);
  if (threadIdx.x < 32) {
    const uint32_t off = resolve_prefix(offsets, t, agg);
    if (threadIdx.x == 0) tile_off = off;
  }
  __syncthreads();
  // The tile's byte span of the data row, clipped at D; its nibbles lie at
  // row nibbles [off, off + agg), of which those below 2D exist.
  const uint32_t off = tile_off;
  const uint32_t limit = static_cast<uint32_t>(D);
  const uint32_t first = (off >> 1) < limit ? off >> 1 : limit;
  const uint32_t stop = ((off + agg + 1) >> 1) < limit ? (off + agg + 1) >> 1
                                                        : limit;
  const uint8_t* drow = data + static_cast<size_t>(b) * D;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(drow + first);
  move_span<true>(stage, lo, reinterpret_cast<uintptr_t>(drow + stop));
  __syncthreads();
  // Decode the thread's values (zz8: un-zig-zag and sum them) into w.
  const uint32_t head = 2 * static_cast<uint32_t>(lo & 15) + (off & 1u);
  uint32_t sum = 0;
  if (off + agg <= 2 * limit) {
    // Every nibble of the tile is there: a window of two aligned words
    // slides along the thread's nibbles, and value k is its low 4 m bits at
    // nibble sh (m = 0 at or past the count, whose code is 0). The word
    // read ahead may lie past the span, inside the buffer. The branch is
    // the tile's, not the thread's (PERF.md: D4 and D).
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(stage);
    const uint32_t q = head + in_tile;
    uint32_t wi = q >> 3, sh = q & 7u;
    uint32_t cur = s32[wi], nxt = s32[wi + 1];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t m = v1_nibbles((code >> (2 * k)) & 3u);
      const uint32_t v =
          __funnelshift_r(cur, nxt, 4 * sh) & ((1u << (4 * m)) - 1u);
      if constexpr (kZigzag) {
        sum += (v >> 1) ^ (0u - (v & 1u));
        w[k / 4] |= (sum & 0xFFu) << (8 * (k % 4));
      } else {
        w[k / 4] |= (v & 0xFFu) << (8 * (k % 4));
      }
      if (k + 1 < kPerThread) {
        sh += m;
        const uint32_t step = sh >> 3;  // at most one word per value
        sh &= 7u;
        wi += step;
        cur = step ? nxt : cur;
        nxt = s32[wi + 1];
      }
    }
  } else {
    // A data row cut short: nibble by nibble, missing nibbles read as 0.
    const uint32_t avail = off < 2 * limit ? 2 * limit - off : 0u;
    uint32_t o = in_tile;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t m = v1_nibbles((code >> (2 * k)) & 3u);
      uint32_t v = 0;
#pragma unroll
      for (uint32_t j = 0; j < 4; ++j) {
        if (j < m && o + j < avail) {
          const uint32_t q = head + o + j;
          v |= ((static_cast<uint32_t>(stage[q >> 1]) >> (4 * (q & 1u))) &
                0xFu) << (4 * j);
        }
      }
      o += m;
      if constexpr (kZigzag) {
        sum += (v >> 1) ^ (0u - (v & 1u));  // 0 for a missing value
        w[k / 4] |= (sum & 0xFFu) << (8 * (k % 4));
      } else {
        w[k / 4] |= (v & 0xFFu) << (8 * (k % 4));
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
    // Only the low byte of each sum is stored, so the carry is added to
    // the four bytes of a word at once, without carries between them.
    const uint32_t add = ((tile_carry + before) & 0xFFu) * 0x01010101u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = __vadd4(w[q], add) & live_bytes(live, q);  // zeros past count
    }
  }
  store_words<int8_t, true>(orow, i0, N, w);
}

template <bool kZigzag>
int encode_launch(const int8_t* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, StatusWord* scratch, int B,
                  int N, cudaStream_t s) {
  const int tiles = grid_tiles(B, N);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = word_aligned<int8_t>(x) ? encode_v1<kZigzag, true>
                                              : encode_v1<kZigzag, false>;
  kernel<<<tiles, kThreads, 0, s>>>(x, lens, keys, data, data_len, scratch, N,
                                    tiles / B);
  return cudaGetLastError();
}

template <bool kZigzag>
int decode_launch(const uint8_t* keys, const uint8_t* data, const int* counts,
                  int8_t* out, StatusWord* scratch, int B, int N, int D,
                  cudaStream_t s) {
  const int tiles = grid_tiles(B, N);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  decode_v1<kZigzag><<<tiles, kThreads, 0, s>>>(keys, data, counts, out,
                                                scratch, N, tiles / B, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Values per tile of V1E and of V1D, T = ceil(N / tile) tiles per row. Their
// scratch is 8-byte words, zeroed before each call: V1E's 1 + B * T (the
// nibble offset with the carried nibble); V1D's 1 + 2 * B * T for zz8 (the
// nibble offset and the un-delta sum), 1 + B * T for none8.
int vbz_v1_encode_tile() { return kPassTile; }
int vbz_v1_decode_tile() { return kPassTile; }

// x: [B, N] int8 (zigzag 1: zz8, 0: none8); lens: [B] i32. Writes keys
// [B, N/4], data [B, 2N], data_len [B] i32 in bytes.
int vbz_v1_encode(const int8_t* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, StatusWord* scratch, int B,
                  int N, int zigzag, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return zigzag ? encode_launch<true>(x, lens, keys, data, data_len, scratch,
                                      B, N, s)
                : encode_launch<false>(x, lens, keys, data, data_len, scratch,
                                       B, N, s);
}

// keys: [B, N/4] u8, data: [B, D] u8, counts: [B] i32. Writes out [B, N]
// int8, which must start on a 4-byte word (the wrapper allocates it).
int vbz_v1_decode(const uint8_t* keys, const uint8_t* data, const int* counts,
                  int8_t* out, StatusWord* scratch, int B, int N, int D,
                  int zigzag, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0 || !word_aligned<int8_t>(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return zigzag ? decode_launch<true>(keys, data, counts, out, scratch, B, N,
                                      D, s)
                : decode_launch<false>(keys, data, counts, out, scratch, B, N,
                                       D, s);
}

}  // extern "C"
