// W2 StreamVByte encode (kernel E) and decode (kernel D) for Hopper, sm_90a.
//
// Replaces the TPU kernels of the zz16/zz8 flavors: encode
// vbz_compression_tpu/ops/pallas_codec5.py:930 (encode_w2_rows_flat), :495
// (encode_w2), pallas_dense.py:311, :365 and pallas_codec3.py:433, :937;
// decode pallas_codec5.py:1039, :841, pallas_dense.py:522, :587 and
// pallas_codec3.py:632, :990.
//
// W2 is the v0 StreamVByte stage for the zig-zag flavors whose values fit in
// two bytes: "zz16" (int16, 16-bit wrapped delta) and "zz8" (int8, 32-bit
// delta, values <= 510). Each value v takes code c = (v > 0xFF): key byte
// i/4 holds c at bit 2*(i%4), and the data section holds v's low byte, then
// its high byte when c == 1, at the exclusive prefix sum of (1 + c).
//
// Layout: a batch is B rows of N values (N % 4 == 0) with a per-row length.
// Keys are [B, N/4] u8, encode data is [B, 2N] u8 (each row dense from byte
// 0), decode data is [B, D] u8 for any D. Values at or past a row's length
// take code 0, write no data, and decode to 0; decode never reads a byte at
// or past D. D's second instance (decode_w2_streams) reads the wire plane's
// v0 streams [B, M] in place, each row its key bytes and then its data, and
// also writes each row's ok, from the sum of code + 1 over its live values;
// the two instances share the tile body and differ in its layout policy.
//
// What bounds them: bytes, per int16 value 2 read, 0.25 key bytes and 1-2
// data bytes written (the reverse for D), and no arithmetic to speak of. So
// each is one launch in which every byte crosses device memory once. A block
// owns one tile of kPassTile values and carries the row's byte offset (and, in
// D, the un-delta sum) from the tiles before it with the decoupled look-back
// of lookback.cuh, where the TPU grid carried both in SMEM:
//   E: 16-byte loads of 16 values per thread (the previous sample from the
//      neighbouring thread through shared memory), zig-zag two int16 values
//      at a time (__vsub2), codes and a block scan of byte counts, publish
//      the tile's bytes, one 32-bit key store per thread, look back for the
//      offset, build the tile's data bytes in shared memory and store its
//      span [off, off + bytes) with 16-byte vectors (head and tail bytes one
//      by one; each data byte belongs to one tile, so no atomics).
//   D: one 32-bit key load per thread, a block scan of byte counts, look back
//      for the offset, stage the span (clipped at D) into shared memory with
//      16-byte vectors, decode and un-zig-zag from there, block scan of the
//      deltas, look back for the un-delta carry, write the output once with
//      16-byte stores.
// Tiles are taken by ticket across the rows first, so a batch's rows carry
// side by side. On the H100 the kernels stay well short of the byte bound:
// a tile's life is a chain of dependent steps (ticket, loads, scan,
// look-back, store), so loads are in flight only for part of it (PERF.md).
// Tile size: 256 threads x 16 values. 16 values are 4 key bytes (one 32-bit
// word) and 32 output bytes (two 16-byte vectors) per thread; a tile's
// staged data is at most 8 KB of shared memory, so eight blocks share an SM
// (the thread limit), and its look-back (one warp reading 32 status words
// per step) is paid once per 8 KB of int16 output. [64, 8192] is 128 tiles,
// about one per SM. Tiles of 8192 and 16384 values, or fewer blocks per SM,
// measured no faster.
//
// Entry points launch on the given stream, allocate nothing and return the
// first CUDA error. Encode and decode take the look-back scratch zeroed by
// the caller; decode_streams zeroes the words its launch uses itself, on the
// same stream, so a caller can keep one scratch a stream for every call.

#include <cstdint>
#include <mutex>
#include <type_traits>

#include <cuda_runtime.h>

#include "lookback.cuh"
#include "row_scan.cuh"
#include "tile_io.cuh"

namespace {

using namespace vbz;

// Blocks an SM holds at once: 8 x 256 threads caps registers at 32.
constexpr int kMinBlocks = 8;
// Staged data: at most 2 bytes per value, after up to 15 bytes that align
// the shared buffer with the span's address mod 16. D reads past the span
// inside its buffer: one byte per value past the count and one ahead.
constexpr int kStageBytes = 2 * kPassTile + 16;
constexpr int kStageBytesD = 2 * kPassTile + 48;

// The zig-zag values of a thread's 16 values, two 16-bit halves per word
// (value 2q in the low half of zz[q]); prev is the value before the first.
// int16 takes the 16-bit wrapped delta two values at a time; int8 the 32-bit
// delta, whose zig-zag is at most 510.
template <typename X>
__device__ __forceinline__ void zigzag_pairs(const uint32_t w[kWords<X>],
                                             int prev, uint32_t zz[8]) {
  if constexpr (sizeof(X) == 2) {
    uint32_t before = static_cast<uint32_t>(prev) << 16;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t d = __vsub2(w[q], __byte_perm(before, w[q], 0x5432));
      zz[q] = ((d << 1) & 0xFFFEFFFEu) ^ __vcmplts2(d, 0u);
      before = w[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cur = lane_value<X>(w, 2 * q + h);
        const int d = cur - prev;
        pair |= ((static_cast<uint32_t>(d) << 1) ^
                 static_cast<uint32_t>(d >> 31)) << (16 * h);
        prev = cur;
      }
      zz[q] = pair;
    }
  }
}

template <typename X, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    encode_w2(const X* x, const int* lens, uint8_t* keys, uint8_t* data,
              int* data_len, StatusWord* scratch, int N, int T) {
  __shared__ uint32_t scan[kThreads / 32];
  __shared__ int last[kThreads];
  __shared__ uint32_t tile_off;
  __shared__ __align__(16) uint8_t stage[kStageBytes];
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
  last[threadIdx.x] = lane_value<X>(w, kPerThread - 1);
  __syncthreads();
  uint32_t zz[8];
  zigzag_pairs<X>(w, threadIdx.x > 0 ? last[threadIdx.x - 1]
                     : (base > 0 ? static_cast<int>(row[base - 1]) : 0),
                  zz);
  // Codes: bit 2k of key is value k's code (zig-zag > 0xFF).
  uint32_t key = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t big = __vcmpgtu2(zz[q], 0x00FF00FFu) & 0x00010001u;
    key |= ((big | (big >> 14)) & 5u) << (4 * q);
  }
  const int live = live_values(len, i0);
  key &= live_key_mask(live);
  uint32_t agg;
  const uint32_t in_tile = block_exclusive_scan<kThreads>(
      static_cast<uint32_t>(live) + __popc(key), &agg, scan);
  if (threadIdx.x == 0) publish_aggregate(status, t, agg);
  store_keys(krow, i0, N, key);
  if (threadIdx.x < 32) {
    const uint32_t off = resolve_prefix(status, t, agg);
    if (threadIdx.x == 0) tile_off = off;
  }
  __syncthreads();
  const uint32_t off = tile_off;
  const uintptr_t lo =
      reinterpret_cast<uintptr_t>(data + static_cast<size_t>(b) * 2 * N + off);
  uint8_t* o = stage + (lo & 15) + in_tile;
  if (live == kPerThread) {
    // Each value's high byte is written whatever its code: a 1-byte value's
    // is overwritten by the next value. Only the last value's depends on it.
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t v = zz[k / 2] >> (16 * (k % 2));
      const uint32_t c = (key >> (2 * k)) & 1u;
      o[0] = static_cast<uint8_t>(v);
      if (k + 1 < kPerThread || c) o[1] = static_cast<uint8_t>(v >> 8);
      o += 1 + c;
    }
  } else {
    for (int k = 0; k < live; ++k) {
      const uint32_t v = zz[k / 2] >> (16 * (k % 2));
      const uint32_t c = (key >> (2 * k)) & 1u;
      o[0] = static_cast<uint8_t>(v);
      if (c) o[1] = static_cast<uint8_t>(v >> 8);
      o += 1 + c;
    }
  }
  __syncthreads();
  move_span<false>(stage, lo, lo + agg);
  if (threadIdx.x == 0 && t == (len - 1) / kPassTile) {
    data_len[b] = static_cast<int>(off + agg);
  }
}

// Places the low bits of a running sum as value k of a thread's packed words.
template <typename X>
__device__ __forceinline__ void put_lane(uint32_t w[kWords<X>], int k,
                                         uint32_t sum) {
  constexpr uint32_t kMask = (1u << (8 * sizeof(X))) - 1u;
  const int shift = 8 * sizeof(X) * (k % kLanes<X>);
  if (k % kLanes<X> == 0) w[k / kLanes<X>] = 0;
  w[k / kLanes<X>] |= (sum & kMask) << shift;
}

// Adds c to every lane of a packed word, each lane mod its width.
template <typename X>
__device__ __forceinline__ uint32_t add_lanes(uint32_t w, uint32_t c) {
  if constexpr (sizeof(X) == 2) {
    return __vadd2(w, (c & 0xFFFFu) * 0x00010001u);
  } else {
    return __vadd4(w, (c & 0xFFu) * 0x01010101u);
  }
}

// decode_w2's row layouts: where row b's key bytes and data section lie.
// Sections: keys [B, N/4] and data [B, D], the row kernels' own layout
// (decode_w2_rows).
struct Sections {
  static constexpr bool kInPlace = false;
  const uint8_t* keys;
  const uint8_t* data;
  int D;
  __device__ __forceinline__ const uint8_t* key_row(int b, int N) const {
    return keys + static_cast<size_t>(b) * (N / 4);
  }
  // How many of a row's N values have their key byte in the row.
  __device__ __forceinline__ int keyed(int N) const { return N; }
  // Row b's data section of *bytes bytes, for a row of len values.
  __device__ __forceinline__ const uint8_t* data_row(int b, int,
                                                     uint32_t* bytes) const {
    *bytes = static_cast<uint32_t>(D);
    return data + static_cast<size_t>(b) * D;
  }
};

// Streams: v0 streams [B, M], the wire plane's layout, read in place. Row b
// holds its (len + 3) / 4 key bytes, then its data bytes: key byte j past M
// reads 0, and the data section is the row's bytes from the key length to
// M. This layout also checks each row as the plane's ok: the data end that
// its keys give (the key length plus code + 1 summed over its live values,
// so codes 2 and 3, which no W2 encoder writes, count 3 and 4 against D's 2
// bytes) equals its stream length, and the key length fits in it.
struct Streams {
  static constexpr bool kInPlace = true;
  // A row's word in the scratch after the status arrays: the tiles that
  // have added to it (from bit kTileShift) and their sum of code + 1.
  static constexpr int kTileShift = 40;
  const uint8_t* streams;
  int M;
  const int* stream_lens;  // [B]
  bool* ok;  // [B]
  __device__ __forceinline__ const uint8_t* key_row(int b, int) const {
    return streams + static_cast<size_t>(b) * M;
  }
  __device__ __forceinline__ int keyed(int N) const {
    return 4LL * M < N ? 4 * M : N;
  }
  static __device__ __forceinline__ long long key_len(int len) {
    return (static_cast<long long>(len) + 3) / 4;
  }
  __device__ __forceinline__ const uint8_t* data_row(int b, int len,
                                                     uint32_t* bytes) const {
    const long long kl = key_len(len) < M ? key_len(len) : M;
    *bytes = static_cast<uint32_t>(M - kl);
    return streams + static_cast<size_t>(b) * M + kl;
  }
  __device__ __forceinline__ void write_ok(int b, int len,
                                           long long total) const {
    const long long kl = key_len(len);
    const long long sl = stream_lens[b];
    ok[b] = kl + total == sl && kl <= sl;
  }
  // Adds a live tile's sum of code + 1 to row b's word of totals; the last
  // of the row's live tiles to add writes the row's ok. One atomic gives
  // both the tiles before and their sum, so no fence is needed.
  __device__ __forceinline__ void add_tile(StatusWord* totals, int b, int len,
                                           int count, uint32_t sum) const {
    const StatusWord before =
        atomicAdd(totals + b, (StatusWord{1} << kTileShift) + sum);
    const int tiles = (count + kPassTile - 1) / kPassTile;
    if (static_cast<int>(before >> kTileShift) == tiles - 1) {
      write_ok(b, len,
               static_cast<long long>(
                   before & ((StatusWord{1} << kTileShift) - 1)) + sum);
    }
  }
};

// How many more than D's bytes a thread's live values count in ok's
// code + 1: one for code 2, two for code 3.
__device__ __forceinline__ uint32_t codes_past_bytes(uint32_t key) {
  const uint32_t hi = (key >> 1) & 0x55555555u;
  return __popc(hi) + __popc(hi & key);
}

// One tile of D on the rows of a layout.
template <typename X, bool kAligned, typename Rows>
__device__ __forceinline__ void decode_tile(const Rows& rows,
                                            const int* counts, X* out,
                                            StatusWord* scratch, int N,
                                            int T) {
  __shared__ uint32_t scan[kThreads / 32];
  __shared__ uint32_t tile_off, tile_carry;
  __shared__ __align__(16) uint8_t stage[kStageBytesD];
  int b, t;
  tile_of_ticket(take_ticket(scratch), T, &b, &t);
  const int base = t * kPassTile;
  const int len = counts[b];
  const int count = clamp_len(len, N);
  const int i0 = base + kPerThread * threadIdx.x;
  // Two status arrays of B * T (= gridDim.x) words: offsets, then sums.
  StatusWord* offsets = scratch + kLookbackHeader + static_cast<size_t>(b) * T;
  StatusWord* sums = offsets + gridDim.x;
  X* orow = out + static_cast<size_t>(b) * N;
  uint32_t w[kWords<X>] = {};
  if (base >= count) {  // past the row's count: zeros
    store_words<X, kAligned>(orow, i0, N, w);
    if (threadIdx.x == 0) {
      publish_status(offsets + t, kStatusAggregate, 0u);
      publish_status(sums + t, kStatusAggregate, 0u);
      if constexpr (Rows::kInPlace) {
        if (t == 0) rows.write_ok(b, len, 0);  // a row of no values
      }
    }
    return;
  }
  // Bit 2k of two: value k is live and takes 2 bytes (any nonzero code).
  const uint32_t key = load_keys(rows.key_row(b, N), i0, rows.keyed(N));
  const int live = live_values(count, i0);
  const uint32_t two = (key | (key >> 1)) & 0x55555555u & live_key_mask(live);
  uint32_t scanned = static_cast<uint32_t>(live) + __popc(two);
  if constexpr (Rows::kInPlace) {
    // ok's excess rides in the upper half: a tile's bytes stay below 2^16.
    scanned += codes_past_bytes(key & live_key_mask(live)) << 16;
  }
  uint32_t agg;
  uint32_t in_tile = block_exclusive_scan<kThreads>(scanned, &agg, scan);
  if constexpr (Rows::kInPlace) {
    if (threadIdx.x == 0) {
      rows.add_tile(scratch + kLookbackHeader + 2 * gridDim.x, b, len, count,
                    (agg & 0xFFFFu) + (agg >> 16));
    }
    in_tile &= 0xFFFFu;
    agg &= 0xFFFFu;
  }
  if (threadIdx.x == 0) publish_aggregate(offsets, t, agg);
  if (threadIdx.x < 32) {
    const uint32_t off = resolve_prefix(offsets, t, agg);
    if (threadIdx.x == 0) tile_off = off;
  }
  __syncthreads();
  // The tile's span of the data section, clipped at its end: in-tile byte o
  // exists when o < avail.
  const uint32_t off = tile_off;
  uint32_t limit;
  const uint8_t* drow = rows.data_row(b, len, &limit);
  const uint32_t first = off < limit ? off : limit;
  const uint32_t end = off + agg < limit ? off + agg : limit;
  const uint32_t avail = end - first;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(drow + first);
  move_span<true>(stage, lo, reinterpret_cast<uintptr_t>(drow + end));
  __syncthreads();
  // Decode, un-zig-zag and sum the thread's values; keep each running sum's
  // low bits packed in w.
  const uint8_t* s = stage + (lo & 15);
  uint32_t o = in_tile, sum = 0;
  if (avail == agg) {
    // Every byte of the tile is there: read two and keep one for a 1-byte
    // value, none for a value past the count (whose code is 0: o moves one
    // byte past the span for each). The second byte may be the next value's,
    // or past the span inside the buffer. The branch is the tile's, not the
    // thread's: with a branch on the thread's live values as well, D gave
    // values past the count that only its mask below hid, as D4 did.
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t c = (two >> (2 * k)) & 1u;
      const uint32_t keep = k < live ? 0xFFu | (0xFF00u * c) : 0u;
      const uint32_t z =
          (s[o] | (static_cast<uint32_t>(s[o + 1]) << 8)) & keep;
      o += 1 + c;
      sum += (z >> 1) ^ (0u - (z & 1u));
      put_lane<X>(w, k, sum);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t n = k < live ? 1u + ((two >> (2 * k)) & 1u) : 0u;
      uint32_t z = 0;
      if (n != 0) {
        if (o < avail) z = s[o];
        if (n == 2 && o + 1 < avail) z |= static_cast<uint32_t>(s[o + 1]) << 8;
        o += n;
      }
      sum += (z >> 1) ^ (0u - (z & 1u));  // 0 for a missing value
      put_lane<X>(w, k, sum);
    }
  }
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
  for (int q = 0; q < kWords<X>; ++q) w[q] = add_lanes<X>(w[q], add);
  if (live < kPerThread) {  // the row's last live values: zeros after
    constexpr uint32_t kMask = (1u << (8 * sizeof(X))) - 1u;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (k >= live) {
        w[k / kLanes<X>] &= ~(kMask << (8 * sizeof(X) * (k % kLanes<X>)));
      }
    }
  }
  store_words<X, kAligned>(orow, i0, N, w);
}

template <typename X, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_w2(const uint8_t* keys, const uint8_t* data, const int* counts,
              X* out, StatusWord* scratch, int N, int T, int D) {
  decode_tile<X, kAligned>(Sections{keys, data, D}, counts, out, scratch, N,
                           T);
}

// out is the wrapper's own allocation, so it starts on a 16-byte word.
template <typename X>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_w2_streams(Streams rows, const int* counts, X* out,
                      StatusWord* scratch, int N, int T) {
  decode_tile<X, true>(rows, counts, out, scratch, N, T);
}

template <typename X>
int encode_launch(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, StatusWord* scratch, int B,
                  int N, cudaStream_t s) {
  const int tiles = grid_tiles(B, N);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = word_aligned<X>(x) ? encode_w2<X, true>
                                         : encode_w2<X, false>;
  kernel<<<tiles, kThreads, 0, s>>>(static_cast<const X*>(x), lens, keys,
                                    data, data_len, scratch, N, tiles / B);
  return cudaGetLastError();
}

template <typename X>
int decode_launch(const uint8_t* keys, const uint8_t* data, const int* counts,
                  void* out, StatusWord* scratch, int B, int N, int D,
                  cudaStream_t s) {
  const int tiles = grid_tiles(B, N);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = word_aligned<X>(out) ? decode_w2<X, true>
                                           : decode_w2<X, false>;
  kernel<<<tiles, kThreads, 0, s>>>(keys, data, counts, static_cast<X*>(out),
                                    scratch, N, tiles / B, D);
  return cudaGetLastError();
}

// Held from the scratch's fill to the launch: ctypes releases the GIL, and
// two threads on one stream must not enqueue fill, fill, D, D, where the
// second D would start on the first's look-back state.
std::mutex enqueue_mutex;

template <typename X>
int decode_streams_launch(const Streams& rows, const int* counts, void* out,
                          StatusWord* scratch, long long scratch_words, int B,
                          int N, cudaStream_t s) {
  const int tiles = grid_tiles(B, N);
  const long long words = 1 + 2LL * tiles + B;
  if (tiles == 0 || words > scratch_words || !word_aligned<X>(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const std::lock_guard<std::mutex> hold(enqueue_mutex);
  const cudaError_t filled =
      cudaMemsetAsync(scratch, 0, words * sizeof(StatusWord), s);
  if (filled != cudaSuccess) return static_cast<int>(filled);
  decode_w2_streams<X><<<tiles, kThreads, 0, s>>>(
      rows, counts, static_cast<X*>(out), scratch, N, tiles / B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Values per tile, T = ceil(N / tile) tiles per row. The scratch of every
// entry point is 8-byte words: 1 + B * T for encode and 1 + 2 * B * T for
// decode, zeroed by the caller before each call; decode_streams takes a
// scratch of scratch_words >= 1 + 2 * B * T + B words in any state and
// zeroes those words on the stream before its launch.
int vbz_w2_tile() { return kPassTile; }

// x: [B, N] int16 (elem_bytes 2, zz16) or int8 (elem_bytes 1, zz8);
// lens: [B] i32. Writes keys [B, N/4], data [B, 2N], data_len [B] i32.
int vbz_w2_encode(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, StatusWord* scratch, int B,
                  int N, int elem_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return encode_launch<int16_t>(x, lens, keys, data, data_len, scratch, B,
                                  N, s);
  }
  if (elem_bytes == 1) {
    return encode_launch<int8_t>(x, lens, keys, data, data_len, scratch, B,
                                 N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys: [B, N/4] u8, data: [B, D] u8, counts: [B] i32. Writes out [B, N]
// int16 (elem_bytes 2) or int8 (elem_bytes 1).
int vbz_w2_decode(const uint8_t* keys, const uint8_t* data, const int* counts,
                  void* out, StatusWord* scratch, int B, int N, int D,
                  int elem_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return decode_launch<int16_t>(keys, data, counts, out, scratch, B, N, D, s);
  }
  if (elem_bytes == 1) {
    return decode_launch<int8_t>(keys, data, counts, out, scratch, B, N, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// streams: [B, M] u8 v0 streams read in place, counts and stream_lens:
// [B] i32. Writes out [B, N] int16 (elem_bytes 2) or int8 (elem_bytes 1),
// 16-byte aligned, and ok [B] (bool). One fill of the scratch and one
// launch, enqueued together.
int vbz_w2_decode_streams(const uint8_t* streams, const int* counts,
                          const int* stream_lens, void* out, bool* ok,
                          StatusWord* scratch, long long scratch_words, int B,
                          int N, int M, int elem_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Streams rows{streams, M, stream_lens, ok};
  if (elem_bytes == 2) {
    return decode_streams_launch<int16_t>(rows, counts, out, scratch,
                                          scratch_words, B, N, s);
  }
  if (elem_bytes == 1) {
    return decode_streams_launch<int8_t>(rows, counts, out, scratch,
                                         scratch_words, B, N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
