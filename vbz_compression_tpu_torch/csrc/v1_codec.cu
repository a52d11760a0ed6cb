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
// 0-2 data bytes written on encode, the reverse on decode. The structure is
// kernel E's (w2_codec.cu): tile sizes (in nibbles) -> per-row scan -> write
// pass, and on decode for zz8 a second per-row scan of the tiles' delta sums
// plus a carry pass.
//
// The trap is that neighbours share bytes: a thread's first nibble can land
// on the high half of a byte whose low half is the previous thread's (or the
// previous tile's) last nibble, and that neighbour may be any distance back,
// since code-0 values have no nibbles. Encode therefore zeroes each row's
// data bytes first (one pass over the bytes the row will hold) and then ORs
// every thread's nibbles into their aligned 32-bit words with atomicOr: at
// most three words per thread (16 nibbles span at most 9 bytes).
//
// Layout: a batch is B rows of N values (N % 4 == 0) with a per-row length.
// Keys are [B, N/4] u8, encode data is [B, 2N] u8 (each row dense from byte
// 0, the row's base 4-byte aligned), decode data is [B, D] u8 for any D.
// Values at or past a row's length take code 0 and decode to 0; decode never
// reads a byte at or past D. data_len is in bytes. Entry points launch on
// the given stream, allocate nothing (the caller passes the [B, T] u32
// scratch) and return cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

using namespace vbz;

template <bool kZigzag>
__device__ __forceinline__ uint32_t v1_value(const int8_t* row, int i) {
  const int cur = row[i];
  if constexpr (kZigzag) {
    const int d = cur - (i > 0 ? static_cast<int>(row[i - 1]) : 0);
    return (static_cast<uint32_t>(d) << 1) ^ static_cast<uint32_t>(d >> 31);
  } else {
    return static_cast<uint32_t>(cur);  // sign-extended
  }
}

__device__ __forceinline__ uint32_t v1_code(uint32_t v) {
  return v == 0 ? 0u : (v < 16u ? 1u : (v < 256u ? 2u : 3u));
}

// Nibbles of a code: 0, 1, 2, 4.
__device__ __forceinline__ uint32_t v1_nibbles(uint32_t code) {
  return (1u << code) >> 1;
}

// Values i0..i0+3 of a row: their codes, and their nibbles packed low first
// into *bits; returns the nibble count (at most 16).
template <bool kZigzag>
__device__ __forceinline__ uint32_t encode_quad(const int8_t* row, int i0,
                                                int len, uint32_t c[4],
                                                uint64_t* bits) {
  uint32_t n = 0;
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = 0;
    if (i0 + k < len) {
      const uint32_t v = v1_value<kZigzag>(row, i0 + k);
      c[k] = v1_code(v);
      const uint32_t m = v1_nibbles(c[k]);
      const uint64_t low = v & ((1u << (4 * m)) - 1u);  // m <= 4
      acc |= low << (4 * n);
      n += m;
    }
  }
  *bits = acc;
  return n;
}

template <bool kZigzag>
__global__ void encode_sizes(const int8_t* x, const int* lens,
                             uint32_t* tile_nibs, int N, int T) {
  __shared__ uint32_t smem[kThreads / 32];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int len = clamp_len(lens[b], N);
  uint32_t* out = tile_nibs + static_cast<size_t>(b) * T + blockIdx.x;
  if (base >= len) {
    if (threadIdx.x == 0) *out = 0;
    return;
  }
  uint32_t c[4];
  uint64_t bits;
  const uint32_t n = encode_quad<kZigzag>(x + static_cast<size_t>(b) * N,
                                          base + 4 * threadIdx.x, len, c,
                                          &bits);
  uint32_t total;
  block_exclusive_scan<kThreads>(n, &total, smem);
  if (threadIdx.x == 0) *out = total;
}

// Zeroes the 32-bit words that hold the tile's data bytes, so that the write
// pass can OR nibbles in; block (0, b) also writes the row's byte length.
__global__ void zero_tiles(const uint32_t* tile_nibs, const uint32_t* tile_off,
                           const uint32_t* row_nibs, uint8_t* data,
                           int* data_len, int N, int T) {
  const int b = blockIdx.y;
  const size_t tile = static_cast<size_t>(b) * T + blockIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    data_len[b] = static_cast<int>((row_nibs[b] + 1) / 2);
  }
  const uint32_t nibs = tile_nibs[tile];
  if (nibs == 0) return;
  const uint32_t off = tile_off[tile];
  const uint32_t w_lo = (off >> 1) >> 2;
  const uint32_t w_hi = (((off + nibs + 1) >> 1) + 3) >> 2;
  uint32_t* words =
      reinterpret_cast<uint32_t*>(data + static_cast<size_t>(b) * 2 * N);
  for (uint32_t w = w_lo + threadIdx.x; w < w_hi; w += kThreads) words[w] = 0;
}

template <bool kZigzag>
__global__ void encode_write(const int8_t* x, const int* lens,
                             const uint32_t* tile_off, uint8_t* keys,
                             uint8_t* data, int N, int T) {
  __shared__ uint32_t smem[kThreads / 32];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int len = clamp_len(lens[b], N);
  const int i0 = base + 4 * threadIdx.x;
  uint8_t* krow = keys + static_cast<size_t>(b) * (N / 4);
  if (base >= len) {
    if (i0 < N) krow[i0 / 4] = 0;
    return;
  }
  uint32_t c[4];
  uint64_t bits;
  const uint32_t n = encode_quad<kZigzag>(x + static_cast<size_t>(b) * N, i0,
                                          len, c, &bits);
  if (i0 < N) {
    krow[i0 / 4] = static_cast<uint8_t>(c[0] | (c[1] << 2) | (c[2] << 4) |
                                        (c[3] << 6));
  }
  uint32_t total;
  const uint32_t o = tile_off[static_cast<size_t>(b) * T + blockIdx.x] +
                     block_exclusive_scan<kThreads>(n, &total, smem);
  if (n == 0) return;
  // The 4n bits go to nibble offset o: shift them by o's half-byte phase;
  // a 16th nibble then spills into a ninth byte.
  const uint32_t shift = (o & 1u) * 4u;
  const uint64_t lo = bits << shift;
  const uint32_t spill = shift ? static_cast<uint32_t>(bits >> 60) : 0u;
  const uint32_t nbytes = (shift + 4 * n + 7) / 8;
  const uint32_t byte0 = o >> 1;
  uint32_t* words =
      reinterpret_cast<uint32_t*>(data + static_cast<size_t>(b) * 2 * N);
  uint32_t word = byte0 >> 2;
  uint32_t acc = 0;
  for (uint32_t j = 0; j < nbytes; ++j) {
    const uint32_t pos = byte0 + j;
    if ((pos >> 2) != word) {
      if (acc) atomicOr(&words[word], acc);
      acc = 0;
      word = pos >> 2;
    }
    const uint32_t byte =
        j < 8 ? static_cast<uint32_t>(lo >> (8 * j)) & 0xFFu : spill;
    acc |= byte << (8 * (pos & 3u));
  }
  if (acc) atomicOr(&words[word], acc);
}

// Nibbles of values i0..i0+3 (i < count), from their codes.
__device__ __forceinline__ uint32_t decode_quad_nibs(uint32_t key, int i0,
                                                     int count, uint32_t n[4]) {
  uint32_t nibs = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n[k] = i0 + k < count ? v1_nibbles((key >> (2 * k)) & 3u) : 0u;
    nibs += n[k];
  }
  return nibs;
}

__global__ void decode_sizes(const uint8_t* keys, const int* counts,
                             uint32_t* tile_nibs, int N, int T) {
  __shared__ uint32_t smem[kThreads / 32];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int count = clamp_len(counts[b], N);
  uint32_t* out = tile_nibs + static_cast<size_t>(b) * T + blockIdx.x;
  if (base >= count) {
    if (threadIdx.x == 0) *out = 0;
    return;
  }
  const int i0 = base + 4 * threadIdx.x;
  const uint32_t key =
      i0 < count ? keys[static_cast<size_t>(b) * (N / 4) + i0 / 4] : 0u;
  uint32_t n[4];
  const uint32_t nibs = decode_quad_nibs(key, i0, count, n);
  uint32_t total;
  block_exclusive_scan<kThreads>(nibs, &total, smem);
  if (threadIdx.x == 0) *out = total;
}

// Decodes one tile: each value's nibbles at the scanned nibble offsets.
// zz8: un-zig-zag, then the inclusive delta sum inside the tile; writes that
// partial sum to out and the tile's delta total to tile_sum, and
// finish_undelta adds the sum of the row's earlier tiles. none8 writes the
// value's low byte.
template <bool kZigzag>
__global__ void decode_tiles(const uint8_t* keys, const uint8_t* data,
                             const int* counts, const uint32_t* tile_off,
                             int8_t* out, uint32_t* tile_sum, int N, int T,
                             int D) {
  __shared__ uint32_t smem[kThreads / 32];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int count = clamp_len(counts[b], N);
  const int i0 = base + 4 * threadIdx.x;
  const size_t tile = static_cast<size_t>(b) * T + blockIdx.x;
  int8_t* orow = out + static_cast<size_t>(b) * N;
  if (base >= count) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i0 + k < N) orow[i0 + k] = 0;
    }
    if (kZigzag && threadIdx.x == 0) tile_sum[tile] = 0;
    return;
  }
  const uint32_t key =
      i0 < count ? keys[static_cast<size_t>(b) * (N / 4) + i0 / 4] : 0u;
  uint32_t n[4];
  const uint32_t nibs = decode_quad_nibs(key, i0, count, n);
  uint32_t total;
  uint32_t p = tile_off[tile] + block_exclusive_scan<kThreads>(nibs, &total, smem);
  const uint8_t* drow = data + static_cast<size_t>(b) * D;
  const uint32_t limit = static_cast<uint32_t>(D);
  uint32_t val[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0;
    for (uint32_t j = 0; j < n[k]; ++j, ++p) {
      const uint32_t byte = (p >> 1) < limit ? drow[p >> 1] : 0u;
      v |= ((p & 1u) ? byte >> 4 : byte & 0xFu) << (4 * j);
    }
    val[k] = v;  // 0 for a value past count
  }
  if constexpr (kZigzag) {
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sum += (val[k] >> 1) ^ (0u - (val[k] & 1u));  // un-zig-zag
      val[k] = sum;
    }
    const uint32_t before = block_exclusive_scan<kThreads>(sum, &total, smem);
#pragma unroll
    for (int k = 0; k < 4; ++k) val[k] += before;
    if (threadIdx.x == 0) tile_sum[tile] = total;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < N) {
      orow[i0 + k] = i0 + k < count
                         ? static_cast<int8_t>(static_cast<uint8_t>(val[k]))
                         : int8_t(0);
    }
  }
}

template <bool kZigzag>
int encode_launch(const int8_t* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, uint32_t* scratch, int B,
                  int N, cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  const dim3 grid(T, B);
  const size_t bt = static_cast<size_t>(B) * T;
  uint32_t* tile_nibs = scratch;
  uint32_t* tile_off = scratch + bt;
  uint32_t* row_nibs = scratch + 2 * bt;
  encode_sizes<kZigzag><<<grid, kThreads, 0, s>>>(x, lens, tile_nibs, N, T);
  int err = cudaGetLastError();
  if (err != 0) return err;
  row_exclusive_scan<<<B, kScanThreads, 0, s>>>(tile_nibs, tile_off, row_nibs,
                                                T);
  err = cudaGetLastError();
  if (err != 0) return err;
  zero_tiles<<<grid, kThreads, 0, s>>>(tile_nibs, tile_off, row_nibs, data,
                                       data_len, N, T);
  err = cudaGetLastError();
  if (err != 0) return err;
  encode_write<kZigzag><<<grid, kThreads, 0, s>>>(x, lens, tile_off, keys,
                                                  data, N, T);
  return cudaGetLastError();
}

template <bool kZigzag>
int decode_launch(const uint8_t* keys, const uint8_t* data, const int* counts,
                  int8_t* out, uint32_t* scratch, int B, int N, int D,
                  cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  const dim3 grid(T, B);
  const size_t bt = static_cast<size_t>(B) * T;
  uint32_t* tile_nibs = scratch;
  uint32_t* tile_off = scratch + bt;
  uint32_t* tile_sum = scratch + 2 * bt;
  uint32_t* tile_carry = scratch + 3 * bt;
  decode_sizes<<<grid, kThreads, 0, s>>>(keys, counts, tile_nibs, N, T);
  int err = cudaGetLastError();
  if (err != 0) return err;
  row_exclusive_scan<<<B, kScanThreads, 0, s>>>(tile_nibs, tile_off, nullptr,
                                                T);
  err = cudaGetLastError();
  if (err != 0) return err;
  decode_tiles<kZigzag><<<grid, kThreads, 0, s>>>(keys, data, counts, tile_off,
                                                  out, tile_sum, N, T, D);
  err = cudaGetLastError();
  if (err != 0 || !kZigzag) return err;
  return finish_undelta<int8_t>(out, counts, tile_sum, tile_carry, B, N, T, s);
}

}  // namespace

extern "C" {

// Values per tile: the scratch of both entry points is [B, ceil(N / tile)].
int vbz_v1_tile() { return kTile; }

// x: [B, N] int8 (zigzag 1: zz8, 0: none8); lens: [B] i32. Writes keys
// [B, N/4], data [B, 2N] (4-byte aligned), data_len [B] i32 in bytes.
// scratch: 2*B*T + B u32.
int vbz_v1_encode(const int8_t* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, uint32_t* scratch, int B,
                  int N, int zigzag, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(data) % 4 != 0 || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return zigzag ? encode_launch<true>(x, lens, keys, data, data_len, scratch,
                                      B, N, s)
                : encode_launch<false>(x, lens, keys, data, data_len, scratch,
                                       B, N, s);
}

// keys: [B, N/4] u8, data: [B, D] u8, counts: [B] i32. Writes out [B, N]
// int8. scratch: 4*B*T u32.
int vbz_v1_decode(const uint8_t* keys, const uint8_t* data, const int* counts,
                  int8_t* out, uint32_t* scratch, int B, int N, int D,
                  int zigzag, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return zigzag ? decode_launch<true>(keys, data, counts, out, scratch, B, N,
                                      D, s)
                : decode_launch<false>(keys, data, counts, out, scratch, B, N,
                                       D, s);
}

}  // extern "C"
