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
// 1-4 data bytes written (encode), the reverse on decode. The structure is
// kernel E's (w2_codec.cu): tile sizes -> per-row scan -> write pass, and on
// decode for zz32 a second per-row scan of the tiles' delta sums plus a
// carry pass; the none flavors need no un-delta and stop after the gather.
//
// Layout: a batch is B rows of N values (N % 4 == 0) with a per-row length.
// Keys are [B, N/4] u8, encode data is [B, 4N] u8 (each row dense from byte
// 0), decode data is [B, D] u8 for any D. Values at or past a row's length
// take code 0, write no data, and decode to 0; decode never reads a byte at
// or past D. Entry points launch on the given stream, allocate nothing (the
// caller passes the [B, T] u32 scratch) and return cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

using namespace vbz;

// Value i of a row as the v0 stream stores it (x[-1] = 0 for zz32).
template <typename X, bool kZigzag>
__device__ __forceinline__ uint32_t w4_value(const X* row, int i) {
  if constexpr (kZigzag) {
    const uint32_t cur = static_cast<uint32_t>(row[i]);
    const uint32_t prev = i > 0 ? static_cast<uint32_t>(row[i - 1]) : 0u;
    const uint32_t d = cur - prev;  // wraps at 32 bits
    return (d << 1) ^ static_cast<uint32_t>(static_cast<int32_t>(d) >> 31);
  } else {
    return static_cast<uint32_t>(static_cast<int32_t>(row[i]));  // sign-extend
  }
}

__device__ __forceinline__ uint32_t w4_code(uint32_t v) {
  return (v > 0xFFu) + (v > 0xFFFFu) + (v > 0xFFFFFFu);
}

// Values i0..i0+3 of a row: stored values, codes, and their data bytes.
template <typename X, bool kZigzag>
__device__ __forceinline__ uint32_t encode_quad(const X* row, int i0, int len,
                                                uint32_t v[4], uint32_t c[4]) {
  uint32_t bytes = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = 0;
    c[k] = 0;
    if (i0 + k < len) {
      v[k] = w4_value<X, kZigzag>(row, i0 + k);
      c[k] = w4_code(v[k]);
      bytes += 1 + c[k];
    }
  }
  return bytes;
}

template <typename X, bool kZigzag>
__global__ void encode_sizes(const X* x, const int* lens, uint32_t* tile_bytes,
                             int N, int T) {
  __shared__ uint32_t smem[kThreads / 32];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int len = clamp_len(lens[b], N);
  uint32_t* out = tile_bytes + static_cast<size_t>(b) * T + blockIdx.x;
  if (base >= len) {
    if (threadIdx.x == 0) *out = 0;
    return;
  }
  uint32_t v[4], c[4];
  const uint32_t bytes = encode_quad<X, kZigzag>(
      x + static_cast<size_t>(b) * N, base + 4 * threadIdx.x, len, v, c);
  uint32_t total;
  block_exclusive_scan<kThreads>(bytes, &total, smem);
  if (threadIdx.x == 0) *out = total;
}

template <typename X, bool kZigzag>
__global__ void encode_write(const X* x, const int* lens,
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
  uint32_t v[4], c[4];
  const uint32_t bytes =
      encode_quad<X, kZigzag>(x + static_cast<size_t>(b) * N, i0, len, v, c);
  if (i0 < N) {
    krow[i0 / 4] = static_cast<uint8_t>(c[0] | (c[1] << 2) | (c[2] << 4) |
                                        (c[3] << 6));
  }
  uint32_t total;
  uint32_t o = tile_off[static_cast<size_t>(b) * T + blockIdx.x] +
               block_exclusive_scan<kThreads>(bytes, &total, smem);
  uint8_t* drow = data + static_cast<size_t>(b) * 4 * N;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < len) {
      for (uint32_t j = 0; j <= c[k]; ++j) {
        drow[o++] = static_cast<uint8_t>(v[k] >> (8 * j));
      }
    }
  }
}

// Data bytes of values i0..i0+3 (i < count): 1 + code each.
__device__ __forceinline__ uint32_t decode_quad_lens(uint32_t key, int i0,
                                                     int count, uint32_t n[4]) {
  uint32_t bytes = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n[k] = i0 + k < count ? 1u + ((key >> (2 * k)) & 3u) : 0u;
    bytes += n[k];
  }
  return bytes;
}

__global__ void decode_sizes(const uint8_t* keys, const int* counts,
                             uint32_t* tile_bytes, int N, int T) {
  __shared__ uint32_t smem[kThreads / 32];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int count = clamp_len(counts[b], N);
  uint32_t* out = tile_bytes + static_cast<size_t>(b) * T + blockIdx.x;
  if (base >= count) {
    if (threadIdx.x == 0) *out = 0;
    return;
  }
  const int i0 = base + 4 * threadIdx.x;
  const uint32_t key =
      i0 < count ? keys[static_cast<size_t>(b) * (N / 4) + i0 / 4] : 0u;
  uint32_t n[4];
  const uint32_t bytes = decode_quad_lens(key, i0, count, n);
  uint32_t total;
  block_exclusive_scan<kThreads>(bytes, &total, smem);
  if (threadIdx.x == 0) *out = total;
}

// Decodes one tile: each value's 1 + code bytes at the scanned offsets.
// zz32: un-zig-zag, then the inclusive delta sum inside the tile; writes
// that partial sum to out and the tile's delta total to tile_sum, and
// finish_undelta adds the sum of the row's earlier tiles. The none
// flavors write the value truncated to X.
template <typename X, bool kZigzag>
__global__ void decode_tiles(const uint8_t* keys, const uint8_t* data,
                             const int* counts, const uint32_t* tile_off,
                             X* out, uint32_t* tile_sum, int N, int T, int D) {
  using U = std::make_unsigned_t<X>;
  __shared__ uint32_t smem[kThreads / 32];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int count = clamp_len(counts[b], N);
  const int i0 = base + 4 * threadIdx.x;
  const size_t tile = static_cast<size_t>(b) * T + blockIdx.x;
  X* orow = out + static_cast<size_t>(b) * N;
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
  const uint32_t bytes = decode_quad_lens(key, i0, count, n);
  uint32_t total;
  uint32_t o = tile_off[tile] + block_exclusive_scan<kThreads>(bytes, &total, smem);
  const uint8_t* drow = data + static_cast<size_t>(b) * D;
  const uint32_t limit = static_cast<uint32_t>(D);
  uint32_t val[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0;
    for (uint32_t j = 0; j < n[k]; ++j) {
      if (o + j < limit) v |= static_cast<uint32_t>(drow[o + j]) << (8 * j);
    }
    o += n[k];
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
      orow[i0 + k] = i0 + k < count ? static_cast<X>(static_cast<U>(val[k]))
                                    : X(0);
    }
  }
}

template <typename X, bool kZigzag>
int encode_launch(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, uint32_t* scratch, int B,
                  int N, cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  const dim3 grid(T, B);
  const size_t bt = static_cast<size_t>(B) * T;
  uint32_t* tile_bytes = scratch;
  uint32_t* tile_off = scratch + bt;
  const X* xt = static_cast<const X*>(x);
  encode_sizes<X, kZigzag><<<grid, kThreads, 0, s>>>(xt, lens, tile_bytes, N,
                                                     T);
  int err = cudaGetLastError();
  if (err != 0) return err;
  row_exclusive_scan<<<B, kScanThreads, 0, s>>>(
      tile_bytes, tile_off, reinterpret_cast<uint32_t*>(data_len), T);
  err = cudaGetLastError();
  if (err != 0) return err;
  encode_write<X, kZigzag><<<grid, kThreads, 0, s>>>(xt, lens, tile_off, keys,
                                                     data, N, T);
  return cudaGetLastError();
}

template <typename X, bool kZigzag>
int decode_launch(const uint8_t* keys, const uint8_t* data, const int* counts,
                  void* out, uint32_t* scratch, int B, int N, int D,
                  cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  const dim3 grid(T, B);
  const size_t bt = static_cast<size_t>(B) * T;
  uint32_t* tile_bytes = scratch;
  uint32_t* tile_off = scratch + bt;
  uint32_t* tile_sum = scratch + 2 * bt;
  uint32_t* tile_carry = scratch + 3 * bt;
  X* o = static_cast<X*>(out);
  decode_sizes<<<grid, kThreads, 0, s>>>(keys, counts, tile_bytes, N, T);
  int err = cudaGetLastError();
  if (err != 0) return err;
  row_exclusive_scan<<<B, kScanThreads, 0, s>>>(tile_bytes, tile_off, nullptr, T);
  err = cudaGetLastError();
  if (err != 0) return err;
  decode_tiles<X, kZigzag><<<grid, kThreads, 0, s>>>(keys, data, counts,
                                                     tile_off, o, tile_sum, N,
                                                     T, D);
  err = cudaGetLastError();
  if (err != 0 || !kZigzag) return err;
  return finish_undelta<X>(o, counts, tile_sum, tile_carry, B, N, T, s);
}

}  // namespace

extern "C" {

// Values per tile: the scratch of both entry points is [B, ceil(N / tile)].
int vbz_w4_tile() { return kTile; }

// x: [B, N] int32 (elem_bytes 4; zz32 with zigzag 1, none32 with 0), int16
// (elem_bytes 2, none16) or int8 (elem_bytes 1, none8); lens: [B] i32.
// Writes keys [B, N/4], data [B, 4N], data_len [B] i32. scratch: 2*B*T u32.
int vbz_w4_encode(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, uint32_t* scratch, int B,
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
// the flavor's type (as for encode). scratch: 4*B*T u32.
int vbz_w4_decode(const uint8_t* keys, const uint8_t* data, const int* counts,
                  void* out, uint32_t* scratch, int B, int N, int D,
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
