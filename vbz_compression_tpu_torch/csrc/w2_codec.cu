// W2 StreamVByte encode (kernel E) and decode (kernel D) for Hopper, sm_90a.
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
// or past D.
//
// A block owns one tile of kTile values, four consecutive values (one key
// byte) per thread. The TPU kernels carried the running byte offset, the
// previous sample and the un-delta sum from one grid step to the next; CUDA
// blocks run in no order, so each carry is a per-row scan over tiles:
//   E: tile sizes -> row scan (offsets, data_len) -> write keys and data.
//      The previous sample is x[i-1], read from global memory.
//   D: tile sizes from keys -> row scan (offsets) -> read, un-zig-zag and
//      scan deltas inside each tile -> row scan of tile sums -> add carry.
// Entry points launch on the given stream, allocate nothing (the caller
// passes the [B, T] u32 scratch) and return cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

using namespace vbz;

// Zig-zag delta of value i of a row (x[-1] = 0).
template <typename X>
__device__ __forceinline__ uint32_t zz_value(const X* row, int i) {
  const int cur = row[i];
  const int prev = i > 0 ? static_cast<int>(row[i - 1]) : 0;
  if constexpr (sizeof(X) == 2) {
    const uint32_t d = static_cast<uint32_t>(cur - prev) & 0xFFFFu;
    return ((d << 1) & 0xFFFFu) ^ ((d >> 15) ? 0xFFFFu : 0u);
  } else {
    const int d = cur - prev;
    return (static_cast<uint32_t>(d) << 1) ^ static_cast<uint32_t>(d >> 31);
  }
}

// Values i0..i0+3 of a row: zig-zag values, codes, and their data bytes.
template <typename X>
__device__ __forceinline__ uint32_t encode_quad(const X* row, int i0, int len,
                                                uint32_t v[4], uint32_t c[4]) {
  uint32_t bytes = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = 0;
    c[k] = 0;
    if (i0 + k < len) {
      v[k] = zz_value(row, i0 + k);
      c[k] = v[k] > 0xFFu;
      bytes += 1 + c[k];
    }
  }
  return bytes;
}

template <typename X>
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
  const uint32_t bytes = encode_quad(x + static_cast<size_t>(b) * N,
                                     base + 4 * threadIdx.x, len, v, c);
  uint32_t total;
  block_exclusive_scan<kThreads>(bytes, &total, smem);
  if (threadIdx.x == 0) *out = total;
}

template <typename X>
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
      encode_quad(x + static_cast<size_t>(b) * N, i0, len, v, c);
  if (i0 < N) {
    krow[i0 / 4] = static_cast<uint8_t>(c[0] | (c[1] << 2) | (c[2] << 4) |
                                        (c[3] << 6));
  }
  uint32_t total;
  uint32_t o = tile_off[static_cast<size_t>(b) * T + blockIdx.x] +
               block_exclusive_scan<kThreads>(bytes, &total, smem);
  uint8_t* drow = data + static_cast<size_t>(b) * 2 * N;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < len) {
      drow[o++] = static_cast<uint8_t>(v[k]);
      if (c[k]) drow[o++] = static_cast<uint8_t>(v[k] >> 8);
    }
  }
}

// Data bytes of values i0..i0+3 (i < count): 1 + (code != 0) each.
__device__ __forceinline__ uint32_t decode_quad_lens(uint32_t key, int i0,
                                                     int count, uint32_t n[4]) {
  uint32_t bytes = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n[k] = i0 + k < count ? 1u + (((key >> (2 * k)) & 3u) != 0u) : 0u;
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

// Decodes one tile: each value's bytes at the scanned offsets, un-zig-zag,
// then the inclusive delta sum inside the tile. Writes that partial sum to
// out and the tile's delta total to tile_sum; finish_undelta adds the sum
// of the row's earlier tiles.
template <typename X>
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
    if (threadIdx.x == 0) tile_sum[tile] = 0;
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
  uint32_t prefix[4];
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v = 0;
    if (n[k] != 0) {
      if (o < limit) v = drow[o];
      if (n[k] == 2 && o + 1 < limit) v |= static_cast<uint32_t>(drow[o + 1]) << 8;
      o += n[k];
    }
    sum += (v >> 1) ^ (0u - (v & 1u));  // un-zig-zag; 0 for a missing value
    prefix[k] = sum;
  }
  const uint32_t before = block_exclusive_scan<kThreads>(sum, &total, smem);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < N) {
      orow[i0 + k] = i0 + k < count
                         ? static_cast<X>(static_cast<U>(before + prefix[k]))
                         : X(0);
    }
  }
  if (threadIdx.x == 0) tile_sum[tile] = total;
}

template <typename X>
int encode_launch(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, uint32_t* tile_bytes,
                  uint32_t* tile_off, int B, int N, cudaStream_t s) {
  const int T = (N + kTile - 1) / kTile;
  const dim3 grid(T, B);
  const X* xt = static_cast<const X*>(x);
  encode_sizes<X><<<grid, kThreads, 0, s>>>(xt, lens, tile_bytes, N, T);
  int err = cudaGetLastError();
  if (err != 0) return err;
  row_exclusive_scan<<<B, kScanThreads, 0, s>>>(
      tile_bytes, tile_off, reinterpret_cast<uint32_t*>(data_len), T);
  err = cudaGetLastError();
  if (err != 0) return err;
  encode_write<X><<<grid, kThreads, 0, s>>>(xt, lens, tile_off, keys, data, N, T);
  return cudaGetLastError();
}

template <typename X>
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
  decode_tiles<X><<<grid, kThreads, 0, s>>>(keys, data, counts, tile_off, o,
                                            tile_sum, N, T, D);
  err = cudaGetLastError();
  if (err != 0) return err;
  return finish_undelta<X>(o, counts, tile_sum, tile_carry, B, N, T, s);
}

}  // namespace

extern "C" {

// Values per tile: the scratch of both entry points is [B, ceil(N / tile)].
int vbz_w2_tile() { return kTile; }

// x: [B, N] int16 (elem_bytes 2, zz16) or int8 (elem_bytes 1, zz8);
// lens: [B] i32. Writes keys [B, N/4], data [B, 2N], data_len [B] i32.
// scratch: 2 * B * T u32.
int vbz_w2_encode(const void* x, const int* lens, uint8_t* keys,
                  uint8_t* data, int* data_len, uint32_t* scratch, int B,
                  int N, int elem_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t bt = static_cast<size_t>(B) * ((N + kTile - 1) / kTile);
  if (elem_bytes == 2) {
    return encode_launch<int16_t>(x, lens, keys, data, data_len, scratch,
                                  scratch + bt, B, N, s);
  }
  if (elem_bytes == 1) {
    return encode_launch<int8_t>(x, lens, keys, data, data_len, scratch,
                                 scratch + bt, B, N, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys: [B, N/4] u8, data: [B, D] u8, counts: [B] i32. Writes out [B, N]
// int16 (elem_bytes 2) or int8 (elem_bytes 1). scratch: 4 * B * T u32.
int vbz_w2_decode(const uint8_t* keys, const uint8_t* data, const int* counts,
                  void* out, uint32_t* scratch, int B, int N, int D,
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

}  // extern "C"
