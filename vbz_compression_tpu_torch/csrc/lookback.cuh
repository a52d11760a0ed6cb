// Decoupled look-back for the one-pass kernels (w2_codec.cu: E and D;
// w4_codec.cu: E4 and D4; v1_codec.cu: V1E, whose variant also carries the
// row's last nibble, and V1D; probe.cu: the prefix sum), sm_90a.
//
// Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back" (2016), written out by hand. A one-pass kernel carries a
// running value from each tile of a row to the next: the byte offset of the
// tile's data, the un-delta sum. The TPU kernels carried both from one grid
// step to the next in SMEM; here each tile publishes a 64-bit status word
// {flag, value}, first its own aggregate and then, once it knows the sum of
// the row's earlier tiles, its inclusive prefix. A tile finds its exclusive
// prefix by reading its predecessors' words, 32 at a time, back to the
// nearest inclusive prefix or to the row's first tile. The scan resets at
// every row.
//
// Blocks take their tile from an atomic ticket, not from blockIdx, so every
// tile a block waits on was taken earlier by a block that is already running
// and that never waits on a later tile: the look-back cannot deadlock.
//
// Scratch layout (zeroed by the caller before each launch): kLookbackHeader
// words holding the ticket, then one status word per tile and carried value.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Everything here has internal linkage (static, constexpr, inline), so each
// source that includes it owns its copy.

namespace vbz {

using StatusWord = unsigned long long;

constexpr int kLookbackHeader = 1;       // scratch words before the status
constexpr uint32_t kStatusEmpty = 0;     // not published yet (zeroed)
constexpr uint32_t kStatusAggregate = 1; // value: the tile's own sum
constexpr uint32_t kStatusPrefix = 2;    // value: the row's sum through it
constexpr unsigned kWarpMask = 0xffffffffu;

static __device__ __forceinline__ StatusWord status_word(uint32_t flag,
                                                         uint32_t value) {
  return (static_cast<StatusWord>(flag) << 32) | value;
}

static __device__ __forceinline__ uint32_t status_flag(StatusWord s) {
  return static_cast<uint32_t>(s >> 32);
}

// One 64-bit store: a reader sees the flag and the value together. Nothing
// else is published through a status word, so no fence has to order other
// writes before it (a __threadfence here measured slower).
static __device__ __forceinline__ void publish_status(StatusWord* s,
                                                      uint32_t flag,
                                                      uint32_t value) {
  *reinterpret_cast<volatile StatusWord*>(s) = status_word(flag, value);
}

static __device__ __forceinline__ StatusWord read_status(const StatusWord* s) {
  return *reinterpret_cast<const volatile StatusWord*>(s);
}

// The block's tile index, in the order blocks start. Every thread of the
// block must call it.
static __device__ __forceinline__ uint32_t take_ticket(StatusWord* scratch) {
  __shared__ uint32_t ticket;
  if (threadIdx.x == 0) {
    ticket = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  }
  __syncthreads();
  return ticket;
}

// The first half of the protocol, by one thread: a row's first tile knows
// its prefix at once; every other tile publishes its aggregate.
static __device__ __forceinline__ void publish_aggregate(StatusWord* row,
                                                         int t,
                                                         uint32_t aggregate) {
  publish_status(row + t, t == 0 ? kStatusPrefix : kStatusAggregate,
                 aggregate);
}

// Exclusive prefix (mod 2^32) of tile t of the row whose status words start
// at row. Called by all 32 lanes of one warp; returns the same value on
// each. Each step reads the status words of the 32 tiles before the last
// one it reached (lane l the tile l + 1 back) and waits until every tile
// nearer than the nearest inclusive prefix among them has published.
static __device__ uint32_t look_back(const StatusWord* row, int t) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (int end = t;; end -= 32) {
    const int j = end - 1 - lane;
    StatusWord s;
    unsigned done;
    while (true) {
      // Before the row's first tile the prefix is 0.
      s = j >= 0 ? read_status(row + j) : status_word(kStatusPrefix, 0);
      const unsigned empty =
          __ballot_sync(kWarpMask, status_flag(s) == kStatusEmpty);
      done = __ballot_sync(kWarpMask, status_flag(s) == kStatusPrefix);
      // Lowest set bit: the nearest tile of each kind.
      if (empty == 0u ||
          (done != 0u && (done & (0u - done)) < (empty & (0u - empty)))) {
        break;
      }
      __nanosleep(32);
    }
    // Sum the values from lane 0 up to the nearest inclusive prefix, or all
    // 32 aggregates when there is none.
    const int stop = done ? __ffs(done) - 1 : 31;
    uint32_t v = lane <= stop ? static_cast<uint32_t>(s) : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kWarpMask, v, d);
    prefix += v;
    if (done) return prefix;
  }
}

// The second half, by all 32 lanes of one warp, after publish_aggregate:
// the tile's exclusive prefix, with its inclusive prefix published.
static __device__ __forceinline__ uint32_t resolve_prefix(StatusWord* row,
                                                          int t,
                                                          uint32_t aggregate) {
  if (t == 0) return 0u;
  const uint32_t prefix = look_back(row, t);
  if ((threadIdx.x & 31) == 0) {
    publish_status(row + t, kStatusPrefix, prefix + aggregate);
  }
  return prefix;
}

// The variant that carries a nibble beside the sum (V1E, v1_codec.cu): each
// tile's state is (nibbles, last nibble, has-nibble), combined as
// (a, n_a, h_a) + (b, n_b, h_b) = (a + b, h_b ? n_b : n_a, h_a | h_b). The
// nibble and its flag ride in the status word's upper half as a tag above
// the flag: kNibbleHas | nibble, or 0 when the tiles hold no nibble. The
// functions above stay as they are, so the other kernels keep their code.
constexpr uint32_t kNibbleHas = 0x10;  // tag bit: the tag holds a nibble
constexpr int kTagShift = 8;           // tag position in the upper half

static __device__ __forceinline__ void publish_tagged(StatusWord* s,
                                                      uint32_t flag,
                                                      uint32_t tag,
                                                      uint32_t value) {
  publish_status(s, flag | (tag << kTagShift), value);
}

// publish_aggregate with the tile's own tag.
static __device__ __forceinline__ void publish_aggregate_tagged(
    StatusWord* row, int t, uint32_t aggregate, uint32_t tag) {
  publish_tagged(row + t, t == 0 ? kStatusPrefix : kStatusAggregate, tag,
                 aggregate);
}

// look_back, which also sets *tag to the carried tag of the tiles before t:
// that of the nearest lane whose tag holds a nibble, up to the inclusive
// prefix the walk stops at (0 when none does).
static __device__ uint32_t look_back_tagged(const StatusWord* row, int t,
                                            uint32_t* tag) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0, found = 0;
  for (int end = t;; end -= 32) {
    const int j = end - 1 - lane;
    StatusWord s;
    unsigned done;
    while (true) {
      s = j >= 0 ? read_status(row + j) : status_word(kStatusPrefix, 0);
      const uint32_t flag = status_flag(s) & ((1u << kTagShift) - 1u);
      const unsigned empty = __ballot_sync(kWarpMask, flag == kStatusEmpty);
      done = __ballot_sync(kWarpMask, flag == kStatusPrefix);
      if (empty == 0u ||
          (done != 0u && (done & (0u - done)) < (empty & (0u - empty)))) {
        break;
      }
      __nanosleep(32);
    }
    const int stop = done ? __ffs(done) - 1 : 31;
    uint32_t v = lane <= stop ? static_cast<uint32_t>(s) : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kWarpMask, v, d);
    prefix += v;
    if (!(found & kNibbleHas)) {
      const uint32_t lane_tag = status_flag(s) >> kTagShift;
      const unsigned has =
          __ballot_sync(kWarpMask, lane <= stop && (lane_tag & kNibbleHas));
      if (has) found = __shfl_sync(kWarpMask, lane_tag, __ffs(has) - 1);
    }
    if (done) {
      *tag = found;
      return prefix;
    }
  }
}

// resolve_prefix with tags: own_tag is the tile's (0 when it holds no
// nibble); *carried receives the tag of the tiles before it. Publishes the
// inclusive prefix with the combined tag.
static __device__ __forceinline__ uint32_t resolve_prefix_tagged(
    StatusWord* row, int t, uint32_t aggregate, uint32_t own_tag,
    uint32_t* carried) {
  *carried = 0;
  if (t == 0) return 0u;
  const uint32_t prefix = look_back_tagged(row, t, carried);
  if ((threadIdx.x & 31) == 0) {
    publish_tagged(row + t, kStatusPrefix,
                   (own_tag & kNibbleHas) ? own_tag : *carried,
                   prefix + aggregate);
  }
  return prefix;
}

}  // namespace vbz
