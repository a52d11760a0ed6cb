// Bounded-offset match scan (kernel M) for Hopper, sm_90a.
//
// Replaces vbz_compression_tpu/ops/zstd_match_tpu.py match_candidates (:37,
// a jitted jnp function of shifted compares, not a pallas_call): for every
// position i of a byte buffer of n bytes, the first offset o of the caller's
// list, in the caller's order, such that i >= o, i + 4 <= n and
// buf[i..i+4) == buf[i-o..i-o+4); none when there is none. The caller cuts
// the list at its first o with o + 4 > n, as the JAX function's `break`
// does. The host's greedy assembler (ops/zstd_seq.py find_sequences)
// extends each candidate to its true length, so the scan only certifies
// 4-byte matches. One source, two results (the template's OutT):
//   int32 off: the offset, 0 for none (the JAX function's result);
//   uint8 index: the offset's place in the list plus one, 0 for none (what
//     the zstd stage copies back: a quarter of the bytes).
//
// What bounds it: bytes, n read and 4n (int32) or n (uint8) written, 5n or
// 2n in all; the compares, about two integer instructions per position and
// offset (24 offsets on the zstd stage's list), take as long again at the
// card's issue rate. On the H100 the offset walk still takes most of the
// time (PERF.md, the kernel table's rows 18 and 18b), so its instruction
// stream is kept short, branch-free and the same for the whole warp.
//
// Design. One block of 128 threads per tile of 4096 positions; thread t owns
// the kRun = 32 consecutive positions i0 = t0 + 32t .. i0 + 31.
// - Staging: the tile, up to kHaloCap bytes behind it (as far back as the
//   list's largest offset reaches) and kAhead bytes ahead are copied to
//   shared memory in 16-byte vectors, all of a thread's loads in flight
//   before its first store, from the 16-byte aligned address at or below
//   the first byte (the buffer may start anywhere), so a byte's place in
//   shared memory has its address's alignment. Vectors that cross 0 or n go
//   byte by byte; bytes past n read as 0. No per-position window array.
// - The loop over the list is outside the positions and the same for the
//   whole warp: the list travels in the launch's parameters
//   (__grid_constant__, read from the constant bank, broadcast). For
//   offset o the misalignment of a thread's source bytes, (i0 - o) mod 16,
//   is the same for every thread of the block, so aligned words and a
//   __funnelshift_r per word give the source bytes with no divergence (a
//   switch on the block-uniform word index keeps register indices
//   constant). Offsets up to kNear take their source from registers loaded
//   once (the kNear bytes before the run, the run, 4 after); larger ones
//   from shared memory, four 16-byte vectors a thread.
// - Byte equality four positions at a time, as __vcmpeq4 gives it, from the
//   zero bytes of t ^ s in four instructions (bit 7 of each byte); then
//   y = z & z>>8 and m = y & y>>16 across the words (funnel shifts) mark the
//   positions whose 4 bytes match: the JAX function's eq, e2 and m4. Masks
//   for i >= o (only where the tile starts below the offset) and
//   i + 4 <= n follow.
// - First match in list order without a chain of branches: each thread keeps
//   the flags of its positions not yet resolved; m & unresolved is written
//   to a shared result tile, each position once. A warp leaves the list
//   when none of its lanes has a position left (__any_sync): on zeros after
//   offset 1.
// - The result tile is zeroed and stored with 16-byte vector stores,
//   neighbouring threads on neighbouring vectors.
// Measured on the H100 and kept (PERF.md, the findings on M): the register
// source for near offsets, 32 positions a thread and the staging loads in
// flight each took 1-10% off the payload's time; a per-position walk, 16
// positions a thread and 16 near offsets were slower. Offsets beyond the staged halo
// (the JAX function takes any list) compare against bytes read from device
// memory. A launch allocates nothing and copies nothing to the card, so
// launches from several host threads, each on its own current stream, share
// no state.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 32;                     // positions per thread
constexpr int kTile = 4096;                  // positions per block
constexpr int kThreads = kTile / kRun;
constexpr int kWords = kRun / 4 + 1;         // a run's bytes and 4 more
constexpr int kHaloCap = 4096;               // bytes staged behind a tile
constexpr int kMaxOffsets = 255;             // offsets in one launch
constexpr int kAhead = 64;                   // bytes staged past the tile
constexpr int kPad = 32;                     // zero bytes before position 0
// Shared bytes: the pad, then 16-byte vectors from the aligned address at
// or below the first staged byte (up to 15 bytes early).
constexpr int kStaged = kPad + ((15 + kHaloCap + kTile + kAhead + 15) / 16) * 16;
constexpr unsigned kFull = 0xffffffffu;
// Staging loads a thread issues, at most.
constexpr int kStageLoads = ((kStaged - kPad) / 16 + kThreads - 1) / kThreads;
constexpr uint32_t kFlags = 0x80808080u;     // bit 7 of each byte
constexpr int kNear = 32;                    // offsets compared in registers
// Aligned words holding the bytes from kNear before a run to 4 after it,
// from up to 15 bytes early, and one more word to shift from.
constexpr int kNearWords = ((kNear + 15) / 4 + kWords + 1 + 3) / 4 * 4;
// Aligned words holding a run's bytes and 4 more, from up to 15 bytes
// early.
constexpr int kFarWords = (15 / 4 + kWords + 1 + 3) / 4 * 4;

struct OffsetList {
  int count;
  int halo;  // min(largest offset, kHaloCap)
  int32_t o[kMaxOffsets];
};

// Bit 7 of each byte set where the bytes of a and b are equal (zero bytes
// of a ^ b, exact: no carry crosses a byte).
__device__ __forceinline__ uint32_t eq_flags(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & kFlags;
}

// Flags of the positions of a run whose 4 bytes all match, from the target
// words t and source words s (the run's bytes and 4 more): word k's byte b
// for position 4k + b.
__device__ __forceinline__ void match4(const uint32_t (&t)[kWords],
                                       const uint32_t (&s)[kWords],
                                       uint32_t (&m)[kRun / 4]) {
  uint32_t z[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) z[k] = eq_flags(t[k], s[k]);
  // y: bytes j and j + 1 equal; m: bytes j .. j + 3 equal.
  uint32_t y[kWords];
#pragma unroll
  for (int k = 0; k < kWords - 1; ++k) {
    y[k] = z[k] & __funnelshift_r(z[k], z[k + 1], 8);
  }
  y[kWords - 1] = z[kWords - 1] & (z[kWords - 1] >> 8);
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k) {
    m[k] = y[k] & __funnelshift_r(y[k], y[k + 1], 16);
  }
}

// Flags of the first `count` positions (clamped to [0, kRun]) of a run.
__device__ __forceinline__ void first_flags(long long count,
                                            uint32_t (&f)[kRun / 4]) {
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k) {
    const long long c = count - 4 * k;
    f[k] = c >= 4 ? kFlags : (c <= 0 ? 0u : kFlags & ((1u << (8 * c)) - 1u));
  }
}

template <int W, int N>
__device__ __forceinline__ void pick(const uint32_t (&a)[N], uint32_t sh,
                                     uint32_t (&w)[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    w[k] = __funnelshift_r(a[W + k], a[W + k + 1], sh);
  }
}

// w = kWords words of bytes from byte p of the aligned words a. p is the
// same for every thread of the warp, so the switch does not diverge, and
// register indices stay constant.
template <int N>
__device__ __forceinline__ void bytes_at(const uint32_t (&a)[N], int p,
                                         uint32_t (&w)[kWords]) {
  const uint32_t sh = 8u * static_cast<uint32_t>(p & 3);
  switch (p >> 2) {
#define VBZ_PICK(W)                                    \
  case W:                                              \
    if constexpr (W + kWords + 1 <= N) pick<W>(a, sh, w); \
    break;
    VBZ_PICK(0) VBZ_PICK(1) VBZ_PICK(2) VBZ_PICK(3) VBZ_PICK(4) VBZ_PICK(5)
    VBZ_PICK(6) VBZ_PICK(7) VBZ_PICK(8) VBZ_PICK(9) VBZ_PICK(10)
    VBZ_PICK(11)
#undef VBZ_PICK
    default: break;
  }
}

// N / 4 aligned 16-byte vectors of shared memory from vector v, as words.
template <int N>
__device__ __forceinline__ void load_words(const uint8_t* sbuf, int v,
                                           uint32_t (&a)[N]) {
  const int4* p = reinterpret_cast<const int4*>(sbuf) + v;
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int4 x = p[k];
    a[4 * k] = x.x;
    a[4 * k + 1] = x.y;
    a[4 * k + 2] = x.z;
    a[4 * k + 3] = x.w;
  }
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* buf, long long p,
                                            long long n) {
  return p >= 0 && p < n ? static_cast<uint32_t>(buf[p]) : 0u;
}

__device__ __forceinline__ uint32_t word_at(const uint8_t* buf, long long p,
                                            long long n) {
  return byte_at(buf, p, n) | (byte_at(buf, p + 1, n) << 8) |
         (byte_at(buf, p + 2, n) << 16) | (byte_at(buf, p + 3, n) << 24);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    match_scan(const uint8_t* __restrict__ buf, OutT* __restrict__ out,
               long long n, const __grid_constant__ OffsetList list) {
  __shared__ __align__(16) uint8_t sbuf[kStaged];
  __shared__ __align__(16) OutT res[kTile];
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(OutT));
  constexpr int kVecs = kTile / kPerVec;

  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long base = t0 > list.halo ? t0 - list.halo : 0;
  // Shared byte kPad + j holds position first + j; first + buf is 16-byte
  // aligned.
  const int lead = static_cast<int>(
      (reinterpret_cast<uintptr_t>(buf) + static_cast<uintptr_t>(base)) & 15);
  const long long first = base - lead;
  const int vecs = (lead + static_cast<int>(t0 + kTile + kAhead - base) + 15) / 16;
  if (threadIdx.x < kPad / 16) {
    reinterpret_cast<int4*>(sbuf)[threadIdx.x] = make_int4(0, 0, 0, 0);
  }
  // Every load in flight before the first store.
  int4 x[kStageLoads];
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int v = threadIdx.x + k * kThreads;
    const long long p = first + 16LL * v;
    if (v < vecs && p >= 0 && p + 16 <= n) {
      x[k] = *reinterpret_cast<const int4*>(buf + p);
    }
  }
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int v = threadIdx.x + k * kThreads;
    const long long p = first + 16LL * v;
    if (v < vecs) {
      if (p < 0 || p + 16 > n) {
        x[k] = make_int4(word_at(buf, p, n), word_at(buf, p + 4, n),
                         word_at(buf, p + 8, n), word_at(buf, p + 12, n));
      }
      reinterpret_cast<int4*>(sbuf + kPad)[v] = x[k];
    }
  }
  for (int v = threadIdx.x; v < kVecs; v += kThreads) {
    reinterpret_cast<int4*>(res)[v] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  const long long i0 = t0 + kRun * threadIdx.x;
  const int pt = kPad + static_cast<int>(i0 - first);  // shared byte of i0
  // The bytes from kNear before the run on, as aligned words: the run
  // starts at byte d of a, the source of offset o <= kNear at d - o.
  // pt - kNear >= 0: the pad, or the halo (at least kNear bytes when the
  // tile has one).
  const int d = kNear + (pt & 15);
  uint32_t a[kNearWords];
  load_words(sbuf, (pt - kNear) >> 4, a);
  uint32_t tw[kWords];
  bytes_at(a, d, tw);
  uint32_t unresolved[kRun / 4];
  first_flags(n - 3 - i0, unresolved);  // positions with i + 4 <= n
  // Offsets above this can exceed a position of the tile.
  const int low = t0 < INT_MAX ? static_cast<int>(t0) : INT_MAX;

  for (int q = 0; q < list.count; ++q) {
    uint32_t left = 0;
#pragma unroll
    for (int k = 0; k < kRun / 4; ++k) left |= unresolved[k];
    if (!__any_sync(kFull, left)) break;
    const int o = list.o[q];
    uint32_t sw[kWords];
    if (o <= kNear) {
      bytes_at(a, d - o, sw);
    } else if (o <= list.halo) {
      // Below position 0 only where every position is masked out: stay in
      // the pad at the same phase.
      const int ps = pt - o < 0 ? (pt - o) & 15 : pt - o;
      uint32_t f[kFarWords];
      load_words(sbuf, ps >> 4, f);
      bytes_at(f, ps & 15, sw);
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) sw[k] = word_at(buf, i0 - o + 4 * k, n);
    }
    uint32_t m[kRun / 4];
    match4(tw, sw, m);
    if (o > low) {  // positions below o
      uint32_t below[kRun / 4];
      first_flags(o - i0, below);
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k) m[k] &= ~below[k];
    }
    uint32_t newly = 0;
#pragma unroll
    for (int k = 0; k < kRun / 4; ++k) {
      m[k] &= unresolved[k];
      unresolved[k] &= ~m[k];
      newly |= m[k];
    }
    if (newly) {
      const OutT value = std::is_same<OutT, uint8_t>::value
                             ? static_cast<OutT>(q + 1)
                             : static_cast<OutT>(o);
      OutT* mine = res + kRun * threadIdx.x;
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k) {
        while (m[k]) {
          mine[4 * k + ((__ffs(m[k]) - 1) >> 3)] = value;
          m[k] &= m[k] - 1;
        }
      }
    }
  }
  __syncthreads();

  for (int v = threadIdx.x; v < kVecs; v += kThreads) {
    const long long i = t0 + static_cast<long long>(v) * kPerVec;
    if (i + kPerVec <= n) {
      *reinterpret_cast<int4*>(out + i) = reinterpret_cast<const int4*>(res)[v];
    } else {
      for (int k = 0; k < kPerVec && i + k < n; ++k) out[i + k] = res[v * kPerVec + k];
    }
  }
}

template <typename OutT>
int launch(const void* buf, void* out, long long n, const int32_t* offsets,
           int n_offsets, void* stream) {
  if (n <= 0 || n_offsets < 0 || n_offsets > kMaxOffsets ||
      (n_offsets > 0 && offsets == nullptr) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
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
  match_scan<OutT><<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<OutT*>(out), n, list);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// buf: [n] uint8 at any address; off: [n] int32, 16-byte aligned (written
// whole); offsets: a host array of n_offsets offsets, each >= 1, already cut
// at the first o with o + 4 > n.
int vbz_match_candidates(const void* buf, void* off, long long n,
                         const int32_t* offsets, int n_offsets,
                         void* stream) {
  return launch<int32_t>(buf, off, n, offsets, n_offsets, stream);
}

// As vbz_match_candidates, with index: [n] uint8, the matching offset's
// place in the list plus one (0 for none).
int vbz_match_index(const void* buf, void* index, long long n,
                    const int32_t* offsets, int n_offsets, void* stream) {
  return launch<uint8_t>(buf, index, n, offsets, n_offsets, stream);
}

// The positions each block takes, for tests that place lengths on tile
// edges.
int vbz_match_tile() { return kTile; }

// The bytes behind a tile held in shared memory; larger offsets are read
// from device memory.
int vbz_match_halo() { return kHaloCap; }

}  // extern "C"
