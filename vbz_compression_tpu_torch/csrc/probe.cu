// Capability probe kernels for Hopper, sm_90a: the counterparts of the
// Mosaic capability probes in tools/probe_*.py, one or two small kernels
// each. On the TPU each probe asked whether Mosaic could lower an operation
// the codec wanted; on the card each of these is plain CUDA, and the probe
// checks it against its plain PyTorch version and times it.
//
//   dynroll  (tools/probe_dynroll.py, pallas_call :79): roll_2d (rows or
//            lanes by a runtime amount, np.roll semantics; _kernel_dynlane
//            :22, _kernel_dynsub :27), flat_shift_right (zero fill;
//            _kernel_flatdyn :50), prefix_sum (inclusive, flat, mod 2^32;
//            _kernel_mxu_psum :54)
//   i8dma    (tools/probe_i8dma.py :45, :64): store_bytes (int32 -> int8 at
//            any byte offset; _wr_kernel :17), load_bytes (int8 window ->
//            int32, sign-extended; _rd_kernel :28)
//   keypack  (tools/probe_keypack.py :50, :64): pack_keys, unpack_keys
//            (four consecutive flat 2-bit codes per byte, code j at bits
//            2j; _pack_kernel :15, _unpack_kernel :29) with bit operations
//            where the TPU used a bf16 matmul
//   widen    (tools/probe_widen.py :62): fetch_i32 (k_i32 :32), fetch_i8
//            (int8 widened to int32 with & 0xFF; k_i8 :40, k_i8_2d :49)
//   i16roll  (tools/probe_i16roll.py :76, kernel_factory :51): the flat
//            shift-and-select butterfly, every stage in one launch, at int16
//            and int32 (its own note below)
//
// Bounds: every kernel moves each byte once and does next to no
// arithmetic, so bytes bound it; the butterfly's integer operations are not
// counted (the data sheet gives no int32 rate). Design: grid-stride loops,
// neighbouring threads on neighbouring elements, 16-byte vectors where the
// layout allows; fetch_i32's grid covers its array, four int4s a thread.
// The prefix sum is one launch over tiles of 256 threads x 16 values, one
// tile per block: four int4 loads per
// thread, a serial scan in registers, row_scan.cuh's block scan, four int4
// stores. Up to 8 tiles (the probe's [256, 128]) run as one thread block
// cluster, whose blocks add the sums of the tiles before them from each
// other's shared memory: no state to fill, no ticket. More tiles take
// their tile by ticket and the sum before it by lookback.cuh's decoupled
// look-back over a single row, whose state the caller zeroes.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "row_scan.cuh"

namespace {

using namespace vbz;

constexpr int kProbeThreads = 256;
// The prefix sum's tile: kScanBlock threads of kScanPer values (int4s);
// up to kClusterTiles tiles run as one thread block cluster.
constexpr int kScanBlock = 256;
constexpr int kScanPer = 16;
constexpr int kScanTile = kScanBlock * kScanPer;
constexpr int kClusterTiles = 8;  // the portable cluster size
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100
constexpr long long kMaxCoverBlocks = 1LL << 20;  // copy.cu's kMaxGrid
constexpr int kFetchVecs = 4;  // int4s a thread of fetch_i32 moves per pass

unsigned grid_for(long long n) {
  const long long blocks = (n + kProbeThreads - 1) / kProbeThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1)
                                                   : kMaxBlocks);
}

// A grid that covers n items at one per thread, as CP's does (copy.cu), up
// to kMaxCoverBlocks blocks, striding beyond.
unsigned grid_covering(long long n) {
  const long long blocks = (n + kProbeThreads - 1) / kProbeThreads;
  return static_cast<unsigned>(
      blocks < kMaxCoverBlocks ? (blocks > 0 ? blocks : 1) : kMaxCoverBlocks);
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// out[r, l] = x[(r - a_rows) mod R, (l - a_lanes) mod L]; a_rows in [0, R),
// a_lanes in [0, L).
__global__ void roll_2d(const int* __restrict__ x, int* __restrict__ out,
                        int R, int L, int a_rows, int a_lanes) {
  const long long n = static_cast<long long>(R) * L;
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const int r = static_cast<int>(i / L);
    const int l = static_cast<int>(i % L);
    const int sr = r >= a_rows ? r - a_rows : r - a_rows + R;
    const int sl = l >= a_lanes ? l - a_lanes : l - a_lanes + L;
    out[i] = x[static_cast<long long>(sr) * L + sl];
  }
}

// out[i] = x[i - a] for i >= a, else 0 (flat, row-major).
__global__ void flat_shift_right(const int* __restrict__ x,
                                 int* __restrict__ out, long long n,
                                 long long a) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    out[i] = i >= a ? x[i - a] : 0;
  }
}

// Inclusive prefix sum (mod 2^32) of n int32, one tile of kScanTile values
// per block. With scratch (the ticket, then a status word per tile), tiles
// go in ticket order and carry by look-back; without (n within
// kClusterTiles tiles), the grid is one cluster whose blocks read the sums
// of the tiles before them from each other's shared memory.
__global__ void __launch_bounds__(kScanBlock)
    prefix_sum(const int* __restrict__ x, int* __restrict__ out, long long n,
               StatusWord* scratch) {
  __shared__ uint32_t smem[kScanBlock / 32];
  __shared__ uint32_t tile_sum, tile_carry;
  const int t = scratch ? static_cast<int>(take_ticket(scratch))
                        : static_cast<int>(blockIdx.x);
  const long long i0 =
      static_cast<long long>(t) * kScanTile + kScanPer * threadIdx.x;
  // Whole runs of kScanPer at 16-byte aligned addresses move as int4s
  // (every thread's run starts a multiple of 16 bytes after the last, so the
  // tensors' own alignment decides); the rest one value at a time.
  const bool vec =
      i0 + kScanPer <= n &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  uint32_t v[kScanPer];
  if (vec) {
#pragma unroll
    for (int q = 0; q < kScanPer / 4; ++q) {
      const int4 a = reinterpret_cast<const int4*>(x + i0)[q];
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = i0 + k < n ? static_cast<uint32_t>(x[i0 + k]) : 0u;
    }
  }
#pragma unroll
  for (int k = 1; k < kScanPer; ++k) v[k] += v[k - 1];
  uint32_t agg;
  uint32_t add =
      block_exclusive_scan<kScanBlock>(v[kScanPer - 1], &agg, smem);
  if (scratch) {
    StatusWord* status = scratch + kLookbackHeader;
    if (threadIdx.x == 0) publish_aggregate(status, t, agg);
    if (threadIdx.x < 32) {
      const uint32_t carry = resolve_prefix(status, t, agg);
      if (threadIdx.x == 0) tile_carry = carry;
    }
    __syncthreads();
  } else {
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    if (threadIdx.x == 0) tile_sum = agg;
    cluster.sync();
    if (threadIdx.x < 32) {
      uint32_t c = static_cast<int>(threadIdx.x) < t
                       ? *cluster.map_shared_rank(&tile_sum, threadIdx.x)
                       : 0u;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kWarpMask, c, d);
      if (threadIdx.x == 0) tile_carry = c;
    }
    cluster.sync();  // no block leaves while another reads its tile_sum
  }
  add += tile_carry;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) v[k] += add;
  if (vec) {
#pragma unroll
    for (int q = 0; q < kScanPer / 4; ++q) {
      reinterpret_cast<int4*>(out + i0)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (i0 + k < n) out[i0 + k] = static_cast<int>(v[k]);
    }
  }
}

// buf[off + i] = int8(x[i]): the low byte, at any byte offset.
__global__ void store_bytes(const int* __restrict__ x, int8_t* __restrict__ buf,
                            long long off, long long n) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    buf[off + i] = static_cast<int8_t>(x[i]);
  }
}

// out[i] = int32(buf[off + i]), sign-extended.
__global__ void load_bytes(const int8_t* __restrict__ buf,
                           int* __restrict__ out, long long off, long long n) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    out[i] = static_cast<int>(buf[off + i]);
  }
}

// keys[j] = sum over m < 4 of (codes[4j + m] & 3) << 2m; codes 16-byte
// aligned, so each key is one int4 load.
__global__ void pack_keys(const int4* __restrict__ codes,
                          uint8_t* __restrict__ keys, long long nkeys) {
  for (long long j = first_index(); j < nkeys; j += grid_stride()) {
    const int4 c = codes[j];
    keys[j] = static_cast<uint8_t>((c.x & 3) | ((c.y & 3) << 2) |
                                   ((c.z & 3) << 4) | ((c.w & 3) << 6));
  }
}

// codes[4j + m] = (keys[j] >> 2m) & 3, one int4 store per key.
__global__ void unpack_keys(const uint8_t* __restrict__ keys,
                            int4* __restrict__ codes, long long nkeys) {
  for (long long j = first_index(); j < nkeys; j += grid_stride()) {
    const int k = keys[j];
    codes[j] = make_int4(k & 3, (k >> 2) & 3, (k >> 4) & 3, (k >> 6) & 3);
  }
}

// out = data[:4 * nvec], int4 vectors: kFetchVecs a thread, the block's
// threads side by side in each, all loads issued before the stores. On the
// H100 one int4 a thread, over grid_for's grid or over one that covers the
// array at 256-1024 threads a block, read 2-4% below copy_ at 16 MB; four
// loads in flight a thread read faster than copy_ (PERF.md).
__global__ void fetch_i32(const int4* __restrict__ data, int4* __restrict__ out,
                          long long nvec) {
  const long long step = static_cast<long long>(kFetchVecs) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * step + threadIdx.x;
       v < nvec; v += step * gridDim.x) {
    int4 a[kFetchVecs];
#pragma unroll
    for (int j = 0; j < kFetchVecs; ++j) {
      if (v + j * blockDim.x < nvec) a[j] = data[v + j * blockDim.x];
    }
#pragma unroll
    for (int j = 0; j < kFetchVecs; ++j) {
      if (v + j * blockDim.x < nvec) out[v + j * blockDim.x] = a[j];
    }
  }
}

// out = data[:4 * nwords] & 0xFF: four bytes in, one int4 out, so that
// loads and stores are both coalesced.
__global__ void fetch_i8(const uint32_t* __restrict__ data,
                         int4* __restrict__ out, long long nwords) {
  for (long long v = first_index(); v < nwords; v += grid_stride()) {
    const uint32_t b = data[v];
    out[v] = make_int4(static_cast<int>(b & 0xFFu),
                       static_cast<int>((b >> 8) & 0xFFu),
                       static_cast<int>((b >> 16) & 0xFFu),
                       static_cast<int>(b >> 24));
  }
}

// The butterfly of probe_i16roll.py, all stages in one launch. For j =
// stages-1 .. 0: rolled = the flat array shifted right by 2^j (zero fill);
// take rolled where its bit 1+j is set, else keep the value where its own
// bit 1+j is clear, else 0.
//
// What bounds it: at the probe's size (67,584 values) the latency of one
// launch; its bytes (each value read and written once) take 0.1-0.2 us.
// Before, each stage was a launch of its own, ten a call.
//
// Design: output i depends only on inputs i - k for k in [0, 2^stages - 1],
// and a zero stays zero through every stage, so zeros staged before index 0
// are the zero fill. Each block of 1024 threads stages its tile (a multiple
// of 1024 values, about the halo) and the halo of 2^stages - 1 values behind
// it in shared memory as int32 at both widths (whole words: int16 stores of
// half words were slower), sized per call up to the 227 KB a block may have;
// it runs every stage there and writes its tile. Stage j only updates the
// window's values from halo - (2^j - 1) on, the ones a later stage or the
// tile still reads, so every read lands inside the window. A stage updates
// in place, the highest chunk of kButterflyThreads x kButterflyPer values
// first: each chunk reads into registers, syncs, writes, syncs, and a lower
// chunk reads only values no higher chunk has written. At the probe's ten
// stages a block's window is one chunk. Blocks share nothing. A thread
// block cluster reading its neighbours' halos through distributed shared
// memory was not taken: it holds at most 8 blocks (the portable size), so
// the probe's array would run on 8 SMs instead of 66 and a longer one would
// need a second path, while the halo costs a block at most one more tile of
// loads and updates.
constexpr int kButterflyThreads = 1024;
constexpr int kButterflyPer = 4;  // values a thread holds in registers
constexpr int kButterflyChunk = kButterflyThreads * kButterflyPer;
constexpr int kButterflyStep = 1024;  // the tile is a multiple of it
constexpr int kSharedOptIn = 227 * 1024;  // bytes a block may have

template <typename T>
__global__ void __launch_bounds__(kButterflyThreads)
    butterfly_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                     int stages, int tile) {
  extern __shared__ __align__(16) int butterfly_win[];
  int* win = butterfly_win;  // int16 too: whole words, no sub-word stores
  const int halo = (1 << stages) - 1;
  const int size = tile + halo;
  const long long t0 = static_cast<long long>(blockIdx.x) * tile;
  const long long first = t0 - halo;  // the index win[0] holds
  // A chunk's loads in flight before their stores.
  for (int w0 = 0; w0 < size; w0 += kButterflyChunk) {
    int v[kButterflyPer];
#pragma unroll
    for (int k = 0; k < kButterflyPer; ++k) {
      const long long i = first + w0 + threadIdx.x + k * kButterflyThreads;
      v[k] = i >= 0 && i < n ? static_cast<int>(x[i]) : 0;
    }
#pragma unroll
    for (int k = 0; k < kButterflyPer; ++k) {
      const int w = w0 + threadIdx.x + k * kButterflyThreads;
      if (w < size) win[w] = v[k];
    }
  }
  __syncthreads();
  for (int j = stages - 1; j >= 0; --j) {
    const int s = 1 << j;
    const int lo = halo - (s - 1);
    for (int hi = size; hi > lo; hi -= kButterflyChunk) {
      const int c0 = hi - kButterflyChunk > lo ? hi - kButterflyChunk : lo;
      int v[kButterflyPer];
#pragma unroll
      for (int k = 0; k < kButterflyPer; ++k) {
        const int w = c0 + threadIdx.x + k * kButterflyThreads;
        if (w < hi) {
          const int c = win[w];
          const int rolled = win[w - s];
          v[k] = ((rolled >> (1 + j)) & 1)
                     ? rolled
                     : (((c >> (1 + j)) & 1) == 0 ? c : 0);
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kButterflyPer; ++k) {
        const int w = c0 + threadIdx.x + k * kButterflyThreads;
        if (w < hi) win[w] = v[k];
      }
      __syncthreads();
    }
  }
  for (int w = threadIdx.x; w < tile; w += kButterflyThreads) {
    const long long i = t0 + w;
    if (i < n) out[i] = static_cast<T>(win[halo + w]);
  }
}

// The values one block writes, a multiple of kButterflyStep: about the
// halo (so the halo costs a block at most as much again), within the
// shared memory a block may have, no more than the array needs.
int butterfly_tile(int stages, long long n) {
  const int halo = (1 << stages) - 1;
  const int fit =
      (kSharedOptIn / static_cast<int>(sizeof(int)) - halo) / kButterflyStep;
  int steps = (halo + kButterflyStep) / kButterflyStep;
  if (steps > fit) steps = fit;
  const long long need = (n + kButterflyStep - 1) / kButterflyStep;
  if (steps > need) steps = static_cast<int>(need);
  return (steps > 0 ? steps : 1) * kButterflyStep;
}

template <typename T>
int butterfly(const void* x, void* out, long long n, int stages,
              cudaStream_t s) {
  const int tile = butterfly_tile(stages, n);
  const size_t smem =
      (static_cast<size_t>(tile) + (1 << stages) - 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        butterfly_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  butterfly_kernel<T><<<static_cast<unsigned>(blocks), kButterflyThreads, smem,
                        s>>>(static_cast<const T*>(x), static_cast<T*>(out), n,
                             stages, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define VBZ_STREAM static_cast<cudaStream_t>(stream)
#define VBZ_LAUNCH(kernel, n, ...)                                         \
  kernel<<<grid_for(n), kProbeThreads, 0, VBZ_STREAM>>>(__VA_ARGS__);      \
  return static_cast<int>(cudaGetLastError())

// x, out: [R, L] int32; a_rows in [0, R), a_lanes in [0, L).
int vbz_probe_roll(const int* x, int* out, int R, int L, int a_rows,
                   int a_lanes, void* stream) {
  VBZ_LAUNCH(roll_2d, static_cast<long long>(R) * L, x, out, R, L, a_rows,
             a_lanes);
}

int vbz_probe_flat_shift_right(const int* x, int* out, long long n,
                               long long a, void* stream) {
  VBZ_LAUNCH(flat_shift_right, n, x, out, n, a);
}

// Values the prefix sum takes without look-back state (one cluster of
// tiles), and values per tile: above the first, its scratch is
// 1 + ceil(n / tile) 8-byte words, zeroed before each call; at or below
// it, scratch is null.
int vbz_probe_prefix_sum_cluster_values() { return kClusterTiles * kScanTile; }
int vbz_probe_prefix_sum_tile() { return kScanTile; }

int vbz_probe_prefix_sum(const int* x, int* out, long long n,
                         StatusWord* scratch, void* stream) {
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  if (tiles < 1 || tiles > INT_MAX ||
      (tiles > kClusterTiles) != (scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (scratch) {
    prefix_sum<<<static_cast<unsigned>(tiles), kScanBlock, 0, VBZ_STREAM>>>(
        x, out, n, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(tiles);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles));
  config.blockDim = dim3(kScanBlock);
  config.stream = VBZ_STREAM;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, prefix_sum, x, out, n,
                                             scratch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// buf holds at least off + n bytes.
int vbz_probe_store_bytes(const int* x, int8_t* buf, long long off,
                          long long n, void* stream) {
  VBZ_LAUNCH(store_bytes, n, x, buf, off, n);
}

int vbz_probe_load_bytes(const int8_t* buf, int* out, long long off,
                         long long n, void* stream) {
  VBZ_LAUNCH(load_bytes, n, buf, out, off, n);
}

// codes: 4 * nkeys int32, 16-byte aligned.
int vbz_probe_pack_keys(const int* codes, uint8_t* keys, long long nkeys,
                        void* stream) {
  VBZ_LAUNCH(pack_keys, nkeys, reinterpret_cast<const int4*>(codes), keys,
             nkeys);
}

int vbz_probe_unpack_keys(const uint8_t* keys, int* codes, long long nkeys,
                          void* stream) {
  VBZ_LAUNCH(unpack_keys, nkeys, keys, reinterpret_cast<int4*>(codes), nkeys);
}

// data, out 16-byte aligned; n % 4 == 0.
int vbz_probe_fetch_i32(const void* data, int* out, long long n,
                        void* stream) {
  const long long nvec = n / 4;
  fetch_i32<<<grid_covering((nvec + kFetchVecs - 1) / kFetchVecs),
              kProbeThreads, 0, VBZ_STREAM>>>(
      static_cast<const int4*>(data), reinterpret_cast<int4*>(out), nvec);
  return static_cast<int>(cudaGetLastError());
}

// data, out 16-byte aligned; n % 4 == 0.
int vbz_probe_fetch_i8(const void* data, int* out, long long n,
                       void* stream) {
  VBZ_LAUNCH(fetch_i8, n / 4, static_cast<const uint32_t*>(data),
             reinterpret_cast<int4*>(out), n / 4);
}

// Values one block of the butterfly writes, for tests that place lengths on
// its tile edges.
int vbz_probe_butterfly_tile(int stages, long long n) {
  return butterfly_tile(stages, n);
}

// x, out: n > 0 values of elem_bytes (2: int16, 4: int32); stages in
// [1, 15]. One launch.
int vbz_probe_butterfly(const void* x, void* out, long long n, int stages,
                        int elem_bytes, void* stream) {
  if (stages < 1 || stages > 15 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (elem_bytes == 2) {
    return butterfly<int16_t>(x, out, n, stages, VBZ_STREAM);
  }
  if (elem_bytes == 4) {
    return butterfly<int32_t>(x, out, n, stages, VBZ_STREAM);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef VBZ_LAUNCH
#undef VBZ_STREAM

}  // extern "C"
