// Bitonic row sort for Hopper: each row of a (B, S) array of u64 keys
// (carried as int64 bits) sorted ascending into a fresh (B, S) output,
// any S.
//
// Replaces the Pallas TPU kernel `_bitonic_kernel`
// (kmerseek_tpu/ops/sort_pallas.py:31, launcher `bitonic_sort_rows`),
// which sorts (hi, lo) u32 pairs with a lane-rotation network held
// whole in VMEM. Keys compare as unsigned long long, so the u64::MAX
// sentinel (-1 as int64) sorts last and keys >= 2^63 order as unsigned.
//
// What bounds it on this card: the function needs 8 bytes read and 8
// written per key and about S log2 S comparisons per row, so its bound is
// the byte term at every S. The bitonic network does more work than
// that, log2 N (log2 N + 1) / 2 compare-exchange steps over the N keys
// of a padded row, so what decides its time is where the keys live
// between steps and how many block-wide barriers separate them.
//
// What the design does about it:
//   * Keys live in registers, 8 a thread. A step whose stride stays
//     inside a thread is a compare-exchange between two registers (6
//     integer instructions a pair); one whose stride stays inside a warp
//     is a `__shfl_xor_sync` (two 32-bit shuffles a key, and 6
//     instructions a key). Neither needs a barrier. The kernel is bound
//     by integer instruction rate, so the layout makes as many steps as
//     it can of the first kind: a thread holds 8 adjacent keys (position
//     = warp * 256 + lane * 8 + register), which turns the strides 1, 2,
//     4 of every stage, and all of the first three stages, into register
//     steps.
//   * Every stage runs ascending: keys in the descending half-blocks of a
//     stage are complemented for its duration (one xor pass between two
//     stages), which takes the direction out of every step.
//   * Global loads and stores are coalesced: a warp (or a block) moves
//     its keys through shared memory once on the way in and once on the
//     way out, lanes on adjacent keys on the global side.
//   * Rows of N <= 256 keys are sorted by (part of) one warp with no
//     block barrier: a warp stages its rows in a 2 KB slice of shared
//     memory of its own (`__syncwarp`), and a 256-thread block carries 8
//     to 256 such rows, so narrow rows still fill the SMs.
//   * Rows of 512 .. 8,192 keys take one block of N / 8 threads and N * 8
//     bytes of dynamic shared memory. The strides above a warp's 256 keys
//     (at most 5 position bits) run after a transpose through shared
//     memory that puts those bits into the register index (and, past
//     three of them, the high lane bits); a second transpose brings the
//     warp layout back. That is four barriers a stage for the stages
//     wider than a warp (8 in all at N = 1,024, plus 4 for staging)
//     instead of one per step. The shared-memory index is the position
//     with bits 4..6 xor-ed into bits 0..2 and bit 11 into bit 3, so that
//     in every layout the 16 lanes of a half-warp hit 16 different 8-byte
//     slots.
//   * Rows of 16,384 .. 131,072 keys take one thread-block cluster of up
//     to 16 blocks (8 is the portable size; an H100 schedules 16 once the
//     kernel opts in), of 2,048 to 8,192 keys a block: as many blocks,
//     and so SMs, as the cluster allows, since such rows come few at a
//     time. A stride that crosses blocks pairs a thread with the same
//     thread of the partner block: each block parks its registers in its
//     own shared memory and reads the partner's copy through distributed
//     shared memory (`map_shared_rank`), between two cluster barriers. So
//     a 65,536-key row is one grid and one trip through device memory.
//   * Wider rows, or a device that cannot schedule the cluster: the tile
//     a cluster holds is sorted as above into a (B, N) scratch, and every
//     wider stage runs its strides >= the tile one grid each over device
//     memory (one thread per compare-exchange), then its strides inside
//     the tile in one more tile grid.
//   * Out of place: the kernel reads the caller's rows (any row stride),
//     pads the tail with the sentinel in registers and writes the first S
//     sorted keys of each row to the output.
//
// Host interface: plain C, bound with ctypes (no PyTorch headers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLogKeys = 3;            // 2^3 keys in each thread's registers
constexpr int kLogWarp = 5;
constexpr int kMaxLogWarps = 5;        // at most 1,024 threads a block
constexpr int kMaxClusterBlocks = 16;  // 8 is portable; 16 needs the opt-in below
constexpr int kMinClusterLogWarps = 3; // a cluster's blocks hold 2,048 keys or more
constexpr int kWarpKernelThreads = 256;
constexpr int kSwizzleShift = kLogKeys + 1;  // index bits 4..6 xor into bits 0..2
constexpr int kSwizzleSrcBit = 2 * kLogKeys + kLogWarp;  // and bit 11 ...
constexpr int kSwizzleDstBit = kLogWarp - 2;             // ... into bit 3
constexpr int kGlobalThreads = 256;

constexpr int kKeys = 1 << kLogKeys;                 // 8
constexpr int kLow = kLogKeys + kLogWarp;            // position bits a warp spans
constexpr int kWarpKeys = 1 << kLow;                 // 256
constexpr int kBlockKeys = kWarpKeys << kMaxLogWarps;  // 8,192

typedef unsigned long long u64;
constexpr u64 kSentinel = ~0ULL;

// ascending compare-exchange of registers r and r | M, for every r
template <int M>
__device__ __forceinline__ void reg_step(u64 (&k)[kKeys]) {
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    if ((r & M) == 0) {
      const u64 a = k[r], b = k[r | M];
      const bool swap = b < a;
      k[r] = swap ? b : a;
      k[r | M] = swap ? a : b;
    }
  }
}

// the lower partner of an ascending compare-exchange keeps the smaller
// key, the upper one the larger (equal keys: either)
__device__ __forceinline__ u64 keep_of(u64 mine, u64 other, bool lower) {
  return ((other < mine) == lower) ? other : mine;
}

// ascending compare-exchange with lane ^ mask
__device__ __forceinline__ void shfl_step(u64 (&k)[kKeys], int mask, int lane) {
  const bool lower = (lane & mask) == 0;
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    k[r] = keep_of(k[r], __shfl_xor_sync(0xffffffffu, k[r], mask), lower);
  }
}

// Strides 2^(LT + 3 - 1) .. 1 of stage `size`, as far as they are below
// `size`: registers hold position bits [0, 3), lanes bits [3, 3 + LT).
// (Recursion over the bit, so that every register index is a constant.)
template <int LT, int Bit = LT + kLogKeys - 1>
__device__ __forceinline__ void low_phase(u64 (&k)[kKeys], int size, int lane) {
  if constexpr (Bit >= 0) {
    if ((1 << Bit) < size) {
      if constexpr (Bit < kLogKeys) {
        reg_step<(1 << Bit)>(k);
      } else {
        shfl_step(k, 1 << (Bit - kLogKeys), lane);
      }
    }
    low_phase<LT, Bit - 1>(k, size, lane);
  }
}

// Layout B of a block of 32 << H threads: the H position bits above a
// warp's span sit in the register index (the first 3) and in the high
// lane bits (the rest).
template <int H>
struct LayoutB {
  static constexpr int kHr = H < kLogKeys ? H : kLogKeys;
  static constexpr int kHl = H - kHr;
  __device__ static __forceinline__ int pos(int warp, int lane, int r) {
    return (lane & ((1 << (kLogWarp - kHl)) - 1)) |
           ((r & ((1 << (kLogKeys - kHr)) - 1)) << (kLogWarp - kHl)) |
           (warp << (kLow - H)) | ((r >> (kLogKeys - kHr)) << kLow) |
           ((lane >> (kLogWarp - kHl)) << (kLow + kHr));
  }
};

// Strides 2^(8 + H - 1) .. 256 of stage `size`, as far as they are below
// `size`, in layout B.
template <int H, int Hb = H - 1>
__device__ __forceinline__ void high_phase(u64 (&k)[kKeys], int size, int lane) {
  constexpr int hr = LayoutB<H>::kHr, hl = LayoutB<H>::kHl;
  if constexpr (Hb >= 0) {
    if ((kWarpKeys << Hb) < size) {
      if constexpr (Hb < hr) {
        reg_step<(1 << (kLogKeys - hr + Hb))>(k);
      } else {
        shfl_step(k, 1 << (kLogWarp - hl + Hb - hr), lane);
      }
    }
    high_phase<H, Hb - 1>(k, size, lane);
  }
}

// layout A: a thread holds 8 adjacent keys, a warp 256
__device__ __forceinline__ int pos_a(int tid, int r) { return (tid << kLogKeys) | r; }

__device__ __forceinline__ int swizzle(int p) {
  return p ^ ((p >> kSwizzleShift) & (kKeys - 1)) ^
         (((p >> kSwizzleSrcBit) & 1) << kSwizzleDstBit);
}

// Between stage `from` and stage `to` (0: none): complement the keys whose
// position has exactly one of the two bits set, so that the descending
// half-blocks of the coming stage run ascending and those of the last one
// get their keys back.
template <typename PosFn>
__device__ __forceinline__ void flip_between(u64 (&k)[kKeys], int from, int to, PosFn pos) {
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int p = pos(r);
    if (((p & from) != 0) != ((p & to) != 0)) k[r] = ~k[r];
  }
}

// Rows of N = 8 << LT <= 256 keys: 2^LT lanes a row, 256 >> LT rows a
// block, position in the row = lane-in-row * 8 + register. A warp stages
// its 256 keys through its own slice of shared memory.
template <int LT>
__global__ void __launch_bounds__(kWarpKernelThreads)
sort_warp_kernel(const u64* __restrict__ src, long long src_stride,
                 u64* __restrict__ dst, int B, int S) {
  __shared__ u64 smem_all[kWarpKernelThreads * kKeys];
  const int tid = threadIdx.x, lane = tid & 31;
  u64* smem = smem_all + (tid >> kLogWarp) * kWarpKeys;  // this warp's slice
  const long long g = (long long)blockIdx.x * kWarpKernelThreads + tid;
  const long long row = g >> LT;
  const int t = lane & ((1 << LT) - 1);     // lane in its row
  const int row_slot = (lane >> LT) << (LT + kLogKeys);  // the row's keys in the slice
  const bool live = row < B;

  // coalesced in: lanes of a row on adjacent keys
  {
    const u64* in = src + (live ? row : 0) * src_stride;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int p = (r << LT) | t;
      smem[swizzle(row_slot + p)] = (live && p < S) ? in[p] : kSentinel;
    }
  }
  __syncwarp();
  u64 k[kKeys];
#pragma unroll
  for (int r = 0; r < kKeys; ++r) k[r] = smem[swizzle(pos_a(lane, r))];

  auto pos = [&](int r) { return pos_a(t, r); };
  int prev = 0;
#pragma unroll 1
  for (int size = 2; size <= (kKeys << LT); size <<= 1) {
    flip_between(k, prev, size, pos);
    low_phase<LT>(k, size, t);
    prev = size;
  }
  flip_between(k, prev, 0, pos);

  __syncwarp();
#pragma unroll
  for (int r = 0; r < kKeys; ++r) smem[swizzle(pos_a(lane, r))] = k[r];
  __syncwarp();
  if (live) {
    u64* out = dst + row * (long long)S;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int p = (r << LT) | t;
      if (p < S) out[p] = smem[swizzle(row_slot + p)];
    }
  }
}

// One block of 32 << H threads holds 256 << H keys of a row; with
// kCluster the blocks of a cluster hold adjacent parts of one tile. Runs
// every stage `size` in [size_lo, size_hi], each with its strides below
// min(size, tile). Reads `src_valid` keys a row at `src` (sentinels
// beyond), writes the positions below `dst_valid` to `dst`. At most 64
// registers a thread, so that 1,024 threads fit an SM at every H.
template <int H, bool kCluster>
__global__ void __launch_bounds__(32 << H, 32 >> H)
sort_tile_kernel(const u64* __restrict__ src, long long src_stride, int src_valid,
                 u64* __restrict__ dst, long long dst_stride, int dst_valid,
                 int tiles_per_row, int size_lo, int size_hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* smem = reinterpret_cast<u64*>(smem_raw);
  constexpr int T = 32 << H;
  constexpr int NB = kKeys * T;

  int cs = 1, rank = 0;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cs = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
  }
  const int tile_keys = NB * cs;
  const int tile_id = blockIdx.x / cs;
  const long long row = tile_id / tiles_per_row;
  const int block_off = (tile_id - (int)row * tiles_per_row) * tile_keys + rank * NB;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // coalesced in: thread tid moves keys tid, tid + T, ... of the block
  {
    const u64* in = src + row * src_stride;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int p = r * T + tid;
      smem[swizzle(p)] = block_off + p < src_valid ? in[block_off + p] : kSentinel;
    }
  }
  __syncthreads();
  u64 k[kKeys];
#pragma unroll
  for (int r = 0; r < kKeys; ++r) k[r] = smem[swizzle(pos_a(tid, r))];
  auto gpos = [&](int r) { return block_off + pos_a(tid, r); };

  int prev = 0;
#pragma unroll 1
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    flip_between(k, prev, size, gpos);
    prev = size;

    if constexpr (kCluster) {
      // strides that cross blocks: the partner block's thread `tid` holds
      // the partner keys in the same registers
      cg::cluster_group cluster = cg::this_cluster();
      bool crossed = false;
      for (int j = (size < tile_keys ? size : tile_keys) >> 1; j >= NB; j >>= 1) {
        cluster.sync();  // earlier readers of this block's shared memory are done
#pragma unroll
        for (int r = 0; r < kKeys; ++r) smem[r * T + tid] = k[r];
        cluster.sync();
        const u64* peer = cluster.map_shared_rank(smem, rank ^ (j / NB));
        const bool lower = ((rank * NB) & j) == 0;
#pragma unroll
        for (int r = 0; r < kKeys; ++r) k[r] = keep_of(k[r], peer[r * T + tid], lower);
        crossed = true;
      }
      if (crossed) cluster.sync();
    }

    if (size > kWarpKeys) {
      // layout A -> B, the strides 256 .. below min(size, NB), B -> A
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kKeys; ++r) smem[swizzle(pos_a(tid, r))] = k[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kKeys; ++r) k[r] = smem[swizzle(LayoutB<H>::pos(warp, lane, r))];
      high_phase<H>(k, size, lane);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kKeys; ++r) smem[swizzle(LayoutB<H>::pos(warp, lane, r))] = k[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kKeys; ++r) k[r] = smem[swizzle(pos_a(tid, r))];
    }

    low_phase<kLogWarp>(k, size, lane);
  }
  flip_between(k, prev, 0, gpos);

  // coalesced out
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kKeys; ++r) smem[swizzle(pos_a(tid, r))] = k[r];
  __syncthreads();
  {
    u64* out = dst + row * dst_stride;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int p = r * T + tid;
      if (block_off + p < dst_valid) out[block_off + p] = smem[swizzle(p)];
    }
  }
  if constexpr (kCluster) {
    // no block leaves while a partner may still read its shared memory
    cg::this_cluster().sync();
  }
}

// pair q of a stage with stride j (a power of two): lower index i
__device__ __forceinline__ long long pair_low(long long q, long long j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// One stride j >= the tile of stage `size`, on the (B, N) scratch in
// device memory: one thread per compare-exchange.
__global__ void __launch_bounds__(kGlobalThreads)
sort_global_kernel(u64* __restrict__ keys, int N, int size, int j, long long n_pairs) {
  const long long g = (long long)blockIdx.x * kGlobalThreads + threadIdx.x;
  if (g >= n_pairs) return;
  const long long half = N / 2;
  const long long row = g / half;
  const long long i = pair_low(g - row * half, j);
  u64* r = keys + row * N;
  const u64 a = r[i], b = r[i + j];
  if (((i & size) == 0) ? a > b : a < b) {
    r[i] = b;
    r[i + j] = a;
  }
}

template <int LT>
cudaError_t launch_warp(const u64* src, long long src_stride, u64* dst, int B, int S,
                        cudaStream_t st) {
  const long long threads = (long long)B << LT;
  const long long blocks = (threads + kWarpKernelThreads - 1) / kWarpKernelThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sort_warp_kernel<LT><<<(unsigned)blocks, kWarpKernelThreads, 0, st>>>(src, src_stride, dst, B, S);
  return cudaGetLastError();
}

template <int H, bool kCluster>
cudaError_t launch_tile(const u64* src, long long src_stride, int src_valid, u64* dst,
                        long long dst_stride, int dst_valid, int B, int N, int cs,
                        int size_lo, int size_hi, cudaStream_t st) {
  constexpr int T = 32 << H;
  constexpr int NB = kKeys * T;
  const size_t smem = (size_t)NB * sizeof(u64);
  auto kernel = sort_tile_kernel<H, kCluster>;
  {  // opt in once per device and instantiation: large shared memory, clusters of 16
    static unsigned long long opted_in = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (!((opted_in >> (dev & 63)) & 1)) {
      if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
      }
      if (kCluster) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
      }
      opted_in |= 1ULL << (dev & 63);
    }
  }
  const int tiles_per_row = N / (NB * cs);
  const long long blocks = (long long)B * tiles_per_row * cs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, src, src_stride, src_valid, dst, dst_stride,
                            dst_valid, tiles_per_row, size_lo, size_hi);
}

// a tile grid whose blocks hold 256 << h keys each (h = 1 .. 5; in
// clusters of cs > 1 blocks: h = 3 .. 5)
cudaError_t launch_tile_h(int h, const u64* src, long long src_stride, int src_valid,
                          u64* dst, long long dst_stride, int dst_valid, int B, int N,
                          int cs, int size_lo, int size_hi, cudaStream_t st) {
#define KMERSEEK_TILE(HH, CLUSTER)                                                      \
  case HH:                                                                              \
    return launch_tile<HH, CLUSTER>(src, src_stride, src_valid, dst, dst_stride,        \
                                    dst_valid, B, N, cs, size_lo, size_hi, st)
  if (cs > 1) {
    switch (h) {
      KMERSEEK_TILE(3, true);
      KMERSEEK_TILE(4, true);
      KMERSEEK_TILE(5, true);
    }
    return cudaErrorInvalidValue;
  }
  switch (h) {
    KMERSEEK_TILE(1, false);
    KMERSEEK_TILE(2, false);
    KMERSEEK_TILE(3, false);
    KMERSEEK_TILE(4, false);
    KMERSEEK_TILE(5, false);
  }
#undef KMERSEEK_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The largest cluster (16, 8, 4, 2 blocks; 1 = none) of the 8,192-key
// tile kernel, the most demanding one, that the current device can
// schedule.
int bitonic_sort_max_cluster_blocks(void) {
  auto kernel = sort_tile_kernel<kMaxLogWarps, true>;
  const size_t smem = (size_t)kBlockKeys * sizeof(u64);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
      cudaSuccess) {
    cudaGetLastError();
  }
  for (int cs = kMaxClusterBlocks; cs > 1; cs >>= 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(32 << kMaxLogWarps);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess && n > 0) return cs;
    cudaGetLastError();
  }
  return 1;
}

// Rows of `src` (B rows of S int64 keys, row stride `src_stride` keys)
// sorted ascending as u64 into `dst` (B, S), contiguous. `scratch` is a
// (B, N) buffer, N = S rounded up to a power of two, needed only when N
// exceeds the 8,192 * cluster_blocks keys a cluster holds (N > 8,192). Returns the
// first non-zero cudaError_t of the launches, or 0.
int bitonic_sort_rows_launch(const void* src_, long long src_stride, void* dst_,
                             void* scratch_, int B, int S, int cluster_blocks,
                             void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  // N <= 2^29: the kernels' `int` stage sizes double once past N
  if (S > (1 << 29)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const u64* src = (const u64*)src_;
  u64* dst = (u64*)dst_;
  u64* scratch = (u64*)scratch_;
  int N = kKeys;
  while (N < S) N <<= 1;

  if (N <= kWarpKeys) {
    switch (N / kKeys) {
      case 1: return (int)launch_warp<0>(src, src_stride, dst, B, S, st);
      case 2: return (int)launch_warp<1>(src, src_stride, dst, B, S, st);
      case 4: return (int)launch_warp<2>(src, src_stride, dst, B, S, st);
      case 8: return (int)launch_warp<3>(src, src_stride, dst, B, S, st);
      case 16: return (int)launch_warp<4>(src, src_stride, dst, B, S, st);
      default: return (int)launch_warp<5>(src, src_stride, dst, B, S, st);
    }
  }
  if (N <= kBlockKeys) {
    int h = 0;
    while ((kWarpKeys << h) < N) ++h;
    return (int)launch_tile_h(h, src, src_stride, S, dst, S, S, B, N, 1, 2, N, st);
  }
  if (cluster_blocks < 1 || cluster_blocks > kMaxClusterBlocks ||
      (cluster_blocks & (cluster_blocks - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  // as many blocks a cluster as allowed, of 2,048 .. 8,192 keys each
  const int min_keys = kWarpKeys << kMinClusterLogWarps;
  const int cs = N / min_keys < cluster_blocks ? N / min_keys : cluster_blocks;
  const int nb = N / cs < kBlockKeys ? N / cs : kBlockKeys;
  int h = 0;
  while ((kWarpKeys << h) < nb) ++h;
  const int tile = nb * cs;
  if (tile == N) {
    return (int)launch_tile_h(h, src, src_stride, S, dst, S, S, B, N, cs, 2, N, st);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  // the tiles sorted (alternating directions) into the scratch, then every
  // wider stage: its strides >= the tile on device memory, the rest on chip
  cudaError_t err = launch_tile_h(h, src, src_stride, S, scratch, N, N, B, N, cs, 2, tile, st);
  if (err != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)B * (N / 2);
  const long long gblocks = (n_pairs + kGlobalThreads - 1) / kGlobalThreads;
  if (gblocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  for (long long size = 2LL * tile; size <= N; size <<= 1) {
    for (long long j = size / 2; j >= tile; j >>= 1) {
      sort_global_kernel<<<(unsigned)gblocks, kGlobalThreads, 0, st>>>(scratch, N, (int)size,
                                                                      (int)j, n_pairs);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const bool last = size == N;
    err = launch_tile_h(h, scratch, N, N, last ? dst : scratch, last ? S : N, last ? S : N, B,
                        N, cs, (int)size, (int)size, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* kmerseek_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
