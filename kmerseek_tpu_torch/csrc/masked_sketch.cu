// Fused sketch kernel for Hopper: encode + murmur3 x64_128 + scaled
// filter over every k-byte window of a padded (B, L) residue batch.
//
// Replaces the Pallas TPU kernel `_masked_sketch_kernel`
// (kmerseek_tpu/ops/sketch_pallas.py:98, launcher
// `masked_window_keys_pallas`). For window j of row b it computes
//   h   = murmur3_x64_128(lut[seq[b, j : j + k]], seed).first_lane
//   keep = j < len[b] - k + 1  &&  h <= max_hash
//   key[b, j] = keep ? h : u64::MAX        (int64 bits; -1 when dropped)
// and the per-row kept count n_kept[b].
//
// What bounds it on this card: integer ALU. Each window reads 1 byte and
// writes 8, but murmur costs ~12 64-bit multiplies plus rotates, xors and
// adds per window (about 100 32-bit integer instructions at k = 24), so
// the operation term is several times the memory term at every k. The
// design therefore spends as few instructions as it can on anything that
// is not the hash.
//
// What the design does about it:
//   * Four adjacent windows a thread, rolling words. A thread reads the
//     encoded bytes of its run from shared memory once, as 32-bit words
//     (lane stride one word: no bank conflicts), and cuts each window's
//     64-bit words out of them with funnel shifts (murmur64.cuh): one or
//     two instructions a word instead of eight byte loads and sixteen
//     shifts and ors.
//   * k compiled in for k = 5, 10, 16 and 24 (template parameter, chosen
//     in the launch function), so the block loop and the tail are
//     straight-line code; every other k <= kMaxK runs the run-time
//     version (K = 0) over the same tile, byte by byte.
//   * Tiles of 256 to 1,024 windows a block (64, 128 or 256 threads,
//     chosen from the row's window count, so a 256-residue row is one
//     64-thread block). The block stages its bytes plus the halo with
//     16-byte global loads, applies the LUT once per byte on the way, and
//     stores 16 encoded bytes at a time; the 256-byte LUT comes from a
//     device table the wrapper caches, not from the kernel's parameters.
//   * A thread's four keys leave as two 16-byte stores
//     (st.global.v2.u64); the two stores of a warp cover 1,024 adjacent
//     bytes, eight whole 128-byte lines.
//   * Windows past the row's length are not hashed at all: a thread whose
//     run starts beyond it only writes sentinels.
//   * The kept count is summed in registers, across the warp with
//     `__reduce_add_sync`, across the block in shared memory. A row that
//     is one tile stores it; wider rows add it with one integer atomicAdd
//     per block (deterministic) to a count the launch function zeroes on
//     the same stream, so the wrapper launches no fill kernel.
//
// The hash, the staging and the run's words live in murmur64.cuh, shared
// with window_hashes.cu. Host interface: plain C, bound with ctypes (no
// PyTorch headers).

#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur64.cuh"

namespace {

using namespace kmerseek;

// K > 0: k compiled in (the argument k equals K); K == 0: run-time k.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
masked_sketch_kernel(const unsigned char* __restrict__ seqs,
                     const int32_t* __restrict__ lengths,
                     long long* __restrict__ keys,
                     int32_t* __restrict__ n_kept,
                     const unsigned char* __restrict__ lut,
                     int L, int W, int k_arg, int tiles_per_row,
                     uint64_t max_hash, uint64_t seed, int vec_in, int vec_out) {
  __shared__ __align__(16) unsigned char s_lut[256];
  __shared__ __align__(16) unsigned char s_seq[kStageBytes];
  __shared__ int s_count[kMaxThreads / 32];

  const int k = K > 0 ? K : k_arg;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tile = nthreads * kRun;
  const int row = blockIdx.x / tiles_per_row;
  const int w0 = (blockIdx.x - row * tiles_per_row) * tile;
  const unsigned char* src = seqs + (size_t)row * L;

  stage_encoded(lut, src, L, w0, tile, k, vec_in, s_lut, s_seq);

  const int j0 = w0 + tid * kRun;
  int n_windows = lengths[row] - (k - 1);
  n_windows = n_windows < W ? n_windows : W;
  uint64_t h[kRun];
  int kept = 0;
  if (j0 < n_windows) {
    hash_thread_run<K>(s_seq, k, seed, h);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const bool keep = j0 + i < n_windows && h[i] <= max_hash;
      h[i] = keep ? h[i] : ~0ULL;
      kept += keep;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) h[i] = ~0ULL;
  }

  if (j0 < W) {
    const size_t o = (size_t)row * W + j0;
    if (vec_out && j0 + kRun <= W && (o & 1) == 0) {
      ulonglong2* out = reinterpret_cast<ulonglong2*>(keys + o);
      out[0] = make_ulonglong2(h[0], h[1]);
      out[1] = make_ulonglong2(h[2], h[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (j0 + i < W) keys[o + i] = (long long)h[i];
      }
    }
  }

  // kept count: registers -> warp -> block -> one store or atomicAdd
  const int warp_kept = __reduce_add_sync(0xffffffffu, kept);
  if ((tid & 31) == 0) s_count[tid >> 5] = warp_kept;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int wp = 0; wp < nthreads / 32; ++wp) total += s_count[wp];
    if (tiles_per_row == 1) {
      n_kept[row] = total;
    } else if (total != 0) {
      atomicAdd(n_kept + row, total);
    }
  }
}

template <int K>
cudaError_t launch(const void* seqs, const void* lengths, void* keys, void* n_kept,
                   const void* lut, int B, int L, int k, uint64_t max_hash, uint64_t seed,
                   cudaStream_t st) {
  const int W = L - k + 1;
  const int nthreads = run_threads(W);
  const int tile = nthreads * kRun;
  const int tiles = (W + tile - 1) / tile;
  const long long blocks = (long long)tiles * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (tiles > 1) {  // blocks add their counts: start from zero, on this stream
    cudaError_t e = cudaMemsetAsync(n_kept, 0, sizeof(int32_t) * (size_t)B, st);
    if (e != cudaSuccess) return e;
  }
  const int vec_in = ((uintptr_t)seqs % 16 == 0) && (L % 16 == 0);
  const int vec_out = (uintptr_t)keys % 16 == 0;
  masked_sketch_kernel<K><<<(unsigned)blocks, nthreads, 0, st>>>(
      (const unsigned char*)seqs, (const int32_t*)lengths, (long long*)keys,
      (int32_t*)n_kept, (const unsigned char*)lut, L, W, k, tiles, max_hash, seed, vec_in,
      vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// seqs (B, L) uint8, lengths (B,) int32, keys (B, W) int64 with
// W = L - k + 1, n_kept (B,) int32 (need not be zeroed); lut is a
// 256-byte table in device memory, 4-byte aligned. Returns the
// cudaError_t of the launch.
int masked_window_keys_launch(const void* seqs, const void* lengths,
                              void* keys, void* n_kept, int B, int L, int k,
                              unsigned long long max_hash,
                              unsigned long long seed,
                              const void* lut, void* stream) {
  const int W = L - k + 1;
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {  // the compiled k; ops/sketch_cuda.py lists them as COMPILED_KS
    case 5: return (int)launch<5>(seqs, lengths, keys, n_kept, lut, B, L, k, max_hash, seed, st);
    case 10: return (int)launch<10>(seqs, lengths, keys, n_kept, lut, B, L, k, max_hash, seed, st);
    case 16: return (int)launch<16>(seqs, lengths, keys, n_kept, lut, B, L, k, max_hash, seed, st);
    case 24: return (int)launch<24>(seqs, lengths, keys, n_kept, lut, B, L, k, max_hash, seed, st);
    default: return (int)launch<0>(seqs, lengths, keys, n_kept, lut, B, L, k, max_hash, seed, st);
  }
}

const char* kmerseek_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
