// Window-hash kernel for Hopper: encode + murmur3 x64_128 + scaled filter
// over every k-byte window of a padded (B, L) residue batch, emitting
// every window's raw hash and its keep flag.
//
// Replaces the Pallas TPU kernel `_sketch_kernel`
// (kmerseek_tpu/ops/sketch_pallas.py:66, launcher `window_hashes_pallas`).
// For window j < W = L - k + 1 of row b it writes
//   hash[b, j] = murmur3_x64_128(lut[seq[b, j : j + k]], seed).first_lane
//   keep[b, j] = j < len[b] - k + 1  &&  hash[b, j] <= max_hash
// for EVERY j < W, including windows past the row's length (they hash the
// encoded padding bytes, as the plain version does), so kernel and plain
// version agree on the whole (B, W) arrays. No sentinel, no count.
//
// What bounds it on this card: integer ALU, as for masked_sketch.cu (same
// ~100 32-bit integer instructions per window against 1 byte read and
// 9 bytes written: 8 of hash, 1 of keep). So the design is the masked
// kernel's, with two outputs and no window skipped:
//   * Four adjacent windows a thread, rolling words: the run's encoded
//     bytes are read from shared memory once as 32-bit words and each
//     window's 64-bit words cut out with funnel shifts (murmur64.cuh).
//     k compiled in for k = 5, 10, 16 and 24; every other k <= kMaxK runs
//     the run-time version (K = 0) over the same tile.
//   * Tiles of 256 to 1,024 windows a block (64, 128 or 256 threads by the
//     row's window count), staged by `stage_encoded`: 16-byte global loads,
//     the LUT (a cached device table, read by pointer) applied once per
//     byte, 16-byte shared stores.
//   * A thread's four hashes leave as two 16-byte stores where its first
//     hash is 16-byte aligned (`row * W + j0` even), and its four keep
//     flags as one 4-byte store (0/1 bytes in window order: what four bool
//     stores would write) where `row * W + j0` is a multiple of 4; a warp
//     then writes 128 adjacent keep bytes. W is odd for most (L, k), so
//     the scalar stores serve the row's last run and every row whose
//     start does not align.
//   * No count, no atomics, no memset: one launch, capturable in a graph.
//
// Host interface: plain C, bound with ctypes (no PyTorch headers).

#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur64.cuh"

namespace {

using namespace kmerseek;

// K > 0: k compiled in (the argument k equals K); K == 0: run-time k.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
window_hashes_kernel(const unsigned char* __restrict__ seqs,
                     const int32_t* __restrict__ lengths,
                     long long* __restrict__ hashes,
                     unsigned char* __restrict__ keep,
                     const unsigned char* __restrict__ lut,
                     int L, int W, int k_arg, int tiles_per_row,
                     uint64_t max_hash, uint64_t seed, int vec_in, int vec_hash,
                     int vec_keep) {
  __shared__ __align__(16) unsigned char s_lut[256];
  __shared__ __align__(16) unsigned char s_seq[kStageBytes];

  const int k = K > 0 ? K : k_arg;
  const int tile = blockDim.x * kRun;
  const int row = blockIdx.x / tiles_per_row;
  const int w0 = (blockIdx.x - row * tiles_per_row) * tile;

  stage_encoded(lut, seqs + (size_t)row * L, L, w0, tile, k, vec_in, s_lut, s_seq);

  const int j0 = w0 + threadIdx.x * kRun;
  if (j0 >= W) return;
  uint64_t h[kRun];
  hash_thread_run<K>(s_seq, k, seed, h);

  const int n_windows = lengths[row] - (k - 1);
  uint32_t flags = 0;  // byte i = keep of window j0 + i, 0 or 1
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    flags |= (uint32_t)(j0 + i < n_windows && h[i] <= max_hash) << (8 * i);
  }

  const size_t o = (size_t)row * W + j0;
  const bool whole = j0 + kRun <= W;
  if (vec_hash && whole && (o & 1) == 0) {
    ulonglong2* out = reinterpret_cast<ulonglong2*>(hashes + o);
    out[0] = make_ulonglong2(h[0], h[1]);
    out[1] = make_ulonglong2(h[2], h[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (j0 + i < W) hashes[o + i] = (long long)h[i];
    }
  }
  if (vec_keep && whole && (o & 3) == 0) {
    *reinterpret_cast<uint32_t*>(keep + o) = flags;
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (j0 + i < W) keep[o + i] = (unsigned char)(flags >> (8 * i));
    }
  }
}

template <int K>
cudaError_t launch(const void* seqs, const void* lengths, void* hashes, void* keep,
                   const void* lut, int B, int L, int k, uint64_t max_hash, uint64_t seed,
                   cudaStream_t st) {
  const int W = L - k + 1;
  const int nthreads = run_threads(W);
  const int tile = nthreads * kRun;
  const int tiles = (W + tile - 1) / tile;
  const long long blocks = (long long)tiles * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int vec_in = ((uintptr_t)seqs % 16 == 0) && (L % 16 == 0);
  const int vec_hash = (uintptr_t)hashes % 16 == 0;
  const int vec_keep = (uintptr_t)keep % 4 == 0;
  window_hashes_kernel<K><<<(unsigned)blocks, nthreads, 0, st>>>(
      (const unsigned char*)seqs, (const int32_t*)lengths, (long long*)hashes,
      (unsigned char*)keep, (const unsigned char*)lut, L, W, k, tiles, max_hash, seed,
      vec_in, vec_hash, vec_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// seqs (B, L) uint8, lengths (B,) int32, hashes (B, W) int64 and keep
// (B, W) bool (one byte each) with W = L - k + 1; lut is a 256-byte table
// in device memory, 4-byte aligned. Returns the cudaError_t of the launch.
int window_hashes_launch(const void* seqs, const void* lengths, void* hashes,
                         void* keep, int B, int L, int k,
                         unsigned long long max_hash, unsigned long long seed,
                         const void* lut, void* stream) {
  const int W = L - k + 1;
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {  // the compiled k; ops/sketch_cuda.py lists them as COMPILED_KS
    case 5: return (int)launch<5>(seqs, lengths, hashes, keep, lut, B, L, k, max_hash, seed, st);
    case 10: return (int)launch<10>(seqs, lengths, hashes, keep, lut, B, L, k, max_hash, seed, st);
    case 16: return (int)launch<16>(seqs, lengths, hashes, keep, lut, B, L, k, max_hash, seed, st);
    case 24: return (int)launch<24>(seqs, lengths, hashes, keep, lut, B, L, k, max_hash, seed, st);
    default: return (int)launch<0>(seqs, lengths, hashes, keep, lut, B, L, k, max_hash, seed, st);
  }
}

const char* kmerseek_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
