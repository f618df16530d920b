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
// 9 bytes written: 8 of hash, 1 of keep).
//
// What the design does about it (the masked kernel's first design; its
// rolling-word redesign is not taken here yet): one thread per window
// with native 64-bit arithmetic through the run-time-k hash of
// murmur64.cuh, the row segment plus its k-1 halo staged encoded in
// shared memory, coalesced 8-byte hash stores and 1-byte keep stores
// straight into a torch.bool tensor.
//
// Host interface: plain C, bound with ctypes (no PyTorch headers).

#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur64.cuh"

namespace {

using namespace kmerseek;

__global__ void __launch_bounds__(kTile)
window_hashes_kernel(const unsigned char* __restrict__ seqs,
                     const int32_t* __restrict__ lengths,
                     long long* __restrict__ hashes,
                     bool* __restrict__ keep,
                     int L, int W, int k, int tiles_per_row,
                     uint64_t max_hash, uint64_t seed, ByteLut lut) {
  __shared__ unsigned char s_lut[256];
  __shared__ unsigned char s_seq[kTile + kMaxK];

  const int row = blockIdx.x / tiles_per_row;
  const int w0 = (blockIdx.x - row * tiles_per_row) * kTile;
  const unsigned char* src = seqs + (size_t)row * L;

  s_lut[threadIdx.x] = lut.v[threadIdx.x];
  __syncthreads();
  stage_encoded_tile(src, L, w0, k, s_lut, s_seq);
  __syncthreads();

  const int j = w0 + threadIdx.x;
  if (j < W) {
    const uint64_t h = murmur64(s_seq + threadIdx.x, k, seed);
    const size_t o = (size_t)row * W + j;
    hashes[o] = (long long)h;
    keep[o] = j < lengths[row] - (k - 1) && h <= max_hash;
  }
}

}  // namespace

extern "C" {

// seqs (B, L) uint8, lengths (B,) int32, hashes (B, W) int64 and keep
// (B, W) bool with W = L - k + 1; lut_host is a 256-byte host table.
// Returns the cudaError_t of the launch.
int window_hashes_launch(const void* seqs, const void* lengths, void* hashes,
                         void* keep, int B, int L, int k,
                         unsigned long long max_hash, unsigned long long seed,
                         const unsigned char* lut_host, void* stream) {
  const int W = L - k + 1;
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  ByteLut lut;
  for (int i = 0; i < 256; ++i) lut.v[i] = lut_host[i];
  const int tiles = (W + kTile - 1) / kTile;
  const long long blocks = (long long)tiles * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  window_hashes_kernel<<<(unsigned)blocks, kTile, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)seqs, (const int32_t*)lengths, (long long*)hashes,
      (bool*)keep, L, W, k, tiles, (uint64_t)max_hash, (uint64_t)seed, lut);
  return (int)cudaGetLastError();
}

const char* kmerseek_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
