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
// adds per window (≈100+ 32-bit integer instructions), so the operation
// term is several times the memory term at every k.
//
// What the design does about it: one thread per window with native
// 64-bit arithmetic (the TPU kernel emulated u64 as (hi, lo) u32 pairs).
// A block stages its row segment plus the k-1 byte halo, already
// LUT-encoded, in shared memory once, so the k-fold reuse of every byte
// costs shared-memory reads, not device-memory reads. Output stores are
// coalesced 8-byte writes. The kept count is a warp ballot + popcount and
// one integer atomicAdd per warp (deterministic result).
//
// Host interface: plain C, bound with ctypes (no PyTorch headers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;      // windows (threads) per block
constexpr int kMaxK = 128;      // largest k the shared tile holds

struct ByteLut {
  unsigned char v[256];
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// little-endian u64 of bytes s[0 .. n), zero-extended past n (n <= 8)
__device__ __forceinline__ uint64_t load_word(const unsigned char* s, int n) {
  uint64_t w = 0;
  for (int i = n - 1; i >= 0; --i) w = (w << 8) | s[i];
  return w;
}

__device__ __forceinline__ uint64_t murmur64(const unsigned char* s, int k,
                                             uint64_t seed) {
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    uint64_t k1 = load_word(s + 16 * b, 8);
    uint64_t k2 = load_word(s + 16 * b + 8, 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ULL;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ULL;
  }
  const unsigned char* tail = s + 16 * nblocks;
  const int tl = k & 15;
  if (tl > 8) {
    uint64_t k2 = load_word(tail + 8, tl - 8);
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
  }
  if (tl > 0) {
    uint64_t k1 = load_word(tail, tl < 8 ? tl : 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (uint64_t)k;
  h2 ^= (uint64_t)k;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

__global__ void __launch_bounds__(kTile)
masked_sketch_kernel(const unsigned char* __restrict__ seqs,
                     const int32_t* __restrict__ lengths,
                     long long* __restrict__ keys,
                     int32_t* __restrict__ n_kept,
                     int L, int W, int k, int tiles_per_row,
                     uint64_t max_hash, uint64_t seed, ByteLut lut) {
  __shared__ unsigned char s_lut[256];
  __shared__ unsigned char s_seq[kTile + kMaxK];

  const int row = blockIdx.x / tiles_per_row;
  const int w0 = (blockIdx.x - row * tiles_per_row) * kTile;
  const unsigned char* src = seqs + (size_t)row * L;

  s_lut[threadIdx.x] = lut.v[threadIdx.x];
  __syncthreads();
  // stage this tile's bytes plus the k-1 halo, encoded; bytes past the
  // padded row read as 0 (those windows are never kept)
  for (int i = threadIdx.x; i < kTile + k - 1; i += kTile) {
    const int p = w0 + i;
    s_seq[i] = p < L ? s_lut[src[p]] : 0;
  }
  __syncthreads();

  const int j = w0 + threadIdx.x;
  const int n_windows = lengths[row] - (k - 1);
  bool keep = false;
  if (j < W) {
    const uint64_t h = murmur64(s_seq + threadIdx.x, k, seed);
    keep = j < n_windows && h <= max_hash;
    keys[(size_t)row * W + j] = keep ? (long long)h : -1LL;
  }
  // every thread of the block reaches the ballot (no early return)
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if ((threadIdx.x & 31) == 0 && ballot != 0) {
    atomicAdd(n_kept + row, __popc(ballot));
  }
}

}  // namespace

extern "C" {

// seqs (B, L) uint8, lengths (B,) int32, keys (B, W) int64 with
// W = L - k + 1, n_kept (B,) int32 zeroed by the caller; lut_host is a
// 256-byte host table. Returns the cudaError_t of the launch.
int masked_window_keys_launch(const void* seqs, const void* lengths,
                              void* keys, void* n_kept, int B, int L, int k,
                              unsigned long long max_hash,
                              unsigned long long seed,
                              const unsigned char* lut_host, void* stream) {
  const int W = L - k + 1;
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  ByteLut lut;
  for (int i = 0; i < 256; ++i) lut.v[i] = lut_host[i];
  const int tiles = (W + kTile - 1) / kTile;
  const long long blocks = (long long)tiles * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  masked_sketch_kernel<<<(unsigned)blocks, kTile, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)seqs, (const int32_t*)lengths, (long long*)keys,
      (int32_t*)n_kept, L, W, k, tiles, (uint64_t)max_hash, (uint64_t)seed,
      lut);
  return (int)cudaGetLastError();
}

const char* kmerseek_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
