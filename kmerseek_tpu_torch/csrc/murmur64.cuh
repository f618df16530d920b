// Shared device code of the two sketch kernels (masked_sketch.cu,
// window_hashes.cu): MurmurHash3 x64_128, first 64-bit lane, over one
// k-byte window. One copy of the mixing steps, so the two kernels cannot
// drift apart. `ops/cuda_build.py` hashes this header into both
// libraries' names, so an edit here rebuilds both.
//
// The hash is integer-ALU work (about 100 32-bit instructions a window at
// k = 24), so what the header can save is everything around it. Two ways
// to feed the mixing steps their little-endian 64-bit words:
//   * `murmur64(s, k, seed)`: k known only at run time, every word
//     assembled byte by byte from shared memory (k loads and about 3
//     instructions a byte). window_hashes.cu uses it for every k,
//     masked_sketch.cu for the k it has no compiled version of.
//   * `murmur64_run<K, I>(w, seed)`: K known at compile time and the
//     thread's run of kRun adjacent windows held in registers as 32-bit
//     words, loaded once. Window I's 64-bit word at byte offset O is two
//     funnel shifts (`__funnelshift_r`) of the words around it, or the
//     words themselves where O is a multiple of 4; the block loop and the
//     tail are straight-line code.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kmerseek {

constexpr int kTile = 256;      // window_hashes.cu: windows (threads) per block
constexpr int kMaxK = 128;      // largest k the shared tile holds
constexpr int kRun = 4;         // masked_sketch.cu: adjacent windows per thread

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

constexpr uint64_t kC1 = 0x87c37b91114253d5ULL;
constexpr uint64_t kC2 = 0x4cf5ad432745937fULL;

__device__ __forceinline__ uint64_t mix_k1(uint64_t k1) {
  k1 *= kC1; k1 = rotl64(k1, 31); k1 *= kC2;
  return k1;
}

__device__ __forceinline__ uint64_t mix_k2(uint64_t k2) {
  k2 *= kC2; k2 = rotl64(k2, 33); k2 *= kC1;
  return k2;
}

// one 16-byte block: words k1 (bytes 0..7) and k2 (bytes 8..15)
__device__ __forceinline__ void murmur_block(uint64_t& h1, uint64_t& h2,
                                             uint64_t k1, uint64_t k2) {
  h1 ^= mix_k1(k1);
  h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ULL;
  h2 ^= mix_k2(k2);
  h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ULL;
}

// length xor, cross adds, final mixes; returns the first lane
__device__ __forceinline__ uint64_t murmur_finish(uint64_t h1, uint64_t h2, int k) {
  h1 ^= (uint64_t)k;
  h2 ^= (uint64_t)k;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

// ---- run-time k: words assembled byte by byte ---------------------------

// little-endian u64 of bytes s[0 .. n), zero-extended past n (n <= 8)
__device__ __forceinline__ uint64_t load_word(const unsigned char* s, int n) {
  uint64_t w = 0;
  for (int i = n - 1; i >= 0; --i) w = (w << 8) | s[i];
  return w;
}

__device__ __forceinline__ uint64_t murmur64(const unsigned char* s, int k,
                                             uint64_t seed) {
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k / 16;
  for (int b = 0; b < nblocks; ++b) {
    murmur_block(h1, h2, load_word(s + 16 * b, 8), load_word(s + 16 * b + 8, 8));
  }
  const unsigned char* tail = s + 16 * nblocks;
  const int tl = k & 15;
  if (tl > 8) h2 ^= mix_k2(load_word(tail + 8, tl - 8));
  if (tl > 0) h1 ^= mix_k1(load_word(tail, tl < 8 ? tl : 8));
  return murmur_finish(h1, h2, k);
}

// ---- compile-time K: rolling words over a run held in registers ---------

// 32-bit words a thread loads for kRun adjacent windows of K bytes; two
// spare words keep every index of word_at inside the array
template <int K>
constexpr int kRunWords = (kRun + K - 1 + 3) / 4 + 2;

// little-endian u64 of the N (1..8) bytes at byte offset O of the run w
template <int O, int N, int NW>
__device__ __forceinline__ uint64_t word_at(const uint32_t (&w)[NW]) {
  constexpr int q = O / 4, s = (O % 4) * 8;
  static_assert(q + 2 < NW, "run too short for this word");
  const uint32_t lo = s ? __funnelshift_r(w[q], w[q + 1], s) : w[q];
  uint32_t hi = 0;
  if constexpr (N > 4) hi = s ? __funnelshift_r(w[q + 1], w[q + 2], s) : w[q + 1];
  uint64_t v = ((uint64_t)hi << 32) | lo;
  if constexpr (N < 8) v &= (1ULL << (8 * N)) - 1;
  return v;
}

template <int K, int I, int Blk, int NW>
__device__ __forceinline__ void murmur_blocks_run(const uint32_t (&w)[NW],
                                                  uint64_t& h1, uint64_t& h2) {
  if constexpr (Blk < K / 16) {
    murmur_block(h1, h2, word_at<I + 16 * Blk, 8>(w), word_at<I + 16 * Blk + 8, 8>(w));
    murmur_blocks_run<K, I, Blk + 1>(w, h1, h2);
  }
}

// hash of window I (0 .. kRun - 1) of the run: bytes [I, I + K) of w
template <int K, int I, int NW>
__device__ __forceinline__ uint64_t murmur64_run(const uint32_t (&w)[NW], uint64_t seed) {
  uint64_t h1 = seed, h2 = seed;
  murmur_blocks_run<K, I, 0>(w, h1, h2);
  constexpr int tail = I + 16 * (K / 16), tl = K & 15;
  if constexpr (tl > 8) h2 ^= mix_k2(word_at<tail + 8, tl - 8>(w));
  if constexpr (tl > 0) h1 ^= mix_k1(word_at<tail, (tl < 8 ? tl : 8)>(w));
  return murmur_finish(h1, h2, K);
}

// ---- window_hashes.cu's staging -----------------------------------------

// Block-wide: stage row bytes [w0, w0 + kTile + k - 1) of `src` (a row of
// L bytes), LUT-encoded, into s_seq; bytes past the padded row read as 0
// (only windows j >= W would see them, and those are never written).
// s_lut must hold the table already (after a __syncthreads()).
__device__ __forceinline__ void stage_encoded_tile(
    const unsigned char* __restrict__ src, int L, int w0, int k,
    const unsigned char* s_lut, unsigned char* s_seq) {
  for (int i = threadIdx.x; i < kTile + k - 1; i += kTile) {
    const int p = w0 + i;
    s_seq[i] = p < L ? s_lut[src[p]] : 0;
  }
}

}  // namespace kmerseek
