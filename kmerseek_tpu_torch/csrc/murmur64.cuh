// Shared device code of the two sketch kernels (masked_sketch.cu,
// window_hashes.cu): MurmurHash3 x64_128, first 64-bit lane, over one
// k-byte window, and the staging of a block's LUT-encoded bytes in shared
// memory. One copy of the mixing steps and one of the staging, so the two
// kernels cannot drift apart. `ops/cuda_build.py` hashes this header into
// both libraries' names, so an edit here rebuilds both.
//
// The hash is integer-ALU work (about 100 32-bit instructions a window at
// k = 24), so what the header can save is everything around it. Both
// kernels give a thread a run of kRun adjacent windows of a tile that
// `stage_encoded` wrote, and hash it with `hash_thread_run<K>`. Two ways
// to feed the mixing steps their little-endian 64-bit words:
//   * `murmur64(s, k, seed)`: k known only at run time, every word
//     assembled byte by byte from shared memory (k loads and about 3
//     instructions a byte). Both kernels use it for the k they have no
//     compiled version of.
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

constexpr int kMaxK = 128;        // largest k the shared tile holds
constexpr int kRun = 4;           // adjacent windows per thread
constexpr int kMaxThreads = 256;  // largest block; a tile is blockDim.x * kRun windows
// encoded bytes a block stages: its windows, the halo, and what the last
// thread's spare words and the 16-byte staging granule reach beyond them
constexpr int kStageBytes = kMaxThreads * kRun + kMaxK + 48;

// threads of a block for rows of W windows: a 256-residue row is one
// 64-thread block, rows beyond 512 windows take tiles of 1,024
inline int run_threads(int W) {
  return W <= 64 * kRun ? 64 : (W <= 128 * kRun ? 128 : kMaxThreads);
}

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

// the kRun hashes of a thread's run: windows I .. kRun - 1 of w
template <int K, int I, int NW>
__device__ __forceinline__ void hash_run(const uint32_t (&w)[NW], uint64_t seed,
                                         uint64_t (&h)[kRun]) {
  if constexpr (I < kRun) {
    h[I] = murmur64_run<K, I>(w, seed);
    hash_run<K, I + 1>(w, seed, h);
  }
}

// ---- a block's tile of encoded bytes, and a thread's run of it ----------

__device__ __forceinline__ uint32_t encode4(uint32_t x, const unsigned char* s_lut) {
  return (uint32_t)s_lut[x & 0xff] | ((uint32_t)s_lut[(x >> 8) & 0xff] << 8) |
         ((uint32_t)s_lut[(x >> 16) & 0xff] << 16) | ((uint32_t)s_lut[x >> 24] << 24);
}

// Block-wide (blockDim.x >= 64), ends after a __syncthreads(): copy the
// 256-byte device table `lut` (4-byte aligned) into s_lut, then stage row
// bytes [w0, w0 + tile + k + 16) of `src` (a row of L bytes), encoded,
// into s_seq (kStageBytes, 16-byte aligned), 16 at a time: 16-byte global
// loads where `vec_in` says pointer and row pitch are 16-byte aligned,
// the LUT once per byte on the way, 16-byte shared stores. Bytes past the
// padded row stage as lut[0]; only windows j >= W see them, and those are
// never written.
__device__ __forceinline__ void stage_encoded(
    const unsigned char* __restrict__ lut, const unsigned char* __restrict__ src, int L,
    int w0, int tile, int k, int vec_in, unsigned char* s_lut, unsigned char* s_seq) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (tid < 64) {
    reinterpret_cast<uint32_t*>(s_lut)[tid] = reinterpret_cast<const uint32_t*>(lut)[tid];
  }
  __syncthreads();
  const int nvec = (tile + k + 31) / 16;
  for (int v = tid; v < nvec; v += nthreads) {
    const int p = w0 + 16 * v;
    uint4 x;
    if (vec_in && p + 16 <= L) {
      x = *reinterpret_cast<const uint4*>(src + p);
    } else {
      uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (p + i < L) b[i >> 2] |= (uint32_t)src[p + i] << (8 * (i & 3));
      }
      x = make_uint4(b[0], b[1], b[2], b[3]);
    }
    uint4 e = make_uint4(encode4(x.x, s_lut), encode4(x.y, s_lut), encode4(x.z, s_lut),
                         encode4(x.w, s_lut));
    *reinterpret_cast<uint4*>(s_seq + 16 * v) = e;
  }
  __syncthreads();
}

// Hashes of this thread's run, windows [kRun * tid, kRun * tid + kRun) of
// the staged tile. K > 0: k compiled in, the run's bytes read once as
// 32-bit words (lane stride one word: no bank conflicts) and cut with
// funnel shifts; K == 0: k at run time, byte by byte.
template <int K>
__device__ __forceinline__ void hash_thread_run(const unsigned char* s_seq, int k,
                                                uint64_t seed, uint64_t (&h)[kRun]) {
  const int tid = threadIdx.x;
  if constexpr (K > 0) {
    constexpr int NW = kRunWords<K>;
    uint32_t w[NW];
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s_seq) + tid * (kRun / 4);
#pragma unroll
    for (int n = 0; n < NW; ++n) w[n] = s32[n];
    hash_run<K, 0>(w, seed, h);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) h[i] = murmur64(s_seq + tid * kRun + i, k, seed);
  }
}

}  // namespace kmerseek
