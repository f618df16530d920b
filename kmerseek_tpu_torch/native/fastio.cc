// libkseek: the host runtime of kmerseek_tpu_torch (a copy of the JAX
// package's kmerseek_tpu/native/fastio.cc; the two packages build and load
// their own libraries).
//
// C++ equivalents of the runtime pieces kmerseek implements in Rust:
//   * FASTA parsing from a memory buffer (needletail's streaming parser):
//     multi-line records, '>'-headers, \r\n safe.
//   * Multithreaded CPU sketching (kmerseek's rayon batch path):
//     per-sequence window -> murmur3 x64_128 (seed 42) -> scaled filter ->
//     sort/dedup with abundances. It is the `--engine native` sketcher and
//     a host oracle for the CUDA kernels.
//   * A stable multithreaded argsort of u64 keys (the host posting build).
//   * The body of a search CSV from typed columns: floats in the digits and
//     layout of CPython's repr, integers, and text cells copied as given.
//
// Exposed as a plain C ABI consumed through ctypes.
//
// Built at first use by kmerseek_tpu_torch/native/__init__.py (g++).
#include <algorithm>
#include <atomic>
#include <charconv>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// murmur3 x64_128, first 64-bit lane (seed 42) — sourmash _hash_murmur
// ---------------------------------------------------------------------------

static inline uint64_t rotl64_(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64_(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

uint64_t ks_murmur64(const uint8_t* data, int64_t len, uint32_t seed) {
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = seed, h2 = seed;
  const int64_t nblocks = len / 16;
  for (int64_t i = 0; i < nblocks; i++) {
    uint64_t k1, k2;
    std::memcpy(&k1, data + i * 16, 8);
    std::memcpy(&k2, data + i * 16 + 8, 8);
    k1 *= c1; k1 = rotl64_(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64_(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64_(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64_(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }
  const uint8_t* tail = data + nblocks * 16;
  const int64_t tl = len & 15;
  uint64_t k1 = 0, k2 = 0;
  for (int64_t i = tl - 1; i >= 8; i--) k2 ^= (uint64_t)tail[i] << ((i - 8) * 8);
  if (tl > 8) { k2 *= c2; k2 = rotl64_(k2, 33); k2 *= c1; h2 ^= k2; }
  for (int64_t i = std::min<int64_t>(tl, 8) - 1; i >= 0; i--)
    k1 ^= (uint64_t)tail[i] << (i * 8);
  if (tl > 0) { k1 *= c1; k1 = rotl64_(k1, 31); k1 *= c2; h1 ^= k1; }
  h1 ^= (uint64_t)len; h2 ^= (uint64_t)len;
  h1 += h2; h2 += h1;
  h1 = fmix64_(h1); h2 = fmix64_(h2);
  h1 += h2;
  return h1;
}

// ---------------------------------------------------------------------------
// FASTA parsing from a memory buffer
// ---------------------------------------------------------------------------

struct KsFastaResult {
  std::vector<std::string> names;
  std::vector<std::string> seqs;
  std::string error;
};

void* ks_parse_fasta(const char* data, size_t len) {
  auto* res = new KsFastaResult();
  const char* p = data;
  const char* end = data + len;
  std::string name;
  std::string seq;
  bool in_record = false;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* line_end = nl ? nl : end;
    const char* trimmed_end = line_end;
    while (trimmed_end > p && (trimmed_end[-1] == '\r')) trimmed_end--;
    if (p < trimmed_end) {
      if (*p == '>') {
        if (in_record) {
          res->names.push_back(std::move(name));
          res->seqs.push_back(std::move(seq));
        }
        name.assign(p + 1, trimmed_end);
        seq.clear();
        in_record = true;
      } else {
        if (!in_record) {
          res->error = "sequence data before first header";
          return res;
        }
        seq.append(p, trimmed_end);
      }
    }
    p = nl ? nl + 1 : end;
  }
  if (in_record) {
    res->names.push_back(std::move(name));
    res->seqs.push_back(std::move(seq));
  }
  return res;
}

int64_t ks_result_n_records(void* h) {
  return (int64_t)((KsFastaResult*)h)->names.size();
}
const char* ks_result_error(void* h) {
  auto* r = (KsFastaResult*)h;
  return r->error.empty() ? nullptr : r->error.c_str();
}
const char* ks_result_name(void* h, int64_t i) {
  return ((KsFastaResult*)h)->names[i].c_str();
}
const uint8_t* ks_result_seq(void* h, int64_t i) {
  return (const uint8_t*)((KsFastaResult*)h)->seqs[i].data();
}
int64_t ks_result_seq_len(void* h, int64_t i) {
  return (int64_t)((KsFastaResult*)h)->seqs[i].size();
}
void ks_result_free(void* h) { delete (KsFastaResult*)h; }

// ---------------------------------------------------------------------------
// CPU sketching (baseline + host oracle)
// ---------------------------------------------------------------------------

// Sketch one encoded sequence: sorted unique hashes (<= max_hash) with
// abundances. Returns the number of distinct hashes written.
int64_t ks_sketch_cpu(const char* encoded, int64_t len, int32_t k,
                      uint64_t max_hash, uint64_t* out_hashes,
                      uint32_t* out_abund) {
  if (len < k) return 0;
  const int64_t w = len - k + 1;
  std::vector<uint64_t> kept;
  kept.reserve(w / 4 + 8);
  for (int64_t i = 0; i < w; i++) {
    uint64_t h = ks_murmur64((const uint8_t*)encoded + i, k, 42);
    if (h <= max_hash) kept.push_back(h);
  }
  std::sort(kept.begin(), kept.end());
  int64_t n = 0;
  for (size_t i = 0; i < kept.size(); i++) {
    if (n > 0 && out_hashes[n - 1] == kept[i]) {
      out_abund[n - 1]++;
    } else {
      out_hashes[n] = kept[i];
      out_abund[n] = 1;
      n++;
    }
  }
  return n;
}

// Multithreaded corpus sketch; returns elapsed seconds and (via
// out_total_kmers) the number of k-mer windows hashed. The sketches
// themselves are computed and discarded: this is the rayon-equivalent
// throughput baseline.
double ks_sketch_cpu_batch(const char* encoded_concat, const int64_t* offsets,
                           int64_t n_seqs, int32_t k, uint64_t max_hash,
                           int32_t n_threads, int64_t* out_total_kmers) {
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> total{0};
  auto t0 = std::chrono::steady_clock::now();
  auto worker = [&]() {
    std::vector<uint64_t> hashes;
    std::vector<uint32_t> abund;
    int64_t local = 0;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_seqs) break;
      int64_t lo = offsets[i], hi = offsets[i + 1];
      int64_t len = hi - lo;
      if (len < k) continue;
      hashes.resize(len - k + 1);
      abund.resize(len - k + 1);
      ks_sketch_cpu(encoded_concat + lo, len, k, max_hash, hashes.data(),
                    abund.data());
      local += len - k + 1;
    }
    total += local;
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  auto t1 = std::chrono::steady_clock::now();
  *out_total_kmers = total.load();
  return std::chrono::duration<double>(t1 - t0).count();
}

// ---------------------------------------------------------------------------
// Stable multithreaded LSD radix argsort over u64 keys
// ---------------------------------------------------------------------------
//
// The inverted posting build (ops/inverted.py::build_inverted_np, the
// counterpart of branchwater's do_index revindex sort) needs
// a stable argsort of every posting hash in the corpus — ~50M u64 at
// SwissProt scale, where numpy's single-threaded comparison sort is the
// dominant index-build cost.
//
// Algorithm: one MSD partition on the top 16 bits of the key RANGE
// (murmur hashes are uniform, so buckets come out even), then parallel
// cache-local comparison sorts of each ~N/65536-element bucket. One
// random-scatter pass over the data instead of an LSD radix's four:
// scatter passes are the expensive part on bandwidth-poor hosts.
// Stability: the scatter assigns (bucket, thread, position) offsets in
// original order and the bucket sort compares (key, idx).
//
// Returns 0 on success, -1 if n exceeds the u32 index range.
int32_t ks_argsort_u64(const uint64_t* keys, int64_t n, int64_t* out_order,
                       int32_t n_threads) {
  if (n < 0 || n > (int64_t)0xFFFFFFFF) return -1;
  if (n == 0) return 0;
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > n) n_threads = (int32_t)n;
  const int32_t T = n_threads;
  constexpr int kBucketBits = 16;
  constexpr int64_t kBuckets = 1 << kBucketBits;

  struct Pair {
    uint64_t key;
    uint32_t idx;
    bool operator<(const Pair& o) const {
      return key != o.key ? key < o.key : idx < o.idx;
    }
  };

  // bucket = top kBucketBits of the key range (shift from the max key
  // so scaled-filtered corpora, whose high bits are all zero, still
  // spread across every bucket)
  uint64_t max_key = 0;
  for (int64_t i = 0; i < n; i++) max_key = std::max(max_key, keys[i]);
  // (bounded at 64: a shift by the full width is undefined, and on x86
  // shifts by 0, so a key with its top bit set never ended the loop)
  int range_bits = 0;
  while (range_bits < 64 && (max_key >> range_bits)) range_bits++;
  const int shift = range_bits > kBucketBits ? range_bits - kBucketBits : 0;

  std::vector<int64_t> bounds(T + 1);
  for (int32_t t = 0; t <= T; t++) bounds[t] = n * t / T;
  std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(kBuckets));
  auto run_threads = [&](auto fn) {
    std::vector<std::thread> ths;
    for (int32_t t = 0; t < T; t++) ths.emplace_back(fn, t);
    for (auto& th : ths) th.join();
  };

  run_threads([&](int32_t t) {
    auto& h = hist[t];
    for (int64_t i = bounds[t]; i < bounds[t + 1]; i++)
      h[keys[i] >> shift]++;
  });
  // exclusive scan, bucket-major thread-minor → stable scatter
  std::vector<int64_t> bucket_start(kBuckets + 1);
  int64_t off = 0;
  for (int64_t b = 0; b < kBuckets; b++) {
    bucket_start[b] = off;
    for (int32_t t = 0; t < T; t++) {
      int64_t c = hist[t][b];
      hist[t][b] = off;
      off += c;
    }
  }
  bucket_start[kBuckets] = n;

  std::vector<Pair> part(n);
  run_threads([&](int32_t t) {
    auto& h = hist[t];
    for (int64_t i = bounds[t]; i < bounds[t + 1]; i++)
      part[h[keys[i] >> shift]++] = Pair{keys[i], (uint32_t)i};
  });

  // parallel per-bucket sorts (dynamic work stealing over bucket blocks)
  std::atomic<int64_t> next_bucket{0};
  constexpr int64_t kBlock = 64;
  run_threads([&](int32_t) {
    for (;;) {
      int64_t b0 = next_bucket.fetch_add(kBlock);
      if (b0 >= kBuckets) break;
      int64_t b1 = std::min(b0 + kBlock, kBuckets);
      for (int64_t b = b0; b < b1; b++)
        std::sort(part.data() + bucket_start[b],
                  part.data() + bucket_start[b + 1]);
    }
  });

  run_threads([&](int32_t t) {
    for (int64_t i = bounds[t]; i < bounds[t + 1]; i++)
      out_order[i] = (int64_t)part[i].idx;
  });
  return 0;
}

// ---------------------------------------------------------------------------
// Search CSV body from typed columns
// ---------------------------------------------------------------------------

// Longest cell each numeric kind writes: "-2.2250738585072014e-308" and
// "-9223372036854775808".
static constexpr int64_t kFloatCellMax = 24;
static constexpr int64_t kIntCellMax = 20;

// `v` as CPython's repr(float) writes it: the shortest digits that read
// back to `v` (std::to_chars), in exponent form when the decimal point
// lies 4 or more places left of the first digit or more than 16 right of
// it ("1e-05", "1.5e+16": signed exponent of at least two digits), else
// in fixed form with ".0" on integral values; "-0.0", "inf", "-inf",
// "nan". Returns the end of what it wrote (at most kFloatCellMax bytes).
static char* put_repr_double_(char* p, double v) {
  if (std::isnan(v)) {
    std::memcpy(p, "nan", 3);
    return p + 3;
  }
  if (std::signbit(v)) *p++ = '-';
  if (std::isinf(v)) {
    std::memcpy(p, "inf", 3);
    return p + 3;
  }
  if (v == 0.0) {
    std::memcpy(p, "0.0", 3);
    return p + 3;
  }
  char sci[32];
  const char* end =
      std::to_chars(sci, sci + sizeof sci, std::fabs(v), std::chars_format::scientific).ptr;
  // sci: d[.ddd]e(+|-)dd[d]
  char digits[20];
  int nd = 0;
  const char* q = sci;
  for (; *q != 'e'; ++q)
    if (*q != '.') digits[nd++] = *q;
  int exp10 = 0;
  for (const char* e = q + 2; e < end; ++e) exp10 = exp10 * 10 + (*e - '0');
  if (q[1] == '-') exp10 = -exp10;
  const int decpt = exp10 + 1;  // value = 0.digits * 10^decpt
  if (decpt <= -4 || decpt > 16) {
    *p++ = digits[0];
    if (nd > 1) {
      *p++ = '.';
      std::memcpy(p, digits + 1, nd - 1);
      p += nd - 1;
    }
    *p++ = 'e';
    *p++ = exp10 < 0 ? '-' : '+';
    int a = exp10 < 0 ? -exp10 : exp10;
    if (a >= 100) *p++ = (char)('0' + a / 100);
    *p++ = (char)('0' + a / 10 % 10);
    *p++ = (char)('0' + a % 10);
  } else if (decpt <= 0) {
    *p++ = '0';
    *p++ = '.';
    std::memset(p, '0', -decpt);
    p += -decpt;
    std::memcpy(p, digits, nd);
    p += nd;
  } else if (decpt >= nd) {
    std::memcpy(p, digits, nd);
    p += nd;
    std::memset(p, '0', decpt - nd);
    p += decpt - nd;
    std::memcpy(p, ".0", 2);
    p += 2;
  } else {
    std::memcpy(p, digits, decpt);
    p += decpt;
    *p++ = '.';
    std::memcpy(p, digits + decpt, nd - decpt);
    p += nd - decpt;
  }
  return p;
}

// Column kinds of ks_format_csv.
enum : int32_t { KS_CSV_FLOAT64 = 0, KS_CSV_INT64 = 1, KS_CSV_TEXT = 2 };

// Writes `n_rows` CSV lines into `out`: each row's cells joined by ',' and
// ended by '\n'. Column c is kinds[c]: KS_CSV_FLOAT64 reads
// ((const double*)data[c])[r], KS_CSV_INT64 ((const int64_t*)data[c])[r],
// and KS_CSV_TEXT copies bytes offsets[c][r] to offsets[c][r + 1] of the
// buffer data[c] as they are (quoting is the caller's). Returns the bytes
// written, or -1 when `cap` is below the bound the columns need (nothing
// is written then) or a kind is unknown.
int64_t ks_format_csv(int64_t n_rows, int32_t n_cols, const int32_t* kinds,
                      const void* const* data, const int64_t* const* offsets,
                      char* out, int64_t cap) {
  int64_t need = n_rows * (int64_t)n_cols;  // separators and line ends
  for (int32_t c = 0; c < n_cols; c++) {
    if (kinds[c] == KS_CSV_FLOAT64)
      need += n_rows * kFloatCellMax;
    else if (kinds[c] == KS_CSV_INT64)
      need += n_rows * kIntCellMax;
    else if (kinds[c] == KS_CSV_TEXT)
      need += offsets[c][n_rows] - offsets[c][0];
    else
      return -1;
  }
  if (need > cap) return -1;
  char* p = out;
  for (int64_t r = 0; r < n_rows; r++) {
    for (int32_t c = 0; c < n_cols; c++) {
      if (c) *p++ = ',';
      switch (kinds[c]) {
        case KS_CSV_FLOAT64:
          p = put_repr_double_(p, ((const double*)data[c])[r]);
          break;
        case KS_CSV_INT64:
          p = std::to_chars(p, p + kIntCellMax, ((const int64_t*)data[c])[r]).ptr;
          break;
        default: {
          const int64_t a = offsets[c][r], b = offsets[c][r + 1];
          std::memcpy(p, (const char*)data[c] + a, b - a);
          p += b - a;
        }
      }
    }
    *p++ = '\n';
  }
  return p - out;
}

// Writes the decimal text of each of the `n` values back to back into
// `out` (room for 20 bytes a value) and the end of each value's text into
// `ends[i]`. Returns the bytes written.
int64_t ks_decimal_u64(const uint64_t* values, int64_t n, char* out, int64_t* ends) {
  char* p = out;
  for (int64_t i = 0; i < n; i++) {
    p = std::to_chars(p, p + 20, values[i]).ptr;
    ends[i] = p - out;
  }
  return p - out;
}

}  // extern "C"
