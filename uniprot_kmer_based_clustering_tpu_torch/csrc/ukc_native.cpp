// Native host-side runtime of the PyTorch/CUDA port: the port's own
// copy of native/ukc_native.cpp, whose index build also emits the
// unique codes' owners.
//
// Four roles (C ABI, built and loaded via ctypes by
// uniprot_kmer_based_clustering_tpu_torch/io/native.py):
//
//   1. FASTA parsing — replaces the reference's seq_io reader-thread
//      pipeline (src/main.rs:62-74) with a single linear scan producing
//      flat id/sequence buffers + offsets, the layout the device arrays
//      want. Semantics match io/fasta.py::parse_fasta_bytes exactly
//      (id = first whitespace token after '>', CRLF tolerated, sequence
//      lines concatenated).
//
//   2. Bitset packing — scatter (protein, rank) incidences into the
//      packed uint32 presence matrix (LSB-first within a word), the
//      native counterpart of kmers/bitset.py::pack_bitsets.
//
//   3. CPU pairwise popcount sweep — the strongest dense CPU
//      formulation of the similarity stage (uint64 AND+popcount over the
//      upper triangle, multithreaded). Serves as an independent oracle
//      for the device engines and as the measured stand-in for the
//      reference's multithreaded CPU baseline (BENCH notes).
//
//   4. k-mer index build — per-protein dedup, global document-frequency
//      counting, and dense-rank compaction (the semantics of
//      src/main.rs:77-199 / kmers/index.py::build_index) as ONE stable
//      LSD radix over the code bits (the input is protein-major, so
//      protein order within a code is free) + inline dedup + a single
//      counting-sort pass by protein. Replaces numpy's comparison sorts
//      on the host index path — the dominant host stage at 100k+
//      proteins (where the ~85 MB/s RAM-write throttle, not the CPU,
//      bounds it on this box).
//
// Build: g++ at first use, into the port's build/ directory under a
// name that hashes this source (io/native.py library_path).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// AND+popcount of two packed rows: an AVX-512 VPOPCNTDQ kernel (8 words
// per instruction, two accumulators for ILP) selected at RUNTIME via
// cpuid — the target attribute keeps the intrinsics legal under any
// -march, and the cpuid gate keeps a library binary copied between
// machines from hitting illegal instructions — with a scalar POPCNT
// fallback.
#if defined(__x86_64__)
#include <immintrin.h>

__attribute__((target("avx512f,avx512vpopcntdq"))) static int64_t
ukc_and_popcnt_row_avx512(const uint64_t* a, const uint64_t* b,
                          int64_t w64) {
  __m512i acc0 = _mm512_setzero_si512();
  __m512i acc1 = _mm512_setzero_si512();
  int64_t w = 0;
  for (; w + 16 <= w64; w += 16) {
    __m512i x0 = _mm512_and_si512(_mm512_loadu_si512(a + w),
                                  _mm512_loadu_si512(b + w));
    __m512i x1 = _mm512_and_si512(_mm512_loadu_si512(a + w + 8),
                                  _mm512_loadu_si512(b + w + 8));
    acc0 = _mm512_add_epi64(acc0, _mm512_popcnt_epi64(x0));
    acc1 = _mm512_add_epi64(acc1, _mm512_popcnt_epi64(x1));
  }
  for (; w + 8 <= w64; w += 8) {
    __m512i x = _mm512_and_si512(_mm512_loadu_si512(a + w),
                                 _mm512_loadu_si512(b + w));
    acc0 = _mm512_add_epi64(acc0, _mm512_popcnt_epi64(x));
  }
  int64_t cnt = _mm512_reduce_add_epi64(_mm512_add_epi64(acc0, acc1));
  for (; w < w64; w++) cnt += __builtin_popcountll(a[w] & b[w]);
  return cnt;
}

static bool ukc_have_vpopcnt() {
  static const bool have =
      __builtin_cpu_supports("avx512f") &&
      __builtin_cpu_supports("avx512vpopcntdq");
  return have;
}
#endif  // __x86_64__

static int64_t ukc_and_popcnt_row_scalar(const uint64_t* a,
                                         const uint64_t* b, int64_t w64) {
  int64_t cnt = 0;
  for (int64_t w = 0; w < w64; w++)
    cnt += __builtin_popcountll(a[w] & b[w]);
  return cnt;
}

static inline int64_t ukc_and_popcnt_row(const uint64_t* a,
                                         const uint64_t* b, int64_t w64) {
#if defined(__x86_64__)
  if (ukc_have_vpopcnt()) return ukc_and_popcnt_row_avx512(a, b, w64);
#endif
  return ukc_and_popcnt_row_scalar(a, b, w64);
}

// ASCII whitespace per Python bytes.split(None) — the numpy parser's
// header-token delimiter set ('\n' never appears inside a line)
static inline bool ukc_ws(uint8_t b) {
  return b == ' ' || b == '\t' || b == '\r' || b == '\v' || b == '\f';
}

extern "C" {

// Bumped on ANY signature change of an exported function. The ctypes
// loader (io/native.py _bind) refuses a library whose version differs —
// an old .so kept by the "stale-but-working" fallback would otherwise
// be called through a mismatched signature (argument shift = memory
// corruption, not an error).
int64_t ukc_abi_version() { return 4; }

// ---------------------------------------------------------------------
// FASTA
// ---------------------------------------------------------------------

// Pass 1: count records and byte totals so the caller can allocate.
// Returns 0 on success, negative on malformed input.
int ukc_fasta_stats(const uint8_t* data, int64_t len, int64_t* n_records,
                    int64_t* id_bytes, int64_t* seq_bytes) {
  int64_t n = 0, idb = 0, seqb = 0;
  int64_t i = 0;
  bool seen_header = false;
  while (i < len) {
    int64_t j = i;
    while (j < len && data[j] != '\n') j++;
    int64_t e = j;
    while (e > i && data[e - 1] == '\r') e--;
    if (e > i) {
      if (data[i] == '>') {
        n++;
        seen_header = true;
        // id = first whitespace-delimited token after '>' (leading
        // whitespace skipped), matching io/fasta.py parse_fasta_bytes
        int64_t k = i + 1;
        while (k < e && ukc_ws(data[k])) k++;
        int64_t start = k;
        while (k < e && !ukc_ws(data[k])) k++;
        if (k == start) return -2;  // header with no id
        idb += k - start;
      } else {
        if (!seen_header) return -1;  // sequence before first header
        seqb += e - i;
      }
    }
    i = j + 1;
  }
  *n_records = n;
  *id_bytes = idb;
  *seq_bytes = seqb;
  return 0;
}

// Pass 2: fill the flat buffers. Offsets arrays have n_records+1 slots.
int ukc_fasta_parse(const uint8_t* data, int64_t len, uint8_t* id_buf,
                    int64_t* id_off, uint8_t* seq_buf, int64_t* seq_off) {
  int64_t rec = -1, idp = 0, seqp = 0;
  int64_t i = 0;
  id_off[0] = 0;
  seq_off[0] = 0;
  while (i < len) {
    int64_t j = i;
    while (j < len && data[j] != '\n') j++;
    int64_t e = j;
    while (e > i && data[e - 1] == '\r') e--;
    if (e > i) {
      if (data[i] == '>') {
        rec++;
        int64_t k = i + 1;
        while (k < e && ukc_ws(data[k])) k++;
        int64_t start = k;
        while (k < e && !ukc_ws(data[k])) k++;
        std::memcpy(id_buf + idp, data + start, k - start);
        idp += k - start;
        id_off[rec + 1] = idp;
        seq_off[rec + 1] = seqp;
      } else {
        if (rec < 0) return -1;
        std::memcpy(seq_buf + seqp, data + i, e - i);
        seqp += e - i;
        seq_off[rec + 1] = seqp;
      }
    }
    i = j + 1;
  }
  return 0;
}

// ---------------------------------------------------------------------
// Bitset packing
// ---------------------------------------------------------------------

// words is zero-initialized uint32[n_pad * w_pad]; incidences need not be
// sorted. Bit r%32 (LSB-first) of word r/32 marks rank r.
void ukc_pack_bits(const int32_t* prot, const int32_t* rank, int64_t nnz,
                   uint32_t* words, int64_t w_pad) {
  for (int64_t i = 0; i < nnz; i++) {
    int64_t p = prot[i];
    int64_t r = rank[i];
    words[p * w_pad + (r >> 5)] |= (1u << (r & 31));
  }
}

// ---------------------------------------------------------------------
// k-mer encoding
// ---------------------------------------------------------------------

// Base-21 window codes per protein (src/protein.rs:9-54 semantics:
// alphabet "CSTAGPDEQNHRKMILVWYF*", any other byte → 20; code =
// Σ aa_i·21^(k−1−i)). codes_out must hold Σ max(len−k+1, 0) entries;
// kmer_offsets: int64[n+1]. Matches kmers/encode.py::encode_kmers
// (sampling="all") exactly — parity pinned in tests/test_native.py.
int ukc_encode(const uint8_t* seq, const int64_t* offsets, int64_t n,
               int64_t k, int64_t* codes_out, int64_t* kmer_offsets) {
  static const char* kAlphabet = "CSTAGPDEQNHRKMILVWYF*";
  int64_t lut[256];
  for (int i = 0; i < 256; i++) lut[i] = 20;
  for (int i = 0; kAlphabet[i]; i++) lut[(uint8_t)kAlphabet[i]] = i;

  int64_t top = 1;  // 21^(k-1)
  for (int64_t i = 1; i < k; i++) top *= 21;

  int64_t pos = 0;
  kmer_offsets[0] = 0;
  for (int64_t p = 0; p < n; p++) {
    const int64_t s = offsets[p], e = offsets[p + 1];
    const int64_t len = e - s;
    if (len >= k) {
      // rolling window: drop the leading digit, shift, append
      int64_t code = 0;
      for (int64_t i = 0; i < k; i++) code = code * 21 + lut[seq[s + i]];
      codes_out[pos++] = code;
      for (int64_t i = s + k; i < e; i++) {
        code = (code - lut[seq[i - k]] * top) * 21 + lut[seq[i]];
        codes_out[pos++] = code;
      }
    }
    kmer_offsets[p + 1] = pos;
  }
  return 0;
}

// ---------------------------------------------------------------------
// Batched AND+popcount (matrix rows vs one vector)
// ---------------------------------------------------------------------

// out[i] = popcount(mat[i*w64 .. +w64] & vec) for i in [0, m). The tree
// model's similarity-cache hot loop (models/tree.py _pool_sims_vs —
// the revival of src/tree.rs's c-bitarray intersection scans): numpy
// spends three full passes (AND temp, per-word popcount temp, axis
// sum) where this is one fused stream through the matrix. Called tens
// of thousands of times per tree build with mostly cache-resident row
// counts, so it stays single-threaded — spawn cost would rival the
// scan.
void ukc_and_popcnt_rows(const uint64_t* mat, int64_t m, int64_t w64,
                         const uint64_t* vec, int64_t* out) {
  for (int64_t i = 0; i < m; i++)
    out[i] = ukc_and_popcnt_row(mat + i * w64, vec, w64);
}

// ---------------------------------------------------------------------
// CPU pairwise sweep
// ---------------------------------------------------------------------

// row_stats: int64[n * 8] zero-initialized; layout matches
// ops.popcount.ROW_STAT_NAMES. pairs_out: int64[pairs_cap * 3] receives
// (i, j, count) for cross-class pairs with count > threshold (and
// same-class ones when include_same != 0). Returns the number of pairs
// found (may exceed pairs_cap; only the first pairs_cap are written).
int64_t ukc_popcount_sweep(const uint64_t* words, int64_t n, int64_t w64,
                           const int32_t* classes, int32_t threshold,
                           int64_t* row_stats, int64_t* pairs_out,
                           int64_t pairs_cap, int include_same,
                           int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> n_pairs(0);

  // j-blocking: the naive i-outer loop streams the whole [n, w64] matrix
  // from DRAM once per row (3.3 TB on the 10.6k-protein golden set).
  // Workers claim CHUNKS of i-rows and run their own j-block loop, so a
  // ~1 MB block of j-rows stays cache-resident across the chunk's rows
  // (DRAM traffic ≈ n²/(2·jb) row streams) — one thread team for the
  // whole sweep, no create/join per block, no shared-row-stats races
  // (each row belongs to exactly one chunk).
  const int64_t row_bytes = w64 * 8;
  int64_t jb = row_bytes > 0 ? (int64_t)(1 << 20) / row_bytes : n;
  if (jb < 8) jb = 8;
  const int64_t chunk = jb;
  std::atomic<int64_t> next_chunk(0);

  auto worker = [&]() {
    for (;;) {
      const int64_t c0 = next_chunk.fetch_add(1) * chunk;
      if (c0 >= n) break;
      const int64_t c1 = std::min(c0 + chunk, n);
      for (int64_t j_lo = c0; j_lo < n; j_lo += jb) {
        const int64_t j_hi = std::min(j_lo + jb, n);
        for (int64_t i = c0; i < c1; i++) {
          const int64_t j_start = std::max(i + 1, j_lo);
          if (j_start >= j_hi) continue;
          const uint64_t* a = words + i * w64;
          int64_t* rs = row_stats + i * 8;
          for (int64_t j = j_start; j < j_hi; j++) {
            const uint64_t* b = words + j * w64;
            int64_t cnt = ukc_and_popcnt_row(a, b, w64);
            bool cross = classes[i] != classes[j];
            int64_t base = cross ? 0 : 4;
            rs[base + 0] += cnt;
            rs[base + 1] += cnt >= 1;
            rs[base + 2] += cnt > threshold;
            if (cnt > rs[base + 3]) rs[base + 3] = cnt;
            if (cnt > threshold && (cross || include_same)) {
              int64_t slot = n_pairs.fetch_add(1);
              if (slot < pairs_cap) {
                pairs_out[slot * 3 + 0] = i;
                pairs_out[slot * 3 + 1] = j;
                pairs_out[slot * 3 + 2] = cnt;
              }
            }
          }
        }
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return n_pairs.load();
}

// Sparse (Gustavson) pairwise sweep over the (protein, rank) incidence
// lists — the strongest CPU formulation when the bitset is sparse (the
// bundled dataset is 0.13% dense: 3.19M incidences in a 10,619×231,253
// matrix). Work is Σ_k f_k(f_k−1)/2 = the reference's multigraph edge
// count (src/graph/mod.rs:44-48; 258.6M golden) of increments into an
// L1-resident [n] accumulator, instead of the dense sweep's 2.06e11
// word AND+popcounts. Incidences must be sorted by (protein, rank) —
// kmers/index.py's layout — so each rank's expansion list is
// protein-ascending and the upper triangle falls out of list suffixes.
// Semantics (row_stats, pairs, include_same, return value) are
// identical to ukc_popcount_sweep. `weights` (nullable, int8[n_ranks],
// the BLOSUM per-k-mer column weights) switches the accumulated score
// from shared-k-mer counts to weighted sums — the host counterpart of
// the weighted MXU sweep (utils/blosum.py rank weights are ≥ k ≥ 1, so
// the ≥1-shared pair counters keep their unweighted meaning).
// Per-survivor epilogue shared by the row finishers: fold one (i, j,
// cnt) into row i's stats and the pair buffer.
static inline void ukc_emit_hit(int64_t i, int64_t j, int64_t cnt,
                                const int32_t* classes, int32_t threshold,
                                int include_same, int64_t* rs,
                                int64_t* pairs_out, int64_t pairs_cap,
                                std::atomic<int64_t>* n_pairs) {
  bool cross = classes[i] != classes[j];
  int64_t base = cross ? 0 : 4;
  rs[base + 0] += cnt;
  rs[base + 1] += cnt >= 1;
  rs[base + 2] += cnt > threshold;
  if (cnt > rs[base + 3]) rs[base + 3] = cnt;
  if (cnt > threshold && (cross || include_same)) {
    int64_t slot = n_pairs->fetch_add(1);
    if (slot < pairs_cap) {
      pairs_out[slot * 3 + 0] = i;
      pairs_out[slot * 3 + 1] = j;
      pairs_out[slot * 3 + 2] = cnt;
    }
  }
}

// Row finisher: scan acc[lo..nn) for nonzero entries (the row's
// partners), emit stats/pairs, and zero the accumulator behind itself.
// Entries below `lo` are never written (partners are strictly j > i in
// the protein-ascending expansion lists), so block-aligned vector scans
// may safely cover them. The scan replaces the old per-increment
// touched-list tracking: the increment loop stays branch-free and the
// suffix scan is ~3 ms total at bundled scale (16 lanes per compare
// over an L1/L2-resident accumulator).
static void ukc_row_finish_scalar(int32_t* acc, int64_t lo, int64_t nn,
                                  int64_t i, const int32_t* classes,
                                  int32_t threshold, int include_same,
                                  int64_t* rs, int64_t* pairs_out,
                                  int64_t pairs_cap,
                                  std::atomic<int64_t>* n_pairs) {
  for (int64_t j = lo; j < nn; j++) {
    int64_t cnt = acc[j];
    if (!cnt) continue;
    acc[j] = 0;
    ukc_emit_hit(i, j, cnt, classes, threshold, include_same, rs,
                 pairs_out, pairs_cap, n_pairs);
  }
}

#if defined(__x86_64__)
__attribute__((target("avx512f"))) static void ukc_row_finish_avx512(
    int32_t* acc, int64_t lo, int64_t nn, int64_t i,
    const int32_t* classes, int32_t threshold, int include_same,
    int64_t* rs, int64_t* pairs_out, int64_t pairs_cap,
    std::atomic<int64_t>* n_pairs) {
  int64_t b = lo & ~int64_t(15);
  const __m512i zero = _mm512_setzero_si512();
  alignas(64) int32_t buf[16];
  for (; b + 16 <= nn; b += 16) {
    __m512i v = _mm512_loadu_si512((const void*)(acc + b));
    __mmask16 m = _mm512_test_epi32_mask(v, v);
    if (!m) continue;
    _mm512_storeu_si512((void*)(acc + b), zero);
    _mm512_store_si512((void*)buf, v);
    do {
      int l = __builtin_ctz((unsigned)m);
      m = (__mmask16)(m & (m - 1));
      ukc_emit_hit(i, b + l, buf[l], classes, threshold, include_same,
                   rs, pairs_out, pairs_cap, n_pairs);
    } while (m);
  }
  ukc_row_finish_scalar(acc, b > lo ? b : lo, nn, i, classes, threshold,
                        include_same, rs, pairs_out, pairs_cap, n_pairs);
}

static bool ukc_have_avx512f() {
  static const bool ok = __builtin_cpu_supports("avx512f");
  return ok;
}

// Vectorized accumulator increment over one expansion list: 16
// gather+add+scatter lanes per step. Legal WITHOUT conflict detection
// because each rank's expansion list is strictly protein-ascending —
// one vector never holds the same index twice (vectors from different
// lists execute in program order, so cross-list repeats are safe).
__attribute__((target("avx512f"))) static void ukc_scatter_inc_avx512(
    int32_t* acc, const int32_t* idx, int64_t m, int32_t w) {
  const __m512i vw = _mm512_set1_epi32(w);
  int64_t q = 0;
  for (; q + 16 <= m; q += 16) {
    __m512i vi = _mm512_loadu_si512((const void*)(idx + q));
    __m512i g = _mm512_i32gather_epi32(vi, (const void*)acc, 4);
    _mm512_i32scatter_epi32((void*)acc, vi, _mm512_add_epi32(g, vw), 4);
  }
  for (; q < m; q++) acc[idx[q]] += w;
}
#endif

int64_t ukc_sparse_sweep(const int32_t* inc_protein, const int32_t* inc_rank,
                         int64_t nnz, int64_t n, int64_t n_ranks,
                         const int32_t* classes, int32_t threshold,
                         const int8_t* weights,
                         int64_t* row_stats, int64_t* pairs_out,
                         int64_t pairs_cap, int include_same,
                         int n_threads) {
  // rank CSR (protein-ascending within each rank) + every incidence's
  // position inside its rank's list, so row i's partners are suffixes
  std::vector<int64_t> roff(n_ranks + 1, 0);
  for (int64_t t = 0; t < nnz; t++) roff[inc_rank[t] + 1]++;
  for (int64_t r = 0; r < n_ranks; r++) roff[r + 1] += roff[r];
  std::vector<int32_t> rlist(nnz);
  std::vector<int64_t> posof(nnz);
  {
    std::vector<int64_t> fill(roff.begin(), roff.end() - 1);
    for (int64_t t = 0; t < nnz; t++) {
      int64_t p = fill[inc_rank[t]]++;
      rlist[p] = inc_protein[t];
      posof[t] = p;
    }
  }
  std::vector<int64_t> poff(n + 1, 0);
  for (int64_t t = 0; t < nnz; t++) poff[inc_protein[t] + 1]++;
  for (int64_t i = 0; i < n; i++) poff[i + 1] += poff[i];

  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next_row(0);
  std::atomic<int64_t> n_pairs(0);

  auto worker = [&]() {
    std::vector<int32_t> acc(n, 0);
    for (;;) {
      int64_t i = next_row.fetch_add(1);
      if (i >= n) break;
      // hot loop: pure scatter-increment, no branches — partner tracking
      // moved to the vectorized suffix scan in the row finisher
#if defined(__x86_64__)
      if (ukc_have_avx512f()) {
        for (int64_t t = poff[i]; t < poff[i + 1]; t++) {
          int32_t r = inc_rank[t];
          int64_t lo = posof[t] + 1;
          ukc_scatter_inc_avx512(acc.data(), rlist.data() + lo,
                                 roff[r + 1] - lo,
                                 weights ? weights[r] : 1);
        }
      } else
#endif
      if (weights == nullptr) {
        for (int64_t t = poff[i]; t < poff[i + 1]; t++) {
          int32_t r = inc_rank[t];
          for (int64_t q = posof[t] + 1; q < roff[r + 1]; q++)
            acc[rlist[q]]++;
        }
      } else {
        for (int64_t t = poff[i]; t < poff[i + 1]; t++) {
          int32_t r = inc_rank[t];
          int32_t w = weights[r];
          for (int64_t q = posof[t] + 1; q < roff[r + 1]; q++)
            acc[rlist[q]] += w;
        }
      }
      int64_t* rs = row_stats + i * 8;
#if defined(__x86_64__)
      if (ukc_have_avx512f()) {
        ukc_row_finish_avx512(acc.data(), i + 1, n, i, classes, threshold,
                              include_same, rs, pairs_out, pairs_cap,
                              &n_pairs);
        continue;
      }
#endif
      ukc_row_finish_scalar(acc.data(), i + 1, n, i, classes, threshold,
                            include_same, rs, pairs_out, pairs_cap,
                            &n_pairs);
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return n_pairs.load();
}

// ---------------------------------------------------------------------
// k-mer index build
// ---------------------------------------------------------------------

namespace {

// LSD radix sort of uint64 keys (11-bit digits — every pass streams the
// whole key array, so fewer/wider passes win while the 2048-counter
// table still lives in L1; only digits covering max_key run). The k=5
// code universe (22 bits) sorts in 2 passes, (code, protein) pair keys
// in 3-4.
// ``start_bit`` > 0 sorts only the key bits at/above it (stably): when
// the input is already ordered by the low bits' grouping (e.g. built
// protein-major), the low-bit passes are pure wasted bandwidth.
void radix_sort_u64(std::vector<uint64_t>& keys, std::vector<uint64_t>& tmp,
                    uint64_t max_key, int start_bit = 0) {
  const int64_t m = (int64_t)keys.size();
  constexpr int kBits = 11;
  constexpr int kBuckets = 1 << kBits;
  constexpr uint64_t kMask = kBuckets - 1;
  int passes = 0;
  while (start_bit + passes * kBits < 64 &&
         (max_key >> (start_bit + kBits * passes)))
    ++passes;
  if (passes == 0 && start_bit == 0) passes = 1;
  std::vector<int64_t> count(kBuckets);
  for (int p = 0; p < passes; ++p) {
    std::fill(count.begin(), count.end(), 0);
    const int shift = start_bit + kBits * p;
    for (int64_t i = 0; i < m; ++i) ++count[(keys[i] >> shift) & kMask];
    int64_t acc = 0;
    for (int d = 0; d < kBuckets; ++d) {
      int64_t c = count[d];
      count[d] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < m; ++i)
      tmp[count[(keys[i] >> shift) & kMask]++] = keys[i];
    keys.swap(tmp);
  }
}

}  // namespace

// Build the doc-freq index from per-protein k-mer code lists.
//
// In:  codes int64[m_total] (concatenated per protein), offsets
//      int64[n+1], universe = 21^k.
// Out (caller-allocated, worst-case m_total entries each):
//      distinct_codes int64[], doc_freq int64[],
//      inc_protein int32[], inc_rank int32[]  (repeated incidences only,
//      sorted by (protein, rank) — rank order == code order)
//      unique_owner int32[]: the single protein holding each unique
//      (doc_freq == 1) code, in ascending code order — the order of
//      distinct_codes[doc_freq == 1]; n_distinct - n_repeated entries.
// Out-params: n_distinct, n_repeated, nnz (distinct incidences before the
//      unique-code strip), nnz_repeated.
// Returns 0 on success.
int ukc_index_build(const int64_t* codes, const int64_t* offsets, int64_t n,
                    int64_t universe, int64_t* distinct_codes,
                    int64_t* doc_freq, int32_t* inc_protein,
                    int32_t* inc_rank, int32_t* unique_owner,
                    int64_t* n_distinct, int64_t* n_repeated, int64_t* nnz,
                    int64_t* nnz_repeated) {
  const int64_t m_total = offsets[n];
  // Keys pack (code << pb) | protein with SHIFT/MASK (sorts identically
  // to code*n + protein, unpacks without 64-bit division). The input is
  // built protein-major, so ONE stable radix over only the code bits
  // (start_bit = pb; 2 passes at k=5, 3 at k=7) yields the code-major
  // order with proteins ascending within each code — the old pipeline's
  // (p,code) sort + dedup + (code,p) re-sort (8 passes) collapses into
  // it, with (code,protein) duplicates deduped inline in the scan. The
  // final (protein, rank) order needs one stable COUNTING-sort pass by
  // protein (rank emission order is rank-ascending, stability keeps it).
  const auto bits_for = [](uint64_t max_val) {
    int b = 1;
    while (max_val >> b) ++b;
    return b;
  };
  const int cb = bits_for(universe > 0 ? (uint64_t)(universe - 1) : 0);
  const int pb = bits_for(n > 0 ? (uint64_t)(n - 1) : 0);
  if (cb + pb > 64) return -1;  // key would overflow (caller falls back)
  const uint64_t pmask = (pb == 64) ? ~0ull : ((1ull << pb) - 1);
  const uint64_t cmask = (cb == 64) ? ~0ull : ((1ull << cb) - 1);

  std::vector<uint64_t> keys((size_t)m_total);
  for (int64_t p = 0; p < n; ++p)
    for (int64_t i = offsets[p]; i < offsets[p + 1]; ++i)
      keys[(size_t)i] = ((uint64_t)codes[i] << pb) | (uint64_t)p;
  std::vector<uint64_t> tmp((size_t)m_total);
  const uint64_t max_key2 =
      (((uint64_t)(universe ? universe - 1 : 0)) << pb) |
      (uint64_t)(n ? n - 1 : 0);
  radix_sort_u64(keys, tmp, max_key2, /*start_bit=*/pb);

  // linear scan over code runs: per-(code,protein) dedup (the
  // reference's per-protein sort+dedup, src/main.rs:100-102), distinct
  // codes, document frequency, rank assignment, (protein, rank)
  // incidence emission for repeated codes, and the owner of each unique
  // code (a doc-freq-1 run holds one protein's keys, so its first names it).
  const int64_t m = m_total;
  int64_t nd = 0, nr = 0, nu = 0, mr = 0, nnz_all = 0;
  int64_t i = 0;
  while (i < m) {
    const uint64_t code = keys[i] >> pb;
    int64_t j = i;
    uint64_t prev = ~keys[i];  // != keys[i]
    int64_t freq = 0;
    while (j < m && (keys[j] >> pb) == code) {
      freq += keys[j] != prev;
      prev = keys[j];
      ++j;
    }
    nnz_all += freq;
    distinct_codes[nd] = (int64_t)code;
    doc_freq[nd] = freq;
    ++nd;
    if (freq == 1)
      unique_owner[nu++] = (int32_t)(keys[i] & pmask);
    if (freq >= 2) {
      prev = ~keys[i];
      for (int64_t t = i; t < j; ++t) {
        if (keys[t] == prev) continue;  // duplicate (code, protein)
        prev = keys[t];
        tmp[(size_t)mr] = ((keys[t] & pmask) << cb) | (uint64_t)nr;
        ++mr;
      }
      ++nr;
    }
    i = j;
  }
  *n_distinct = nd;
  *n_repeated = nr;
  *nnz = nnz_all;
  *nnz_repeated = mr;

  // stable counting sort by protein: emission order is rank-ascending,
  // so the result is (protein, rank)-sorted in ONE pass
  std::vector<int64_t> pstart((size_t)(n + 1), 0);
  for (int64_t t = 0; t < mr; ++t) ++pstart[(tmp[(size_t)t] >> cb) + 1];
  for (int64_t p = 0; p < n; ++p) pstart[(size_t)p + 1] += pstart[(size_t)p];
  for (int64_t t = 0; t < mr; ++t) {
    const uint64_t prot = tmp[(size_t)t] >> cb;
    const int64_t dst = pstart[(size_t)prot]++;
    inc_protein[dst] = (int32_t)prot;
    inc_rank[dst] = (int32_t)(tmp[(size_t)t] & cmask);
  }
  return 0;
}

}  // extern "C"
