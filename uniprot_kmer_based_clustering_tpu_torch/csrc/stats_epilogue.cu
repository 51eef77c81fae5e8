// Statistics epilogue over a materialized int32 counts block: K1 and K2.
//
// Replaces the Pallas tile walks of uniprot_kmer_based_clustering_tpu/ops/
// stats_pallas.py: K1 `stats_from_counts` (`_stats_kernel`,
// `accumulate_stats_block`), the strip schedule's epilogue, and K2
// `stats_from_counts_traced` (`_stats_kernel_traced`), the block-pair
// scan's. For an [s, j] counts block at global offset (i_off, j_off) both
// compute, per stationary row, the 8 lanes of ops.popcount.ROW_STAT_NAMES
// over the pairs with gi < gj < n, split cross/same by class inequality
// (stats_common.cuh), and per (tile row, tile column) the two
// over-threshold hit counts (cross, same).
//
// Bound: bytes. The counts a row needs are one contiguous run, its valid
// range [max(gi + 1, j_off), min(n, j_off + j)); the kernel must read each
// of them once, plus the classes and the outputs. Strip 0 of the
// 10,619-protein strip sweep needs 15,130,368 counts (60.5 MB, 18 us at
// 3.35 TB/s), a [3584, 3584] off-diagonal block of the 30,000-protein scan
// all 12.8 M of its counts (51.4 MB, 15 us). What the design does about
// that bound:
//   * one owner per row. A warp reduces one stationary row over its whole
//     valid range and merges the 8 lanes once, with redux.sync; the TPU
//     revisits a row's output block once per tile instead. K1 launches
//     once per strip and owns its rows, so it stores them (no zero-fill);
//     K2 merges into the scan's accumulators with integer atomics
//     (atomicAdd for the sums, atomicMax for lanes 3 and 7; from 0, which
//     is merge_row_stats_at after the Pallas clamp of the max lanes at 0):
//     exact and independent of order.
//   * only the valid range is read. A tile that K1's Pallas walk skips
//     (wholly below the diagonal) holds no valid pair, so the kernel needs
//     no tile list; only a row's first and last chunk test validity, the
//     counts between take the class compare alone, branch-free.
//   * bytes in flight: strip 0 gives an SM about 12 rows, one warp each.
//     A lane issues the 16-byte loads of its next four 128-column chunks
//     before it reduces the four it holds (a register double buffer). On
//     the H100 this form reads the strip-0 block close to the rate a plain
//     device copy reaches (PERF.md); deeper groups, a ring refilled chunk
//     by chunk, eight rows a block, and more blocks an SM forced by launch
//     bounds measured no faster, and splitting K2's rows into column parts
//     (one grid column each, merged by the atomics) to even out its
//     rounds of blocks measured slower. So the other candidate, a producer
//     warp with 1-D bulk copies (cp.async.bulk) into a shared ring, was
//     not built: it could win no more than that gap, for a shared-memory
//     round trip per count.
//   * four rows a block, so that strip 6 (1,536 rows) still spreads 384
//     blocks over the 132 SMs. A block stages the column classes of its
//     span in shared memory once (in windows of 11,264 columns: one at
//     strip 0, 43 KB; 14 KB for a scan block), eight 16-byte loads a
//     thread in flight: a plain copy loop waits out each load, and was the
//     largest cost of the first version on the card.
//   * tile hits: where a row's tile column span ends, its warp reduces the
//     two over-threshold counts with redux.sync into shared slots, and one
//     integer atomic per (block, tile, lane) adds them into the caller's
//     block_hits view.
// Tiles or strides that break 16-byte alignment (tile % 128 != 0) take a
// scalar-load path of 32-column chunks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stats_common.cuh"

namespace {

constexpr int kWarps = 4;  // rows of a block: one warp owns one row
constexpr int kAhead = 4;  // chunks a lane loads ahead, twice over
constexpr int kWindow = 11264;  // column classes staged at once (44 KB)

struct Args {
  const int* counts;
  long long ld;
  int s, j;
  const int* classes_row;
  const int* classes_col;
  int tile, i_off, j_off, n, threshold, w_thresh;
  int* row_stats;     // [s, 8]
  unsigned* hits;     // hit (ti, tj, lane) at ti * hits_ld + tj * 2 + lane
  long long hits_ld;
  int win;            // columns staged a window, a multiple of the chunk
};

// One lane's share of a row: cross pairs (c*) and all valid pairs (t*);
// the same-class lanes are t* - c*. Within a window the present and over
// counts share a register (tpo, cpo: present in the low 16 bits, over in
// the high 16; a lane meets at most kWindow / 32 = 352 pairs a window)
// and are folded into tp, to, cp, co at its end.
struct Partial {
  unsigned cw, tw, tpo, cpo, tp, to, cp, co;
  int cm, sm;
};

__device__ __forceinline__ void add_pair(Partial& a, int x, int ccol,
                                         int crow, int threshold,
                                         int w_thresh) {
  const unsigned m = ccol != crow ? ~0u : 0u;  // cross-class pair
  const unsigned u = static_cast<unsigned>(x);
  const unsigned po = (x >= w_thresh ? 1u : 0u) + (x > threshold ? 0x10000u : 0u);
  a.tw += u;
  a.cw += u & m;
  a.tpo += po;
  a.cpo += po & m;
  a.cm = max(a.cm, static_cast<int>(u & m));
  a.sm = max(a.sm, static_cast<int>(u & ~m));
}

// The over counts so far: folded ones plus the window's.
__device__ __forceinline__ unsigned over_total(unsigned folded,
                                               unsigned packed) {
  return folded + (packed >> 16);
}

__device__ __forceinline__ void fold_window(Partial& a) {
  a.tp += a.tpo & 0xffffu;
  a.to += a.tpo >> 16;
  a.cp += a.cpo & 0xffffu;
  a.co += a.cpo >> 16;
  a.tpo = a.cpo = 0u;
}

// Copy n elements of T into shared memory, eight loads a thread issued
// before their stores (a plain copy loop waits out each load in turn: the
// compiler does not move a load above the previous iteration's exit test).
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  constexpr int kBatch = 8;
  for (int q0 = threadIdx.x; q0 < n; q0 += kBatch * blockDim.x) {
    T v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int q = q0 + k * blockDim.x;
      if (q < n) v[k] = __ldg(src + q);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int q = q0 + k * blockDim.x;
      if (q < n) dst[q] = v[k];
    }
  }
}

// The `count` column classes of a window (a multiple of 32) into shared
// memory, in 16-byte pieces where the source allows.
__device__ __forceinline__ void stage_classes(int* dst, const int* src,
                                              int count) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    stage(reinterpret_cast<int4*>(dst), reinterpret_cast<const int4*>(src),
          count / 4);
  } else {
    stage(dst, src, count);
  }
}

// The kVec consecutive ints one lane holds of a 32 * kVec-column chunk.
template <int kVec>
struct Lanes;

template <>
struct Lanes<4> {
  int4 v;
  __device__ __forceinline__ void load(const int* p) {
    v = __ldcs(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ void load_shared(const int* p) {
    v = *reinterpret_cast<const int4*>(p);
  }
  __device__ __forceinline__ int at(int e) const {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

template <>
struct Lanes<1> {
  int v;
  __device__ __forceinline__ void load(const int* p) { v = __ldcs(p); }
  __device__ __forceinline__ void load_shared(const int* p) { v = *p; }
  __device__ __forceinline__ int at(int) const { return v; }
};

// Issue the loads of the kAhead chunks from column c on, those below c1.
template <int kVec>
__device__ __forceinline__ void load_group(Lanes<kVec> (&g)[kAhead],
                                           const int* row, int c, int c1,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int cc = c + k * 32 * kVec;
    if (cc < c1) g[k].load(row + cc + lane * kVec);
  }
}

template <int kVec, bool kAccumulate>
__global__ void __launch_bounds__(kWarps * 32)
stats_epilogue_kernel(const Args a) {
  constexpr int kChunk = 32 * kVec;
  extern __shared__ int smem[];
  int* s_cls = smem;                                         // [win]
  unsigned* s_hits = reinterpret_cast<unsigned*>(smem + a.win);  // [slots, 2]
  const int slots = a.win / a.tile + 2;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kWarps;
  const int r = r0 + warp;
  const int ti = r0 / a.tile;
  // valid local columns: [lo, hi) for this row, [blo, hi) for the block
  const int hi = min(a.n - a.j_off, a.j);
  const int lo = max(a.i_off + r + 1 - a.j_off, 0);
  const int blo = max(a.i_off + r0 + 1 - a.j_off, 0);
  const int span0 = blo < hi ? blo / kChunk * kChunk : 0;
  const int span1 = blo < hi ? (hi + kChunk - 1) / kChunk * kChunk : 0;
  const int first = lo / kChunk * kChunk;
  const int crow = a.classes_row[r];
  const int* row = a.counts + static_cast<long long>(r) * a.ld;

  Partial acc = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0, 0};
  unsigned co_mark = 0u, to_mark = 0u;  // over counts at the tile start

  for (int w0 = span0; w0 < span1; w0 += a.win) {
    const int w1 = min(w0 + a.win, span1);
    // this row's chunks in the window; their first loads go out before
    // the classes are staged
    const int c0 = max(first, w0);
    const int c1 = lo < hi ? w1 : c0;
    int tile_end = (c0 / a.tile + 1) * a.tile;
    Lanes<kVec> next[kAhead];
    load_group<kVec>(next, row, c0, c1, lane);
    __syncthreads();  // the previous window's classes and hits are used
    stage_classes(s_cls, a.classes_col + w0, w1 - w0);
    for (int q = threadIdx.x; q < 2 * slots; q += blockDim.x) s_hits[q] = 0u;
    __syncthreads();

    for (int c = c0; c < c1; c += kAhead * kChunk) {
      Lanes<kVec> cur[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) cur[k] = next[k];
      load_group<kVec>(next, row, c + kAhead * kChunk, c1, lane);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int cc = c + k * kChunk;
        if (cc >= c1) break;
        const int col = cc + lane * kVec;
        Lanes<kVec> cls;
        cls.load_shared(s_cls + (col - w0));
        if (cc < lo || cc + kChunk > hi) {  // the row's first or last chunk
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            if (col + e >= lo && col + e < hi)
              add_pair(acc, cur[k].at(e), cls.at(e), crow, a.threshold,
                       a.w_thresh);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            add_pair(acc, cur[k].at(e), cls.at(e), crow, a.threshold,
                     a.w_thresh);
        }
        if (cc + kChunk == tile_end || cc + kChunk >= hi) {
          // a tile column span of this row ends: its hits to the slot
          const unsigned co = over_total(acc.co, acc.cpo);
          const unsigned to = over_total(acc.to, acc.tpo);
          const unsigned dc = __reduce_add_sync(0xffffffffu, co - co_mark);
          const unsigned dt = __reduce_add_sync(0xffffffffu, to - to_mark);
          co_mark = co;
          to_mark = to;
          if (lane == 0) {
            unsigned* h = s_hits + 2 * (cc / a.tile - w0 / a.tile);
            if (dc) atomicAdd(h, dc);
            if (dt - dc) atomicAdd(h + 1, dt - dc);
          }
          tile_end += a.tile;
        }
      }
    }

    fold_window(acc);
    __syncthreads();
    const long long base = ti * a.hits_ld + (w0 / a.tile) * 2;
    for (int q = threadIdx.x; q < 2 * slots; q += blockDim.x)
      if (s_hits[q]) atomicAdd(a.hits + base + q, s_hits[q]);
  }

  const RowAcc part = {acc.cw, acc.cp, acc.co, acc.cm,
                       acc.tw - acc.cw, acc.tp - acc.cp, acc.to - acc.co,
                       acc.sm};
  const RowAcc total = redux_row(part);
  if (lane == 0) {
    int* out = a.row_stats + static_cast<long long>(r) * 8;
    if (kAccumulate) {
      flush_row(out, total);
    } else {
      store_row(out, total);
    }
  }
}

int launch(Args a, bool accumulate, void* stream) {
  if (a.s <= 0 || a.j <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec4 = a.tile % 128 == 0 && a.ld % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.counts) % 16 == 0;
  const int chunk = vec4 ? 128 : 32;
  const int span = (a.j + chunk - 1) / chunk * chunk;
  a.win = span < kWindow ? span : kWindow;
  const size_t smem = (a.win + 2 * (a.win / a.tile + 2)) * sizeof(int);
  const dim3 grid(a.s / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4 && accumulate) {
    stats_epilogue_kernel<4, true><<<grid, block, smem, s>>>(a);
  } else if (vec4) {
    stats_epilogue_kernel<4, false><<<grid, block, smem, s>>>(a);
  } else if (accumulate) {
    stats_epilogue_kernel<1, true><<<grid, block, smem, s>>>(a);
  } else {
    stats_epilogue_kernel<1, false><<<grid, block, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* counts, long long ld, int s, int j,
               const void* classes_row, const void* classes_col, int tile,
               int i_off, int j_off, int n, int threshold, int w_thresh,
               void* row_stats, void* block_hits, long long hits_ld) {
  Args a;
  a.counts = static_cast<const int*>(counts);
  a.ld = ld;
  a.s = s;
  a.j = j;
  a.classes_row = static_cast<const int*>(classes_row);
  a.classes_col = static_cast<const int*>(classes_col);
  a.tile = tile;
  a.i_off = i_off;
  a.j_off = j_off;
  a.n = n;
  a.threshold = threshold;
  a.w_thresh = w_thresh;
  a.row_stats = static_cast<int*>(row_stats);
  a.hits = static_cast<unsigned*>(block_hits);
  a.hits_ld = hits_ld;
  a.win = 0;
  return a;
}

}  // namespace

// Both entries: counts int32 [s, j] with row stride ld; classes_row int32
// [s]; classes_col int32 [j]; s and j multiples of tile, tile a multiple of
// 32; row_stats int32 [s, 8] contiguous; block_hits an int32 view whose hit
// (ti, tj, lane) for local tile (ti, tj) sits at ti * hits_ld + tj * 2 +
// lane (the sweep's dense [nb, nb, 2] at tile offset (i_off / tile,
// j_off / tile)); the tile hits are ADDED into it. Launch on `stream`,
// never synchronise, and return cudaGetLastError().

// K1 into a strip: every row of row_stats is stored (the launch owns it).
extern "C" int ukc_stats_epilogue_into(
    const void* counts, long long ld, int s, int j, const void* classes_row,
    const void* classes_col, int tile, int i_off, int j_off, int n,
    int threshold, int w_thresh, void* row_stats, void* block_hits,
    long long hits_ld, void* stream) {
  return launch(make_args(counts, ld, s, j, classes_row, classes_col, tile,
                          i_off, j_off, n, threshold, w_thresh, row_stats,
                          block_hits, hits_ld),
                false, stream);
}

// K2 into the scan's accumulators: each row of row_stats is merged (sums
// by atomicAdd, lanes 3 and 7 by atomicMax).
extern "C" int ukc_stats_epilogue_traced_into(
    const void* counts, long long ld, int s, int j, const void* classes_row,
    const void* classes_col, int tile, int i_off, int j_off, int n,
    int threshold, int w_thresh, void* row_stats, void* block_hits,
    long long hits_ld, void* stream) {
  return launch(make_args(counts, ld, s, j, classes_row, classes_col, tile,
                          i_off, j_off, n, threshold, w_thresh, row_stats,
                          block_hits, hits_ld),
                true, stream);
}
