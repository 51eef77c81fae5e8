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
//
// Survivor append (K1 only, kAppend 1 or 2; the launch picks it when the
// caller passes pair buffers, ukc_stats_epilogue_append_into, and only
// then): the counts K1 reads once are the counts the pair list is made
// of, so K1 appends each survivor as it reads it, and extraction
// recomputes nothing.
//   * predicate: a valid count x > threshold whose two classes differ
//     (kAppend 1), or every valid count over the threshold (2, the
//     caller's include_same): exactly ops.stats.survivor_mask, and exactly
//     what the tile hits count (the cross lane, or both lanes).
//   * finding them costs a compare a chunk: a survivor is a count that the
//     lane's over count (cross, or cross + same) takes in, so a lane whose
//     over count moved in a chunk marks which of its kVec counts survive,
//     a bit each (rare: 465 cross-class pairs in the 56 M of the
//     10,619-protein sweep), and one __ballot_sync a group of kAhead
//     chunks tells the warp whether any lane marked one.
//   * warp-aggregated cursor: such a group takes each lane's place by one
//     ballot (a scan where a lane holds two) and stages the survivors, as
//     (gj, x), in the warp's kStage-entry stage in shared memory. A full
//     stage, and the row's end, take their slots with one atomicAdd on the
//     int64 cursor by lane 0 and store (gi, gj, x) into the int32 buffers
//     pair_i, pair_j, pair_c; the row's last atomic goes out before the
//     row's reduction, which covers its round trip.
//   * what it costs: every row of a strip runs at once, so a launch lasts
//     as long as its slowest row, here a row of a two-class family with up
//     to 62 survivors in 15 groups; each of those groups adds a short chain
//     of waits to that row's warp. 1.10 times K1's time without the append
//     over a sweep job (PERF.md). Designs that took an atomic a chunk (60
//     round trips on such a row), or re-read the classes and balloted each
//     element slot of such a group, took 1.4 to 1.8 times on the strips
//     that hold those rows; marking survivors on every count cost 12-17%
//     on the strips that hold few.
//   * where a survivor is stored: the mask offsets (i_off, j_off, n) decide
//     only which lanes count. The pair stored for local (r, c) is
//     (pi0 + r, pj0 + c), or (pj0 + c, pi0 + r) when transposed, from the
//     pair origin (pi0, pj0) the caller passes: a strip passes its own
//     offsets; a ring sub-step, launched at fake offsets, passes the real
//     global position of its block pair, transposed where the moving rows
//     lie below the stationary ones, so every pair is stored (min, max).
//   * capacity and exactness: only slots below cap are stored, but the
//     cursor counts every survivor, so an overflow shows exactly. The
//     caller compares the cursor with the sweep's own tile hits, the exact
//     total: equal and within cap, the buffers hold the whole pair list;
//     above cap it extracts the other way (recomputing the hit tiles); any
//     other disagreement raises.
// With kAppend 0 the append code is not compiled in: K1 without buffers
// and K2 run the kernel they ran before it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stats_common.cuh"

namespace {

constexpr int kWarps = 4;  // rows of a block: one warp owns one row
constexpr int kAhead = 4;  // chunks a lane loads ahead, twice over
constexpr int kWindow = 11264;  // column classes staged at once (44 KB)
// kAppend: survivors a warp stages in shared memory, as (gj, count), before
// it takes their slots with one atomicAdd; and the window that leaves room
// for the four warps' stages in the 48 KB of dynamic shared memory a launch
// gets without opting in, at the least tile (32: 2 * 346 hit slots)
constexpr int kStage = 64;
constexpr int kAppendWindow = 11008;

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
  // survivor append (kAppend): buffers [cap] and their slot cursor; the
  // pair origin and orientation of what is stored
  int include_same;
  int pi0, pj0, transposed;
  int* pair_i;
  int* pair_j;
  int* pair_c;
  unsigned long long* cursor;
  long long cap;
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

// kAppend: 1 when count x survives: over the threshold and cross-class
// (kAppend 1) or over it (2), as ops.stats.survivor_mask has it.
template <int kAppend>
__device__ __forceinline__ unsigned survives(int x, int ccol, int crow,
                                             int threshold) {
  return x > threshold && (kAppend == 2 || ccol != crow) ? 1u : 0u;
}

// kAppend: the over count that survivors add to (a lane's, in its high 16
// bits): cross-class (kAppend 1) or every pair (2).
template <int kAppend>
__device__ __forceinline__ unsigned survivor_count(const Partial& a) {
  return kAppend == 1 ? a.cpo : a.tpo;
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

// Store survivor (gi, gj, x) at slot, as (gj, gi, x) when transposed; a
// slot at or past cap is not stored.
__device__ __forceinline__ void store_pair(const Args& a,
                                           unsigned long long slot, int gi,
                                           int gj, int x) {
  if (slot < static_cast<unsigned long long>(a.cap)) {
    a.pair_i[slot] = a.transposed ? gj : gi;
    a.pair_j[slot] = a.transposed ? gi : gj;
    a.pair_c[slot] = x;
  }
}

// Store a warp's staged survivors at the slots from base on, those below
// cap. Every lane of the warp calls.
__device__ __forceinline__ void store_stage(const Args& a, const int* stage,
                                            unsigned staged,
                                            unsigned long long base, int gi,
                                            int lane) {
  for (unsigned q = lane; q < staged; q += 32)
    store_pair(a, base + q, gi, stage[2 * q], stage[2 * q + 1]);
}

// Append a warp's staged survivors: one atomicAdd on the cursor for their
// slots, then their stores. Every lane of the warp calls.
__device__ __forceinline__ void flush_stage(const Args& a, const int* stage,
                                            unsigned& staged, int gi,
                                            int lane) {
  __syncwarp();  // every lane's staged entries are visible
  unsigned long long base = 0ull;
  if (lane == 0)
    base = atomicAdd(a.cursor, static_cast<unsigned long long>(staged));
  store_stage(a, stage, staged, __shfl_sync(0xffffffffu, base, 0), gi, lane);
  __syncwarp();  // the stage is read before it is written again
  staged = 0u;
}

// x[q / kVec].at(q % kVec) for a q known only at run time, by selects (an
// index into the registers would put them in local memory).
template <int kVec>
__device__ __forceinline__ int pick(const Lanes<kVec> (&x)[kAhead], int q) {
  Lanes<kVec> chunk = x[0];
#pragma unroll
  for (int k = 1; k < kAhead; ++k)
    if (q / kVec == k) chunk = x[k];
  return chunk.at(q % kVec);
}

// Stage the survivors of a group of kAhead chunks that holds some: bit
// k * kVec + e of the lane's svm marks its count x[k].at(e), at local column
// c + k * 32 * kVec + lane * kVec + e, stored at column pj0 + that of pair
// row gi. A group with more than a
// stage holds takes its slots at once and stores them straight into the
// buffers. Every lane of the warp calls.
template <int kVec>
__device__ __forceinline__ void stage_survivors(
    const Args& a, const Lanes<kVec> (&x)[kAhead], unsigned svm, int c,
    int* stage, unsigned& staged, int gi, int lane) {
  const unsigned all = 0xffffffffu;
  const unsigned below = (1u << lane) - 1u;
  // this lane's first place among the group's survivors: a ballot where no
  // lane holds two (the usual case), else an exclusive scan
  const unsigned mine = __popc(svm);
  const unsigned any = __ballot_sync(all, mine != 0u);
  unsigned at = __popc(any & below);
  unsigned total = __popc(any);
  if (__ballot_sync(all, mine > 1u)) {
    unsigned upto = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(all, upto, o);
      if (lane >= o) upto += v;
    }
    total = __shfl_sync(all, upto, 31);
    at = upto - mine;
  }
  const int gj = a.pj0 + c + lane * kVec;
  if (staged + total > kStage) flush_stage(a, stage, staged, gi, lane);
  if (total > kStage) {
    unsigned long long base = 0ull;
    if (lane == 0)
      base = atomicAdd(a.cursor, static_cast<unsigned long long>(total));
    base = __shfl_sync(all, base, 0) + at;
    for (unsigned bits = svm; bits; bits &= bits - 1u, ++base) {
      const int q = __ffs(bits) - 1;
      store_pair(a, base, gi, gj + q / kVec * 32 * kVec + q % kVec,
                 pick<kVec>(x, q));
    }
    __syncwarp();
    return;
  }
  int* p = stage + 2 * (staged + at);
  for (unsigned bits = svm; bits; bits &= bits - 1u, p += 2) {
    const int q = __ffs(bits) - 1;
    p[0] = gj + q / kVec * 32 * kVec + q % kVec;
    p[1] = pick<kVec>(x, q);
  }
  __syncwarp();
  staged += total;
}

template <int kVec, bool kAccumulate, int kAppend>
__global__ void __launch_bounds__(kWarps * 32)
stats_epilogue_kernel(const Args a) {
  constexpr int kChunk = 32 * kVec;
  extern __shared__ int smem[];
  int* s_cls = smem;                                         // [win]
  unsigned* s_hits = reinterpret_cast<unsigned*>(smem + a.win);  // [slots, 2]
  const int slots = a.win / a.tile + 2;
  // kAppend: this warp's stage, [kStage, 2], and how much of it is used
  [[maybe_unused]] int* stage =
      smem + a.win + 2 * slots + (threadIdx.x >> 5) * 2 * kStage;
  [[maybe_unused]] unsigned staged = 0u;

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
      // kAppend: this lane's survivors in the group, bit k * kVec + e, and
      // its survivor_count before the chunk
      [[maybe_unused]] unsigned svm = 0u;
      [[maybe_unused]] unsigned last = survivor_count<kAppend>(acc);
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
        if constexpr (kAppend != 0) {
          const unsigned now = survivor_count<kAppend>(acc);
          if ((now >> 16) != (last >> 16)) {  // this lane met one (rare)
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              if (col + e >= lo && col + e < hi)
                svm |= survives<kAppend>(cur[k].at(e), cls.at(e), crow,
                                         a.threshold) << (k * kVec + e);
          }
          last = now;
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
      if constexpr (kAppend != 0) {
        if (__ballot_sync(0xffffffffu, svm))  // one ballot a group
          stage_survivors<kVec>(a, cur, svm, c, stage, staged, a.pi0 + r,
                                lane);
      }
    }

    fold_window(acc);
    __syncthreads();
    const long long base = ti * a.hits_ld + (w0 / a.tile) * 2;
    for (int q = threadIdx.x; q < 2 * slots; q += blockDim.x)
      if (s_hits[q]) atomicAdd(a.hits + base + q, s_hits[q]);
  }

  // kAppend: the slots of the row's last staged survivors; the atomic goes
  // out before the row's reduction, which covers its round trip
  [[maybe_unused]] unsigned long long base = 0ull;
  if constexpr (kAppend != 0) {
    __syncwarp();
    if (staged && lane == 0)
      base = atomicAdd(a.cursor, static_cast<unsigned long long>(staged));
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
  if constexpr (kAppend != 0) {
    if (staged)
      store_stage(a, stage, staged, __shfl_sync(0xffffffffu, base, 0),
                  a.pi0 + r, lane);
  }
}

int launch(Args a, bool accumulate, void* stream) {
  if (a.s <= 0 || a.j <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec4 = a.tile % 128 == 0 && a.ld % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.counts) % 16 == 0;
  const int chunk = vec4 ? 128 : 32;
  const int span = (a.j + chunk - 1) / chunk * chunk;
  const bool append = a.cursor != nullptr;
  const int window = append ? kAppendWindow : kWindow;
  a.win = span < window ? span : window;
  const size_t smem =
      (a.win + 2 * (a.win / a.tile + 2) + (append ? kWarps * 2 * kStage : 0)) *
      sizeof(int);
  const dim3 grid(a.s / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (append) {  // K1 with survivor buffers
    if (accumulate) return static_cast<int>(cudaErrorInvalidValue);
    if (vec4 && a.include_same) {
      stats_epilogue_kernel<4, false, 2><<<grid, block, smem, s>>>(a);
    } else if (vec4) {
      stats_epilogue_kernel<4, false, 1><<<grid, block, smem, s>>>(a);
    } else if (a.include_same) {
      stats_epilogue_kernel<1, false, 2><<<grid, block, smem, s>>>(a);
    } else {
      stats_epilogue_kernel<1, false, 1><<<grid, block, smem, s>>>(a);
    }
  } else if (vec4 && accumulate) {
    stats_epilogue_kernel<4, true, 0><<<grid, block, smem, s>>>(a);
  } else if (vec4) {
    stats_epilogue_kernel<4, false, 0><<<grid, block, smem, s>>>(a);
  } else if (accumulate) {
    stats_epilogue_kernel<1, true, 0><<<grid, block, smem, s>>>(a);
  } else {
    stats_epilogue_kernel<1, false, 0><<<grid, block, smem, s>>>(a);
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
  a.include_same = 0;
  a.pi0 = a.pj0 = a.transposed = 0;
  a.pair_i = a.pair_j = a.pair_c = nullptr;
  a.cursor = nullptr;
  a.cap = 0;
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

// K1 into a strip that also appends its survivors (see the header): pair_i,
// pair_j, pair_c int32 [cap] take (pi0 + r, pj0 + c, count) for the
// survivor at local (r, c), (pj0 + c, pi0 + r, count) when transposed is
// nonzero, at the slots the int64 cursor hands out; the cursor advances by
// every survivor, stored or not.
extern "C" int ukc_stats_epilogue_append_into(
    const void* counts, long long ld, int s, int j, const void* classes_row,
    const void* classes_col, int tile, int i_off, int j_off, int n,
    int threshold, int w_thresh, void* row_stats, void* block_hits,
    long long hits_ld, int include_same, void* pair_i, void* pair_j,
    void* pair_c, void* cursor, long long cap, int pi0, int pj0,
    int transposed, void* stream) {
  Args a = make_args(counts, ld, s, j, classes_row, classes_col, tile, i_off,
                     j_off, n, threshold, w_thresh, row_stats, block_hits,
                     hits_ld);
  a.include_same = include_same;
  a.pair_i = static_cast<int*>(pair_i);
  a.pair_j = static_cast<int*>(pair_j);
  a.pair_c = static_cast<int*>(pair_c);
  a.cursor = static_cast<unsigned long long*>(cursor);
  a.cap = cap;
  a.pi0 = pi0;
  a.pj0 = pj0;
  a.transposed = transposed;
  return launch(a, false, stream);
}
