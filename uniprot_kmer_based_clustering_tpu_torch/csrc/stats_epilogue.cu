// Statistics epilogue over a materialized int32 counts block (K1).
//
// Replaces the Pallas tile walk `stats_from_counts` / `_stats_kernel` /
// `accumulate_stats_block` of uniprot_kmer_based_clustering_tpu/ops/
// stats_pallas.py. For every kept (ti, tj) tile of a counts block that sits
// at global offset (i_off, j_off) it computes, per stationary row, the 8
// statistic lanes of ops.popcount.ROW_STAT_NAMES over the pairs with
// valid = gi < gj && gj < n, split cross/same by class inequality:
//   0 cross sum, 1 cross #(count >= w_thresh), 2 cross #(count > threshold),
//   3 cross max, 4..7 the same for same-class pairs,
// plus the tile's two over-threshold hit counts (cross, same).
//
// Bound: one read of the counts block. The first 1536-row strip of the
// 10,752-row corpus is a 66 MB block, about 20 us at the H100's 3.35 TB/s.
// Design for that bound:
//   * the TPU grid walks tiles in order and carries each row's stats in a
//     revisited output block; GPU blocks run in no order, so rows merge
//     into a pre-zeroed row_stats [S, 8] by integer atomics instead
//     (atomicAdd for the sum/count lanes, atomicMax for lanes 3 and 7).
//     int32 atomics are exact and order-free, so the result is
//     deterministic and wraps modulo 2^32 exactly like the TPU's int32.
//   * starting the max lanes at 0 is exact: the Pallas kernel clamps its
//     first tile with prev = 0 as well.
//   * one block covers kRowsPerBlock rows of one tile (a whole tile per
//     block would give the last strips fewer blocks than SMs); one warp
//     per row, lanes striding the tile's columns with 16-byte loads where
//     the layout allows, so every read is coalesced.
//   * the tile's column classes are staged in shared memory once per block.
//   * hit counts reduce in the block and merge across the tile's row
//     blocks with one atomicAdd each.
// Offsets, n, threshold and w_thresh are runtime arguments. Tile indices
// come from a small device array the block reads itself (the TPU's scalar
// prefetch).
//
// K2, the traced-offset variant (stats_from_counts_traced /
// _stats_kernel_traced of the same Pallas file), is the same kernel on the
// full tile grid: with no tile array, block t takes tile (t / ntj, t % ntj),
// so tile_hits comes out as block_hits [S/tile, J/tile, 2] in row-major
// order. Tiles wholly below the pair diagonal are visited and mask to zero,
// as in the Pallas kernel. It runs once per step of the block-pair scan
// (a [3584, 3584] block of the 30,000-protein corpus: 51 MB, ~15 us at
// 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "stats_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 32;

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
stats_epilogue_kernel(const int* __restrict__ counts, long long ld,
                      const int* __restrict__ classes_row,
                      const int* __restrict__ classes_col,
                      const int* __restrict__ tiles, int ntj, int tile,
                      int i_off, int j_off, int n, int threshold,
                      int w_thresh, int* __restrict__ row_stats,
                      int* __restrict__ tile_hits) {
  extern __shared__ int s_ccol[];  // [tile] classes of this tile's columns
  __shared__ unsigned s_hits[2];

  const int t = blockIdx.x;
  const int ti = tiles ? tiles[2 * t] : t / ntj;
  const int tj = tiles ? tiles[2 * t + 1] : t % ntj;
  const int r0 = ti * tile + blockIdx.y * kRowsPerBlock;  // local row
  const int c0 = tj * tile;                                // local column
  for (int c = threadIdx.x; c < tile; c += blockDim.x)
    s_ccol[c] = classes_col[c0 + c];
  if (threadIdx.x < 2) s_hits[threadIdx.x] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gj0 = j_off + c0;
  unsigned hit_c = 0, hit_s = 0;

  for (int rr = warp; rr < kRowsPerBlock; rr += kWarps) {
    const int r = r0 + rr;
    const int gi = i_off + r;
    const int cr = classes_row[r];
    const int* row = counts + static_cast<long long>(r) * ld + c0;
    RowAcc a = {0u, 0u, 0u, 0, 0u, 0u, 0u, 0};
    if (kVec4) {
      for (int c = lane * 4; c < tile; c += 128) {
        const int4 v = *reinterpret_cast<const int4*>(row + c);
        visit(a, v.x, gi, gj0 + c, cr, s_ccol[c], n, threshold, w_thresh);
        visit(a, v.y, gi, gj0 + c + 1, cr, s_ccol[c + 1], n, threshold,
              w_thresh);
        visit(a, v.z, gi, gj0 + c + 2, cr, s_ccol[c + 2], n, threshold,
              w_thresh);
        visit(a, v.w, gi, gj0 + c + 3, cr, s_ccol[c + 3], n, threshold,
              w_thresh);
      }
    } else {
      for (int c = lane; c < tile; c += 32)
        visit(a, row[c], gi, gj0 + c, cr, s_ccol[c], n, threshold, w_thresh);
    }
    a = reduce_row(a);
    if (lane == 0) {
      flush_row(row_stats + static_cast<long long>(r) * 8, a);
      hit_c += a.co;
      hit_s += a.so;
    }
  }

  if (lane == 0) {
    if (hit_c) atomicAdd(&s_hits[0], hit_c);
    if (hit_s) atomicAdd(&s_hits[1], hit_s);
  }
  __syncthreads();
  if (threadIdx.x < 2) add_lane(tile_hits + 2 * t + threadIdx.x, s_hits[threadIdx.x]);
}

}  // namespace

namespace {

int launch(const void* counts, long long ld, const void* classes_row,
           const void* classes_col, const void* tiles, int n_tiles, int ntj,
           int tile, int i_off, int j_off, int n, int threshold, int w_thresh,
           void* row_stats, void* tile_hits, void* stream) {
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(n_tiles, tile / kRowsPerBlock);
  const dim3 block(kWarps * 32);
  const size_t smem = static_cast<size_t>(tile) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = tile % 128 == 0 && ld % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  const int* c = static_cast<const int*>(counts);
  const int* cr = static_cast<const int*>(classes_row);
  const int* cc = static_cast<const int*>(classes_col);
  const int* tl = static_cast<const int*>(tiles);
  int* rs = static_cast<int*>(row_stats);
  int* th = static_cast<int*>(tile_hits);
  if (vec4) {
    stats_epilogue_kernel<true><<<grid, block, smem, s>>>(
        c, ld, cr, cc, tl, ntj, tile, i_off, j_off, n, threshold, w_thresh,
        rs, th);
  } else {
    stats_epilogue_kernel<false><<<grid, block, smem, s>>>(
        c, ld, cr, cc, tl, ntj, tile, i_off, j_off, n, threshold, w_thresh,
        rs, th);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. counts: int32 [S, ld] row-major; classes_row int32 [S]; classes_col
// int32 [ld]; tiles int32 [n_tiles, 2] local (ti, tj); row_stats int32
// [S, 8] and tile_hits int32 [n_tiles, 2], both zeroed by the caller. tile
// must be a multiple of 32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ukc_stats_epilogue(const void* counts, long long ld,
                                  const void* classes_row,
                                  const void* classes_col, const void* tiles,
                                  int n_tiles, int tile, int i_off, int j_off,
                                  int n, int threshold, int w_thresh,
                                  void* row_stats, void* tile_hits,
                                  void* stream) {
  return launch(counts, ld, classes_row, classes_col, tiles, n_tiles, 0, tile,
                i_off, j_off, n, threshold, w_thresh, row_stats, tile_hits,
                stream);
}

// K2: every tile of the [s, ld] block, row-major; block_hits int32
// [s/tile, ld/tile, 2] and row_stats int32 [s, 8], both zeroed by the
// caller.
extern "C" int ukc_stats_epilogue_traced(const void* counts, long long ld,
                                         int s, const void* classes_row,
                                         const void* classes_col, int tile,
                                         int i_off, int j_off, int n,
                                         int threshold, int w_thresh,
                                         void* row_stats, void* block_hits,
                                         void* stream) {
  const int ntj = static_cast<int>(ld / tile);
  return launch(counts, ld, classes_row, classes_col, nullptr,
                (s / tile) * ntj, ntj, tile, i_off, j_off, n, threshold,
                w_thresh, row_stats, block_hits, stream);
}
