// Popcount sweep over the packed bitset (K4).
//
// Replaces the Pallas kernel `sweep_pallas` / `_sweep_kernel` of
// uniprot_kmer_based_clustering_tpu/ops/popcount.py. For every listed
// (ti, tj) tile pair of the upper triangle it computes the shared-bit count
// of each protein pair, popcount(words[gi] & words[gj]) summed over the
// word axis, and reduces it on the spot to
//   row_stats [N_pad, 8]: per stationary row, over the pairs with
//     valid = gi < gj && gj < n, split cross/same by class inequality:
//     0 cross sum, 1 cross #(count >= 1), 2 cross #(count > threshold),
//     3 cross max, 4..7 the same for same-class pairs;
//   tile_hits [nT, 4]: per tile pair, #cross / #same pairs over threshold,
//     then #cross / #same pairs with count >= 1.
// The count matrix never reaches device memory.
//
// Bound: the popcount issue rate. The 10,619-protein corpus (N_pad 10,752,
// 7,680 words) needs ~4.4e11 AND+popcount word operations; at 16 popcounts
// per SM per clock that is ~0.1 s on 132 SMs, while the words it reads
// (330 MB) come from L2 and shared memory many times over.
// Design for that bound:
//   * the TPU kernel holds a whole [tile, W] stationary block in VMEM and
//     loops the moving rows; here one block of 256 threads owns a 32 x 32
//     sub-tile of pairs and walks the word axis in chunks of 32 words
//     staged in shared memory (rows padded to 33 words, so the moving
//     operand's column reads hit 32 distinct banks and the stationary
//     operand's reads are broadcasts). Each warp is one column set: lane x
//     holds the counts of pairs (4 rows, column x) in registers.
//   * the grid is (listed tile pair, sub-tile); GPU blocks run in no order,
//     so row stats merge into a pre-zeroed row_stats by integer atomics
//     (atomicAdd for sums and counts, atomicMax for lanes 3 and 7; counts
//     are >= 0, so starting from 0 is exact) after a warp reduction, and
//     each block adds its four hit counts to its tile's row once.
//   * sub-tiles with no valid pair (wholly on or below the diagonal, or
//     past n) return before loading anything.
// The tile is the caller's choice, a multiple of 32. The TPU kernel's tile
// follows from VMEM (`pallas_tile`) and its 1 GiB tile_hits guard from the
// 8 x 128 padding of each hit block; neither applies here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stats_common.cuh"

namespace {

constexpr int kSub = 32;    // pairs per sub-tile side
constexpr int kChunk = 32;  // words staged per step
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kSub / (kThreads / 32);  // 4

__global__ void __launch_bounds__(kThreads)
popcount_sweep_kernel(const uint32_t* __restrict__ words, int w,
                      const int* __restrict__ classes,
                      const int* __restrict__ tiles, int tile, int n,
                      int threshold, int* __restrict__ row_stats,
                      int* __restrict__ tile_hits) {
  __shared__ uint32_t sa[kSub][kChunk + 1];
  __shared__ uint32_t sb[kSub][kChunk + 1];
  __shared__ unsigned s_hits[4];

  const int t = blockIdx.x;
  const int nsub = tile / kSub;
  const int gi0 = tiles[2 * t] * tile + (blockIdx.y / nsub) * kSub;
  const int gj0 = tiles[2 * t + 1] * tile + (blockIdx.y % nsub) * kSub;
  if (gj0 + kSub - 1 <= gi0 || gj0 >= n) return;  // no gi < gj < n pair

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < 4) s_hits[threadIdx.x] = 0;

  unsigned acc[kRowsPerThread] = {0u, 0u, 0u, 0u};
  for (int w0 = 0; w0 < w; w0 += kChunk) {
    const int wi = w0 + lane;
    for (int r = warp; r < kSub; r += kThreads / 32) {
      sa[r][lane] = wi < w ? words[static_cast<long long>(gi0 + r) * w + wi] : 0u;
      sb[r][lane] = wi < w ? words[static_cast<long long>(gj0 + r) * w + wi] : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const uint32_t b = sb[lane][k];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[q] += __popc(sa[warp + q * (kThreads / 32)][k] & b);
    }
    __syncthreads();
  }

  const int gj = gj0 + lane;
  const int ccol = classes[gj];
  unsigned hc = 0, hs = 0, pc = 0, ps = 0;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int gi = gi0 + warp + q * (kThreads / 32);
    RowAcc a = {0u, 0u, 0u, 0, 0u, 0u, 0u, 0};
    visit(a, static_cast<int>(acc[q]), gi, gj, classes[gi], ccol, n,
          threshold, 1);
    a = reduce_row(a);
    if (lane == 0) {
      flush_row(row_stats + static_cast<long long>(gi) * 8, a);
      hc += a.co;
      hs += a.so;
      pc += a.cp;
      ps += a.sp;
    }
  }
  __syncthreads();  // s_hits zeroed before any warp adds to it
  if (lane == 0) {
    if (hc) atomicAdd(&s_hits[0], hc);
    if (hs) atomicAdd(&s_hits[1], hs);
    if (pc) atomicAdd(&s_hits[2], pc);
    if (ps) atomicAdd(&s_hits[3], ps);
  }
  __syncthreads();
  if (threadIdx.x < 4)
    add_lane(tile_hits + 4 * t + threadIdx.x, s_hits[threadIdx.x]);
}

}  // namespace

// words: [N_pad, w] 32-bit words row-major; classes int32 [N_pad]; tiles
// int32 [n_tiles, 2] (ti, tj) with ti <= tj; row_stats int32 [N_pad, 8] and
// tile_hits int32 [n_tiles, 4], both zeroed by the caller. tile must be a
// multiple of 32 dividing N_pad, with (tile/32)^2 <= 65535. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ukc_popcount_sweep(const void* words, int w,
                                  const void* classes, const void* tiles,
                                  int n_tiles, int tile, int n, int threshold,
                                  void* row_stats, void* tile_hits,
                                  void* stream) {
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int nsub = tile / kSub;
  const dim3 grid(n_tiles, nsub * nsub);
  popcount_sweep_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), w,
      static_cast<const int*>(classes), static_cast<const int*>(tiles), tile,
      n, threshold, static_cast<int*>(row_stats),
      static_cast<int*>(tile_hits));
  return static_cast<int>(cudaGetLastError());
}
