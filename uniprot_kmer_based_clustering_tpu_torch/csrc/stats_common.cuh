// The eight row-statistic lanes shared by K1/K2 (stats_epilogue.cu), K3
// (tri_mxu.cu) and K4 (popcount_sweep.cu): what a pair contributes (visit;
// K1/K2, which know a row's valid range, count interior pairs with a
// branch-free form of it), how a row's partial lanes reduce across lanes of
// a warp, and how they merge into row_stats (by atomics, or by a store
// where one launch owns the row).
//
// Per stationary row, over the pairs with valid = gi < gj && gj < n, split
// cross/same by class inequality:
//   0 cross sum, 1 cross #(count >= w_thresh), 2 cross #(count > threshold),
//   3 cross max, 4..7 the same for same-class pairs.
// Sums are unsigned and wrap modulo 2^32 like the TPU's int32. The max lanes
// start at 0, as the Pallas epilogue (accumulate_stats_block) clamps its
// first tile with prev = 0; flush_row merges them only when positive.

#pragma once

#include <cuda_runtime.h>

namespace {

struct RowAcc {
  unsigned cw, cp, co;
  int cm;
  unsigned sw, sp, so;
  int sm;
};

__device__ __forceinline__ void visit(RowAcc& a, int cnt, int gi, int gj,
                                      int crow, int ccol, int n,
                                      int threshold, int w_thresh) {
  if (!(gi < gj && gj < n)) return;
  const unsigned u = static_cast<unsigned>(cnt);
  const unsigned present = cnt >= w_thresh;
  const unsigned over = cnt > threshold;
  if (crow != ccol) {
    a.cw += u;
    a.cp += present;
    a.co += over;
    a.cm = max(a.cm, cnt);
  } else {
    a.sw += u;
    a.sp += present;
    a.so += over;
    a.sm = max(a.sm, cnt);
  }
}

// Reductions over groups of kWidth neighbouring lanes (32: the whole warp;
// 4: the quad of an mma.sync accumulator row). Every lane of the warp calls.
template <int kWidth = 32>
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kWidth = 32>
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int kWidth = 32>
__device__ __forceinline__ RowAcc reduce_row(const RowAcc& a) {
  return {warp_sum<kWidth>(a.cw), warp_sum<kWidth>(a.cp),
          warp_sum<kWidth>(a.co), warp_max<kWidth>(a.cm),
          warp_sum<kWidth>(a.sw), warp_sum<kWidth>(a.sp),
          warp_sum<kWidth>(a.so), warp_max<kWidth>(a.sm)};
}

// reduce_row over the whole warp with redux.sync (sm_80+): one instruction
// a lane where the shuffle tree takes five. Every lane of the warp calls.
__device__ __forceinline__ RowAcc redux_row(const RowAcc& a) {
  const unsigned all = 0xffffffffu;
  return {__reduce_add_sync(all, a.cw), __reduce_add_sync(all, a.cp),
          __reduce_add_sync(all, a.co), __reduce_max_sync(all, a.cm),
          __reduce_add_sync(all, a.sw), __reduce_add_sync(all, a.sp),
          __reduce_add_sync(all, a.so), __reduce_max_sync(all, a.sm)};
}

// Store a reduced row into its row_stats entry (int32 [8]), replacing what
// was there: for a launch that owns the whole row.
__device__ __forceinline__ void store_row(int* out, const RowAcc& a) {
  out[0] = static_cast<int>(a.cw);
  out[1] = static_cast<int>(a.cp);
  out[2] = static_cast<int>(a.co);
  out[3] = a.cm;
  out[4] = static_cast<int>(a.sw);
  out[5] = static_cast<int>(a.sp);
  out[6] = static_cast<int>(a.so);
  out[7] = a.sm;
}

__device__ __forceinline__ void add_lane(int* p, unsigned v) {
  if (v) atomicAdd(reinterpret_cast<unsigned*>(p), v);
}

// Merge a reduced row into its row_stats entry (int32 [8], zeroed by the
// caller): integer atomics, exact and independent of block order.
__device__ __forceinline__ void flush_row(int* out, const RowAcc& a) {
  add_lane(out + 0, a.cw);
  add_lane(out + 1, a.cp);
  add_lane(out + 2, a.co);
  if (a.cm > 0) atomicMax(out + 3, a.cm);
  add_lane(out + 4, a.sw);
  add_lane(out + 5, a.sp);
  add_lane(out + 6, a.so);
  if (a.sm > 0) atomicMax(out + 7, a.sm);
}

}  // namespace
