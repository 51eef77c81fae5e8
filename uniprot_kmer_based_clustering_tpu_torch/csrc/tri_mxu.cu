// Fused upper-triangle sweep over the packed bitset on the tensor cores (K3).
//
// Replaces the Pallas kernel `sweep_tri_mxu` / `_tri_kernel` of
// uniprot_kmer_based_clustering_tpu/ops/tri_mxu.py. For every listed (ti, tj)
// tile pair of the upper triangle it computes the pair scores
//   C[gi, gj] = sum over bit columns k of bit(gi, k) * bit(gj, k) * weight(k)
// from the packed uint32 words, and reduces them on the spot to
//   row_stats [N_pad, 8]: the lanes of stats_common.cuh per stationary row;
//   tile_hits [nT, 2]: per tile pair, #cross / #same pairs over threshold.
// Neither the unpacked operands nor the counts reach device memory: the
// kernel reads only the packed words, 8x fewer bytes than int8 operands.
//
// Bound: tensor-core issue plus the shared-memory unpack. The 10,619-protein
// corpus (231 tile pairs of 512^2 x 245,760 bits) is 3.0e13 operations, the
// 30,000-protein one 9.6e14. mma.sync reaches only part of Hopper's int8
// rate, which needs wgmma fed by TMA. This first version is simple:
//   * one block of 256 threads (8 warps, 2 x 4) owns a 128 x 128 sub-tile of
//     one tile pair; each warp keeps a 64 x 32 accumulator in registers
//     (4 x 4 mma tiles of 16 x 8);
//   * the word axis runs in chunks of 256 bytes of contraction per row (8
//     words as int8, 4 as bf16). Each thread loads its packed words with
//     16-byte loads one chunk ahead, into registers while the tensor cores
//     work on the current chunk, then unpacks them into shared memory: two
//     operand tiles of 128 rows, each row padded by 16 bytes so that the
//     eight row addresses of an ldmatrix fall in distinct banks;
//   * the unpack permutes the contraction axis inside each word, which no
//     dot product observes. The int8 register r of a word holds bits r,
//     r+8, r+16, r+24 as four bytes, (x >> r) & 0x01010101: two integer
//     operations for four columns. The bf16 register r holds bits r and
//     r+16. The caller permutes the moving operand's weights the same way;
//     they are applied with a byte (or half-word) mask;
//   * fragments come from shared memory by ldmatrix and go to
//     mma.sync m16n8k32 s8.s8 -> s32 or m16n8k16 bf16.bf16 -> f32: 32 bytes
//     of contraction either way, so both variants share the fragment layout
//     and differ only in the spread and the instruction;
//   * after the last chunk every thread runs the shared `visit` over its
//     accumulator entries (bf16 sums through __float2int_rn: exact, since
//     the caller's guard keeps every partial sum below 2^24), the four lanes
//     of a quad that share a row reduce, and the row merges into row_stats
//     by integer atomics; the block adds its two hit counts to its tile once;
//   * sub-tiles with no valid pair (wholly on or below the diagonal, or past
//     n) return before loading anything.
// The TPU kernel's VMEM scratch of [tile, wc * 32] operands and its
// word-chunk grid axis are facts of the TPU. Here the tile only sets the
// tile_hits granularity (a multiple of 128), and the word chunk is the
// kernel's own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stats_common.cuh"

namespace {

constexpr int kSub = 128;      // rows and columns of a block's sub-tile
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kMi = 4;         // 16-row mma tiles of a warp (64 rows)
constexpr int kNi = 4;         // 8-column mma tiles of a warp (32 columns)
constexpr int kChunkBytes = 256;          // contraction bytes a row, a chunk
constexpr int kRowBytes = kChunkBytes + 16;
constexpr int kSmemBytes = 2 * kSub * kRowBytes;  // 69,632

struct Int8Dot {
  using Acc = int;
  static constexpr int kBytesPerBit = 1;
  static constexpr uint32_t kSpread = 0x01010101u;  // bits r, r+8, r+16, r+24
  static constexpr uint32_t kOne = 1u;              // 0/1 byte -> int8 0/1
  static constexpr uint32_t kFill = 0xFFu;          // 0/1 byte -> byte mask
  __device__ static void mma(int* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static int count(int v) { return v; }
};

struct Bf16Dot {
  using Acc = float;
  static constexpr int kBytesPerBit = 2;
  static constexpr uint32_t kSpread = 0x00010001u;  // bits r, r+16
  static constexpr uint32_t kOne = 0x3F80u;         // bf16 1.0
  static constexpr uint32_t kFill = 0xFFFFu;        // 0/1 half -> half mask
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static int count(float v) { return __float2int_rn(v); }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// One packed word -> its 32 columns at dst (16-byte aligned), in the
// in-word order described above; `wp` points at the word's permuted
// weights, or is null for 0/1 columns.
template <class D>
__device__ __forceinline__ void unpack_word(uint32_t x, unsigned char* dst,
                                            const uint4* wp) {
  constexpr int kRegs = 8 * D::kBytesPerBit;
  uint32_t v[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) v[r] = (x >> r) & D::kSpread;
#pragma unroll
  for (int q = 0; q < kRegs / 4; ++q) {
    uint32_t* u = v + 4 * q;
    if (wp) {
      const uint4 w = __ldg(wp + q);
      u[0] = (u[0] * D::kFill) & w.x;
      u[1] = (u[1] * D::kFill) & w.y;
      u[2] = (u[2] * D::kFill) & w.z;
      u[3] = (u[3] * D::kFill) & w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] *= D::kOne;
    }
    reinterpret_cast<uint4*>(dst)[q] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

template <class D>
__global__ void __launch_bounds__(kThreads, 2)
tri_mxu_kernel(const uint4* __restrict__ words, int w,
               const int* __restrict__ classes,
               const int* __restrict__ tiles, int tile, int n, int threshold,
               int w_thresh, const uint4* __restrict__ weights,
               int* __restrict__ row_stats, int* __restrict__ tile_hits) {
  // [2][kSub][kRowBytes]: the stationary, then the moving operand tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_hits[2];
  constexpr int kChunkWords = kChunkBytes / (32 * D::kBytesPerBit);
  constexpr int kWordBytes = 32 * D::kBytesPerBit;  // unpacked bytes a word
  constexpr int kQuadsPerRow = kChunkWords / 4;     // 16-byte loads a row
  constexpr int kQuads = 2 * kSub * kQuadsPerRow / kThreads;  // a thread
  static_assert(kQuads * kThreads == 2 * kSub * kQuadsPerRow, "");

  const int nsub = tile / kSub;
  const int t = blockIdx.x / (nsub * nsub);
  const int sub = blockIdx.x % (nsub * nsub);
  const int gi0 = tiles[2 * t] * tile + (sub / nsub) * kSub;
  const int gj0 = tiles[2 * t + 1] * tile + (sub % nsub) * kSub;
  if (gj0 + kSub - 1 <= gi0 || gj0 >= n) return;  // no gi < gj < n pair

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 2;  // warp row (0..1)
  const int wn = (tid >> 5) & 3;   // warp column (0..3)
  if (tid < 2) s_hits[tid] = 0;

  // The quads this thread moves in every chunk: quad i is 4 words of one
  // row of the stationary (op 0) or the moving (op 1) operand.
  const int w4 = w / 4;
  const uint4* src[kQuads];
  int qoff[kQuads], dst[kQuads];
  bool moving[kQuads];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int idx = tid + i * kThreads;
    const int op = idx / (kSub * kQuadsPerRow);
    const int rem = idx % (kSub * kQuadsPerRow);
    const int row = rem / kQuadsPerRow;
    qoff[i] = rem % kQuadsPerRow;
    src[i] = words + static_cast<long long>((op ? gj0 : gi0) + row) * w4;
    dst[i] = (op * kSub + row) * kRowBytes + qoff[i] * 4 * kWordBytes;
    moving[i] = op == 1;
  }
  uint4 pre[kQuads];
  auto load = [&](int c) {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int q = c * kQuadsPerRow + qoff[i];
      pre[i] = q < w4 ? __ldg(src[i] + q) : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  typename D::Acc acc[kMi][kNi][4] = {};
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // ldmatrix row addresses: A rows (lane & 15) at byte (lane >> 4) * 16;
  // B rows (lane & 7) + 8 * (lane >> 4) at byte ((lane >> 3) & 1) * 16
  const uint32_t a_addr =
      s_base + (wm * 64 + (lane & 15)) * kRowBytes + (lane >> 4) * 16;
  const uint32_t b_addr =
      s_base + (kSub + wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * kRowBytes +
      ((lane >> 3) & 1) * 16;

  const int nchunks = (w + kChunkWords - 1) / kChunkWords;
  load(0);
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int wi = c * kChunkWords + qoff[i] * 4;  // first word of the quad
      const bool weighted = moving[i] && weights != nullptr && wi < w;
      const uint32_t xs[4] = {pre[i].x, pre[i].y, pre[i].z, pre[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long wq = static_cast<long long>(wi + j) * kWordBytes / 16;
        unpack_word<D>(xs[j], smem + dst[i] + j * kWordBytes,
                       weighted ? weights + wq : nullptr);
      }
    }
    __syncthreads();
    if (c + 1 < nchunks) load(c + 1);  // in flight during the products
#pragma unroll
    for (int kb = 0; kb < kChunkBytes; kb += 32) {
      uint32_t a[kMi][4], b[kNi][2];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
        ldmatrix_x4(a[mi], a_addr + mi * 16 * kRowBytes + kb);
#pragma unroll
      for (int np = 0; np < kNi / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b_addr + np * 16 * kRowBytes + kb);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) D::mma(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Accumulator entry (mi, ni, 2h + e) is row wm*64 + mi*16 + g + 8h,
  // column wn*32 + ni*8 + 2*tq + e of the sub-tile.
  const int g = lane >> 2, tq = lane & 3;
  int ccol[kNi][2];
#pragma unroll
  for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ccol[ni][e] = classes[gj0 + wn * 32 + ni * 8 + 2 * tq + e];
  unsigned hc = 0, hs = 0;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = gi0 + wm * 64 + mi * 16 + g + 8 * h;
      const int crow = classes[gi];
      RowAcc r = {0u, 0u, 0u, 0, 0u, 0u, 0u, 0};
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          visit(r, D::count(acc[mi][ni][2 * h + e]), gi,
                gj0 + wn * 32 + ni * 8 + 2 * tq + e, crow, ccol[ni][e], n,
                threshold, w_thresh);
      r = reduce_row<4>(r);
      if (tq == 0) {
        flush_row(row_stats + static_cast<long long>(gi) * 8, r);
        hc += r.co;
        hs += r.so;
      }
    }
  }
  __syncthreads();  // s_hits zeroed before any thread adds to it
  if (tq == 0) {
    if (hc) atomicAdd(&s_hits[0], hc);
    if (hs) atomicAdd(&s_hits[1], hs);
  }
  __syncthreads();
  if (tid < 2) add_lane(tile_hits + 2 * t + tid, s_hits[tid]);
}

template <class D>
int launch(const void* words, int w, const void* classes, const void* tiles,
           int n_tiles, int tile, int n, int threshold, int w_thresh,
           const void* weights, void* row_stats, void* tile_hits,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      tri_mxu_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nsub = tile / kSub;
  tri_mxu_kernel<D><<<n_tiles * nsub * nsub, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint4*>(words), w, static_cast<const int*>(classes),
      static_cast<const int*>(tiles), tile, n, threshold, w_thresh,
      static_cast<const uint4*>(weights), static_cast<int*>(row_stats),
      static_cast<int*>(tile_hits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: [N_pad, w] 32-bit words row-major, 16-byte aligned, w % 4 == 0;
// classes int32 [N_pad]; tiles int32 [n_tiles, 2] (ti, tj) with ti <= tj;
// weights: null (every column 1) or [w * 32] int8 (bf16 when `bf16` is
// nonzero) in the in-word order of the unpack, 16-byte aligned; row_stats
// int32 [N_pad, 8] and tile_hits int32 [n_tiles, 2], both zeroed by the
// caller. tile must be a multiple of 128 dividing N_pad, and
// n_tiles * (tile / 128)^2 < 2^31. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ukc_tri_mxu_sweep(const void* words, int w,
                                 const void* classes, const void* tiles,
                                 int n_tiles, int tile, int n, int threshold,
                                 int w_thresh, const void* weights, int bf16,
                                 void* row_stats, void* tile_hits,
                                 void* stream) {
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<Bf16Dot>(words, w, classes, tiles, n_tiles, tile, n,
                           threshold, w_thresh, weights, row_stats, tile_hits,
                           s);
  return launch<Int8Dot>(words, w, classes, tiles, n_tiles, tile, n,
                         threshold, w_thresh, weights, row_stats, tile_hits,
                         s);
}
