// Fused upper-triangle sweep over the packed bitset on the tensor cores (K3).
//
// Replaces the Pallas kernel `sweep_tri_mxu` / `_tri_kernel` of
// uniprot_kmer_based_clustering_tpu/ops/tri_mxu.py. Over the pairs gi < gj
// < n of the upper triangle it computes the pair scores
//   C[gi, gj] = sum over bit columns k of bit(gi, k) * bit(gj, k) * weight(k)
// from the packed uint32 words, and reduces them on the spot to
//   row_stats [N_pad, 8]: the lanes of stats_common.cuh per stationary row;
//   tile_hits [nT, 2]: per (ti, tj) tile pair of the upper triangle,
//                      #cross / #same pairs over threshold.
// Neither the unpacked operands nor the counts reach device memory: the
// kernel reads only the packed words, 8x fewer bytes than int8 operands.
//
// Bound: the tensor cores. The work is 2 * n(n-1)/2 * K operations for K
// bit columns (2.7e13 at 10,619 proteins, 8.2e14 at 30,000), against 0.3
// and 3.7 GB of packed words: hundreds of operations a byte. What stands
// between the two is the unpack, which must keep pace with the tensor
// cores and shares shared memory with their operand reads. The design:
//   * a block owns a 256 x 128 pair sub-tile (256 stationary rows gi, 128
//     moving rows gj) and walks the whole word axis. Three warpgroups:
//     two consumers, each holding two 64 x 128 accumulators in registers
//     (128 a thread) for its 128 stationary rows, and one producer;
//   * products run on wgmma: m64n128k32 s8.s8 -> s32, or m64n128k16
//     bf16.bf16 -> f32. The moving operand (B) comes from shared memory
//     through a matrix descriptor, K-major with the 128-byte swizzle; the
//     stationary one (A) from registers: each consumer thread expands the
//     packed words of its rows straight into wgmma's A fragments. Only B
//     is unpacked into shared memory, and it is the narrow side: 16 KB of
//     writes against 64 KB of wgmma reads a stage;
//   * the word axis runs in stages of 128 bytes of contraction a row (4
//     words as int8, 2 as bf16): one swizzle atom, 4 wgmma k-steps. The
//     producer copies each row's packed words into a ring of its own with
//     cp.async, seven stages ahead, expands stage c+1's moving rows into
//     the next of eight stages (and copies the stationary rows' packed
//     words beside them) while the consumers' wgmmas run on stage c, and
//     hands stages over with full/empty mbarriers; setmaxnreg moves
//     registers from the producer to the consumers;
//   * a consumer builds a stage's A fragments only while none of its own
//     wgmmas is in flight (registers that an in-flight wgmma reads must not
//     be redefined, or ptxas serializes every wgmma); the other
//     warpgroup's products keep the tensor cores busy meanwhile;
//   * the unpack permutes the contraction axis inside each word, which no
//     dot product observes: 16-byte chunk c of a stage row holds registers
//     r = 4 (c % cpw) .. +3 of word c / cpw (cpw = 2 chunks a word as int8,
//     4 as bf16). The int8 register r of a word holds bits r, r+8, r+16,
//     r+24 as four bytes, (x >> r) & 0x01010101: two integer operations
//     for four columns; the bf16 register r holds bits r and r+16. The A
//     fragment of a k-step holds registers tq and tq+4 of its 8 (int8:
//     one word; bf16: half a word), the same order. A producer thread
//     owns a whole row, so each 16-byte store of a warp lands, through the
//     swizzle, on distinct banks. The caller permutes the moving operand's
//     weights the same way; they are applied with a byte (or half-word)
//     mask;
//   * after the last stage every consumer thread runs the shared `visit`
//     over its accumulator entries (bf16 sums through __float2int_rn:
//     exact, since the caller's guard keeps every partial sum below 2^24);
//     wgmma's accumulator gives a thread rows g and g+8 and column pairs
//     8k + 2tq + e, the quad layout of mma.sync, so the four lanes of a
//     quad that share a row reduce, and the row merges into row_stats by
//     integer atomics; each warpgroup's 128 rows lie in one tile row, and
//     the block's hit counts go to its two tile pairs;
//   * only sub-tiles with a valid pair (gi < gj < n) are launched: the
//     caller lists them.
// The TPU kernel's VMEM scratch of [tile, wc * 32] operands and its
// word-chunk grid axis are facts of the TPU. Here the tile only sets the
// tile_hits granularity (a multiple of 128), and the stage is the kernel's
// own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stats_common.cuh"

namespace {

constexpr int kBM = 256;        // stationary rows of a sub-tile (2 x 2 x 64)
constexpr int kBN = 128;        // moving rows of a sub-tile
constexpr int kRows = kBM + kBN;
constexpr int kRowBytes = 128;  // contraction bytes a row, a stage
constexpr int kStages = 8;      // stages handed to the consumers
constexpr int kRing = 8;        // packed slots a row: 7 stages in flight
// a stage: B unpacked [kBN][kRowBytes], then A's packed words [kBM][16]
constexpr int kAOff = kBN * kRowBytes;                // 16,384
constexpr int kStageBytes = kAOff + kBM * 16;         // 20,480
constexpr int kRingBytes = kRing * kRows * 16;        // 49,152
constexpr int kProducerThreads = 128;
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kProducerThreads + kConsumerThreads;
constexpr int kProducerRegs = 88;   // 88 * 128 + 208 * 256 = 168 * 384
constexpr int kConsumerRegs = 208;
// shared memory, from a 1024-byte aligned base: the stages, the packed
// ring, full[kStages] and empty[kStages] barriers, the moving rows'
// classes, the block's hit counts
constexpr int kRingOff = kStages * kStageBytes;
constexpr int kBarOff = kRingOff + kRingBytes;
constexpr int kClsOff = kBarOff + 2 * kStages * 8;
constexpr int kHitsOff = kClsOff + kBN * 4;
constexpr int kSmemBytes = kHitsOff + 16 + 1024;  // + alignment slack

struct Int8Dot {
  using Acc = int;
  static constexpr int kWords = 4;                  // packed words a stage
  static constexpr int kRegsPerWord = 8;
  static constexpr uint32_t kSpread = 0x01010101u;  // bits r, r+8, r+16, r+24
  static constexpr uint32_t kOne = 1u;              // 0/1 byte -> int8 0/1
  static constexpr uint32_t kFill = 0xFFu;          // 0/1 byte -> byte mask
  __device__ static void mma(int (&d)[64], const uint32_t (&a)[4],
                               uint64_t b) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
          "}, {%64, %65, %66, %67}, %68, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
            "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
            "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
            "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
            "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
            "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
            "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
            "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
            "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
            "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
            "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
            "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
            "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
            "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
            "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
            "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
  __device__ static int count(int v) { return v; }
};

struct Bf16Dot {
  using Acc = float;
  static constexpr int kWords = 2;
  static constexpr int kRegsPerWord = 16;
  static constexpr uint32_t kSpread = 0x00010001u;  // bits r, r+16
  static constexpr uint32_t kOne = 0x3F80u;         // bf16 1.0
  static constexpr uint32_t kFill = 0xFFFFu;        // 0/1 half -> half mask
  __device__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                               uint64_t b) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
          "}, {%64, %65, %66, %67}, %68, p, %70, %71, %72;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
            "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
            "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
            "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
            "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1), "n"(1), "n"(0));
    }
  __device__ static int count(float v) { return __float2int_rn(v); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 (int8) or 8 (bf16) bytes of packed words into the ring; `valid` 0
// fills zeros (a row past N_pad).
template <int kBytes>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
}

// K-major operand with the 128-byte swizzle: rows of 128 bytes, 8-row
// groups 1024 bytes apart (SBO), leading offset unused (1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keep the compiler from moving registers that an asynchronous wgmma
// reads or writes.
__device__ __forceinline__ void fence_reg(int& x) {
  asm volatile("" : "+r"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}
template <class T, int N>
__device__ __forceinline__ void fence_regs(T (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(x[i]);
}

// The A fragments of a stage's 4 k-steps for rows g (packed words xg)
// and g+8 (xh): registers r and r+4 of the k-step's 8, r = tq.
template <class D>
__device__ __forceinline__ void a_frags(const uint4& xg, const uint4& xh,
                                        int tq, uint32_t (&a)[4][4]) {
  const uint32_t g[4] = {xg.x, xg.y, xg.z, xg.w};
  const uint32_t h[4] = {xh.x, xh.y, xh.z, xh.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = k * 8 / D::kRegsPerWord;
    const int r = (k * 8) % D::kRegsPerWord + tq;
    a[k][0] = ((g[q] >> r) & D::kSpread) * D::kOne;
    a[k][1] = ((h[q] >> r) & D::kSpread) * D::kOne;
    a[k][2] = ((g[q] >> (r + 4)) & D::kSpread) * D::kOne;
    a[k][3] = ((h[q] >> (r + 4)) & D::kSpread) * D::kOne;
  }
}

// Index of the upper-triangle tile pair (ti, tj), ti <= tj, in the
// row-major enumeration over nts tiles a side (ops/popcount.py
// upper_triangle_tiles).
__device__ __forceinline__ int tile_index(int ti, int tj, int nts) {
  return ti * nts - ti * (ti - 1) / 2 + (tj - ti);
}

template <class D>
__device__ __forceinline__ void produce(
    unsigned char* smem, const uint32_t* __restrict__ words, int w, int n_pad,
    int gi0, int gj0, const uint4* __restrict__ weights, int nst) {
  constexpr int kBytes = 4 * D::kWords;       // packed bytes a row, a stage
  constexpr int kChunksPerWord = 8 / D::kWords;
  const int t = threadIdx.x - kConsumerThreads;
  const uint32_t base = smem_addr(smem);
  const uint32_t ring = base + kRingOff;
  const uint32_t full = base + kBarOff;
  const uint32_t empty = full + kStages * 8;
  // this thread's rows of a stage, in ring order: stationary rows t and
  // 128 + t, moving row t (ring row 256 + t)
  const int gr[3] = {gi0 + t, gi0 + kProducerThreads + t, gj0 + t};
  const uint32_t* src[3];
  bool valid[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    valid[i] = gr[i] < n_pad;
    src[i] = words + static_cast<long long>(valid[i] ? gr[i] : 0) * w;
  }
  auto issue = [&](int s) {
    if (s < nst) {
      const uint32_t slot = ring + (s % kRing) * kRows * 16;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        copy_async<kBytes>(slot + (t + i * kProducerThreads) * 16,
                           src[i] + s * D::kWords, valid[i]);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);

  unsigned char* const row_b = smem + t * kRowBytes;  // in stage 0
  for (int s = 0; s < nst; ++s) {
    issue(s + kRing - 1);
    // every group up to stage s has landed: at most kRing - 1 pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
    const unsigned char* slot = smem + kRingOff + (s % kRing) * kRows * 16;
    const uint4 ra0 = *reinterpret_cast<const uint4*>(slot + t * 16);
    const uint4 ra1 =
        *reinterpret_cast<const uint4*>(slot + (kProducerThreads + t) * 16);
    const uint4 rb = *reinterpret_cast<const uint4*>(slot + (kBM + t) * 16);
    const uint32_t x[4] = {rb.x, rb.y, rb.z, rb.w};
    const int stage = s % kStages;
    mbar_wait(empty + stage * 8, ((s / kStages) & 1) ^ 1);
    unsigned char* dst = smem + stage * kStageBytes;
    // the stationary rows' packed words, which their consumers expand
    *reinterpret_cast<uint4*>(dst + kAOff + t * 16) = ra0;
    *reinterpret_cast<uint4*>(dst + kAOff + (kProducerThreads + t) * 16) =
        ra1;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int q = c / kChunksPerWord;
      const int r0 = 4 * (c % kChunksPerWord);
      uint32_t u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = (x[q] >> (r0 + j)) & D::kSpread;
      if (weights) {
        const uint4 wt = __ldg(weights + s * 8 + c);
        u[0] = (u[0] * D::kFill) & wt.x;
        u[1] = (u[1] * D::kFill) & wt.y;
        u[2] = (u[2] * D::kFill) & wt.z;
        u[3] = (u[3] * D::kFill) & wt.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) u[j] *= D::kOne;
      }
      *reinterpret_cast<uint4*>(row_b + stage * kStageBytes +
                                ((c ^ (t & 7)) << 4)) =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
    // the stores become visible to wgmma (the async proxy), then the
    // stage is handed over
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(full + stage * 8);
  }
}

template <class D>
__device__ __forceinline__ void consume(
    unsigned char* smem, const int* __restrict__ classes, int gi0, int gj0,
    int n, int n_pad, int tile, int threshold, int w_thresh, int nst,
    int* __restrict__ row_stats, int* __restrict__ tile_hits) {
  const int wg = threadIdx.x / 128;  // consumer warpgroup: rows 128 wg ..
  const int tc = threadIdx.x % 128;
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kBarOff;
  const uint32_t empty = full + kStages * 8;
  const uint64_t desc_b = make_desc(base);
  const int g = (tc & 31) >> 2, tq = tc & 3;
  // this thread's A rows: ra + 64 m + {0, 8} of the sub-tile, m = 0, 1
  const int ra = wg * 128 + (tc >> 5) * 16 + g;

  typename D::Acc d[2][64];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[m][i] = 0;
  uint32_t a[2][4][4];  // [m][k-step][register]
  for (int s = 0; s < nst; ++s) {
    const int stage = s % kStages;
    mbar_wait(full + stage * 8, (s / kStages) & 1);
    const unsigned char* pa = smem + stage * kStageBytes + kAOff;
#pragma unroll
    for (int m = 0; m < 2; ++m)
      a_frags<D>(*reinterpret_cast<const uint4*>(pa + (ra + 64 * m) * 16),
                 *reinterpret_cast<const uint4*>(pa + (ra + 64 * m + 8) * 16),
                 tq, a[m]);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      fence_regs(d[m]);
#pragma unroll
      for (int k = 0; k < 4; ++k) fence_regs(a[m][k]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kRowBytes / 32; ++k) {
      const uint64_t db = desc_b + ((stage * kStageBytes + k * 32) >> 4);
#pragma unroll
      for (int m = 0; m < 2; ++m) D::mma(d[m], a[m][k], db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      fence_regs(d[m]);
#pragma unroll
      for (int k = 0; k < 4; ++k) fence_regs(a[m][k]);
    }
    mbar_arrive(empty + stage * 8);  // the stage goes back to the producer
  }

  // Entry 4k + 2h + e of d[m] is row ra + 64 m + 8 h, column 8k + 2tq + e
  // of the sub-tile.
  const int* s_cls = reinterpret_cast<const int*>(smem + kClsOff);
  unsigned* s_hits = reinterpret_cast<unsigned*>(smem + kHitsOff);
  unsigned hc = 0, hs = 0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = gi0 + ra + 64 * m + 8 * h;
      const int crow = gi < n_pad ? classes[gi] : -1;
      RowAcc r = {0u, 0u, 0u, 0, 0u, 0u, 0u, 0};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * k + 2 * tq + e;
          visit(r, D::count(d[m][4 * k + 2 * h + e]), gi, gj0 + col, crow,
                s_cls[col], n, threshold, w_thresh);
        }
      }
      hc += r.co;
      hs += r.so;
      r = reduce_row<4>(r);
      if (tq == 0 && gi < n_pad)
        flush_row(row_stats + static_cast<long long>(gi) * 8, r);
    }
  }
  hc = warp_sum(hc);
  hs = warp_sum(hs);
  if ((tc & 31) == 0) {
    if (hc) atomicAdd(s_hits + 2 * wg, hc);
    if (hs) atomicAdd(s_hits + 2 * wg + 1, hs);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  // each warpgroup's 128 rows lie in one tile row, the 128 columns in one
  // tile column
  if (threadIdx.x < 4) {
    const int i0 = gi0 + (threadIdx.x >> 1) * 128;
    if (i0 < n_pad) {
      const int ti = i0 / tile, tj = gj0 / tile;
      if (ti <= tj)
        add_lane(tile_hits + 2 * tile_index(ti, tj, n_pad / tile) +
                     (threadIdx.x & 1),
                 s_hits[threadIdx.x]);
    }
  }
}

template <class D>
__global__ void __launch_bounds__(kThreads, 1)
tri_mxu_kernel(const uint32_t* __restrict__ words, int w,
               const int* __restrict__ classes,
               const int* __restrict__ subtiles, int n_pad, int tile, int n,
               int threshold, int w_thresh, const uint4* __restrict__ weights,
               int* __restrict__ row_stats, int* __restrict__ tile_hits) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int gi0 = subtiles[2 * blockIdx.x];
  const int gj0 = subtiles[2 * blockIdx.x + 1];
  const int nst = w / D::kWords;

  const uint32_t bars = smem_addr(smem) + kBarOff;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bars + i * 8, kProducerThreads);              // full
      mbar_init(bars + (kStages + i) * 8, kConsumerThreads);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int* s_cls = reinterpret_cast<int*>(smem + kClsOff);
  for (int i = threadIdx.x; i < kBN; i += kThreads)
    s_cls[i] = gj0 + i < n_pad ? classes[gj0 + i] : -1;
  if (threadIdx.x < 4)
    reinterpret_cast<unsigned*>(smem + kHitsOff)[threadIdx.x] = 0u;
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce<D>(smem, words, w, n_pad, gi0, gj0, weights, nst);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<D>(smem, classes, gi0, gj0, n, n_pad, tile, threshold, w_thresh,
               nst, row_stats, tile_hits);
  }
}

template <class D>
int launch(const void* words, int w, const void* classes, const void* subtiles,
           int n_sub, int n_pad, int tile, int n, int threshold, int w_thresh,
           const void* weights, void* row_stats, void* tile_hits,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      tri_mxu_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  tri_mxu_kernel<D><<<n_sub, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint32_t*>(words), w,
      static_cast<const int*>(classes), static_cast<const int*>(subtiles),
      n_pad, tile, n, threshold, w_thresh, static_cast<const uint4*>(weights),
      static_cast<int*>(row_stats), static_cast<int*>(tile_hits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: [n_pad, w] 32-bit words row-major, 16-byte aligned, w % 4 == 0;
// classes int32 [n_pad]; subtiles int32 [n_sub, 2]: the (gi0, gj0) row
// offsets of the 256 x 128 sub-tiles that hold a pair gi < gj < n, gi0 a
// multiple of 256 and gj0 of 128; weights: null (every column 1) or
// [w * 32] int8 (bf16 when `bf16` is nonzero) in the in-word order of the
// unpack, 16-byte aligned; row_stats int32 [n_pad, 8] and tile_hits int32
// [nT, 2] over the row-major upper triangle of (n_pad / tile)^2 tile
// pairs, both zeroed by the caller. tile must be a multiple of 128
// dividing n_pad. Launches on `stream` and returns cudaGetLastError().
extern "C" int ukc_tri_mxu_sweep(const void* words, int w,
                                 const void* classes, const void* subtiles,
                                 int n_sub, int n_pad, int tile, int n,
                                 int threshold, int w_thresh,
                                 const void* weights, int bf16,
                                 void* row_stats, void* tile_hits,
                                 void* stream) {
  if (n_sub == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<Bf16Dot>(words, w, classes, subtiles, n_sub, n_pad, tile, n,
                           threshold, w_thresh, weights, row_stats, tile_hits,
                           s);
  return launch<Int8Dot>(words, w, classes, subtiles, n_sub, n_pad, tile, n,
                         threshold, w_thresh, weights, row_stats, tile_hits, s);
}
