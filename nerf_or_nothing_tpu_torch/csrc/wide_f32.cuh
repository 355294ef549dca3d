// The wide f32 route of every kernel (render_level.cu, mlp_fwd.cu, and the
// forwards of train_level.cu, train_level_twopass.cu and mlp_bwd.cu; the
// backward is wide_train.cuh's launch_wide_backward_f32): net_width a
// multiple of 32 from 288 up, with no ceiling but the card's memory
// (net_width_condition a multiple of 32 up to net_width), where the narrow
// f32 kernels' [64, W] activation tile no longer fits a block (256 KB at
// W=1024 of the 227 KB); below 288 where the narrow route's shared memory
// does not hold the config (fused_level.takes_wide).
//
// Replaces, at these widths in f32, the same TPU kernels as its callers:
// nerf_or_nothing_tpu/kernels/fused_level.py::_render_kernel (render),
// ::_level_kernel and ::_level_kernel_twopass (train), fused_mlp.py::
// _fwd_kernel (mlp_fwd) and ::_bwd_kernel (mlp_bwd).
//
// Bound: the products, at the 3xTF32 rate (495 / 3 = 165 TFLOP/s of f32
// work on an H100 SXM): one row of a W=1024 layer is 2 x 1024^2 FLOP
// against 8 KB of f32 activations in and out, 256 FLOP a byte, above the
// ~49 FLOP/B ridge of that rate.
//
// The launch sequence is the bf16 wide route's (wide_forward.cuh): every
// activation and masked g in global memory, in f32, one launch of the
// layer GEMM wide_gemm_f32_kernel<kKind> a layer product: out =
// epilogue(A @ B), A one or two row-major f32 activations (the skip
// layers' [h | x]), B the product's slabs of a packed stream that the
// packer splits once a step into hi = rna_tf32(w) and lo = rna_tf32(w -
// hi), hi's whole stream then lo's (fused_level.pack_params_wf: the
// forward's products after pack_params' layout, from which the heads and
// the direction rows are still read; pack_params_wft: the g-chain's W^T,
// at pack_params_t's offsets; pack_params_wfx: dX's W_x^T, at
// pack_params_tx's), each slab [N rows x 32 k-values] in the 128-byte
// swizzle: the K-major operand that TF32 wgmma takes (it has no
// transposed form). The GEMM is wide_gemm.cuh's design with 3xTF32
// products:
//  - one persistent block an SM walks the output tiles, the column
//    blocks of a row band back to back (A from HBM
//    once, B from L2);
//  - a producer thread (warpgroup 2, its registers lowered by setmaxnreg)
//    fills a ring of kF32Stages stages, each 32 k-values of A by TMA (a
//    tensor map a part, 128-byte swizzle, zeros past M and past the
//    part's ka) and the tile's 128 rows of B hi and of B lo by two bulk
//    copies, completion on full / empty mbarriers, no block-wide barrier
//    in the k-loop;
//  - two consumer warpgroups (rows 0-63 and 64-127 of the tile) take each
//    k8 step in the parent's order: A's fragment from shared memory into
//    registers, split there (split_tf32: wgmma would truncate an f32
//    operand it read from shared memory), then three wgmma m64n128k8 with
//    A from registers, a_lo b_hi (overwriting the step's sums), a_hi b_lo
//    and a_hi b_hi, and the step's sums added to the f32 accumulator
//    round-to-nearest (level_common.cuh's note: summed in the tensor core
//    over a layer, its truncation flips ReLU masks against the plain
//    version). A warpgroup waits for its step's products before its adds,
//    so the two warpgroups' steps interleave on the tensor cores;
//  - tiles of 128 rows x kF32BN = 128 columns (a partial column block
//    where 128 does not divide N): a consumer holds two sets of 64 sums
//    (the accumulator and a k8 step's), and the kernel's 384 threads leave
//    it 168 registers, which blocks of 144 and 160 overran, and which
//    ptxas spilled at 96 too (12-68 bytes);
//  - the epilogue is a compile-time kind (no runtime branch near the
//    wgmma), stored from the registers; each output element is one
//    thread's: no atomics, fixed sums, so two launches on the same inputs
//    give the same bits:
//     - kF32Fwd: the first view layer's per-ray direction term, the bias,
//       ReLU;
//     - kF32Chain: the density head's term (into the trunk, over cd
//       channels), then zero where the layer below's activation is not > 0;
//     - kF32Dx: mlp_bwd's dX, the deeper x layers' sum in out plus this
//       term.
// WideF32Route runs wide_forward.cuh's drivers (the features and
// direction-term kernels are theirs, instantiated in f32) on this GEMM and
// on wide_head_f32_kernel, the heads as one warp a row from pack_params'
// transposed head rows [C, K], 8 channels a launch.

#pragma once

#include "wide_forward.cuh"

// B of the f32 GEMM is the hi / lo slab streams (csrc/wide_gemm_f32.cu
// reads this to build against a version whose B is row-major).
#define WIDE_F32_SLABS 1

namespace {

constexpr int kF32SlabK = 32;                      // k-values of a slab row: 128 bytes of f32
constexpr int kF32ATile = kWideRows * kSlabBytes;  // A of a stage: 128 rows x 32 f32
constexpr int kF32Stages = 4;
constexpr int kF32BN = 128;  // columns of an output tile

enum { kF32Fwd = 0, kF32Chain = 1, kF32Dx = 2 };

// One layer product and its epilogue (wide_gemm_f32_kernel).
struct WideGemmF32 {
  const float* a0;     // A, first part: [M, lda0], columns [0, ka0) read
  const float* a1;     // second part (layer 0's and the skip layers' x rows), or null
  int lda0, ka0, lda1, ka1;
  const float* b;      // B hi: the product's cdiv(ka0, 32) slabs, then cdiv(ka1, 32), each
                       // [N rows x 32] in the 128-byte swizzle
  const float* blo;    // B lo, laid out as b
  int N;               // columns of the product (a multiple of 16)
  long long M;         // rows
  const float* bias;   // kF32Fwd: [N]
  const float* dc;     // kF32Fwd, first view layer: [rays, N], ray = row / S
  int S;
  const float* act;    // kF32Chain: the layer below's activation [M, N]
  const float* gden;   // kF32Chain into the trunk: the density cotangents [M, cd]
  const float* wden;   // and W_den^T [cd, N]
  int cd;
  float* out;          // [M, N]; kF32Dx: [M, ldo], columns < ldo
  int ldo, accum;      // kF32Dx: out already holds the deeper x layers' sum
};

// A stage: A [128 rows x 32], then B hi and B lo [kF32BN rows x 32].
constexpr int kF32StageBytes = kF32ATile + 2 * kF32BN * kSlabBytes;
// The ring (192 KB), the barriers, 1 KB of alignment.
constexpr int kF32Smem = 1024 + kF32Stages * kF32StageBytes + 16 * kF32Stages;

// ---- wgmma m64n128k8, TF32 in, f32 sums in d[0 : 64] ----
// d += a b: A from registers (a: the m16n8k8 fragment layout of each
// warp's 16 rows), B K-major in shared memory with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The first pass of a k8 step: d = a b (scale-d 0), d written, not read,
// so the step's sums hold no register outside the step (freeing them for
// the epilogue).
__device__ __forceinline__ void wgmma_tf32_first(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// Keep a wgmma's A registers live up to here (after the wait for its
// products), so that nothing written in between takes their places.
__device__ __forceinline__ void keep_a(uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(hi[e]), "+r"(lo[e]));
}

// The A fragment of k8 step kk of a stage's 64 rows at a (32 f32 a row in
// the 128-byte swizzle: 16-byte chunk c of row r at c ^ (r & 7)): rows rt
// and rt + 8, columns 8 kk + tq and + 4, in level_common.cuh's
// load_a_split order.
__device__ __forceinline__ void load_a_f32(const unsigned char* a, int rt, int tq, int kk,
                                           float* v) {
  const unsigned char* r = a + rt * kSlabBytes + 4 * tq;
  const int c0 = ((2 * kk) ^ (rt & 7)) << 4, c1 = ((2 * kk + 1) ^ (rt & 7)) << 4;
  v[0] = *reinterpret_cast<const float*>(r + c0);
  v[1] = *reinterpret_cast<const float*>(r + 8 * kSlabBytes + c0);
  v[2] = *reinterpret_cast<const float*>(r + c1);
  v[3] = *reinterpret_cast<const float*>(r + 8 * kSlabBytes + c1);
}

// One tile's epilogue by thread t of a consumer warpgroup, rows r0 ..
// r0 + 63 and columns n0 .. n0 + 127 from the m64n128 fragment acc (row
// (t >> 5) * 16 + ((t & 31) >> 2) + 8h, columns 8j + 2(t & 3) + {0, 1} in
// acc[4j + 2h + {0, 1}]), two columns a store, in rounds of kR column
// groups whose column terms (the bias; the mask and the density term) are
// loaded all at once before the round's stores (one at a time, the loads
// took ~20% of the kernel); a compiler barrier ends each round, so that
// no round's loads are hoisted above an earlier round's stores (all of a
// tile's in flight spill). The bias is read one float at a time: a view
// layer's starts at an odd offset (after the density head's Cd biases).
template <int kKind>
__device__ __forceinline__ void wide_f32_epilogue(const WideGemmF32& g, const float* acc,
                                                  long long r0, int n0, int t) {
  constexpr int kJ = kF32BN / 8;
  constexpr int kR = 8;
  const int qd = t & 3, rt = (t >> 5) * 16 + ((t & 31) >> 2);
  const int c0 = n0 + 2 * qd;  // the column of j = 0; N is a multiple of 16, so
                               // col < N has col + 1 < N too
#pragma unroll
  for (int j0 = 0; j0 < kJ; j0 += kR) {
    if constexpr (kKind == kF32Fwd) {
      float2 b[kR];
#pragma unroll
      for (int jj = 0; jj < kR; ++jj) {
        const int col = c0 + 8 * (j0 + jj);
        b[jj] = j0 + jj < kJ && col < g.N
                    ? make_float2(__ldg(g.bias + col), __ldg(g.bias + col + 1))
                    : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rt + 8 * h;
        if (row >= g.M) continue;
        const float* dr = g.dc ? g.dc + (row / g.S) * g.N : nullptr;
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          const int j = j0 + jj, col = c0 + 8 * j;
          if (j >= kJ || col >= g.N) continue;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          // the plain version's (acc + dc) + b, then ReLU
          if (dr) {
            const float2 d = *reinterpret_cast<const float2*>(dr + col);
            v0 += d.x;
            v1 += d.y;
          }
          *reinterpret_cast<float2*>(g.out + row * g.N + col) =
              make_float2(fmaxf(v0 + b[jj].x, 0.0f), fmaxf(v1 + b[jj].y, 0.0f));
        }
      }
    } else if constexpr (kKind == kF32Chain) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rt + 8 * h;
        if (row >= g.M) continue;
        float2 a[kR], d[kR];
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          const int col = c0 + 8 * (j0 + jj);
          a[jj] = j0 + jj < kJ && col < g.N
                      ? *reinterpret_cast<const float2*>(g.act + row * g.N + col)
                      : make_float2(0.0f, 0.0f);
          d[jj] = make_float2(-0.0f, -0.0f);
        }
        if (g.gden) {
          // g_den @ W_den^T: an f32 sum over the cd channels in order, from -0
          for (int k = 0; k < g.cd; ++k) {
            const float gd = g.gden[row * g.cd + k];
            const float* w = g.wden + (long long)k * g.N;
#pragma unroll
            for (int jj = 0; jj < kR; ++jj) {
              const int col = c0 + 8 * (j0 + jj);
              if (j0 + jj >= kJ || col >= g.N) continue;
              const float2 wv = *reinterpret_cast<const float2*>(w + col);
              d[jj].x = fmaf(gd, wv.x, d[jj].x);
              d[jj].y = fmaf(gd, wv.y, d[jj].y);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          const int j = j0 + jj, col = c0 + 8 * j;
          if (j >= kJ || col >= g.N) continue;
          // g plus the density term (-0 without one adds nothing), then
          // the mask of the layer below
          const float v0 = acc[4 * j + 2 * h] + d[jj].x, v1 = acc[4 * j + 2 * h + 1] + d[jj].y;
          *reinterpret_cast<float2*>(g.out + row * g.N + col) =
              make_float2(a[jj].x > 0.0f ? v0 : 0.0f, a[jj].y > 0.0f ? v1 : 0.0f);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rt + 8 * h;
        if (row >= g.M) continue;
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          // dX: the first (deepest) x layer's term added to 0, each later
          // one to the sum so far (the narrow chain's X += acc)
          const int j = j0 + jj, col = c0 + 8 * j;
          if (j >= kJ || col >= g.N || col >= g.ldo) continue;  // past ldo: W_x^T's zeros
          float* o = g.out + row * g.ldo + col;
          o[0] = (g.accum ? o[0] : 0.0f) + acc[4 * j + 2 * h];
          if (col + 1 < g.ldo) o[1] = (g.accum ? o[1] : 0.0f) + acc[4 * j + 2 * h + 1];
        }
      }
    }
    asm volatile("" ::: "memory");  // the round's stores before the next round's loads
  }
}

// The persistent GEMM: block b takes tiles b, b + gridDim.x, ... of
// ceil(M / 128) row bands by nb = ceil(N / 128) column blocks, tile t at
// row band t / nb and column block t % nb. ta0 / ta1: the tensor maps of
// a0 / a1 (ta1 = ta0 when there is no a1). A stage: A [128 rows x 32]
// (consumer warpgroup w reads rows 64 w ..), then B hi and B lo [128 rows
// x 32] each.
template <int kKind>
__global__ void __launch_bounds__(kWideThreads, 1)
    wide_gemm_f32_kernel(__grid_constant__ const CUtensorMap ta0,
                         __grid_constant__ const CUtensorMap ta1, const WideGemmF32 g) {
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  constexpr int BN = kF32BN, kStage = kF32StageBytes;
  unsigned char* base = align1024(smem_f32);
  const uint32_t full = smem_u32(base + kF32Stages * kStage);
  const uint32_t empty = full + 8 * kF32Stages;
  const int nb = (g.N + BN - 1) / BN;
  const long long tiles = (g.M + kWideRows - 1) / kWideRows * nb;
  const int ns0 = cdiv(g.ka0, kF32SlabK);
  const int nk = ns0 + (g.a1 ? cdiv(g.ka1, kF32SlabK) : 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= 256) {  // the producer warpgroup: thread 256 copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 256) return;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (int)(tile / nb) * kWideRows;
      const int n0 = (int)(tile % nb) * BN;
      const int bbytes = min(BN, g.N - n0) * kSlabBytes;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the consumers released the slot
        const uint32_t bar = full + 8 * stage, dst = smem_u32(base + stage * kStage);
        mbar_expect_tx(bar, kF32ATile + 2 * bbytes);
        if (kt < ns0)
          tma_load_2d(dst, &ta0, kt * kF32SlabK, m0, bar);
        else
          tma_load_2d(dst, &ta1, (kt - ns0) * kF32SlabK, m0, bar);
        const long long boff = ((long long)kt * g.N + n0) * kF32SlabK;
        bulk_copy(dst + kF32ATile, g.b + boff, bbytes, bar);
        bulk_copy(dst + kF32ATile + BN * kSlabBytes, g.blo + boff, bbytes, bar);
        advance(stage, phase, kF32Stages);
        if constexpr (kKind == kF32Chain) {
          // the tile's rows of the layer below's activation, which its
          // epilogue reads for the mask, into L2 while the products run
          if (kt == (nk > 1 ? 1 : 0))
            for (int r = m0; r < m0 + kWideRows && r < g.M; ++r)
              prefetch_l2(g.act + (long long)r * g.N + n0, bbytes / (kSlabBytes / 4));
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int rt = (t >> 5) * 16 + ((t & 31) >> 2), tq = t & 3;
  float acc[BN / 2], part[BN / 2];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = tile / nb * kWideRows;
    const int n0 = (int)(tile % nb) * BN;
    zero_acc<BN>(acc);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const unsigned char* st = base + stage * kStage;
      const unsigned char* a = st + wg * (kF32ATile / 2);
      const uint32_t bh = opaque(smem_u32(st + kF32ATile)), bl = bh + BN * kSlabBytes;
      float v[4];
      load_a_f32(a, rt, tq, 0, v);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
        wgmma_fence();
        wgmma_tf32_first(part, lo, sdesc(bh + kk * 32));
        wgmma_tf32(part, hi, sdesc(bl + kk * 32));
        wgmma_tf32(part, hi, sdesc(bh + kk * 32));
        wgmma_commit();
        if (kk < 3) load_a_f32(a, rt, tq, kk + 1, v);
        wgmma_wait<0>();
        keep_a(hi, lo);
        fence_acc<BN / 2>(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
      // the stage's products and A reads are done: release it
      if (t == 0) mbar_arrive(empty + 8 * stage);
      advance(stage, phase, kF32Stages);
    }
    wide_f32_epilogue<kKind>(g, acc, m0 + wg * 64, n0, t);
  }
}

// The tensor map of an f32 matrix [M, ld], columns [0, cols) (a read past
// them or past M gives zeros), in boxes of 32 columns x kWideRows rows in
// the 128-byte swizzle: A of a stage as load_a_f32 reads it; false where
// TMA cannot take it (a row stride or base that is not a multiple of 16
// bytes).
inline bool wide_f32_map(CUtensorMap* map, const float* a, int ld, int cols, long long M) {
  const WideEncodeTiled enc = wide_encode_tiled();
  if (!enc || !a || !aligned16(a) || ld % 4 || cols < 1 || cols > ld) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kF32SlabK, (cuuint32_t)kWideRows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// One layer product with the epilogue kKind: out [M, N] in tiles of 128
// rows x kF32BN columns (the last column block partial where kF32BN does
// not divide N), one persistent block an SM.
template <int kKind>
inline cudaError_t launch_wide_gemm_f32(const WideGemmF32& g, cudaStream_t st) {
  if (g.M <= 0) return cudaSuccess;
  CUtensorMap t0, t1;
  if (!wide_f32_map(&t0, g.a0, g.lda0, g.ka0, g.M) ||
      (g.a1 && !wide_f32_map(&t1, g.a1, g.lda1, g.ka1, g.M)) || !aligned16(g.b) ||
      !aligned16(g.blo) || g.N < 16 || g.N % 16 || (kKind == kF32Chain && !aligned16(g.act)))
    return cudaErrorInvalidValue;
  if (!g.a1) t1 = t0;
  cudaError_t err = cudaFuncSetAttribute(wide_gemm_f32_kernel<kKind>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long tiles = (g.M + kWideRows - 1) / kWideRows * cdiv(g.N, kF32BN);
  wide_gemm_f32_kernel<kKind>
      <<<(unsigned)(tiles < sms ? tiles : sms), kWideThreads, kF32Smem, st>>>(t0, t1, g);
  return cudaGetLastError();
}

// Elements of one copy (hi or lo) of pack_params_wft's chain slabs (the
// length of pack_params_t, whose offsets wt_off they keep) and of
// pack_params_wfx's dX slabs (pack_params_tx's, wtx_off).
inline long long wide_f32_chain_len(const Params& p) {
  return (long long)(p.D - 1) * p.W * p.W + (long long)p.W * p.Wc +
         (long long)(p.Dc - 1) * p.Wc * p.Wc;
}

inline long long wide_f32_dx_len(const Params& p) {
  return (long long)(1 + (p.D - 1) / p.skip) * p.W * p.KX;
}

// out[row * ld + c] = A[row, :K] . w[c, :K] + b[c] for c < nc (1-8), one
// warp a row: a head as pack_params stores it (transposed, [nc, K]),
// staged kWideHeadK k-values at a time as wide_head_kernel stages its
// own (each lane's k-values 4 lane + 128 i, ascending across the chunks):
// the same bits at any chunking.
__global__ void __launch_bounds__(kThreads) wide_head_f32_kernel(const float* A, int K,
                                                                 long long M, const float* w,
                                                                 const float* b, float* out,
                                                                 int ld, int nc) {
  __shared__ float ws[8 * kWideHeadK];
  const bool once = K <= kWideHeadK;
  auto stage = [&](int kc, int kn) {
    for (int idx = threadIdx.x; idx < nc * kn; idx += kThreads) {
      const int c = idx / kn, k = idx - c * kn;
      ws[c * kWideHeadK + k] = w[(long long)c * K + kc + k];
    }
  };
  if (once) {
    stage(0, K);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long row0 = (long long)blockIdx.x * (kThreads / 32); row0 < M;
       row0 += (long long)gridDim.x * (kThreads / 32)) {
    const long long row = row0 + warp;
    const bool live = row < M;
    const float* a = A + row * K;
    float s[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = 0.0f;
    for (int kc = 0; kc < K; kc += kWideHeadK) {
      const int kn = min(kWideHeadK, K - kc);
      if (!once) {
        __syncthreads();  // every warp's reads of the previous chunk are done
        stage(kc, kn);
        __syncthreads();
      }
      for (int k0 = lane * 4; live && k0 < kn; k0 += 128) {
        const float4 v = *reinterpret_cast<const float4*>(a + kc + k0);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c < nc) s[c] = fmaf(e[q], ws[c * kWideHeadK + k0 + q], s[c]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c >= nc) break;
      const float v = warp_sum(s[c]);
      if (lane == 0) out[row * ld + c] = v + b[c];
    }
  }
}

inline cudaError_t launch_wide_head_f32(const float* A, int K, long long M, const float* w,
                                        const float* b, float* out, int ld, int nc,
                                        cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  const long long want = (M + kThreads / 32 - 1) / (kThreads / 32);
  wide_head_f32_kernel<<<(unsigned)(want < 8192 ? want : 8192), kThreads, 0, st>>>(
      A, K, M, w, b, out, ld, nc);
  return cudaGetLastError();
}

// The f32 route's parts of wide_forward.cuh's drivers (wide_forward,
// launch_forward_wide; wide_train.cuh's launch_train_wide): the layer
// products as wide_gemm_f32_kernel on pack_params_wf's slabs, which start
// after pack_params' layout (base: its length) with hi's stream (len
// elements) then lo's; in each, trunk layer i (its h slabs for i > 0,
// then its x slabs for layer 0 and the skip layers), then the view layers
// (the first one's h rows); the heads and the direction rows from
// pack_params' layout at init_params' offsets.
struct WideF32Route {
  using T = float;
  static constexpr bool kBf16 = false;
  std::vector<long long> trunk, view;
  long long base = 0, len = 0;
  bool init(const Params& p) {
    const int nh = cdiv(p.W, kF32SlabK), nc = cdiv(p.Wc, kF32SlabK), nx = cdiv(p.KX, kF32SlabK);
    trunk.resize(p.D);
    view.resize(p.Dc);
    long long off = 0;
    for (int i = 0; i < p.D; ++i) {
      trunk[i] = off;
      off += (long long)((i == 0 ? 0 : nh) + ((i == 0 || i % p.skip == 0) ? nx : 0)) * p.W *
             kF32SlabK;
    }
    view[0] = off;
    off += (long long)nh * p.Wc * kF32SlabK;
    for (int j = 1; j < p.Dc; ++j) {
      view[j] = off;
      off += (long long)nc * p.Wc * kF32SlabK;
    }
    len = off;
    base = p.w_rgb + (long long)p.Cr * p.Wc;
    return true;
  }
  long long trunk_off(const Params&, int i) const { return trunk[i]; }
  long long view_off(const Params&, int j) const { return view[j]; }
  const float* dir(const Params& p) const { return static_cast<const float*>(p.w) + p.w_v0_bot; }
  // out [M, N] = ReLU(a0 @ B + a1 @ B_x + dc + bias), a0 [M, k0], a1 the
  // features of an x layer (or null), B's slabs at w_off in the streams.
  cudaError_t fwd(const Params& p, const float* a0, int k0, const float* a1, int N, long long M,
                  long long w_off, const float* bias, const float* dc, float* out,
                  cudaStream_t st) const {
    const float* w = static_cast<const float*>(p.w) + base + w_off;
    WideGemmF32 g{};
    g.a0 = a0; g.lda0 = g.ka0 = k0;
    if (a1) { g.a1 = a1; g.lda1 = g.ka1 = p.KX; }
    g.b = w; g.blo = w + len; g.N = N; g.M = M;
    g.bias = bias; g.S = p.S; g.dc = dc; g.out = out;
    return launch_wide_gemm_f32<kF32Fwd>(g, st);
  }
  // The rgb head (rgb) or the density head on A [M, K] to out (row stride
  // ld), a launch for each group of 8 channels (rows c0 .. of [C, K]).
  template <int kHeads>
  cudaError_t head(const Params& p, bool rgb, const float* A, long long M, float* out, int ld,
                   cudaStream_t st) const {
    const int C = rgb ? p.Cr : p.Cd, K = rgb ? p.Wc : p.W;
    const float* w = static_cast<const float*>(p.w) + (rgb ? p.w_rgb : p.w_den);
    const float* b = p.b + (rgb ? p.b_rgb : p.b_den);
    for (int c0 = 0; c0 < C; c0 += 8) {
      const cudaError_t err = launch_wide_head_f32(A, K, M, w + (long long)c0 * K, b + c0,
                                                   out + c0, ld, C - c0 < 8 ? C - c0 : 8, st);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
};

// The last view layer's masked g: round-free g_rgb @ W_rgb^T (f32, the Cr
// channels in order; wr: pack_params' rgb head rows [Cr, Wc]), zero where
// its activation is not > 0.
__global__ void wide_rgb_chain_f32_kernel(const float* g_rgb, const float* wr, const float* act,
                                          float* out, long long N, int Wc, int Cr) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < N * Wc;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / Wc;
    const int n = (int)(idx - row * Wc);
    float s = 0.0f;
    for (int k = 0; k < Cr; ++k) s = fmaf(g_rgb[row * Cr + k], wr[k * Wc + n], s);
    out[idx] = act[idx] > 0.0f ? s : 0.0f;
  }
}

// g_ray[ray, :] = the f32 sum in row order of the ray's rows of the first
// view layer's masked g (gv: [R * S, Wc] f32), a thread a column.
__global__ void g_ray_f32_kernel(const float* gv, float* g_ray, int S, int Wc) {
  const float* g = gv + (long long)blockIdx.x * S * Wc + threadIdx.x;
  float s = 0.0f;
#pragma unroll 8
  for (int r = 0; r < S; ++r) s += g[(long long)r * Wc];
  g_ray[(long long)blockIdx.x * Wc + threadIdx.x] = s;
}

// dD[ray, f] = g_ray[ray, :] . W_d[f, :] (f32, FMA in column order; wd:
// pack_params' direction rows [Fd, Wc]), one warp a ray.
__global__ void wide_dd_f32_kernel(const float* g_ray, const float* wd, float* dd, int R, int Wc,
                                   int Fd) {
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= R) return;
  const float* g = g_ray + (long long)ray * Wc;
  for (int f = threadIdx.x & 31; f < Fd; f += 32) {
    float s = 0.0f;
    for (int n = 0; n < Wc; ++n) s = fmaf(g[n], wd[f * Wc + n], s);
    dd[(long long)ray * Fd + f] = s;
  }
}

}  // namespace
