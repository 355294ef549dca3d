// The wide route's bf16 layer GEMM (wide_gemm_kernel), on which
// wide_forward.cuh's forward, wide_train.cuh's g-chain and mlp_bwd.cu's dX
// run every layer product: out = epilogue(A @ B) for A one or two
// row-major bf16 activations [M, ka] (the skip layers' [h | x]) and B the
// layer's slabs of a packed stream (fused_level.pack_params_wg for the
// forward, pack_params_wgt / pack_params_wgx for the g-chain and dX: W^T
// rows of 64 k-values in the 128-byte swizzle, [N rows x 64] a slab, the
// K-major operand wgmma reads).
//
// Bound: the products. At W = 1024 a row of a layer is 2 x 1024^2 FLOP
// against 4 KB of activations in and out (512 FLOP a byte, above the
// card's ~295 FLOP/B ridge), so the kernel is built to keep the tensor
// cores fed:
//  - one persistent block an SM walks the output tiles of 128 rows x BN
//    columns, the column blocks of a row band back to back, so that the
//    132 blocks in flight read ~33 row bands of A (8.6 MB at K = 1024)
//    and the whole of B from L2, and A comes from HBM once;
//  - a producer thread (warpgroup 2, its registers lowered by setmaxnreg)
//    fills a ring of stages (64 k-values of A and B each) and runs ahead
//    into the next tile while the consumers store this one: A by TMA
//    (cp.async.bulk.tensor, a tensor map a part with the 128-byte swizzle,
//    whose out-of-bounds zeros stand for the rows past M and the columns
//    past ka), B as one bulk copy of the block's BN slab rows; completion
//    on full / empty mbarriers, no block-wide barrier in the k-loop;
//  - two consumer warpgroups (rows 0-63 and 64-127 of the tile) issue the
//    m64nBNk16 wgmma of each stage, four k16 steps in order, over a0's
//    slabs and then a1's (the parent kernel's k-order: the same sums, the
//    same bits), and release a stage once its products are done;
//  - the epilogue is a compile-time kind (kKind), so no runtime branch
//    sits near the wgmma (ptxas serialises wgmma across such branches,
//    C7515): the forward's (direction term, bias, ReLU, round), the
//    g-chain's (round, the density head's term; the mask of the layer
//    below's activation > 0), mlp_bwd's density term over cd channels
//    (kWideChainHeads) and dX (kWideDx). Each warpgroup loads a round's
//    operands all at once (the chain's mask prefetched into L2 by the
//    producer), stages its 64 rows in 64-column rounds in shared memory
//    and stores them by TMA, which runs on behind the
//    warpgroup's next round or tile (loads one at a time and stores from
//    the registers took ~40% of the kernel); dX, whose rows are
//    location_features wide (not always 16-byte aligned), stores from the
//    registers;
//  - BN (a multiple of 16 from 128 to 256) is picked per N for the least
//    padded work (wide_bn: 288 in two blocks of 144, 1056 in six of 176,
//    1024 in four of 256).
// The tensor maps are kernel parameters (__grid_constant__), encoded on
// the host at each launch by libcuda's cuTensorMapEncodeTiled (found
// with cudaGetDriverEntryPoint, so the build needs no -lcuda), so a launch
// captured in a CUDA graph holds its maps by value.
// At W = 1024 and 2^18 rows the GEMM runs at ~610 TFLOP/s on an H100
// 80GB HBM3 at 700 W (chip_smoke.py's wide_gemm phase; PERF.md).

#pragma once

#include <cuda.h>

#include "forward_wg.cuh"

namespace {

constexpr int kWideThreads = 384;  // consumers 0-255 (64 rows each), producer 256
constexpr int kWideRows = 128;
constexpr int kWideEpiCols = 64;   // columns of one round of a warpgroup's epilogue
constexpr int kWideBoxCols = 16;   // columns of one TMA store box (64 rows of 32 bytes)
constexpr int kWideBoxBytes = 64 * kWideBoxCols * 2;
// a warpgroup's two staging buffers, each a round's boxes
constexpr int kWideEpiBytes = 2 * kWideEpiCols / kWideBoxCols * kWideBoxBytes;
constexpr int kWideMaxStages = 6;

enum { kWideFwd = 0, kWideChain = 1, kWideChainHeads = 2, kWideDx = 3 };

// One layer product and its epilogue.
struct WideGemm {
  const bf16* a0;      // A, first part: [M, lda0], columns [0, ka0) read, ns0 slabs of 64
  const bf16* a1;      // second part (the features of layer 0's and the skip layers' x
                       // rows), ns1 slabs (0: none)
  int lda0, ka0, ns0, lda1, ka1, ns1;
  const bf16* b;       // the product's ns0 + ns1 slabs, each [N rows x 64] swizzled
  int N;               // columns of the product and of out
  long long M;         // rows
  int kind;            // launch_wide_gemm: kWideFwd or kWideChain
  const float* bias;   // forward: [N]
  const float* dc;     // forward, first view layer: [rays, N] f32, ray = row / S
  int S;
  const bf16* act;     // chain: the layer below's activation [M, N]; g is kept where > 0
  const float* gden;   // chain into the trunk: the density cotangent [M] (one channel)
  const bf16* wden;    // its weights W_den^T [1, N]
  bf16* out;           // [M, N]
};

// A product with mlp_bwd's epilogues: g's operands and the epilogue's own
// fields.
struct WideGemmMlp {
  WideGemm g;
  int cd;              // kWideChainHeads: g.gden is [M, cd], g.wden [cd, N]
  int ldo;             // kWideDx: g.out is [M, ldo] (location_features), columns < ldo
  int accum;           // kWideDx: g.out already holds the deeper x layers' sum
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// m64nNk16 wgmma at the column blocks of 144, 176, 208 and 240, beside
// forward_wg.cuh's multiples of 32 (the same operands and sums).
template <>
__device__ __forceinline__ void wgmma<144>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<176>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<208>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<240>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, %120, %121, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A 2-D tile of a tensor map into shared memory at dst: the box at
// (column k0, row r0), completing on the mbarrier bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k0, int r0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r0), "r"(bar)
      : "memory");
}

// A box of shared memory at src to the tensor map's box at (column c0,
// row r0) (the parts past the map's bounds are not written).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(r0), "r"(src)
      : "memory");
}

// bytes of global memory at src into L2 (a hint; no completion to wait on).
__device__ __forceinline__ void prefetch_l2(const void* src, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

template <int BN>
__host__ __device__ constexpr int wide_stage_bytes() {
  return 2 * kTileSlab + BN * kSlabBytes;
}

// Stages of the ring at BN: as many as fit beside the epilogue's staging
// (4 at BN = 256, 5 at 144-176, 6 at 128).
template <int BN>
__host__ __device__ constexpr int wide_stages() {
  constexpr int n = (232448 - 1024 - 2 * kWideEpiBytes - 16 * kWideMaxStages) /
                    wide_stage_bytes<BN>();
  return n < kWideMaxStages ? n : kWideMaxStages;
}

template <int BN>
__host__ __device__ constexpr int wide_gemm_smem() {
  return 1024 + wide_stages<BN>() * wide_stage_bytes<BN>() + 2 * kWideEpiBytes +
         16 * wide_stages<BN>();
}

// The forward's epilogue of two columns (n, n + 1) of one row: the
// direction term of the row's ray (dr: its row of dc, or null), the bias
// (b0, b1), ReLU, rounded to bf16 (the plain version's (acc + dc) + b).
__device__ __forceinline__ uint32_t wide_fwd_pair(const float* dr, int n, float b0, float b1,
                                                  float v0, float v1) {
  if (dr) {
    v0 += dr[n];
    v1 += dr[n + 1];
  }
  v0 += b0;
  v1 += b1;
  return relu_bf16x2(v0, v1);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float v0, float v1) {
  const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&o);
}

// The g-chain's epilogue of two columns before the mask: g = round(acc),
// plus (into the trunk, den) round(gd w) with gd the row's rounded g_den
// and (w0, w1) W_den^T's columns, added, rounded to bf16.
__device__ __forceinline__ uint32_t wide_chain_pair(bool den, float gd, float w0, float w1,
                                                    float v0, float v1) {
  v0 = round_bf(v0);
  v1 = round_bf(v1);
  if (den) {
    v0 = v0 + round_bf(gd * w0);
    v1 = v1 + round_bf(gd * w1);
  }
  return bf16x2_bits(v0, v1);
}

// kWideChainHeads' epilogue of two columns before the mask: the density
// term round(round(g_den) . w_den) an f32 sum over the cd channels in order
// (from -0, so one channel's term is its product exactly, sign of zero
// included).
__device__ __forceinline__ uint32_t wide_chain_heads_pair(const WideGemmMlp& m, long long row,
                                                          int n, float v0, float v1) {
  const WideGemm& g = m.g;
  v0 = round_bf(v0);
  v1 = round_bf(v1);
  float t0 = -0.0f, t1 = -0.0f;
  for (int k = 0; k < m.cd; ++k) {
    const float gd = round_bf(g.gden[row * m.cd + k]);
    const bf16* w = g.wden + (long long)k * g.N + n;
    t0 = fmaf(gd, __bfloat162float(w[0]), t0);
    t1 = fmaf(gd, __bfloat162float(w[1]), t1);
  }
  v0 = v0 + round_bf(t0);
  v1 = v1 + round_bf(t1);
  return bf16x2_bits(v0, v1);
}

// kWideDx's epilogue of two columns (n, n + 1 < ldo): t = round(acc), and
// unless this is the first (deepest) x layer, t = round(out + t), with out
// the sum of the deeper x layers' terms; each element is one thread's.
__device__ __forceinline__ void wide_dx_pair(const WideGemmMlp& m, long long row, int n,
                                             float v0, float v1) {
  if (n >= m.ldo) return;  // zero-padded columns of W_x^T
  v0 = round_bf(v0);
  v1 = round_bf(v1);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(m.g.out + row * m.ldo + n);
  if (m.accum) {
    const float2 s = __bfloat1622float2(*o);
    v0 = s.x + v0;
    v1 = s.y + v1;
  }
  *o = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores but the last group have read their shared
// memory.
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// This thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One tile's epilogue by consumer warpgroup wg (thread t of it), rows
// r0 .. r0 + 63 and columns n0 .. n0 + BN - 1 of the product from the
// m64nBN fragment acc (row (t >> 5) * 16 + ((t & 31) >> 2) + 8h, columns
// 8j + 2(t & 3) + {0, 1} in acc[4j + 2h + {0, 1}]). Each round of
// kWideEpiCols columns loads its columns' bias or W_den^T first, all at
// once, then stages its values in one of the warpgroup's two buffers as
// boxes of 64 rows x kWideBoxCols columns (row-major, 32 bytes a row);
// the g-chain masks them there with the layer below's activation, read
// 16 bytes a thread along the rows from L2 (the producer prefetched it);
// thread 0 stores the boxes by TMA (tout), which runs on while the
// warpgroup goes on; before a buffer is written again, the stores from it
// (two rounds back, rnd counts the rounds) have read it. dX (kWideDx)
// stores from the registers.
template <int BN, int kKind>
__device__ __forceinline__ void wide_epilogue(const WideGemmMlp& m, const CUtensorMap* tout,
                                              const float* acc, unsigned char* stg,
                                              long long r0, int n0, int wg, int t, int& rnd) {
  const WideGemm& g = m.g;
  const int qd = t & 3, rt = (t >> 5) * 16 + ((t & 31) >> 2);
  if constexpr (kKind == kWideDx) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * qd;
      if (n >= g.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rt + 8 * h;
        if (row < g.M) wide_dx_pair(m, row, n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  } else {
    constexpr int kJ = kWideEpiCols / 8;  // column groups of 8 in a round
    constexpr int kBoxes = kWideEpiCols / kWideBoxCols;
    // the rows' terms: the direction term's row (forward), the rounded
    // density cotangent (g-chain into the trunk)
    const float* dr[2] = {nullptr, nullptr};
    float gd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r0 + rt + 8 * h;
      if (row >= g.M) continue;
      if constexpr (kKind == kWideFwd) {
        if (g.dc) dr[h] = g.dc + (row / g.S) * g.N;
      } else if constexpr (kKind == kWideChain) {
        if (g.gden) gd[h] = round_bf(g.gden[row]);
      }
    }
#pragma unroll
    for (int c = 0; c < (BN + kWideEpiCols - 1) / kWideEpiCols; ++c, ++rnd) {
      const int c0 = n0 + c * kWideEpiCols;  // the round's first column
      unsigned char* buf = stg + (rnd & 1) * (kWideEpiBytes / 2);
      // the round's column terms, all loads in flight together
      float p[2 * kJ];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int n = c0 + 8 * jj + 2 * qd;
        p[2 * jj] = p[2 * jj + 1] = 0.0f;
        if (c * kJ + jj >= BN / 8 || n >= g.N) continue;
        if constexpr (kKind == kWideFwd) {
          p[2 * jj] = __ldg(g.bias + n);
          p[2 * jj + 1] = __ldg(g.bias + n + 1);
        } else if constexpr (kKind == kWideChain) {
          if (g.gden) {
            p[2 * jj] = __bfloat162float(g.wden[n]);
            p[2 * jj + 1] = __bfloat162float(g.wden[n + 1]);
          }
        }
      }
      const int cw = min(kWideEpiCols, min(BN - c * kWideEpiCols, g.N - c0));  // columns stored
      if (t == 0) bulk_wait_read1();
      bar_sync(1 + wg, 128);  // buf is free
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = c * kJ + jj;
        if (j >= BN / 8) break;
        const int n = c0 + 8 * jj + 2 * qd;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = rt + 8 * h;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          uint32_t v;
          if constexpr (kKind == kWideFwd) {
            v = wide_fwd_pair(n < g.N ? dr[h] : nullptr, n, p[2 * jj], p[2 * jj + 1], v0, v1);
          } else if constexpr (kKind == kWideChain) {
            v = wide_chain_pair(g.gden != nullptr, gd[h], p[2 * jj], p[2 * jj + 1], v0, v1);
          } else {
            const long long row = r0 + rr;
            if (row >= g.M || n >= g.N) continue;
            v = wide_chain_heads_pair(m, row, n, v0, v1);
          }
          *reinterpret_cast<uint32_t*>(buf + (jj >> 1) * kWideBoxBytes + rr * 32 +
                                       (jj & 1) * 16 + 4 * qd) = v;
        }
      }
      if constexpr (kKind != kWideFwd) {  // g is kept where the layer below's activation > 0
        // its 16-byte chunks idx = t, t + 128, ... (row idx / kJ, columns
        // 8 (idx % kJ) ..), one at a time: with the 128 sums live, more
        // loads in flight spilled at BN 240 and 256
        bar_sync(1 + wg, 128);
#pragma unroll 1
        for (int idx = t; idx < 64 * kJ; idx += 128) {
          const int rr = idx / kJ, ch = idx % kJ;
          if (r0 + rr >= g.M || 8 * ch >= cw) continue;
          const uint4 a4 =
              *reinterpret_cast<const uint4*>(g.act + (r0 + rr) * g.N + c0 + 8 * ch);
          uint4* sp = reinterpret_cast<uint4*>(buf + (ch >> 1) * kWideBoxBytes + rr * 32 +
                                               (ch & 1) * 16);
          uint4 v = *sp;
          const bf16* a = reinterpret_cast<const bf16*>(&a4);
          bf16* o = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (!(__bfloat162float(a[q]) > 0.0f)) o[q] = __float2bfloat16_rn(0.0f);
          *sp = v;
        }
      }
      fence_proxy_async();  // the staged boxes are visible to the TMA stores
      bar_sync(1 + wg, 128);
      if (t == 0) {
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          if (b * kWideBoxCols < cw)
            tma_store_2d(tout, smem_u32(buf + b * kWideBoxBytes), c0 + b * kWideBoxCols,
                         (int)r0);
        bulk_commit();
      }
    }
  }
}

// The persistent GEMM: block b takes tiles b, b + gridDim.x, ... of
// ceil(M / 128) row bands by nb = ceil(N / BN) column blocks, tile t at
// row band t / nb and column block t % nb. ta0 / ta1: the tensor maps of
// a0 / a1 (ta1 = ta0 when there is no a1); tout: out's, in the epilogue's
// boxes (unused by kWideDx).
template <int BN, int kKind>
__global__ void __launch_bounds__(kWideThreads, 1)
    wide_gemm_kernel(__grid_constant__ const CUtensorMap ta0,
                     __grid_constant__ const CUtensorMap ta1,
                     __grid_constant__ const CUtensorMap tout, const WideGemmMlp m) {
  extern __shared__ __align__(1024) unsigned char smem_wide[];
  constexpr int kStages = wide_stages<BN>();
  constexpr int kStage = wide_stage_bytes<BN>();
  const WideGemm& g = m.g;
  unsigned char* base = align1024(smem_wide);
  unsigned char* epi = base + kStages * kStage;
  const uint32_t full = smem_u32(epi + 2 * kWideEpiBytes);
  const uint32_t empty = full + 8 * kStages;
  const int nb = (g.N + BN - 1) / BN;
  const long long tiles = (g.M + kWideRows - 1) / kWideRows * nb;
  const int nk = g.ns0 + g.ns1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        mbar_expect_tx(bar, 2 * kTileSlab + bbytes);
        if (kt < g.ns0)
          tma_load_2d(dst, &ta0, kt * 64, m0, bar);
        else
          tma_load_2d(dst, &ta1, (kt - g.ns0) * 64, m0, bar);
        bulk_copy(dst + 2 * kTileSlab, g.b + ((long long)kt * g.N + n0) * 64, bbytes, bar);
        advance(stage, phase, kStages);
        if constexpr (kKind == kWideChain || kKind == kWideChainHeads) {
          // the tile's rows of the layer below's activation, which its
          // epilogue reads for the mask, into L2 while the products run
          if (kt == (nk > 1 ? 1 : 0))
            for (int r = m0; r < m0 + kWideRows && r < g.M; ++r)
              prefetch_l2(g.act + (long long)r * g.N + n0, bbytes / 64);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  unsigned char* stg = epi + wg * kWideEpiBytes;
  int rnd = 0;  // epilogue rounds so far (the staging buffer of the next)
  float acc[BN / 2];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = tile / nb * kWideRows;
    const int n0 = (int)(tile % nb) * BN;
    zero_acc<BN>(acc);
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t st = smem_u32(base + stage * kStage);
      const uint32_t a = opaque(st + wg * kTileSlab), b = opaque(st + 2 * kTileSlab);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma<BN>(acc, sdesc(a + kk * 32), sdesc(b + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage kt - 1 are done: release it
      if (kt > 0 && t == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      advance(stage, phase, kStages);
    }
    wgmma_wait<0>();
    if (t == 0) mbar_arrive(empty + 8 * prev);
    fence_acc<BN / 2>(acc);
    wide_epilogue<BN, kKind>(m, &tout, acc, stg, m0 + wg * 64, n0, wg, t, rnd);
  }
  if (t == 0) bulk_wait();
}

// ---- host side ----

typedef CUresult (*WideEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once.
inline WideEncodeTiled wide_encode_tiled() {
  static WideEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<WideEncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 matrix [M, ld], columns [0, cols) (a read
// past them or past M gives zeros, a write there is dropped), in boxes of
// box_cols x box_rows; false where TMA cannot take it (a row stride or
// base that is not a multiple of 16 bytes).
inline bool wide_tensor_map(CUtensorMap* map, const bf16* a, int ld, int cols, long long M,
                            int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const WideEncodeTiled enc = wide_encode_tiled();
  if (!enc || !a || (reinterpret_cast<uintptr_t>(a) & 15) || ld % 8 || cols < 1 || cols > ld)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(a), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A's map: boxes of 64 k-values by kWideRows rows in the 128-byte
// swizzle, a stage's operand as the wgmma descriptors read it.
inline bool wide_a_map(CUtensorMap* map, const bf16* a, int lda, int ka, long long M) {
  return wide_tensor_map(map, a, lda, ka, M, 64, kWideRows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The column block for N columns: of the multiples of 16 from 128 to 256
// (of 128 and 256 alone for mlp_bwd's own epilogues, kWideChainHeads and
// kWideDx, which few launches run: 7 kernels fewer a source to build), the
// one with the least ceil(N / BN) x (BN + 32) (the padded columns and a
// tile's fixed cost in columns), the wider at a tie.
inline int wide_bn(int N, bool all = true) {
  int best = 256;
  long long cost = -1;
  for (int bn = 256; bn >= 128; bn -= all ? 16 : 128) {
    const long long c = (long long)cdiv(N, bn) * (bn + 32);
    if (cost < 0 || c < cost) {
      cost = c;
      best = bn;
    }
  }
  return best;
}

inline bool aligned16(const void* p) { return !(reinterpret_cast<uintptr_t>(p) & 15); }

template <int BN, int kKind>
inline cudaError_t launch_wide_gemm_bn(const WideGemmMlp& m, const CUtensorMap& t0,
                                       const CUtensorMap& t1, const CUtensorMap& to,
                                       cudaStream_t st) {
  constexpr int smem = wide_gemm_smem<BN>();
  cudaError_t err = cudaFuncSetAttribute(wide_gemm_kernel<BN, kKind>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long tiles = (m.g.M + kWideRows - 1) / kWideRows * cdiv(m.g.N, BN);
  wide_gemm_kernel<BN, kKind>
      <<<(unsigned)(tiles < sms ? tiles : sms), kWideThreads, smem, st>>>(t0, t1, to, m);
  return cudaGetLastError();
}

// One layer product with the epilogue kKind, on wide_bn(N) columns a block.
template <int kKind>
inline cudaError_t launch_wide_gemm_mlp(const WideGemmMlp& m, cudaStream_t st) {
  const WideGemm& g = m.g;
  if (g.M <= 0) return cudaSuccess;
  CUtensorMap t0, t1, to;
  if (!wide_a_map(&t0, g.a0, g.lda0, g.ka0, g.M) || g.ns0 < 1 ||
      (g.ns1 > 0 && !wide_a_map(&t1, g.a1, g.lda1, g.ka1, g.M)) || !aligned16(g.b) ||
      (kKind != kWideDx && !wide_tensor_map(&to, g.out, g.N, g.N, g.M, kWideBoxCols, 64,
                                            CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      ((kKind == kWideChain || kKind == kWideChainHeads) && !aligned16(g.act)))
    return cudaErrorInvalidValue;
  if (g.ns1 == 0) t1 = t0;
  if (kKind == kWideDx) to = t0;
  if constexpr (kKind == kWideChainHeads || kKind == kWideDx) {
    return wide_bn(g.N, false) == 128 ? launch_wide_gemm_bn<128, kKind>(m, t0, t1, to, st)
                                      : launch_wide_gemm_bn<256, kKind>(m, t0, t1, to, st);
  } else {
    switch (wide_bn(g.N)) {
      case 128: return launch_wide_gemm_bn<128, kKind>(m, t0, t1, to, st);
      case 144: return launch_wide_gemm_bn<144, kKind>(m, t0, t1, to, st);
      case 160: return launch_wide_gemm_bn<160, kKind>(m, t0, t1, to, st);
      case 176: return launch_wide_gemm_bn<176, kKind>(m, t0, t1, to, st);
      case 192: return launch_wide_gemm_bn<192, kKind>(m, t0, t1, to, st);
      case 208: return launch_wide_gemm_bn<208, kKind>(m, t0, t1, to, st);
      case 224: return launch_wide_gemm_bn<224, kKind>(m, t0, t1, to, st);
      case 240: return launch_wide_gemm_bn<240, kKind>(m, t0, t1, to, st);
      default: return launch_wide_gemm_bn<256, kKind>(m, t0, t1, to, st);
    }
  }
}

// One layer product with the epilogue g.kind (kWideFwd or kWideChain). A
// template, so that only a source that calls it builds the kernels of
// both epilogues (the forwards call launch_wide_gemm_mlp<kWideFwd>).
template <class G = WideGemm>
inline cudaError_t launch_wide_gemm(const G& g, cudaStream_t st) {
  const WideGemmMlp m{g, 1, 0, 0};
  return g.kind == kWideFwd ? launch_wide_gemm_mlp<kWideFwd>(m, st)
                            : launch_wide_gemm_mlp<kWideChain>(m, st);
}

}  // namespace
