// The wide routes' dW GEMMs: dW[i, n] = sum over the rows r of a split of
// act[r, i] g[r, n], for every layer product of a level in one launch (a
// launch for each column block in bf16), each split's partial into its own
// row of part [splits, n_out] (launch_small_reduce in level_backward.cuh
// then sums the rows in split order). wide_train.cuh's
// launch_wide_backward runs wide_dw_kernel<BN> (bf16) as its pass 6, and
// launch_wide_backward_f32 runs wide_dw_f32_kernel (f32, db in the same
// pass) in place of the narrow route's dw_gemm_f32_kernel.
//
// Replaces, at the wide widths, the dW products of nerf_or_nothing_tpu/
// kernels/fused_level.py::_level_kernel and ::_level_kernel_twopass (the
// train level) and of fused_mlp.py::_bwd_kernel (mlp_bwd), as a part of
// their callers' launches.
//
// Bound: the products. A level at Config(net_width=1024) and 2^17 rows is
// ~2.0 TFLOP of dW against ~2.1 GB of bf16 activations and masked g read
// once and ~1 GB of f32 partials written: ~2.0 ms at the bf16 989 TFLOP/s
// (~0.9 ms of bytes at 3.35 TB/s), ~12 ms at the 3xTF32 165 TFLOP/s.
//
// Both kernels have the structure of wide_gemm.cuh's layer GEMM:
//  - one persistent block an SM walks the work items (product, row block,
//    column block, split), split-major, so that the blocks in flight read
//    the same split's rows of act and g, from HBM once and then from L2;
//    the products of a launch come from a job table (WideDwTable, a kernel
//    parameter beside the operands' tensor maps);
//  - a producer thread (warpgroup 2, its registers lowered by setmaxnreg)
//    fills a ring of stages by TMA (cp.async.bulk.tensor on 3-D maps of
//    [layers, rows, columns], so that a box past a layer's last row reads
//    zeros), completion on full / empty mbarriers, no block-wide barrier
//    in the k-loop;
//  - two consumer warpgroups (output rows 0-63 and 64-127 of a tile) on
//    wgmma, in the parent kernels' k-order and over the same splits
//    (split_rows: each split a multiple of 32 rows), so every output has
//    the parent's bits.
// Every partial is written by exactly one block: no atomics, so two
// launches on the same inputs give the same bits.
//
// bf16 (wide_dw_kernel<BN>): tiles of 128 output rows x BN = 256 columns
// (128 where 256 does not divide N), 64-row stages of A [64 x 128] and B
// [64 x BN] as stored (MN-major: the rows are K), which bf16 wgmma takes
// transposed (sdesc_mn, dw_wg_kernel's layout: slabs of 64 columns, 128
// bytes a row, the 128-byte swizzle), each slab as two TMA boxes of 32
// rows: a split ends on a multiple of 32 rows, and a half past its end is
// read at a row past the tensor's, as zeros (the parent's zero fill), so
// every stage is four k16 steps of m64nBNk16 and no branch sits near the
// wgmma. 4 stages at BN = 256, 6 at 128. The partials are stored from the
// registers (a split's rows of part are n_out apart, which is only even in
// general: no 16-byte TMA store), while the producer loads the next
// tile's first stages.
//
// f32 (wide_dw_f32_kernel): TF32 wgmma takes K-major operands only (and
// would truncate f32 that it read from shared memory), so
//  - A (act) is loaded as stored, as four boxes [32 rows x 32 columns] in
//    the 128-byte swizzle, and each consumer reads its fragment from there
//    into registers and splits it (split_tf32), as wide_f32.cuh's GEMM
//    does; fragment row 16 w + g + 8 h of warp w reads column
//    8 (w % 2) + 16 (g / 4) + g % 4 + 4 h of box w / 2, so that the eight
//    rows and four k-values of one read fall on 32 banks;
//  - B (masked g) is loaded as stored, [32 rows x 128 columns], and three
//    transposer warps (warpgroup 2 but the producer's warp) write it as the
//    K-major slabs [128 columns x 32 rows] hi and lo (split_tf32) in the
//    128-byte swizzle that wgmma_tf32's descriptor reads, a column a
//    thread (16-byte stores, a stage's 32 rows of a column in order; the
//    first warp takes a second column); in row block 0 of a product with a
//    bias, that thread adds the column's rows to db in row order
//    (dw_gemm_f32_kernel's db);
//  - per 32-row stage, each k8 step's three passes lo·hi, hi·lo, hi·hi go
//    into the stage's sums in the tensor core (the first from zero), then
//    the sums are added to the f32 accumulator round-to-nearest: the
//    parent's order, in which TF32 wgmma's sums equal mma.sync's bit for
//    bit (as wide_f32.cuh's GEMM found);
//  - tiles of 128 x 128 (a consumer holds 64 sums and 64 stage sums in the
//    168 registers a thread has), 3 stages of A, raw B, B hi and B lo
//    (64 KB each); a stage is released once both consumers' products are
//    done, and the transposers run ahead of them (ready barriers); their
//    warpgroup keeps 72 registers (at 56 the transpose spilled). Two rings
//    instead (5 stages of A and raw B, 2 of B hi and lo, thread 256 issuing
//    the loads between its columns) ran the level's dW 27% slower.

#pragma once

#include "train_wg.cuh"
#include "wide_f32.cuh"

// The dW GEMMs take a job table (csrc/wide_dw.cu reads this to build
// against a version without it).
#define WIDE_DW_TABLE 1

namespace {

constexpr int kDwMaps = 5;        // the operands' tensor maps of a launch
constexpr int kDwMaxJobs = 48;    // products a launch (the table is a kernel parameter)
constexpr int kDwBoxRows = 32;    // rows of a TMA box: a split's rows are a multiple of 32
constexpr int kDwRowsBf16 = 64;   // rows of a bf16 stage: four k16 steps
constexpr int kDwF32Stages = 3;
constexpr int kDwF32Part = 16384;  // A, raw B, B hi or B lo of a 32-row f32 stage
constexpr int kDwF32Smem = 1024 + kDwF32Stages * (4 * kDwF32Part + 24);
constexpr int kDwTransposers = 96;  // threads 288-383

// A level's operands: the activations [D layers x N rows x W], the view
// layers' [Dc x N x Wc], the features [N x KX] (LX columns read), and the
// masked g of both.
enum { kDwActs = 0, kDwViewActs = 1, kDwX = 2, kDwGrads = 3, kDwViewGrads = 4 };

struct WideDwJob {
  long long out_off;  // dW [M, Nn] (row stride Nn) in each split's partial row
  long long db_off;   // f32: B's column sums there, or -1
  int a, a_layer;     // A: layer a_layer of map a, its columns [0, M) the output rows
  int b, b_layer;     // B: layer b_layer of map b, [K rows x Nn columns]
  int M, Nn, tiles_m, tile0;  // row blocks; the job's first tile among a split's
};

struct WideDwTable {
  CUtensorMap map[kDwMaps];
  WideDwJob job[kDwMaxJobs];
  float* part;  // [splits, n_out]
  long long n_out;
  int n, splits, K, tiles;  // jobs, row splits, rows, tiles of a split
};

// A 3-D box (columns c0.., rows r0.., layer l0) of a tensor map into
// shared memory at dst, completing on the mbarrier bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int r0,
                                            int l0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(l0), "r"(bar)
      : "memory");
}

// Work item `item` (split-major; a split's tiles job by job, row blocks
// fastest): its job, split and tile origin.
struct WideDwTile {
  int jn, split, m0, n0;
};

__device__ __forceinline__ WideDwTile dw_tile(const WideDwTable& t, long long item, int bn) {
  WideDwTile x;
  x.split = (int)(item / t.tiles);
  int r = (int)(item - (long long)x.split * t.tiles);
  int jn = 0;
  while (jn + 1 < t.n && r >= t.job[jn + 1].tile0) ++jn;
  r -= t.job[jn].tile0;
  x.jn = jn;
  x.m0 = (r % t.job[jn].tiles_m) * kWideRows;
  x.n0 = (r / t.job[jn].tiles_m) * bn;
  return x;
}

// The stages of `rows` rows of work item `item`'s split.
__device__ __forceinline__ int dw_split_stages(const WideDwTable& t, long long item,
                                               long long chunk, int rows) {
  const long long k_lo = (item / t.tiles) * chunk;
  const long long k_hi = min((long long)t.K, k_lo + chunk);
  return k_hi > k_lo ? (int)((k_hi - k_lo + rows - 1) / rows) : 0;
}

// ---- bf16 ----

template <int BN>
__host__ __device__ constexpr int dw_stage_bytes() {
  return (2 + BN / 64) * kTileSlab;
}

template <int BN>
__host__ __device__ constexpr int dw_stages() {
  constexpr int n = (232448 - 1024 - 16 * kWideMaxStages) / dw_stage_bytes<BN>();
  return n < kWideMaxStages ? n : kWideMaxStages;
}

template <int BN>
__host__ __device__ constexpr int dw_smem() {
  return 1024 + dw_stages<BN>() * dw_stage_bytes<BN>() + 16 * dw_stages<BN>();
}

// A stage: A's two slabs of 64 output rows (consumer warpgroup w reads
// slab w), then B's BN / 64 slabs, each [64 rows x 64 columns] as two
// boxes of 32 rows.
template <int BN>
__global__ void __launch_bounds__(kWideThreads, 1)
    wide_dw_kernel(__grid_constant__ const WideDwTable t) {
  extern __shared__ __align__(1024) unsigned char smem_dw[];
  constexpr int kStages = dw_stages<BN>(), kStage = dw_stage_bytes<BN>();
  unsigned char* base = align1024(smem_dw);
  const uint32_t full = smem_u32(base + kStages * kStage);
  const uint32_t empty = full + 8 * kStages;
  const long long items = (long long)t.splits * t.tiles;
  const long long chunk = split_rows(t.K, t.splits);
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
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const WideDwTile x = dw_tile(t, item, BN);
      const WideDwJob& jb = t.job[x.jn];
      const CUtensorMap* ma = &t.map[jb.a];
      const CUtensorMap* mb = &t.map[jb.b];
      const long long k_lo = x.split * chunk;
      const long long k_hi = min((long long)t.K, k_lo + chunk);
      for (long long k0 = k_lo; k0 < k_hi; k0 += kDwRowsBf16) {
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the consumers released the slot
        const uint32_t bar = full + 8 * stage, dst = smem_u32(base + stage * kStage);
        mbar_expect_tx(bar, kStage);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows past the split: the box at row K, all zeros
          const int row = k0 + h * kDwBoxRows < k_hi ? (int)(k0 + h * kDwBoxRows) : t.K;
          const uint32_t d = dst + h * (kTileSlab / 2);
          tma_load_3d(d, ma, x.m0, row, jb.a_layer, bar);
          tma_load_3d(d + kTileSlab, ma, x.m0 + 64, row, jb.a_layer, bar);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_3d(d + (2 + c) * kTileSlab, mb, x.n0 + 64 * c, row, jb.b_layer, bar);
        }
        advance(stage, phase, kStages);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  float acc[BN / 2];
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const WideDwTile x = dw_tile(t, item, BN);
    const WideDwJob& jb = t.job[x.jn];
    const int nk = dw_split_stages(t, item, chunk, kDwRowsBf16);
    zero_acc<BN>(acc);
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t st = smem_u32(base + stage * kStage);
      const uint32_t a = opaque(st + wg * kTileSlab), b = opaque(st + 2 * kTileSlab);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_mn<BN>(acc, sdesc_mn(a + kk * 16 * kSlabBytes), sdesc_mn(b + kk * 16 * kSlabBytes),
                     1);
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage kt - 1 are done: release it
      if (kt > 0 && tid == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      advance(stage, phase, kStages);
    }
    wgmma_wait<0>();
    if (nk > 0 && tid == 0) mbar_arrive(empty + 8 * prev);
    fence_acc<BN / 2>(acc);
    float* part = t.part + x.split * t.n_out + jb.out_off;
    const int row0 = x.m0 + wg * 64 + (tid >> 5) * 16 + ((tid & 31) >> 2), qd = tid & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = x.n0 + 8 * j + 2 * qd;
      if (n >= jb.Nn) continue;
      if (row0 < jb.M)
        *reinterpret_cast<float2*>(part + (long long)row0 * jb.Nn + n) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row0 + 8 < jb.M)
        *reinterpret_cast<float2*>(part + (long long)(row0 + 8) * jb.Nn + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---- f32 ----

// Column c of a stage's raw B [32 rows x 128 columns] (512 bytes a row)
// into the B hi slab at hi and the B lo slab after it ([128 rows x 32
// k-values], 128 bytes a row, 16-byte chunk q of row c at q ^ (c % 8)),
// split by split_tf32; with db, the column's rows added to s in order
// (returned).
__device__ __forceinline__ float dw_transpose(const float* raw, unsigned char* hi, int c, bool db,
                                              float s) {
#pragma unroll 2
  for (int q = 0; q < 8; ++q) {
    float v[4];
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = raw[(4 * q + e) * 128 + c];
    if (db) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s += v[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
    const int off = c * kSlabBytes + ((q ^ (c & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + kDwF32Part + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  return s;
}

// The A fragment of k8 step kk from an A box (32 rows x 32 columns, 128
// bytes a row, 16-byte chunk q of row r at q ^ (r % 8)): rows g and g + 8
// of the fragment are columns lc and lc + 4, its k-values tq and tq + 4
// rows 8 kk + tq and + 4 (level_common.cuh's load_a_split order).
__device__ __forceinline__ void load_a_dw(const unsigned char* a, int lc, int tq, int kk,
                                          float* v) {
  const int q = lc >> 2;
  const unsigned char* r0 = a + (8 * kk + tq) * kSlabBytes + (lc & 3) * 4;
  const unsigned char* r1 = r0 + 4 * kSlabBytes;
  v[0] = *reinterpret_cast<const float*>(r0 + ((q ^ tq) << 4));
  v[1] = *reinterpret_cast<const float*>(r0 + (((q + 1) ^ tq) << 4));
  v[2] = *reinterpret_cast<const float*>(r1 + ((q ^ (tq + 4)) << 4));
  v[3] = *reinterpret_cast<const float*>(r1 + (((q + 1) ^ (tq + 4)) << 4));
}

// A stage: A [32 rows x 128 columns] as four boxes of 32 columns, raw B
// [32 rows x 128 columns] (one box), B hi and B lo [128 x 32].
__global__ void __launch_bounds__(kWideThreads, 1)
    wide_dw_f32_kernel(__grid_constant__ const WideDwTable t) {
  extern __shared__ __align__(1024) unsigned char smem_dwf[];
  constexpr int kStages = kDwF32Stages, kStage = 4 * kDwF32Part;
  unsigned char* base = align1024(smem_dwf);
  const uint32_t full = smem_u32(base + kStages * kStage);
  const uint32_t ready = full + 8 * kStages;  // the transposers wrote B hi / lo
  const uint32_t empty = ready + 8 * kStages;
  const long long items = (long long)t.splits * t.tiles;
  const long long chunk = split_rows(t.K, t.splits);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, kDwTransposers);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (threadIdx.x < 256 + 32) {  // the producer's warp: thread 256 copies
      if (threadIdx.x != 256) return;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const WideDwTile x = dw_tile(t, item, 128);
        const WideDwJob& jb = t.job[x.jn];
        const CUtensorMap* ma = &t.map[jb.a];
        const CUtensorMap* mb = &t.map[jb.b];
        const long long k_lo = x.split * chunk;
        const long long k_hi = min((long long)t.K, k_lo + chunk);
        for (long long k0 = k_lo; k0 < k_hi; k0 += kDwBoxRows) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage, dst = smem_u32(base + stage * kStage);
          mbar_expect_tx(bar, 2 * kDwF32Part);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            tma_load_3d(dst + c * (kDwF32Part / 4), ma, x.m0 + 32 * c, (int)k0, jb.a_layer, bar);
          tma_load_3d(dst + kDwF32Part, mb, x.n0, (int)k0, jb.b_layer, bar);
          advance(stage, phase, kStages);
        }
      }
      return;
    }
    // the transposers: column tt of every stage, and column 96 + tt for tt < 32
    const int tt = threadIdx.x - 288;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const WideDwTile x = dw_tile(t, item, 128);
      const WideDwJob& jb = t.job[x.jn];
      const bool db = jb.db_off >= 0 && x.m0 == 0;
      const long long k_lo = x.split * chunk;
      const long long k_hi = min((long long)t.K, k_lo + chunk);
      float s0 = 0.0f, s1 = 0.0f;
      for (long long k0 = k_lo; k0 < k_hi; k0 += kDwBoxRows) {
        mbar_wait(full + 8 * stage, phase);
        unsigned char* st = base + stage * kStage;
        const float* raw = reinterpret_cast<const float*>(st + kDwF32Part);
        s0 = dw_transpose(raw, st + 2 * kDwF32Part, tt, db, s0);
        if (tt < 32) s1 = dw_transpose(raw, st + 2 * kDwF32Part, 96 + tt, db, s1);
        fence_proxy_async();  // the slabs are visible to the consumers' wgmma
        mbar_arrive(ready + 8 * stage);
        advance(stage, phase, kStages);
      }
      if (db) {
        float* part = t.part + x.split * t.n_out + jb.db_off + x.n0;
        if (x.n0 + tt < jb.Nn) part[tt] = s0;
        if (tt < 32 && x.n0 + 96 + tt < jb.Nn) part[96 + tt] = s1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, wj = tid >> 5;
  const int g = (tid & 31) >> 2, tq = tid & 3;
  const int box = 2 * wg + (wj >> 1);                  // this warp's A box
  const int lc = 8 * (wj & 1) + 16 * (g >> 2) + (g & 3);  // its fragment rows' columns
  float acc[64], sum[64];
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int nk = dw_split_stages(t, item, chunk, kDwBoxRows);
    zero_acc<128>(acc);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full + 8 * stage, phase);   // A
      mbar_wait(ready + 8 * stage, phase);  // B hi / lo
      const unsigned char* st = base + stage * kStage;
      const unsigned char* a = st + box * (kDwF32Part / 4);
      const uint32_t bh = opaque(smem_u32(st + 2 * kDwF32Part)), bl = bh + kDwF32Part;
      float v[4];
      load_a_dw(a, lc, tq, 0, v);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
        wgmma_fence();
        if (kk == 0)
          wgmma_tf32_first(sum, lo, sdesc(bh));
        else
          wgmma_tf32(sum, lo, sdesc(bh + kk * 32));
        wgmma_tf32(sum, hi, sdesc(bl + kk * 32));
        wgmma_tf32(sum, hi, sdesc(bh + kk * 32));
        wgmma_commit();
        if (kk < 3) load_a_dw(a, lc, tq, kk + 1, v);
        wgmma_wait<0>();
        keep_a(hi, lo);
      }
      fence_acc<64>(sum);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += sum[i];
      // the stage's products and A reads are done: release it
      if (tid == 0) mbar_arrive(empty + 8 * stage);
      advance(stage, phase, kStages);
    }
    // the tile decoded again here: nothing of it is held through the k-loop
    const WideDwTile x = dw_tile(t, item, 128);
    const WideDwJob& jb = t.job[x.jn];
    float* part = t.part + x.split * t.n_out + jb.out_off;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = x.m0 + 32 * box + lc + 4 * h;
      if (row >= jb.M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = x.n0 + 8 * j + 2 * tq;
        if (n < jb.Nn)
          *reinterpret_cast<float2*>(part + (long long)row * jb.Nn + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---- host side ----

// The tensor map of [layers, rows, ld] elements of esize bytes at a,
// columns [0, cols) read (a read past them, past a layer's rows or past
// the layers gives zeros), in boxes of box_cols x kDwBoxRows x 1; false
// where TMA cannot take it (a base or row stride off 16 bytes).
inline bool dw_map(CUtensorMap* map, const void* a, int esize, int ld, int cols, long long rows,
                   int layers, int box_cols, CUtensorMapSwizzle swizzle) {
  const WideEncodeTiled enc = wide_encode_tiled();
  if (!enc || !a || !aligned16(a) || (ld * esize) % 16 || cols < 1 || cols > ld || layers < 1)
    return false;
  if (rows < 1) rows = 1;  // no rows: nothing is read, every partial is zero
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * esize, (cuuint64_t)(rows * ld * esize)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)kDwBoxRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(a), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One dW product: A = layer a_layer of map a (M output rows), B = layer
// b_layer of map b (Nn output columns), its block at out_off of a split's
// partial row, db (f32) at db_off or none (-1).
struct WideDwProduct {
  int a, a_layer, M, b, b_layer, Nn;
  long long out_off, db_off;
};

// A level's dW products in launch_dw's order (level_backward.cuh): trunk
// layer 0 from the features, layer i from layer i - 1's activation (and
// the features for a skip layer, without db), then the view layers (the
// first from the last trunk layer's activation).
inline std::vector<WideDwProduct> dw_products(const Params& p) {
  std::vector<long long> w_off, b_off;
  output_offsets(p, w_off, b_off);
  std::vector<WideDwProduct> v;
  for (int i = 0; i < p.D; ++i) {
    if (i == 0) {
      v.push_back({kDwX, 0, p.LX, kDwGrads, 0, p.W, w_off[0], b_off[0]});
    } else {
      v.push_back({kDwActs, i - 1, p.W, kDwGrads, i, p.W, w_off[i], b_off[i]});
      if (i % p.skip == 0)
        v.push_back({kDwX, 0, p.LX, kDwGrads, i, p.W, w_off[i] + (long long)p.W * p.W, -1});
    }
  }
  for (int j = 0; j < p.Dc; ++j) {
    const long long o = w_off[p.D + 1 + j], b = b_off[p.D + 1 + j];
    if (j == 0)
      v.push_back({kDwActs, p.D - 1, p.W, kDwViewGrads, 0, p.Wc, o, b});
    else
      v.push_back({kDwViewActs, j - 1, p.Wc, kDwViewGrads, j, p.Wc, o, b});
  }
  return v;
}

// The products prods (all in column blocks of bn), kDwMaxJobs a launch of
// launch(grid, table): one persistent block an SM, at most one a work item.
template <class F>
inline cudaError_t dw_launches(WideDwTable& t, const std::vector<WideDwProduct>& prods, int bn, bool db,
                               F&& launch) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  for (size_t j0 = 0; j0 < prods.size(); j0 += kDwMaxJobs) {
    t.n = 0;
    t.tiles = 0;
    for (size_t j = j0; j < prods.size() && j < j0 + kDwMaxJobs; ++j) {
      const WideDwProduct& d = prods[j];
      WideDwJob& jb = t.job[t.n++];
      jb.out_off = d.out_off; jb.db_off = db ? d.db_off : -1;
      jb.a = d.a; jb.a_layer = d.a_layer; jb.b = d.b; jb.b_layer = d.b_layer;
      jb.M = d.M; jb.Nn = d.Nn; jb.tiles_m = cdiv(d.M, kWideRows); jb.tile0 = t.tiles;
      t.tiles += jb.tiles_m * cdiv(d.Nn, bn);
    }
    const long long items = (long long)t.splits * t.tiles;
    launch((unsigned)(items < sms ? items : sms), t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// bf16: the products whose columns 256 divides on wide_dw_kernel<256>,
// the others on wide_dw_kernel<128> (the parent's column blocks).
inline cudaError_t dw_run_bf16(WideDwTable& t, const std::vector<WideDwProduct>& prods,
                               cudaStream_t st) {
  std::vector<WideDwProduct> p256, p128;
  for (const WideDwProduct& d : prods) (d.Nn % 256 == 0 ? p256 : p128).push_back(d);
  cudaError_t err;
  if (!p256.empty()) {
    if ((err = cudaFuncSetAttribute(wide_dw_kernel<256>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    dw_smem<256>())) != cudaSuccess ||
        (err = dw_launches(t, p256, 256, false, [&](unsigned grid, const WideDwTable& tt) {
           wide_dw_kernel<256><<<grid, kWideThreads, dw_smem<256>(), st>>>(tt);
         })) != cudaSuccess)
      return err;
  }
  if (!p128.empty()) {
    if ((err = cudaFuncSetAttribute(wide_dw_kernel<128>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    dw_smem<128>())) != cudaSuccess ||
        (err = dw_launches(t, p128, 128, false, [&](unsigned grid, const WideDwTable& tt) {
           wide_dw_kernel<128><<<grid, kWideThreads, dw_smem<128>(), st>>>(tt);
         })) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

inline cudaError_t dw_run_f32(WideDwTable& t, const std::vector<WideDwProduct>& prods, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwF32Smem);
  if (err != cudaSuccess) return err;
  return dw_launches(t, prods, 128, true, [&](unsigned grid, const WideDwTable& tt) {
    wide_dw_f32_kernel<<<grid, kWideThreads, kDwF32Smem, st>>>(tt);
  });
}

// The maps of a level's operands (kDwActs ...) for the bf16 kernel (every
// operand in boxes of 64 columns, 128-byte swizzle) or the f32 one (A's in
// boxes of 32 columns, 128-byte swizzle; B's of 128 columns as stored).
inline bool dw_level_maps(const Params& p, const Extra& e, bool f32, CUtensorMap* map) {
  const int es = f32 ? 4 : 2, ab = f32 ? 32 : 64, bb = f32 ? 128 : 64;
  const CUtensorMapSwizzle bs = f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle as = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long N = e.N, view = act_off(p, N, p.D) * es;  // bytes to the view layers
  const unsigned char* acts = static_cast<const unsigned char*>(e.acts);
  const unsigned char* grads = static_cast<const unsigned char*>(e.grads);
  return dw_map(&map[kDwActs], acts, es, p.W, p.W, N, p.D, ab, as) &&
         dw_map(&map[kDwViewActs], acts + view, es, p.Wc, p.Wc, N, p.Dc, ab, as) &&
         dw_map(&map[kDwX], e.xs, es, p.KX, p.LX, N, 1, ab, as) &&
         dw_map(&map[kDwGrads], grads, es, p.W, p.W, N, p.D, bb, bs) &&
         dw_map(&map[kDwViewGrads], grads + view, es, p.Wc, p.Wc, N, p.Dc, bb, bs);
}

// Pass 6 of the wide routes: every dW product of the level (f32: with db)
// over the rows e.N of the activations, features and masked g in the
// workspace (e.acts, e.xs, e.grads at act_off), each split's partial into
// part [splits, n_out] at output_offsets' offsets.
inline cudaError_t launch_wide_dw(const Params& p, const Extra& e, bool f32, float* part,
                                  long long n_out, int splits, cudaStream_t st) {
  WideDwTable t{};
  if (!dw_level_maps(p, e, f32, t.map)) return cudaErrorInvalidValue;
  t.part = part; t.n_out = n_out; t.splits = splits; t.K = (int)e.N;
  const std::vector<WideDwProduct> prods = dw_products(p);
  return f32 ? dw_run_f32(t, prods, st) : dw_run_bf16(t, prods, st);
}

// One product alone (csrc/wide_dw.cu): A [K, lda] (M columns read), B [K,
// ldb] (Nn columns), each split's partial at 0 of its row of part
// [splits, n_out], f32 db at db_off (or none, -1).
inline cudaError_t launch_wide_dw_one(bool f32, const void* A, int lda, int M, const void* B,
                                      int ldb, int Nn, int K, int splits, float* part,
                                      long long n_out, long long db_off, cudaStream_t st) {
  WideDwTable t{};
  const int es = f32 ? 4 : 2;
  if (!dw_map(&t.map[kDwActs], A, es, lda, M, K, 1, f32 ? 32 : 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !dw_map(&t.map[kDwGrads], B, es, ldb, Nn, K, 1, f32 ? 128 : 64,
              f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B) ||
      splits < 1 || Nn % 32)
    return cudaErrorInvalidValue;
  t.map[kDwViewActs] = t.map[kDwX] = t.map[kDwActs];
  t.map[kDwViewGrads] = t.map[kDwGrads];
  t.part = part; t.n_out = n_out; t.splits = splits; t.K = K;
  const std::vector<WideDwProduct> prods{{kDwActs, 0, M, kDwGrads, 0, Nn, 0, db_off}};
  return f32 ? dw_run_f32(t, prods, st) : dw_run_bf16(t, prods, st);
}

}  // namespace
