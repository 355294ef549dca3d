// The wide routes' dW GEMMs: dW[i, n] = sum over the rows r of a split of
// act[r, i] g[r, n], for every layer product of a level in one launch (a
// launch for each column block in bf16), and db[n] = the column sums of g
// in the product that owns the layer's bias; each split's tile added into
// the output in split order, which is level_backward.cuh's reduce_kernel's
// sum of the split partials, bit for bit, without the partials.
// wide_train.cuh's launch_wide_backward runs wide_dw_kernel<BN> (bf16) and
// launch_wide_backward_f32 runs wide_dw_f32_kernel (f32) in place of the
// narrow route's dw_gemm_f32_kernel, both with db.
//
// Replaces, at the wide widths, the dW and db products of
// nerf_or_nothing_tpu/kernels/fused_level.py::_level_kernel and
// ::_level_kernel_twopass (the train level) and of fused_mlp.py::_bwd_kernel
// (mlp_bwd), as a part of their callers' launches.
//
// Bound: the products. A level at Config(net_width=1024) and 2^17 rows is
// ~2.0 TFLOP of dW against ~2.1 GB of bf16 activations and masked g read
// once and 31 MB of dW written: ~2.0 ms at the bf16 989 TFLOP/s (~0.6 ms
// of bytes at 3.35 TB/s), ~12 ms at the 3xTF32 165 TFLOP/s.
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
//    (split_rows: each split a multiple of 32 rows), so every split's sums
//    have the parent's bits;
//  - db by the other warps of warpgroup 2 in a product with a bias, each
//    column's rows of the split added in row order in f32 (bf16: a column
//    block's columns spread over its row blocks' tiles, a thread a column;
//    f32: the transposers, in row block 0).
//
// The split order (split_wait, split_sums2, split_done): split 0 of a
// tile stores 0.0f + its sums (reduce_kernel's start from +0), split k > 0
// waits until split k - 1 of the same tile has stored, loads the sums so
// far (ld.global.cg: another SM wrote them; the producer thread, done with
// the item's loads, has asked L2 for them; each thread's loads go in
// batches of kDwLoads ahead of their adds) and stores them plus its own, a
// plain f32 add. One counter a (tile, part) in t.flags (parts: consumer
// warpgroups 0 and 1, db) orders them: the writer's warpgroup stores,
// meets at a named barrier, then one thread adds 1 with release semantics
// at gpu scope; the reader's thread spins on an acquire load until the
// counter reaches k, then its warpgroup meets. Each launch starts with the counters
// zeroed (a memset on the stream, which a CUDA graph captures). A wait is
// only ever on the item tiles earlier in the split-major order, which a
// block took in an earlier round or the same one: every block is resident
// (one an SM, gridDim.x at most the SMs), so the lowest unfinished item
// always runs on, and no launch can deadlock. Two launches on the same
// inputs give the same bits.
//
// bf16 (wide_dw_kernel<BN>): tiles of 128 output rows x BN = 256 columns
// (128 where 256 does not divide N), 64-row stages of A [64 x 128] and B
// [64 x BN] as stored (MN-major: the rows are K), which bf16 wgmma takes
// transposed (sdesc_mn, dw_wg_kernel's layout: slabs of 64 columns, 128
// bytes a row, the 128-byte swizzle), each slab as two TMA boxes of 32
// rows: a split ends on a multiple of 32 rows, and a half past its end is
// read at a row past the tensor's, as zeros (the parent's zero fill), so
// every stage is four k16 steps of m64nBNk16 and no branch sits near the
// wgmma. 4 stages at BN = 256, 6 at 128. The sums are added from the
// registers (float2 by float2 in the fragment layout), while the producer
// loads the next tile's first stages. The db warps wait for every stage
// (a stage is released by the two consumers and by them) and sum the
// tile's slice of the block's columns, 1 / tiles_m of them (dw_db_cols).
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

// The dW GEMMs add the splits into the output (csrc/wide_dw.cu reads this
// to build against a version whose kernels write each split's partial).
#define WIDE_DW_REDUCED 1

namespace {

constexpr int kDwMaps = 5;        // the operands' tensor maps of a launch
constexpr int kDwMaxJobs = 48;    // products a launch (the table is a kernel parameter)
constexpr int kDwBoxRows = 32;    // rows of a TMA box: a split's rows are a multiple of 32
constexpr int kDwRowsBf16 = 64;   // rows of a bf16 stage: four k16 steps
constexpr int kDwF32Stages = 3;
constexpr int kDwF32Part = 16384;  // A, raw B, B hi or B lo of a 32-row f32 stage
constexpr int kDwF32Smem = 1024 + kDwF32Stages * (4 * kDwF32Part + 24);
constexpr int kDwTransposers = 96;  // threads 288-383 (bf16: the db warps)
constexpr int kDwParts = 3;         // split counters a tile: consumers 0 and 1, db
constexpr int kDwBarDb = 3;         // named barrier of the db warps (1, 2: the consumers)

// A level's operands: the activations [D layers x N rows x W], the view
// layers' [Dc x N x Wc], the features [N x KX] (LX columns read), and the
// masked g of both.
enum { kDwActs = 0, kDwViewActs = 1, kDwX = 2, kDwGrads = 3, kDwViewGrads = 4 };

struct WideDwJob {
  long long out_off;  // dW [M, Nn] (row stride Nn) in the output
  long long db_off;   // B's column sums there, or -1
  int a, a_layer;     // A: layer a_layer of map a, its columns [0, M) the output rows
  int b, b_layer;     // B: layer b_layer of map b, [K rows x Nn columns]
  int M, Nn, tiles_m, tile0;  // row blocks; the job's first tile among a split's
};

struct WideDwTable {
  CUtensorMap map[kDwMaps];
  WideDwJob job[kDwMaxJobs];
  float* out;   // dW and db at the jobs' offsets
  int* flags;   // [tiles x kDwParts] split counters, zero at the launch's start
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
// fastest): its job, split, tile of the split and tile origin.
struct WideDwTile {
  int jn, split, tile, m0, n0;
};

__device__ __forceinline__ WideDwTile dw_tile(const WideDwTable& t, long long item, int bn) {
  WideDwTile x;
  x.split = (int)(item / t.tiles);
  int r = (int)(item - (long long)x.split * t.tiles);
  x.tile = r;
  int jn = 0;
  while (jn + 1 < t.n && r >= t.job[jn + 1].tile0) ++jn;
  r -= t.job[jn].tile0;
  x.jn = jn;
  x.m0 = (r % t.job[jn].tiles_m) * kWideRows;
  x.n0 = (r / t.job[jn].tiles_m) * bn;
  return x;
}

// The split order: wait (thread `lead` of the `count` threads at named
// barrier `bar`) until the counter at flag shows split k - 1 stored;
// after the stores, split_done lets split k + 1 go. A wait of more than
// 2^28 polls traps, as mbar_wait does.
__device__ __forceinline__ void split_wait(const int* flag, int k, bool lead, int bar, int count) {
  if (k == 0) return;
  if (lead) {
    int got = 0;
    for (uint32_t n = 0;; ++n) {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(got) : "l"(flag) : "memory");
      if (got >= k) break;
      if (n == (1u << 28)) __trap();
    }
  }
  bar_sync(bar, count);
}

__device__ __forceinline__ void split_done(int* flag, bool lead, int bar, int count) {
  bar_sync(bar, count);
  if (lead)
    asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(flag)
                 : "memory");
}

// The sums so far of a split k > 0, read past L1 (another SM wrote them),
// or split 0's +0 (reduce_kernel's sum from +0, so a -0 partial gives
// +0); a thread's reads are issued in batches of kDwLoads float2 before
// their adds, so that their latency is paid once a batch.
constexpr int kDwLoads = 8;

__device__ __forceinline__ float2 split_sums2(const float* out, bool add) {
  return add ? __ldcg(reinterpret_cast<const float2*>(out)) : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float split_sums1(const float* out, bool add) {
  return add ? __ldcg(out) : 0.0f;
}

// Rows [row0, row0 + rows) x columns [c0, c0 + cols) of the row-major
// out (ld columns) into L2 (the producer, for the consumers' reads of the
// sums so far of a tile it has just loaded the last stage of).
__device__ __forceinline__ void prefetch_rows(const float* out, long long ld, int row0, int rows,
                                              int c0, int cols) {
  for (int r = row0; r < row0 + rows; ++r)
    for (int c = c0; c < c0 + cols; c += 32)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(out + r * ld + c));
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

// Columns 4g .. 4g + 3 of rows r8 .. r8 + 7 of a stage's B slabs (at
// shared address b) into v: slab g / 16, box r8 / 32, the half g % 2 of
// 16-byte chunk (g % 16) / 2 of the box's row r, at chunk ((g % 16) / 2)
// ^ (r % 8).
__device__ __forceinline__ void dw_quad_rows(uint32_t b, int g, int r8, uint32_t (&v)[8][2]) {
  const uint32_t row = b + (g >> 4) * kTileSlab + (g & 1) * 8 + (r8 >> 5) * (kTileSlab / 2) +
                       (r8 & 31) * kSlabBytes;
  const int q = (g & 15) >> 1;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v[u][0]), "=r"(v[u][1])
                 : "r"(row + u * kSlabBytes + ((q ^ u) << 4)));
}

// Rows of a column that a db thread loads before it adds them: a stage's
// loads wait behind the wgmma's operand reads, so a stage takes two round
// trips (at 8 or 16 rows, the db warps set the pace of a W = 1024 level).
constexpr int kDwDbRows = 32;

// Column c of rows r0 .. r0 + kDwDbRows - 1 of a stage's B slabs (at
// shared address b) into v: slab c / 64, box r0 / 32, byte 2 (c % 8) of
// 16-byte chunk (c % 64) / 8 of the box's row r, at chunk ((c % 64) / 8) ^
// (r % 8).
__device__ __forceinline__ void dw_col_rows(uint32_t b, int c, int r0,
                                            unsigned short (&v)[kDwDbRows]) {
  const uint32_t row = b + (c >> 6) * kTileSlab + (c & 7) * 2 + (r0 >> 5) * (kTileSlab / 2) +
                       (r0 & 31) * kSlabBytes;
  const int q = (c & 63) >> 3;
#pragma unroll
  for (int u = 0; u < kDwDbRows; ++u)
    asm volatile("ld.shared.u16 %0, [%1];\n"
                 : "=h"(v[u])
                 : "r"(row + u * kSlabBytes + ((q ^ (u & 7)) << 4)));
}

// The columns [x, y) of its column block's db that a tile sums: the
// block's columns spread over its row blocks in runs of a multiple of
// four, so that each tile's db warps read 1 / tiles_m of a stage (a tile
// past the columns sums none).
__device__ __forceinline__ int2 dw_db_cols(const WideDwJob& jb, const WideDwTile& x, int bn) {
  const int cols = min(bn, jb.Nn - x.n0);
  const int per = ((cols + jb.tiles_m - 1) / jb.tiles_m + 3) & ~3;
  const int lo = min(cols, x.m0 / kWideRows * per);
  return make_int2(lo, min(cols, lo + per));
}

// A stage: A's two slabs of 64 output rows (consumer warpgroup w reads
// slab w), then B's BN / 64 slabs, each [64 rows x 64 columns] as two
// boxes of 32 rows. The empty barrier takes three arrivals a use: the two
// consumer warpgroups and the db warps (which wait for every stage and sum
// it where the tile has db columns, so they never run ahead of the ring
// or fall a phase behind). A thread's loads of a stage wait behind the
// wgmma's reads of it, so the db warps' time a stage is their round trips
// and adds: with a column block's db in its row-block-0 tile, four
// columns a thread, 8 rows a round trip, dW with db took 4.5-4.7 ms a W =
// 1024 level against 3.30 without db; spread over the row blocks, a
// column a thread, 5.4 at 8 or 16 rows a round trip, 3.5 at 32.
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
      mbar_init(empty + 8 * s, 3);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= 256) {  // the producer warpgroup: thread 256 copies, warps 9-11 sum db
    // 56 registers (kDwDbRows loads in flight); with the consumers' 224
    // the block's 168 x 384 it was launched with
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 256) {
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
        if (x.split > 0) {  // the sums so far, which the epilogue adds to
          const int rows = min(kWideRows, jb.M - x.m0), cols = min(BN, jb.Nn - x.n0);
          prefetch_rows(t.out + jb.out_off, jb.Nn, x.m0, rows, x.n0, cols);
          if (jb.db_off >= 0) {
            const int2 dc = dw_db_cols(jb, x, BN);
            if (dc.x < dc.y) prefetch_rows(t.out + jb.db_off, 0, 0, 1, x.n0 + dc.x, dc.y - dc.x);
          }
        }
      }
      return;
    }
    if (threadIdx.x < 256 + 32) return;
    // db: each column's rows in order (a stage's rows past the split or K
    // are zeros, and adding a zero to a sum that started from +0 leaves it
    // as it is) over the tile's columns of dw_db_cols: a thread a column,
    // or four (4 tt ..) where they are more than the 96 threads (a product
    // of one or two row blocks)
    const int tt = threadIdx.x - 288;
    const bool lead = tt == 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const WideDwTile x = dw_tile(t, item, BN);
      const WideDwJob& jb = t.job[x.jn];
      const int2 dc = jb.db_off >= 0 ? dw_db_cols(jb, x, BN) : make_int2(0, 0);
      const bool db = dc.x < dc.y, quads = dc.y - dc.x > kDwTransposers;
      const int c = dc.x + (quads ? 4 * tt : tt);
      const bool mine = db && c < dc.y;
      const int nk = dw_split_stages(t, item, chunk, kDwRowsBf16);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        if (mine) {
          const uint32_t b = smem_u32(base + stage * kStage + 2 * kTileSlab);
          if (quads) {
            for (int r8 = 0; r8 < kDwRowsBf16; r8 += 8) {
              uint32_t v[8][2];
              dw_quad_rows(b, c >> 2, r8, v);
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                s[0] += __uint_as_float(v[u][0] << 16);
                s[1] += __uint_as_float(v[u][0] & 0xffff0000u);
                s[2] += __uint_as_float(v[u][1] << 16);
                s[3] += __uint_as_float(v[u][1] & 0xffff0000u);
              }
            }
          } else {
            for (int r0 = 0; r0 < kDwRowsBf16; r0 += kDwDbRows) {
              unsigned short v[kDwDbRows];
              dw_col_rows(b, c, r0, v);
#pragma unroll
              for (int u = 0; u < kDwDbRows; ++u) s[0] += __uint_as_float((uint32_t)v[u] << 16);
            }
          }
        }
        bar_sync(kDwBarDb, kDwTransposers);  // every db thread read the stage
        if (lead) mbar_arrive(empty + 8 * stage);
        advance(stage, phase, kStages);
      }
      if (db) {
        int* flag = t.flags + (long long)x.tile * kDwParts + 2;
        split_wait(flag, x.split, lead, kDwBarDb, kDwTransposers);
        // a bias row may start at an odd offset (a view layer's, after Cd
        // density biases): one float at a time
        float* out = t.out + jb.db_off + x.n0 + c;
        const int n = mine ? min(quads ? 4 : 1, dc.y - c) : 0;
        const bool add = x.split > 0;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = e < n ? split_sums1(out + e, add) : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < n) out[e] = v[e] + s[e];
        split_done(flag, lead, kDwBarDb, kDwTransposers);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  float acc[BN / 2];
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
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
    // the tile decoded again here: nothing of it is held through the k-loop
    const WideDwTile x = dw_tile(t, item, BN);
    const WideDwJob& jb = t.job[x.jn];
    int* flag = t.flags + (long long)x.tile * kDwParts + wg;
    split_wait(flag, x.split, tid == 0, 1 + wg, 128);
    const bool add = x.split > 0;
    const int row0 = x.m0 + wg * 64 + (tid >> 5) * 16 + ((tid & 31) >> 2), qd = tid & 3;
    const bool r0 = row0 < jb.M, r1 = row0 + 8 < jb.M;
    float* o0 = t.out + jb.out_off + (long long)row0 * jb.Nn + x.n0 + 2 * qd;
    float* o1 = o0 + 8 * (long long)jb.Nn;
    const int nn = jb.Nn - x.n0 - 2 * qd;  // columns left from this thread's first
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kDwLoads / 2) {
      float2 v[kDwLoads];
#pragma unroll
      for (int u = 0; u < kDwLoads / 2; ++u) {
        const int j = j0 + u;
        const bool in = 8 * j < nn;
        v[2 * u] = split_sums2(o0 + 8 * j, add && in && r0);
        v[2 * u + 1] = split_sums2(o1 + 8 * j, add && in && r1);
      }
#pragma unroll
      for (int u = 0; u < kDwLoads / 2; ++u) {
        const int j = j0 + u;
        if (8 * j >= nn) continue;
        if (r0)
          *reinterpret_cast<float2*>(o0 + 8 * j) =
              make_float2(v[2 * u].x + acc[4 * j], v[2 * u].y + acc[4 * j + 1]);
        if (r1)
          *reinterpret_cast<float2*>(o1 + 8 * j) =
              make_float2(v[2 * u + 1].x + acc[4 * j + 2], v[2 * u + 1].y + acc[4 * j + 3]);
      }
    }
    split_done(flag, tid == 0, 1 + wg, 128);
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
        if (x.split > 0) {  // the sums so far, which the epilogue adds to
          const int rows = min(kWideRows, jb.M - x.m0), cols = min(128, jb.Nn - x.n0);
          prefetch_rows(t.out + jb.out_off, jb.Nn, x.m0, rows, x.n0, cols);
          if (jb.db_off >= 0 && x.m0 == 0) prefetch_rows(t.out + jb.db_off, 0, 0, 1, x.n0, cols);
        }
      }
      return;
    }
    // the transposers: column tt of every stage, and column 96 + tt for tt < 32
    const int tt = threadIdx.x - 288;
    const bool lead = tt == 0;
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
        int* flag = t.flags + (long long)x.tile * kDwParts + 2;
        split_wait(flag, x.split, lead, kDwBarDb, kDwTransposers);
        float* out = t.out + jb.db_off + x.n0;
        const bool add = x.split > 0;
        const bool p0 = x.n0 + tt < jb.Nn, p1 = tt < 32 && x.n0 + 96 + tt < jb.Nn;
        const float v0 = p0 ? split_sums1(out + tt, add) : 0.0f;
        const float v1 = p1 ? split_sums1(out + 96 + tt, add) : 0.0f;
        if (p0) out[tt] = v0 + s0;
        if (p1) out[96 + tt] = v1 + s1;
        split_done(flag, lead, kDwBarDb, kDwTransposers);
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
    int* flag = t.flags + (long long)x.tile * kDwParts + wg;
    split_wait(flag, x.split, tid == 0, 1 + wg, 128);
    const bool add = x.split > 0;
    const int nn = jb.Nn - x.n0 - 2 * tq;  // columns left from this thread's first
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = x.m0 + 32 * box + lc + 4 * h;
      if (row >= jb.M) continue;
      float* o = t.out + jb.out_off + (long long)row * jb.Nn + x.n0 + 2 * tq;
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += kDwLoads) {
        float2 v[kDwLoads];
#pragma unroll
        for (int u = 0; u < kDwLoads; ++u) v[u] = split_sums2(o + 8 * (j0 + u), add && 8 * (j0 + u) < nn);
#pragma unroll
        for (int u = 0; u < kDwLoads; ++u) {
          const int j = j0 + u;
          if (8 * j < nn)
            *reinterpret_cast<float2*>(o + 8 * j) =
                make_float2(v[u].x + acc[4 * j + 2 * h], v[u].y + acc[4 * j + 2 * h + 1]);
        }
      }
    }
    split_done(flag, tid == 0, 1 + wg, 128);
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
// b_layer of map b (Nn output columns), dW at out_off of the output, db
// (B's column sums) at db_off or none (-1).
struct WideDwProduct {
  int a, a_layer, M, b, b_layer, Nn;
  long long out_off, db_off;
};

// The tiles of a product at the smallest column block (128): the split
// counters a launch of it needs are kDwParts of them.
inline long long dw_tiles(int M, int Nn) { return (long long)cdiv(M, kWideRows) * cdiv(Nn, 128); }

// Split counters enough for any launch of a level of D trunk layers of W
// (each with a product from the previous layer and at most one from the
// KX feature columns), the first view layer from W and Dc - 1 of Wc.
inline long long dw_flag_bound(int D, int W, int Wc, int Dc, int KX) {
  return kDwParts * ((long long)D * (dw_tiles(W, W) + dw_tiles(KX, W)) + dw_tiles(W, Wc) +
                     (long long)(Dc > 1 ? Dc - 1 : 0) * dw_tiles(Wc, Wc));
}

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
// launch(grid, table): one persistent block an SM, at most one a work
// item; the split counters (n_flags of them at t.flags) zeroed on the
// stream before each launch.
template <class F>
inline cudaError_t dw_launches(WideDwTable& t, long long n_flags,
                               const std::vector<WideDwProduct>& prods, int bn, cudaStream_t st,
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
      jb.out_off = d.out_off; jb.db_off = d.db_off;
      jb.a = d.a; jb.a_layer = d.a_layer; jb.b = d.b; jb.b_layer = d.b_layer;
      jb.M = d.M; jb.Nn = d.Nn; jb.tiles_m = cdiv(d.M, kWideRows); jb.tile0 = t.tiles;
      t.tiles += jb.tiles_m * cdiv(d.Nn, bn);
    }
    const long long flags = (long long)kDwParts * t.tiles;
    if (!t.flags || flags > n_flags) return cudaErrorInvalidValue;
    if ((err = cudaMemsetAsync(t.flags, 0, flags * sizeof(int), st)) != cudaSuccess) return err;
    const long long items = (long long)t.splits * t.tiles;
    launch((unsigned)(items < sms ? items : sms), t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// bf16: the products whose columns 256 divides on wide_dw_kernel<256>,
// the others on wide_dw_kernel<128> (the parent's column blocks).
inline cudaError_t dw_run_bf16(WideDwTable& t, long long n_flags,
                               const std::vector<WideDwProduct>& prods, cudaStream_t st) {
  std::vector<WideDwProduct> p256, p128;
  for (const WideDwProduct& d : prods) (d.Nn % 256 == 0 ? p256 : p128).push_back(d);
  cudaError_t err;
  if (!p256.empty()) {
    if ((err = cudaFuncSetAttribute(wide_dw_kernel<256>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    dw_smem<256>())) != cudaSuccess ||
        (err = dw_launches(t, n_flags, p256, 256, st, [&](unsigned grid, const WideDwTable& tt) {
           wide_dw_kernel<256><<<grid, kWideThreads, dw_smem<256>(), st>>>(tt);
         })) != cudaSuccess)
      return err;
  }
  if (!p128.empty()) {
    if ((err = cudaFuncSetAttribute(wide_dw_kernel<128>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    dw_smem<128>())) != cudaSuccess ||
        (err = dw_launches(t, n_flags, p128, 128, st, [&](unsigned grid, const WideDwTable& tt) {
           wide_dw_kernel<128><<<grid, kWideThreads, dw_smem<128>(), st>>>(tt);
         })) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

inline cudaError_t dw_run_f32(WideDwTable& t, long long n_flags,
                              const std::vector<WideDwProduct>& prods, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwF32Smem);
  if (err != cudaSuccess) return err;
  return dw_launches(t, n_flags, prods, 128, st, [&](unsigned grid, const WideDwTable& tt) {
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

// Pass 5 of the wide routes: dW and db of every product of the level
// over the rows e.N of the activations, features and masked g in the
// workspace (e.acts, e.xs, e.grads at act_off), the splits added in order
// into out at output_offsets' offsets; n_flags split counters at flags
// (dw_flag_bound).
inline cudaError_t launch_wide_dw(const Params& p, const Extra& e, bool f32, float* out,
                                  int* flags, long long n_flags, int splits, cudaStream_t st) {
  WideDwTable t{};
  if (!dw_level_maps(p, e, f32, t.map)) return cudaErrorInvalidValue;
  t.out = out; t.flags = flags; t.splits = splits; t.K = (int)e.N;
  const std::vector<WideDwProduct> prods = dw_products(p);
  return f32 ? dw_run_f32(t, n_flags, prods, st) : dw_run_bf16(t, n_flags, prods, st);
}

// One product alone (csrc/wide_dw.cu): A [K, lda] (M columns read), B [K,
// ldb] (Nn columns), dW summed over the splits at 0 of out (row stride Nn)
// and db at db_off (or none, -1); n_flags split counters at flags
// (kDwParts dw_tiles(M, Nn)).
inline cudaError_t launch_wide_dw_one(bool f32, const void* A, int lda, int M, const void* B,
                                      int ldb, int Nn, int K, int splits, float* out,
                                      long long db_off, int* flags, long long n_flags,
                                      cudaStream_t st) {
  WideDwTable t{};
  const int es = f32 ? 4 : 2;
  if (!dw_map(&t.map[kDwActs], A, es, lda, M, K, 1, f32 ? 32 : 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !dw_map(&t.map[kDwGrads], B, es, ldb, Nn, K, 1, f32 ? 128 : 64,
              f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B) ||
      splits < 1 || Nn % 32 || !out || (reinterpret_cast<uintptr_t>(out) & 7))
    return cudaErrorInvalidValue;
  t.map[kDwViewActs] = t.map[kDwX] = t.map[kDwActs];
  t.map[kDwViewGrads] = t.map[kDwGrads];
  t.out = out; t.flags = flags; t.splits = splits; t.K = K;
  const std::vector<WideDwProduct> prods{{kDwActs, 0, M, kDwGrads, 0, Nn, 0, db_off}};
  return f32 ? dw_run_f32(t, n_flags, prods, st) : dw_run_bf16(t, n_flags, prods, st);
}

}  // namespace
