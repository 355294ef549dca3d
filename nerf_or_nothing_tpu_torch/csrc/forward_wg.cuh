// The bf16 MLP forward of render_level.cu and mlp_fwd.cu on sm_90a:
// warpgroup matrix products (wgmma) with both operands in shared memory,
// the weights streamed into a ring of slabs by bulk asynchronous copies,
// and warp specialisation.
//
// Bound: the products (1,082,624 FLOP a sample at the default config). The
// mma.sync forward of level_common.cuh read every weight fragment from L2
// once per 64 rows (about 63 FLOP a byte of L2 traffic) and ran its serial
// phases (IPE, epilogues, heads, composite) while the tensor cores idled.
// Here one block per SM is persistent and holds three warpgroups:
//  - thread 256: the producer. It copies the packed weights
//    (pack_params_wg: every matrix as slabs of 64 K-rows, each slab W^T
//    rows of 128 bytes in the 128-byte swizzle that a wgmma descriptor
//    reads) front to back into a ring of 2-4 slots, one cp.async.bulk per
//    slab, with an mbarrier full/empty pair per slot;
//  - warpgroups 0 and 1: the consumers. Each owns a 64-row sub-tile: its
//    features [64, KX] and activations [64, W] live in shared memory in the
//    same swizzled layout, as the A operand. Every slab feeds both
//    consumers (a slot is free once both have arrived), so the weights are
//    read from L2 once per 128 rows. Each layer is m64nNk16 wgmma, N a
//    compile-time width (by_width), four k-steps a slab with no branch
//    between them, one slab's products in flight behind the next; the sums
//    start from the bias (and the first view layer's direction term of the
//    row's ray), so the epilogue is one relu-and-round instruction per two
//    values, written back in place behind a barrier of the warpgroup only.
//    The heads are N=8 products, one for each group of 8 channels (the
//    last group's columns zero-padded);
//  - warps 9-11: the helpers. For each round they write both feature tiles
//    (the IPE with level_common.cuh's explicitly rounded polynomials, or
//    the features of mode "t") as soon as the consumers' last products
//    that read them are done, compute each unit's direction term d @ W_dir
//    (two buffers), and composite the round before from its raw heads (two
//    buffers), so none of that waits for or holds up the products. Named
//    barriers hand the tiles over (kBarXReady .. kBarOutEmpty).
// setmaxnreg gives the consumers 224 registers a thread (the 128 f32 sums
// of an m64n256 product and the rest) and the producer warpgroup 56: the
// 168 x 384 registers the launch holds (2 x 224 + 56 = 3 x 168; a larger
// request would wait for registers that never come).
// A work unit is RB whole rays (wg_rays: 128 rows, fewer when S does not
// divide 128, or S rows in several rounds when S > 128); the grid walks
// the units.
// forward_wg<false, true> is the train level's forward (train_wg.cuh): it
// also copies every activation tile and feature tile into the row-major
// workspace, stores each hidden layer's ReLU mask as bits in the wgmma
// accumulator layout (what the g-chain's epilogue reads), and writes the
// raw heads as [N, 4] rows. forward_wg<false, true, false> is mlp_bwd.cu's
// recomputed forward: the same stores without the heads, which its
// backward does not read (heads of any width would not fit [N, 4]); its
// producer streams the first group of 8 channels of each head, which its
// consumers multiply and discard.

#pragma once

#include "level_common.cuh"

namespace {

constexpr int kWgThreads = 384;  // consumers 0-255, producer 256, helpers 288-383
constexpr int kHelperBase = 288;
constexpr int kHelpers = kWgThreads - kHelperBase;
constexpr int kWgRows = 128;     // rows of a round: 2 consumers x 64
constexpr int kSlabBytes = 128;  // bytes of one slab row (64 bf16)
constexpr int kTileSlab = 8192;  // bytes of one 64-row slab of a tile
constexpr int kHeadN = 8;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Rows of a head of c channels in the slab streams (fused_level._wg_head):
// whole groups of kHeadN, each group its own slabs.
__host__ __device__ inline int head_cols(int c) { return cdiv(c, kHeadN) * kHeadN; }

// Phase clocks for profile_forward.py, compiled in only with
// FORWARD_WG_PHASES: consumer threads 0 and 128 and the first helper add
// the clock64() cycles of each phase to wg_phases[block][role][phase]
// (phase 7 of a consumer: %globaltimer nanoseconds of its whole run).
#ifdef FORWARD_WG_PHASES
__device__ unsigned long long wg_phases[256 * 3 * 8];
__device__ __forceinline__ void wg_phase_add(int phase, long long v) {
  const int role = threadIdx.x == 0 ? 0 : threadIdx.x == 128 ? 1 : threadIdx.x == 288 ? 2 : -1;
  if (role >= 0 && blockIdx.x < 256) wg_phases[(blockIdx.x * 3 + role) * 8 + phase] += v;
}
__device__ __forceinline__ long long wg_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
#define WG_CLOCK(t) const long long t = clock64()
#define WG_PHASE(phase, t) wg_phase_add(phase, clock64() - (t))
#define WG_NS(t) const long long t = wg_ns()
#define WG_PHASE_NS(phase, t) wg_phase_add(phase, wg_ns() - (t))
#else
#define WG_CLOCK(t)
#define WG_PHASE(phase, t)
#define WG_NS(t)
#define WG_PHASE_NS(phase, t)
#endif

struct WgParams {
  Params p;
  float* raw_rgb;     // mlp_fwd: [R * S, Cr]
  float* raw_den;     // mlp_fwd: [R * S, Cd]
  long long w_dir;    // element offset of the direction rows [Fd, Wc]
  int RB, ngroups, stages, nh, nc, nx;
  int off_h, off_x, off_out, off_dc, off_bar, h_bytes, x_bytes, slot;
  int bytes;          // dynamic shared memory of the launch
  // train level only (forward_wg<false, true>)
  bf16* acts;         // per layer [N, width] (act_off)
  bf16* xs;           // [N, KX]
  uint32_t* mask;     // ReLU bits per layer and sub-tile (mask_words)
  float* heads;       // [N, 4]: raw r, g, b, density
  long long N;
};

// Sub-tiles of 64 rows of the whole level: every unit counts as full, so a
// sub-tile's index depends only on its unit and round (the forward and the
// g-chain walk the units alike).
__host__ __device__ inline long long wg_subtiles(const WgParams& q) {
  return 2LL * q.ngroups * cdiv(q.RB * q.p.S, kWgRows);
}

// u32 words of one layer's ReLU mask for one thread of one sub-tile: a bit
// per accumulator value of its m64nN product (N / 2 values).
__host__ __device__ constexpr int mask_nw(int N) { return (N + 63) / 64; }

// Offset (in words) of layer L's masks: [layer][sub-tile][word][thread].
__host__ __device__ inline long long mask_off(const WgParams& q, int L) {
  const Params& p = q.p;
  const long long per = L < p.D ? (long long)L * mask_nw(p.W)
                                : (long long)p.D * mask_nw(p.W) + (long long)(L - p.D) * mask_nw(p.Wc);
  return per * 128 * wg_subtiles(q);
}

__host__ __device__ inline long long mask_words(const WgParams& q) {
  return mask_off(q, q.p.D + q.p.Dc);
}

// Rays of one unit: whole rays filling 128 rows, each buffer of the
// direction term [rays, Wc] f32 held to 16 KB (fused_level.wg_rays_per_group).
__host__ __device__ inline int wg_rays(int S, int Wc) {
  int rb = kWgRows / S;
  if (rb > 4096 / Wc) rb = 4096 / Wc;
  return rb < 1 ? 1 : rb;
}

// Shared-memory layout of the launch (fused_level.wg_smem): the ring, two
// activation and two feature tiles, the raw heads of two rounds (render)
// and the direction terms of two units, the barriers, and 1 KB to align
// the tiles to 1024 bytes.
// False when not even a ring of two slots fits.
inline bool init_wg(WgParams& q, bool composite) {
  const Params& p = q.p;
  q.RB = wg_rays(p.S, p.Wc);
  q.ngroups = cdiv(p.R, q.RB);
  q.nh = cdiv(p.W, 64);
  q.nc = cdiv(p.Wc, 64);
  q.nx = cdiv(p.KX, 64);
  q.slot = p.W * kSlabBytes;
  q.h_bytes = q.nh * kTileSlab;
  q.x_bytes = q.nx * kTileSlab;
  long long trunk = 0;
  for (int i = 0; i < p.D; ++i)
    trunk += (i == 0 ? 0 : q.nh) + ((i == 0 || i % p.skip == 0) ? q.nx : 0);
  q.w_dir = (trunk * p.W + (long long)q.nh * head_cols(p.Cd) + (long long)q.nh * p.Wc +
             (long long)(p.Dc - 1) * q.nc * p.Wc + (long long)q.nc * head_cols(p.Cr)) * 64;
  for (int stages = 4; stages >= 2; --stages) {
    int off = stages * q.slot;
    q.off_h = off;  off += 2 * q.h_bytes;
    q.off_x = off;  off += 2 * q.x_bytes;
    q.off_out = off; off += composite ? 2 * kWgRows * 16 : 0;
    q.off_dc = off; off += 2 * q.RB * p.Wc * 4;
    q.off_bar = off; off += 16 * stages;
    if (off + 1024 <= 232448) {
      q.stages = stages;
      q.bytes = off + 1024;
      return true;
    }
  }
  return false;
}

// ---- PTX helpers ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of the given parity to complete. A wait of more than
// 2^28 polls (seconds) traps: a lost arrival fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// v, hidden from the optimiser: what is computed from it is computed here,
// not hoisted out of the layer loop into registers held across it.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Keep the compiler from moving accumulator reads across the async products.
template <int R>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Descriptor of a K-major operand at shared address a: 128-byte swizzle,
// 8-row groups 1024 bytes apart (stride byte offset 64 x 16 B).
__device__ __forceinline__ uint64_t sdesc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Byte offset of element (row, col) in a swizzled tile of 64-col slabs.
__device__ __forceinline__ int swz(int row, int col) {
  const int kk = col & 63;
  return (col >> 6) * kTileSlab + row * kSlabBytes + ((((kk >> 3) ^ (row & 7))) << 4) +
         ((kk & 7) << 1);
}

// ---- wgmma m64nNk16, bf16 in, f32 sums in d[0 : N/2] ----
// A and B K-major in shared memory with the 128-byte swizzle; scale_d = 0
// overwrites d (the first k-step of a layer).
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<96>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<160>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<192>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<224>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
struct Width {
  static constexpr int value = N;
};

// f(Width<n>{}) for a width n that is a multiple of 32 up to 256: every
// product and epilogue is compiled for its N, so the four wgmma of a slab
// run back to back with no branch between them (ptxas serializes wgmma
// whose accumulators it cannot place across such branches).
template <class F>
__device__ __forceinline__ void by_width(int n, F&& f) {
  switch (n) {
    case 32: f(Width<32>{}); break;
    case 64: f(Width<64>{}); break;
    case 96: f(Width<96>{}); break;
    case 128: f(Width<128>{}); break;
    case 160: f(Width<160>{}); break;
    case 192: f(Width<192>{}); break;
    case 224: f(Width<224>{}); break;
    default: f(Width<256>{}); break;
  }
}

// The consumer's view of the ring: the slots and barriers in shared
// memory, the slot of the next slab and the parity of its pass.
struct Ring {
  uint32_t slots, full, empty;
  int slot, stages;
  int stage;
  uint32_t phase;
};

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

__device__ __forceinline__ void release(const Ring& r, int stage) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(r.empty + 8 * stage);
}

// Wait for the next slab of the stream and issue its four k-steps against
// the A slab at a, summing onto acc. Returns its slot.
template <int N>
__device__ __forceinline__ int slab_mma(Ring& r, float* acc, uint32_t a) {
  const int stage = r.stage;
  WG_CLOCK(t_wait);
  mbar_wait(r.full + 8 * stage, r.phase);
  WG_PHASE(1, t_wait);
  const uint32_t b = opaque(r.slots + stage * r.slot);
  a = opaque(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<N>(acc, sdesc(a + kk * 32), sdesc(b + kk * 32), 1);
  wgmma_commit();
  advance(r.stage, r.phase, r.stages);
  return stage;
}

// The sums' starting values, which define every sum register of the
// layer (so none stays live from an earlier one): a hidden layer's bias
// (plus, for the first view layer, the direction term of each row's ray),
// loaded straight into the registers before the products; zeros for a
// head, whose bias head_out adds.
template <int N>
__device__ __forceinline__ void init_acc(float* acc, const float* bias, const float* dc0,
                                         const float* dc1) {
  const int t = threadIdx.x & 127, qd = t & 3;
  const float* bq = bias + 2 * qd;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[4 * j] = __ldg(bq + 8 * j);
    acc[4 * j + 1] = __ldg(bq + 8 * j + 1);
    acc[4 * j + 2] = acc[4 * j];
    acc[4 * j + 3] = acc[4 * j + 1];
  }
  if (dc0) {
    const float* d0 = dc0 + 2 * qd;
    const float* d1 = dc1 + 2 * qd;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      acc[4 * j] += d0[8 * j];
      acc[4 * j + 1] += d0[8 * j + 1];
      acc[4 * j + 2] += d1[8 * j];
      acc[4 * j + 3] += d1[8 * j + 1];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
}

// acc[0 : N/2] += [A0 (n0 slabs) | A1 (n1 slabs)] @ the next n0 + n1 slabs
// of the stream (n0 + n1 > 0). Each slab is released once its products are
// done, with one slab's products in flight behind the next.
template <int N>
__device__ __forceinline__ void layer_gemm(Ring& r, uint32_t a0, int n0, uint32_t a1, int n1,
                                           float* acc) {
  int pending = slab_mma<N>(r, acc, n0 > 0 ? a0 : a1);
#pragma unroll 1
  for (int s = 1; s < n0 + n1; ++s) {
    const int stage =
        slab_mma<N>(r, acc, s < n0 ? a0 + s * kTileSlab : a1 + (s - n0) * kTileSlab);
    wgmma_wait<1>();
    release(r, pending);
    pending = stage;
  }
  wgmma_wait<0>();
  release(r, pending);
  fence_acc<N / 2>(acc);
}

// bf16x2 of relu(lo), relu(hi), rounded to nearest even: one instruction.
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t out;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

// H[:, :N] = round(relu(acc)) (acc holds the bias already), then make the
// tile visible to the warpgroup's next products.
template <int N>
__device__ __forceinline__ void epilogue_wg(const float* acc, unsigned char* H, int bar_id) {
  const int t = threadIdx.x & 127;
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2), qd = t & 3, r7 = row0 & 7;
  // Column 8j + 2qd of rows row0 and row0 + 8 (same row & 7): one base
  // address, the rest immediate offsets (swz()).
  unsigned char* h = H + row0 * kSlabBytes + 4 * qd;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    unsigned char* dst = h + (j >> 3) * kTileSlab + (((j & 7) ^ r7) << 4);
    *reinterpret_cast<uint32_t*>(dst) = relu_bf16x2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dst + 8 * kSlabBytes) =
        relu_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  fence_proxy_async();
  bar_sync(bar_id, 128);
}

// layer_gemm that runs after() once the first slab's products are issued:
// the train forward copies the tile before out while the tensor cores
// work (the next epilogue_store waits for every warp's copy). A copy split
// into one band of rows after each slab measured slower.
template <int N, class F>
__device__ __forceinline__ void layer_gemm_then(Ring& r, uint32_t a0, int n0, uint32_t a1,
                                                int n1, float* acc, F&& after) {
  int pending = slab_mma<N>(r, acc, n0 > 0 ? a0 : a1);
  after();
#pragma unroll 1
  for (int s = 1; s < n0 + n1; ++s) {
    const int stage =
        slab_mma<N>(r, acc, s < n0 ? a0 + s * kTileSlab : a1 + (s - n0) * kTileSlab);
    wgmma_wait<1>();
    release(r, pending);
    pending = stage;
  }
  wgmma_wait<0>();
  release(r, pending);
  fence_acc<N / 2>(acc);
}

// epilogue_wg of the train forward: first waits until every warp of the
// warpgroup has copied the tile out (store_tile), then also stores the
// ReLU mask: bit i of word i / 32 is set when the rounded value of acc[i]
// is > 0, words [mask_nw(N)][128 threads] at mask.
template <int N>
__device__ __forceinline__ void epilogue_store(const float* acc, unsigned char* H, int bar_id,
                                               uint32_t* mask) {
  bar_sync(bar_id, 128);
  const int t = threadIdx.x & 127;
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2), qd = t & 3, r7 = row0 & 7;
  unsigned char* h = H + row0 * kSlabBytes + 4 * qd;
  uint32_t bits[mask_nw(N)];
#pragma unroll
  for (int w = 0; w < mask_nw(N); ++w) bits[w] = 0u;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    unsigned char* dst = h + (j >> 3) * kTileSlab + (((j & 7) ^ r7) << 4);
    const uint32_t lo = relu_bf16x2(acc[4 * j], acc[4 * j + 1]);
    const uint32_t hi = relu_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    *reinterpret_cast<uint32_t*>(dst) = lo;
    *reinterpret_cast<uint32_t*>(dst + 8 * kSlabBytes) = hi;
    const uint32_t b4 = (uint32_t)((lo & 0x7FFFu) != 0u) |
                        ((uint32_t)((lo & 0x7FFF0000u) != 0u) << 1) |
                        ((uint32_t)((hi & 0x7FFFu) != 0u) << 2) |
                        ((uint32_t)((hi & 0x7FFF0000u) != 0u) << 3);
    bits[j >> 3] |= b4 << (4 * (j & 7));
  }
#pragma unroll
  for (int w = 0; w < mask_nw(N); ++w) mask[w * 128 + t] = bits[w];
  fence_proxy_async();
  bar_sync(bar_id, 128);
}

// Rows < nvalid of a swizzled [64, width] tile T to dst (row-major, width
// a multiple of 8), 16 bytes a thread, by threads t = 0 .. n - 1.
__device__ __forceinline__ void store_tile(const unsigned char* T, bf16* dst, int width,
                                           int nvalid, int t, int n) {
  const int C = width >> 3, drow = n / C, dc = n - drow * C;
  int row = t / C, c = t - row * C;  // chunk t, then every n-th
  while (row < nvalid) {
    *reinterpret_cast<uint4*>(dst + (long long)row * width + c * 8) =
        *reinterpret_cast<const uint4*>(T + (c >> 3) * kTileSlab + row * kSlabBytes +
                                        (((c & 7) ^ (row & 7)) << 4));
    row += drow;
    c += dc;
    if (c >= C) {
      c -= C;
      ++row;
    }
  }
}

// Head columns c < nc of rows < nvalid: out[row * ld + c] = acc + b[c].
__device__ __forceinline__ void head_out(const float* acc, const float* b, int nc, float* out,
                                         int ld, int nvalid) {
  const int t = opaque(static_cast<int>(threadIdx.x & 127));
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2), col = 2 * (t & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + (e >> 1) * 8, c = col + (e & 1);
    if (row < nvalid && c < nc) out[row * ld + c] = acc[e] + __ldg(b + c);
  }
}

// The IPE features of kItems (row, coordinate) items of one helper thread
// (kHelpers of them, h: 0 .. kHelpers - 1) into the swizzled tile X: each
// item's mean and variance loaded once (neighbouring threads on
// neighbouring floats), then every frequency of all the items, two
// frequencies at a time. One warp per scheduler, so the independent
// polynomial chains, with no branch between them, are what keeps it
// issuing. kFast: level_common.cuh's explicitly rounded polynomials, else
// sinf / cosf / expf; rows past nvalid get zeros.
constexpr int kItems = 64 * 3 / kHelpers;
static_assert(64 * 3 % kHelpers == 0, "every helper takes the same items");

template <bool kFast>
__device__ __forceinline__ void ipe_items(const Params& p, unsigned char* X, long long grow0,
                                          int nvalid, int h) {
  float m[kItems], var[kItems];
  bool valid[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = h + it * kHelpers;
    valid[it] = item / 3 < nvalid;
    m[it] = valid[it] ? p.means[grow0 * 3 + item] : 0.0f;
    var[it] = valid[it] ? __fmul_rn(p.vars[grow0 * 3 + item], 0.5f) : 0.0f;
  }
  float scale = ldexpf(1.0f, p.min_deg);  // 2^(min_deg + i), exact
#pragma unroll 2
  for (int i = 0; i < p.F; ++i, scale = __fmul_rn(scale, 2.0f)) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const float y = __fmul_rn(m[it], scale);
      const float v = __fmul_rn(var[it], __fmul_rn(scale, scale));
      float sn, cs, damp;
      if (kFast) {
        fast_sincos(y, &sn, &cs);
        damp = fast_exp_neg(v);
      } else {
        sn = sinf(y);
        cs = cosf(y);
        damp = expf(-v);
      }
      const float fs = valid[it] ? __fmul_rn(damp, sn) : 0.0f;
      const float fc = valid[it] ? __fmul_rn(damp, cs) : 0.0f;
      // columns 6i + a and 6i + a + 3 of the item's row
      const int item = h + it * kHelpers, row = item / 3, a = item - 3 * row;
      *reinterpret_cast<bf16*>(X + swz(row, 6 * i + a)) = __float2bfloat16_rn(fs);
      *reinterpret_cast<bf16*>(X + swz(row, 6 * i + a + 3)) = __float2bfloat16_rn(fc);
    }
  }
}

// The features of rows [grow0, grow0 + nvalid) into the swizzled tile X
// (columns [0, KX), zeros past LX and past nvalid; the columns past KX
// stay as zeroed at the start), by the helper threads.
__device__ __forceinline__ void load_x_wg(const Params& p, unsigned char* X, long long grow0,
                                          int nvalid, int h) {
  if (p.mode == 0) {
    if (p.fast)
      ipe_items<true>(p, X, grow0, nvalid, h);
    else
      ipe_items<false>(p, X, grow0, nvalid, h);
  } else if (p.LX % 8 == 0) {  // 16-byte chunks, neighbouring threads on neighbours
    const uint4* x = static_cast<const uint4*>(p.x);
    const int cx = p.KX >> 3, cl = p.LX >> 3;
    for (int idx = h; idx < 64 * cx; idx += kHelpers) {
      const int row = idx / cx, c = idx - row * cx;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < nvalid && c < cl) v = x[(grow0 + row) * cl + c];
      *reinterpret_cast<uint4*>(X + (c >> 3) * kTileSlab + row * kSlabBytes +
                                (((c & 7) ^ (row & 7)) << 4)) = v;
    }
  } else {
    const bf16* x = static_cast<const bf16*>(p.x);
    for (int idx = h; idx < 64 * p.KX; idx += kHelpers) {
      const int row = idx / p.KX, col = idx - row * p.KX;
      bf16 v = __float2bfloat16_rn(0.0f);
      if (row < nvalid && col < p.LX) v = x[(grow0 + row) * p.LX + col];
      *reinterpret_cast<bf16*>(X + swz(row, col)) = v;
    }
  }
  fence_proxy_async();
}

// DC[r, :] = d[ray0 + r, :] @ W_dir (f32 sum of bf16 products) for the
// unit's nr rays, by the helper threads (h as in load_x_wg).
__device__ __forceinline__ void direction_term_wg(const WgParams& q, float* DC, int ray0, int nr,
                                                  int h) {
  const Params& p = q.p;
  const bf16* d = static_cast<const bf16*>(p.d);
  const bf16* wd = static_cast<const bf16*>(p.w) + q.w_dir;
  for (int idx = h; idx < q.RB * p.Wc; idx += kHelpers) {
    const int r = idx / p.Wc, n = idx - r * p.Wc;
    float s = 0.0f;
    if (r < nr) {
      const bf16* dr = d + (long long)(ray0 + r) * p.Fd;
#pragma unroll 9
      for (int k = 0; k < p.Fd; ++k) s = fmaf(to_f(dr[k]), to_f(wd[k * p.Wc + n]), s);
    }
    DC[idx] = s;
  }
}

struct CompState {
  float carry, a, r, g, b;
};

// One warp composites samples [s0, s1) of a ray from raw heads out (one
// row of 4 per sample from s0), carrying the transmittance and the sums in
// st; with fin, reduces the sums and writes comp and acc.
__device__ __forceinline__ void composite_span(const Params& p, const float* out, long long ray, int s0,
                               int s1, CompState& st, bool fin) {
  const int lane = threadIdx.x & 31;
  const float pad = p.rgb_padding;
  for (int sb = s0; sb < s1; sb += 32) {
    const int s = sb + lane;
    const bool valid = s < s1;
    float sd = 0.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
    if (valid) {
      const float* o = out + (s - s0) * 4;
      const float sigma = softplus(o[3] + p.density_bias);
      sd = sigma * p.delta[ray * p.S + s];
      rr = sigmoid(o[0]) * (1.0f + 2.0f * pad) - pad;
      rg = sigmoid(o[1]) * (1.0f + 2.0f * pad) - pad;
      rb = sigmoid(o[2]) * (1.0f + 2.0f * pad) - pad;
    }
    float incl = sd;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float trans = expf(-(st.carry + excl));
    const float alpha = 1.0f - expf(-sd);
    const float w = valid ? alpha * trans : 0.0f;
    if (valid) p.weights[ray * p.S + s] = w;
    st.a += w;
    st.r += w * rr;
    st.g += w * rg;
    st.b += w * rb;
    st.carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (fin) {
    const float a_acc = warp_sum(st.a), cr = warp_sum(st.r), cg = warp_sum(st.g),
                cb = warp_sum(st.b);
    if (lane == 0) {
      const float bg = p.white_bkgd ? 1.0f - a_acc : 0.0f;
      p.comp[ray * 3 + 0] = cr + bg;
      p.comp[ray * 3 + 1] = cg + bg;
      p.comp[ray * 3 + 2] = cb + bg;
      p.acc[ray] = a_acc;
    }
  }
}

// How the producer streams the heads' slabs: the one group of 8 channels of
// the level kernels' heads (kLevelHeads), every group (kAllGroups: mlp_fwd,
// which writes every channel), or the first group of each head and not the
// others (kFirstGroup: mlp_bwd's recomputed forward, which multiplies the
// first group and discards it).
enum { kLevelHeads = 0, kAllGroups = 1, kFirstGroup = 2 };

// The producer: every slab of the stream, once per round of every unit of
// this block, in the consumers' order (the heads' as kGroups says).
template <int kGroups>
__device__ __forceinline__ void produce(const WgParams& q, uint32_t slots, uint32_t full, uint32_t empty) {
  const Params& p = q.p;
  const unsigned char* w = static_cast<const unsigned char*>(p.w);
  int stage = 0;
  uint32_t phase = 0;
  bool wrapped = false;  // every slot has been filled once
  for (int grp = blockIdx.x; grp < q.ngroups; grp += gridDim.x) {
    const int nr = min(q.RB, p.R - grp * q.RB);
    for (int r0 = 0; r0 < nr * p.S; r0 += kWgRows) {
      long long off = 0;
      auto put = [&](int nslab, int bytes) {
        for (int s = 0; s < nslab; ++s) {
          if (wrapped) mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, bytes);
          bulk_copy(slots + stage * q.slot, w + off, bytes, full + 8 * stage);
          off += bytes;
          advance(stage, phase, q.stages);
          wrapped = wrapped || stage == 0;
        }
      };
      // a head's slabs on k-slabs of its input: every group, or the first
      auto put_head = [&](int nk, int c) {
        if constexpr (kGroups == kAllGroups) {
          put(nk * cdiv(c, kHeadN), kHeadN * kSlabBytes);
        } else {
          put(nk, kHeadN * kSlabBytes);
          if constexpr (kGroups == kFirstGroup)
            off += (long long)(cdiv(c, kHeadN) - 1) * nk * kHeadN * kSlabBytes;
        }
      };
      for (int i = 0; i < p.D; ++i)
        put((i == 0 ? 0 : q.nh) + ((i == 0 || i % p.skip == 0) ? q.nx : 0),
            p.W * kSlabBytes);
      put_head(q.nh, p.Cd);
      put(q.nh, p.Wc * kSlabBytes);
      for (int j = 1; j < p.Dc; ++j) put(q.nc, p.Wc * kSlabBytes);
      put_head(q.nc, p.Cr);
    }
  }
}

// Named barriers between the consumer warpgroups (w = 0, 1) and the
// helpers; round k of the block uses the buffers k & 1.
constexpr int kBarXReady = 4;  // + w: helpers wrote X[w] (consumer w waits)
constexpr int kBarXFree = 6;   // + w: consumer w's products read X[w] (helpers wait)
constexpr int kBarOutFull = 8;    // + b: both consumers wrote the heads to OUT[b]
constexpr int kBarOutEmpty = 10;  // + b: the helpers composited OUT[b]
constexpr int kBarHelp = 12;   // the helpers alone
constexpr int kXSync = 128 + kHelpers;
constexpr int kOutSync = 256 + kHelpers;

// Rounds of 128 rows this block runs: every unit's rows, unit by unit.
__device__ __forceinline__ int block_rounds(const WgParams& q) {
  int k = 0;
  for (int grp = blockIdx.x; grp < q.ngroups; grp += gridDim.x)
    k += cdiv(min(q.RB, q.p.R - grp * q.RB) * q.p.S, kWgRows);
  return k;
}

// The helpers (warps 9-11): for each round, the direction term of a new
// unit and both feature tiles as soon as the consumers' last products that
// read them are done; then (render) the composite of the round before,
// from the raw heads in OUT: one warp a ray, or warp 0 carrying one ray
// over several rounds when S > 128. kStore: each feature tile also goes to
// q.xs once the consumer may read it.
template <bool kRender, bool kStore>
__device__ __forceinline__ void help(const WgParams& q, unsigned char* X0, float* OUT,
                                     float* DC) {
  const Params& p = q.p;
  const int h = threadIdx.x - kHelperBase, warp = h >> 5;
  WG_CLOCK(t_help);
  const int K = block_rounds(q);
  int k = 0, u = 0;
  int pend_ray0 = 0, pend_nr = 0, pend_r0 = 0, pend_rows = 0;
  CompState st{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  auto composite_round = [&](int kk) {  // round kk, described by pend_*
    float* out = OUT + (kk & 1) * kWgRows * 4;
    WG_CLOCK(t_full);
    bar_sync(kBarOutFull + (kk & 1), kOutSync);
    WG_PHASE(5, t_full);
    WG_CLOCK(t_comp);
    if (p.S <= kWgRows) {
      for (int r = warp; r < pend_nr; r += kHelpers / 32) {
        CompState s{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        composite_span(p, out + r * p.S * 4, pend_ray0 + r, 0, p.S, s, true);
      }
    } else if (warp == 0) {
      if (pend_r0 == 0) st = CompState{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      composite_span(p, out, pend_ray0, pend_r0, min(p.S, pend_r0 + kWgRows), st,
                     pend_r0 + kWgRows >= pend_rows);
    }
    WG_PHASE(6, t_comp);
    if (kk + 2 < K) bar_arrive(kBarOutEmpty + (kk & 1), kOutSync);
  };
  for (int grp = blockIdx.x; grp < q.ngroups; grp += gridDim.x, ++u) {
    const int ray0 = grp * q.RB;
    const int nr = min(q.RB, p.R - ray0);
    const int rows = nr * p.S;
    for (int r0 = 0; r0 < rows; r0 += kWgRows, ++k) {
      for (int w = 0; w < 2; ++w) {
        WG_CLOCK(t_free);
        if (k > 0) bar_sync(kBarXFree + w, kXSync);
        WG_PHASE(3, t_free);
        WG_CLOCK(t_dc);
        if (r0 == 0 && w == 0) direction_term_wg(q, DC + (u & 1) * q.RB * p.Wc, ray0, nr, h);
        WG_PHASE(2, t_dc);
        WG_CLOCK(t_x);
        const int sub0 = r0 + w * 64;
        load_x_wg(p, X0 + w * q.x_bytes, (long long)ray0 * p.S + sub0,
                  max(0, min(64, rows - sub0)), h);
        WG_PHASE(4, t_x);
        bar_arrive(kBarXReady + w, kXSync);
        if constexpr (kStore) {  // every helper's part of the tile is written
          bar_sync(kBarHelp, kHelpers);
          store_tile(X0 + w * q.x_bytes, q.xs + ((long long)ray0 * p.S + sub0) * p.KX, p.KX,
                     max(0, min(64, rows - sub0)), h, kHelpers);
        }
      }
      if (kRender && k > 0) composite_round(k - 1);
      pend_ray0 = ray0; pend_nr = nr; pend_r0 = r0; pend_rows = rows;
    }
  }
  if (kRender && K > 0) composite_round(K - 1);
  WG_PHASE(0, t_help);
}

// The whole kernel body; kRender: composite into comp/acc/weights, else
// the raw heads to raw_rgb/raw_den, or with kStore (the train level) to
// q.heads (unless kHeads is false) with the activations, features and
// masks. Launch with kWgThreads threads and q.bytes of dynamic shared
// memory.
template <bool kRender, bool kStore = false, bool kHeads = true>
__device__ __forceinline__ void forward_wg(const WgParams& q, unsigned char* smem_raw) {
  const Params& p = q.p;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t slots = smem_u32(base);
  const uint32_t full = smem_u32(base + q.off_bar);
  const uint32_t empty = full + 8 * q.stages;
  unsigned char* X0 = base + q.off_x;
  float* OUT = reinterpret_cast<float*>(base + q.off_out);
  float* DC = reinterpret_cast<float*>(base + q.off_dc);
  if (threadIdx.x == 0) {
    for (int s = 0; s < q.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Zero the tiles once: a product reads whole 64-column slabs, and the
  // columns past W and past KX (zero rows in the pack) are never written.
  for (int i = threadIdx.x; i < (2 * q.h_bytes + 2 * q.x_bytes) / 16; i += kWgThreads)
    reinterpret_cast<uint4*>(base + q.off_h)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: the producer and the helpers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 256)
      produce<kRender || (kStore && kHeads) ? kLevelHeads
              : kStore                      ? kFirstGroup
                                            : kAllGroups>(q, slots, full, empty);
    if (threadIdx.x >= kHelperBase) help<kRender, kStore>(q, X0, OUT, DC);
    return;
  }
  // consumer warpgroups 0 and 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = threadIdx.x >> 7, bar_id = 1 + wg;
  unsigned char* H = base + q.off_h + wg * q.h_bytes;
  const uint32_t hs = smem_u32(H), xs = smem_u32(X0 + wg * q.x_bytes);
  const float* b = p.b;
  const int t = threadIdx.x & 127;
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2);
  const int last_x = ((p.D - 1) / p.skip) * p.skip;  // the last layer reading X
  const int K = block_rounds(q);
  Ring ring{slots, full, empty, q.slot, q.stages, 0, 0u};
  float acc[128];
  int k = 0, u = 0;
  WG_CLOCK(t_run);
  WG_NS(ns_run);
  for (int grp = blockIdx.x; grp < q.ngroups; grp += gridDim.x, ++u) {
    const int ray0 = grp * q.RB;
    const int nr = min(q.RB, p.R - ray0);
    const int rows = nr * p.S;
    const float* DCu = DC + (u & 1) * q.RB * p.Wc;
    for (int r0 = 0; r0 < rows; r0 += kWgRows, ++k) {
      const int sub0 = r0 + wg * 64;  // first row of the sub-tile in the unit
      const int nvalid = max(0, min(64, rows - sub0));
      const long long grow0 = (long long)ray0 * p.S + sub0;
      float* out = OUT + (k & 1) * kWgRows * 4 + (wg * 64) * 4;
      // kStore: this sub-tile's masks, and the copy of layer L's tile (in
      // H while the next products read it) to the workspace
      const long long sid = ((long long)grp * cdiv(q.RB * p.S, kWgRows) + r0 / kWgRows) * 2 + wg;
      auto copy_out = [&](int L, int width) {
        if constexpr (kStore)
          store_tile(H, q.acts + act_off(p, q.N, L) + grow0 * width, width, nvalid, t, 128);
      };
      WG_CLOCK(t_ready);
      bar_sync(kBarXReady + wg, kXSync);
      WG_PHASE(3, t_ready);
      by_width(p.W, [&](auto w) {
        constexpr int N = decltype(w)::value;
        for (int i = 0; i < p.D; ++i) {
          const bool xin = i == 0 || i % p.skip == 0;
          WG_CLOCK(t_mma);
          init_acc<N>(acc, b + i * p.W, nullptr, nullptr);
          if constexpr (kStore)
            layer_gemm_then<N>(ring, hs, i == 0 ? 0 : q.nh, xs, xin ? q.nx : 0, acc, [&] {
              if (i > 0) copy_out(i - 1, p.W);
            });
          else
            layer_gemm<N>(ring, hs, i == 0 ? 0 : q.nh, xs, xin ? q.nx : 0, acc);
          WG_PHASE(5, t_mma);
          if (i == last_x && k + 1 < K) bar_arrive(kBarXFree + wg, kXSync);
          WG_CLOCK(t_epi);
          if constexpr (kStore)
            epilogue_store<N>(acc, H, bar_id, q.mask + mask_off(q, i) + sid * mask_nw(N) * 128);
          else
            epilogue_wg<N>(acc, H, bar_id);
          WG_PHASE(4, t_epi);
        }
      });
      WG_CLOCK(t_den);
      if constexpr (!kRender && !kStore) {  // mlp_fwd: every group of 8 channels
        for (int c0 = 0; c0 < p.Cd; c0 += kHeadN) {
          zero_acc<kHeadN>(acc);
          layer_gemm<kHeadN>(ring, hs, q.nh, 0, 0, acc);
          head_out(acc, b + p.b_den + c0, min(kHeadN, p.Cd - c0), q.raw_den + grow0 * p.Cd + c0,
                   p.Cd, nvalid);
        }
      } else {
        zero_acc<kHeadN>(acc);
        if constexpr (kStore)
          layer_gemm_then<kHeadN>(ring, hs, q.nh, 0, 0, acc, [&] { copy_out(p.D - 1, p.W); });
        else
          layer_gemm<kHeadN>(ring, hs, q.nh, 0, 0, acc);
      }
      WG_PHASE(2, t_den);
      if constexpr (kStore) {
        if constexpr (kHeads) head_out(acc, b + p.b_den, p.Cd, q.heads + grow0 * 4 + 3, 4, nvalid);
      } else if (kRender) {
        WG_CLOCK(t_empty);
        if (k >= 2) bar_sync(kBarOutEmpty + (k & 1), kOutSync);
        WG_PHASE(6, t_empty);
        head_out(acc, b + p.b_den, p.Cd, out + 3, 4, nvalid);
      }
      // the direction term of each row's ray (rows past the unit clamp)
      const float* dc0 = DCu + min((sub0 + row0) / p.S, q.RB - 1) * p.Wc;
      const float* dc1 = DCu + min((sub0 + row0 + 8) / p.S, q.RB - 1) * p.Wc;
      by_width(p.Wc, [&](auto w) {
        constexpr int N = decltype(w)::value;
        for (int j = 0; j < p.Dc; ++j) {
          WG_CLOCK(t_mma);
          init_acc<N>(acc, b + p.b_v0 + j * p.Wc, j == 0 ? dc0 : nullptr,
                      j == 0 ? dc1 : nullptr);
          if constexpr (kStore)
            layer_gemm_then<N>(ring, hs, j == 0 ? q.nh : q.nc, 0, 0, acc, [&] {
              if (j > 0) copy_out(p.D + j - 1, p.Wc);
            });
          else
            layer_gemm<N>(ring, hs, j == 0 ? q.nh : q.nc, 0, 0, acc);
          WG_PHASE(5, t_mma);
          WG_CLOCK(t_epi);
          if constexpr (kStore)
            epilogue_store<N>(acc, H, bar_id,
                              q.mask + mask_off(q, p.D + j) + sid * mask_nw(N) * 128);
          else
            epilogue_wg<N>(acc, H, bar_id);
          WG_PHASE(4, t_epi);
        }
      });
      WG_CLOCK(t_rgb);
      if constexpr (!kRender && !kStore) {
        for (int c0 = 0; c0 < p.Cr; c0 += kHeadN) {
          zero_acc<kHeadN>(acc);
          layer_gemm<kHeadN>(ring, hs, q.nc, 0, 0, acc);
          head_out(acc, b + p.b_rgb + c0, min(kHeadN, p.Cr - c0), q.raw_rgb + grow0 * p.Cr + c0,
                   p.Cr, nvalid);
        }
      } else {
        zero_acc<kHeadN>(acc);
        if constexpr (kStore)
          layer_gemm_then<kHeadN>(ring, hs, q.nc, 0, 0, acc,
                                  [&] { copy_out(p.D + p.Dc - 1, p.Wc); });
        else
          layer_gemm<kHeadN>(ring, hs, q.nc, 0, 0, acc);
      }
      WG_PHASE(2, t_rgb);
      if constexpr (kStore) {
        if constexpr (kHeads) head_out(acc, b + p.b_rgb, p.Cr, q.heads + grow0 * 4, 4, nvalid);
      } else if (kRender) {
        head_out(acc, b + p.b_rgb, p.Cr, out, 4, nvalid);
        bar_arrive(kBarOutFull + (k & 1), kOutSync);
      }
    }
  }
  WG_PHASE(0, t_run);
  WG_PHASE_NS(7, ns_run);
}

// Set the shared memory and launch one persistent block per SM (at most
// one per unit).
inline cudaError_t launch_wg(void (*kernel)(WgParams), const WgParams& q, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = q.ngroups < sms ? q.ngroups : sms;
  kernel<<<grid, kWgThreads, q.bytes, st>>>(q);
  return cudaGetLastError();
}

}  // namespace
