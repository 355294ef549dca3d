// The bf16 passes of train_level.cu on sm_90a: the forward that keeps its
// activations, a composite launch of its own, the g-chain as a
// warp-specialised wgmma kernel, the view layer's per-ray sums and the dW
// GEMM on wgmma; passes 6-7 (small products, reduction) are
// level_backward.cuh's launch_small_reduce.
//
// Bound: the products (412.8 GFLOP a level at the default config) and,
// with the activations parked in the workspace, ~2.9 GB of HBM traffic
// (~0.87 ms at 3.35 TB/s): the forward writes 570 MB of activations, the
// chain writes 570 MB of masked g, the dW GEMM reads both.
//
//  1. train_fwd_wg_kernel: forward_wg<false, true> (forward_wg.cuh), the
//     mlp_fwd route of the wgmma forward. Each consumer copies its
//     activation tile to the workspace while the next layer's products
//     run, stores the tile's ReLU mask as bits in the accumulator layout
//     (one u32 per 64 columns a thread, 1/16 of the activations' bytes),
//     and writes the raw heads as [N, 4] f32; the helpers copy each
//     feature tile (the IPE in mode "mv") to xs.
//  2. train_composite_kernel: level_backward.cuh's composite_train on the
//     raw heads in global memory, one warp per ray (any S, ragged R):
//     comp, acc, weights, g_rgb and g_den.
//  3. chain_wg_kernel: the g-chain, top layer first, built like the
//     forward: one persistent block per SM walks the forward's units; the
//     producer streams pack_params_wgt's slabs (each chained layer's W^T
//     as the K-major B operand: W's own rows) into a ring with
//     cp.async.bulk; two consumer warpgroups of 64 rows each run
//     g @ W^T as m64nNk16 wgmma with the masked g tile [64, K] as A in the
//     same 128-byte swizzle. The epilogue rounds (adds the density head's
//     term on the view chain, rounded), zeroes where the forward's mask
//     bit is clear (prefetched into registers while the products run) and
//     writes the next A tile in place. The rgb head's K=3 product from
//     the f32 cotangents starts the chain in registers. The helper warps
//     take each masked tile while the next products run: copy it to the
//     row-major grads 16 bytes a thread and sum its columns into the
//     block's db (f32, in a fixed order); each block writes its db
//     partial row to dbpart, which pass 6 reduces with the rest (no
//     atomics: bit-equal dW/db over two launches).
//     chain_wg_kernel<kCr, kCd, kDx> is also mlp_bwd.cu's chain: heads of
//     any width (kCr = kCd = 0: read from the Params; 3 and 1 is
//     the train level's instantiation), and with kDx the chain's stream
//     (fused_level.pack_params_wgx) also holds W_x^T of layer 0 and of each
//     skip layer, zero-padded to nxw columns (KX rounded up to 32, a width
//     by_width has): after the epilogue of such a layer the masked g tile
//     is also the A operand of g @ W_x^T, whose rounded sum each consumer
//     thread adds to its own part of the sub-tile's dX in shared memory
//     (bf16, the deepest skip layer first), layer 0's last, straight to dX.
//  4. g_ray_kernel: the first view layer's masked g summed per ray (f32),
//     for the direction rows' dW.
//  5. dw_wg_kernel: dW = act^T g of every layer over the rows, split into
//     the backward's fixed chunks: both operands stored row-major, so
//     MN-major for this product, which wgmma takes from shared memory
//     through its transpose bits; nothing is transposed in memory.
// The rounding is the mma.sync chain's: bf16 after every product, the
// density term rounded and added in bf16, the mask after rounding.

#pragma once

#include "forward_wg.cuh"
#include "level_backward.cuh"

namespace {

constexpr int kMaxChainBlocks = 256;  // rows of dbpart the workspace holds
constexpr int kBarGFull = 4;  // + w: consumer w wrote its masked g tile (helpers wait)
constexpr int kBarGFree = 6;  // + w: the helpers have read it (consumer w waits)
constexpr int kGSync = 128 + kHelpers;

struct ChainParams {
  WgParams q;          // the forward's units and Params
  const bf16* wt;      // pack_params_wgt (or _wgx): the chain's slabs, then
                       // W_rgb^T [Cr, Wc], W_den^T [Cd, W]
  long long w_rgb, w_den;  // element offsets of the two head matrices in wt
  const uint32_t* mask;    // the forward's ReLU bits
  const float* g_rgb;  // [N, Cr]
  const float* g_den;  // [N, Cd]
  bf16* grads;         // masked g per layer [N, width] (act_off)
  float* dbpart;       // [gridDim.x, nb]
  bf16* dx;            // kDx: [N, LX]
  int nb, stages, slot, g_bytes, off_g, off_part, off_db, off_bar, bytes;
  int nxw;             // columns of the x rows' slabs in the stream (0: none)
  int dx_bytes, off_dx;  // kDx: one consumer's dX partial [64, nxw] bf16
};

// Elements of the chain's slabs: views Dc-1 .. 1 (K = Wc, N = Wc), view 0
// (K = Wc, N = W), trunk D-1 .. 1 (K = W, N = W).
__host__ __device__ inline long long chain_slab_elems(const Params& p) {
  const int nh = cdiv(p.W, 64), nc = cdiv(p.Wc, 64);
  return ((long long)(p.Dc - 1) * nc * p.Wc + (long long)nc * p.W +
          (long long)(p.D - 1) * nh * p.W) * 64;
}

// Whether layer i multiplies the features x: layer 0 and the skip layers.
__host__ __device__ inline bool x_layer(const Params& p, int i) {
  return i == 0 || i % p.skip == 0;
}

// Elements of the x rows' slabs in a pack_params_wgx stream: W_x^T
// [W, nxw] of every x layer.
__host__ __device__ inline long long chain_x_elems(const Params& p, int nxw) {
  int n = 0;
  for (int i = 0; i < p.D; ++i) n += x_layer(p, i);
  return (long long)n * cdiv(p.W, 64) * nxw * 64;
}

// Shared memory: the ring (slots of the widest slab, W or with dx nxw x
// 128 bytes), two g tiles [64, W], with dx two dX partials [64, nxw]
// bf16, the helpers' column partials (two buffers of kHelpers x 8 f32),
// the block's db, the barriers and 1 KB of alignment
// (fused_level.chain_wg_smem). x_stream: the stream holds the x rows'
// slabs (pack_params_wgx), which only dx multiplies. False when not even
// a ring of two slots fits, or with dx the x rows are wider than 256.
inline bool init_chain(ChainParams& c, const WgParams& q, bool x_stream = false,
                       bool dx = false) {
  const Params& p = q.p;
  c.q = q;
  c.nb = num_biases(p);
  c.nxw = x_stream ? cdiv(p.KX, 32) * 32 : 0;
  if (dx && c.nxw > 256) return false;
  c.slot = (dx && c.nxw > p.W ? c.nxw : p.W) * kSlabBytes;
  c.g_bytes = q.nh * kTileSlab;
  c.dx_bytes = dx ? 64 * c.nxw * 2 : 0;
  c.dx = nullptr;
  c.w_rgb = chain_slab_elems(p) + chain_x_elems(p, c.nxw);
  c.w_den = c.w_rgb + (long long)p.Cr * p.Wc;
  for (int stages = 4; stages >= 2; --stages) {
    int off = stages * c.slot;
    c.off_g = off;    off += 2 * c.g_bytes;
    c.off_dx = off;   off += 2 * c.dx_bytes;
    c.off_part = off; off += 2 * kHelpers * 8 * 4;
    c.off_db = off;   off += (c.nb * 4 + 15) / 16 * 16;
    c.off_bar = off;  off += 16 * stages;
    if (off + 1024 <= 232448) {
      c.stages = stages;
      c.bytes = off + 1024;
      return true;
    }
  }
  return false;
}

// The producer: the chain's slabs, once per round of every unit of this
// block, in the consumers' order; a stream's x rows are skipped unless
// the consumers multiply them (dx).
__device__ __forceinline__ void produce_chain(const ChainParams& c, uint32_t slots,
                                              uint32_t full, uint32_t empty, bool dx) {
  const WgParams& q = c.q;
  const Params& p = q.p;
  const unsigned char* w = reinterpret_cast<const unsigned char*>(c.wt);
  int stage = 0;
  uint32_t phase = 0;
  bool wrapped = false;
  for (int grp = blockIdx.x; grp < q.ngroups; grp += gridDim.x) {
    const int nr = min(q.RB, p.R - grp * q.RB);
    for (int r0 = 0; r0 < nr * p.S; r0 += kWgRows) {
      long long off = 0;
      auto put = [&](int nslab, int bytes) {
        for (int s = 0; s < nslab; ++s) {
          if (wrapped) mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, bytes);
          bulk_copy(slots + stage * c.slot, w + off, bytes, full + 8 * stage);
          off += bytes;
          advance(stage, phase, c.stages);
          wrapped = wrapped || stage == 0;
        }
      };
      for (int j = p.Dc - 1; j >= 1; --j) put(q.nc, p.Wc * kSlabBytes);
      put(q.nc, p.W * kSlabBytes);
      for (int i = p.D - 1; i >= 0; --i) {
        if (c.nxw && x_layer(p, i)) {
          if (dx)
            put(q.nh, c.nxw * kSlabBytes);
          else
            off += (long long)q.nh * c.nxw * kSlabBytes;
        }
        if (i >= 1) put(q.nh, p.W * kSlabBytes);
      }
    }
  }
}

// acc = round(g_rgb) @ W_rgb^T of the thread's rows (gr0: row0, gr1:
// row0 + 8, already rounded) in the accumulator layout of an m64nN product.
template <int N>
__device__ __forceinline__ void rgb_term(float* acc, const float* gr0, const float* gr1,
                                         const bf16* wrgb, int Wc) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * qd + e;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float w = __bfloat162float(wrgb[k * Wc + col]);
        s0 = fmaf(gr0[k], w, s0);
        s1 = fmaf(gr1[k], w, s1);
      }
      acc[4 * j + e] = s0;
      acc[4 * j + 2 + e] = s1;
    }
}

// rgb_term for Cr channels read from the Params (heads of any width):
// acc = round(g_rgb) @ W_rgb^T of rows grow0 + row0 (valid v0) and
// + row0 + 8 (v1), summed over the channels in order.
template <int N>
__device__ __forceinline__ void rgb_term_any(float* acc, const float* g_rgb, long long r0,
                                             bool v0, bool v1, int Cr, const bf16* wrgb,
                                             int Wc) {
  const int qd = threadIdx.x & 3;
  zero_acc<N>(acc);
  for (int k = 0; k < Cr; ++k) {
    const float g0 = v0 ? round_bf(g_rgb[r0 * Cr + k]) : 0.0f;
    const float g1 = v1 ? round_bf(g_rgb[(r0 + 8) * Cr + k]) : 0.0f;
    const bf16* wr = wrgb + k * Wc;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w = __bfloat162float(wr[8 * j + 2 * qd + e]);
        acc[4 * j + e] = fmaf(g0, w, acc[4 * j + e]);
        acc[4 * j + 2 + e] = fmaf(g1, w, acc[4 * j + 2 + e]);
      }
  }
}

// The masked g tile G[:, :N]: round(acc) (kDen: + round(gd * W_den^T),
// rounded again), zero where the mask bit of the value is clear. Waits
// until the helpers have read the tile before (unless first), then makes
// the tile visible to the warpgroup's products and hands it over. kCd 1:
// one density channel, gd0 / gd1 of the thread's two rows (rounded);
// kCd 0: Cd channels from the rows' f32 cotangents gp0 / gp1 (null past
// the valid rows), W_den^T rows ldw apart, each term summed over the
// channels in f32 and rounded once.
template <int N, bool kDen, int kCd = 1>
__device__ __forceinline__ void chain_epi(const float* acc, unsigned char* G,
                                          const uint32_t* words, float gd0, float gd1,
                                          const bf16* wden, int bar_id, int wg, bool first,
                                          const float* gp0 = nullptr,
                                          const float* gp1 = nullptr, int Cd = 1,
                                          int ldw = 0) {
  if (!first) bar_sync(kBarGFree + wg, kGSync);
  const int t = threadIdx.x & 127;
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2), qd = t & 3, r7 = row0 & 7;
  unsigned char* h = G + row0 * kSlabBytes + 4 * qd;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float v0 = round_bf(acc[4 * j]), v1 = round_bf(acc[4 * j + 1]);
    float v2 = round_bf(acc[4 * j + 2]), v3 = round_bf(acc[4 * j + 3]);
    if constexpr (kDen && kCd == 1) {
      const int col = 8 * j + 2 * qd;
      const float w0 = __bfloat162float(wden[col]), w1 = __bfloat162float(wden[col + 1]);
      v0 += round_bf(gd0 * w0);
      v1 += round_bf(gd0 * w1);
      v2 += round_bf(gd1 * w0);
      v3 += round_bf(gd1 * w1);
    } else if constexpr (kDen) {
      const int col = 8 * j + 2 * qd;
      float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
      for (int k = 0; k < Cd; ++k) {
        const float w0 = __bfloat162float(wden[k * ldw + col]);
        const float w1 = __bfloat162float(wden[k * ldw + col + 1]);
        const float a = gp0 ? round_bf(gp0[k]) : 0.0f, b = gp1 ? round_bf(gp1[k]) : 0.0f;
        t0 = fmaf(a, w0, t0);
        t1 = fmaf(a, w1, t1);
        t2 = fmaf(b, w0, t2);
        t3 = fmaf(b, w1, t3);
      }
      v0 += round_bf(t0);
      v1 += round_bf(t1);
      v2 += round_bf(t2);
      v3 += round_bf(t3);
    }
    const uint32_t m = words[j >> 3] >> (4 * (j & 7));
    unsigned char* dst = h + (j >> 3) * kTileSlab + (((j & 7) ^ r7) << 4);
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn((m & 1u) ? v0 : 0.0f, (m & 2u) ? v1 : 0.0f);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * kSlabBytes) =
        __floats2bfloat162_rn((m & 4u) ? v2 : 0.0f, (m & 8u) ? v3 : 0.0f);
  }
  fence_proxy_async();
  bar_sync(bar_id, 128);
  bar_arrive(kBarGFull + wg, kGSync);
}

// The thread's mask words of layer L for sub-tile sid.
template <int NW>
__device__ __forceinline__ void load_words(const ChainParams& c, int L, long long sid,
                                           uint32_t* w) {
  const uint32_t* m = c.mask + mask_off(c.q, L) + sid * NW * 128 + (threadIdx.x & 127);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = __ldg(m + i * 128);
}

// One dX term of x layer i (kDx): acc = G @ W_x^T over the next nh slabs
// (N = NX columns, nxw), then, for each of the thread's values, t =
// round(acc) and, unless first (the deepest x layer), t = round(dX + t)
// with the thread's partial dX (bf16x2 words [NX / 4][128 threads] at DX);
// the last term (layer 0) goes to dx (rows < nvalid, columns < LX), the
// others back to DX. Only the thread itself reads its words: no barrier.
template <int NX>
__device__ __forceinline__ void dx_layer(Ring& ring, uint32_t gs, int nh, float* acc,
                                         uint32_t* DX, bool first, bool last, bf16* dx,
                                         long long grow0, int nvalid, int LX) {
  zero_acc<NX>(acc);
  layer_gemm<NX>(ring, gs, nh, 0, 0, acc);
  const int t = threadIdx.x & 127;
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2), qd = t & 3;
  bf16* d0 = dx + (grow0 + row0) * LX;
  bf16* d1 = d0 + 8LL * LX;
#pragma unroll
  for (int j = 0; j < NX / 8; ++j) {
    float v0 = round_bf(acc[4 * j]), v1 = round_bf(acc[4 * j + 1]);
    float v2 = round_bf(acc[4 * j + 2]), v3 = round_bf(acc[4 * j + 3]);
    if (!first) {
      const uint32_t lo = DX[(2 * j) * 128 + t], hi = DX[(2 * j + 1) * 128 + t];
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
      v0 = a.x + v0;
      v1 = a.y + v1;
      v2 = b.x + v2;
      v3 = b.y + v3;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
    if (last) {
      const int col = 8 * j + 2 * qd;
      if (col < LX) {
        if (row0 < nvalid) *reinterpret_cast<__nv_bfloat162*>(d0 + col) = lo;
        if (row0 + 8 < nvalid) *reinterpret_cast<__nv_bfloat162*>(d1 + col) = hi;
      }
    } else {
      DX[(2 * j) * 128 + t] = *reinterpret_cast<const uint32_t*>(&lo);
      DX[(2 * j + 1) * 128 + t] = *reinterpret_cast<const uint32_t*>(&hi);
    }
  }
}

// Consumer warpgroups 0 and 1: per round, the rgb head's term, then every
// chained layer top first, each product's epilogue writing the next tile;
// with kDx, after the epilogue of each x layer, its dX term (dx_layer).
template <int kCr, int kCd, bool kDx>
__device__ __forceinline__ void chain_consume(const ChainParams& c, unsigned char* base,
                                              uint32_t slots, uint32_t full, uint32_t empty) {
  const WgParams& q = c.q;
  const Params& p = q.p;
  const int wg = threadIdx.x >> 7, bar_id = 1 + wg;
  unsigned char* G = base + c.off_g + wg * c.g_bytes;
  const uint32_t gs = smem_u32(G);
  const int t = threadIdx.x & 127;
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2);
  const bf16* wrgb = c.wt + c.w_rgb;
  const bf16* wden = c.wt + c.w_den;
  uint32_t* DX = reinterpret_cast<uint32_t*>(base + c.off_dx + wg * c.dx_bytes);
  const int last_x = ((p.D - 1) / p.skip) * p.skip;  // the deepest x layer
  const int rpu = cdiv(q.RB * p.S, kWgRows);
  Ring ring{slots, full, empty, c.slot, c.stages, 0, 0u};
  float acc[128];
  bool first = true;
  for (int grp = blockIdx.x; grp < q.ngroups; grp += gridDim.x) {
    const int ray0 = grp * q.RB;
    const int rows = min(q.RB, p.R - ray0) * p.S;
    for (int r0 = 0; r0 < rows; r0 += kWgRows) {
      const int sub0 = r0 + wg * 64;
      const int nvalid = max(0, min(64, rows - sub0));
      const long long grow0 = (long long)ray0 * p.S + sub0;
      const long long sid = ((long long)grp * rpu + r0 / kWgRows) * 2 + wg;
      const bool v0 = row0 < nvalid, v1 = row0 + 8 < nvalid;
      by_width(p.Wc, [&](auto w) {
        constexpr int N = decltype(w)::value;
        uint32_t mw[mask_nw(N)];
        load_words<mask_nw(N)>(c, p.D + p.Dc - 1, sid, mw);
        if constexpr (kCr > 0) {
          float gr0[kCr], gr1[kCr];
#pragma unroll
          for (int k = 0; k < kCr; ++k) {
            gr0[k] = v0 ? round_bf(c.g_rgb[(grow0 + row0) * kCr + k]) : 0.0f;
            gr1[k] = v1 ? round_bf(c.g_rgb[(grow0 + row0 + 8) * kCr + k]) : 0.0f;
          }
          rgb_term<N>(acc, gr0, gr1, wrgb, p.Wc);
        } else {
          rgb_term_any<N>(acc, c.g_rgb, grow0 + row0, v0, v1, p.Cr, wrgb, p.Wc);
        }
        chain_epi<N, false>(acc, G, mw, 0.0f, 0.0f, nullptr, bar_id, wg, first);
        first = false;
        for (int j = p.Dc - 1; j >= 1; --j) {
          load_words<mask_nw(N)>(c, p.D + j - 1, sid, mw);
          zero_acc<N>(acc);
          layer_gemm<N>(ring, gs, q.nc, 0, 0, acc);
          chain_epi<N, false>(acc, G, mw, 0.0f, 0.0f, nullptr, bar_id, wg, false);
        }
      });
      // The view chain into trunk layer D-1, with the density head's term.
      auto den_layer = [&](auto w) {
        constexpr int N = decltype(w)::value;
        uint32_t mw[mask_nw(N)];
        load_words<mask_nw(N)>(c, p.D - 1, sid, mw);
        if constexpr (kCd > 0) {
          const float gd0 = v0 ? round_bf(c.g_den[grow0 + row0]) : 0.0f;
          const float gd1 = v1 ? round_bf(c.g_den[grow0 + row0 + 8]) : 0.0f;
          zero_acc<N>(acc);
          layer_gemm<N>(ring, gs, q.nc, 0, 0, acc);
          chain_epi<N, true>(acc, G, mw, gd0, gd1, wden, bar_id, wg, false);
        } else {
          zero_acc<N>(acc);
          layer_gemm<N>(ring, gs, q.nc, 0, 0, acc);
          chain_epi<N, true, 0>(acc, G, mw, 0.0f, 0.0f, wden, bar_id, wg, false,
                                v0 ? c.g_den + (grow0 + row0) * p.Cd : nullptr,
                                v1 ? c.g_den + (grow0 + row0 + 8) * p.Cd : nullptr, p.Cd,
                                p.W);
        }
      };
      if constexpr (!kDx && kCd > 0) {
        by_width(p.W, [&](auto w) {
          constexpr int N = decltype(w)::value;
          uint32_t mw[mask_nw(N)];
          load_words<mask_nw(N)>(c, p.D - 1, sid, mw);
          const float gd0 = v0 ? round_bf(c.g_den[grow0 + row0]) : 0.0f;
          const float gd1 = v1 ? round_bf(c.g_den[grow0 + row0 + 8]) : 0.0f;
          zero_acc<N>(acc);
          layer_gemm<N>(ring, gs, q.nc, 0, 0, acc);
          chain_epi<N, true>(acc, G, mw, gd0, gd1, wden, bar_id, wg, false);
          for (int i = p.D - 1; i >= 1; --i) {
            load_words<mask_nw(N)>(c, i - 1, sid, mw);
            zero_acc<N>(acc);
            layer_gemm<N>(ring, gs, q.nh, 0, 0, acc);
            chain_epi<N, false>(acc, G, mw, 0.0f, 0.0f, nullptr, bar_id, wg, false);
          }
        });
      } else {
        by_width(p.W, den_layer);
        for (int i = p.D - 1; i >= 0; --i) {
          if constexpr (kDx) {
            if (x_layer(p, i))
              by_width(c.nxw, [&](auto w) {
                dx_layer<decltype(w)::value>(ring, gs, q.nh, acc, DX, i == last_x, i == 0,
                                             c.dx, grow0, nvalid, p.LX);
              });
          }
          if (i == 0) break;
          by_width(p.W, [&](auto w) {
            constexpr int N = decltype(w)::value;
            uint32_t mw[mask_nw(N)];
            load_words<mask_nw(N)>(c, i - 1, sid, mw);
            zero_acc<N>(acc);
            layer_gemm<N>(ring, gs, q.nh, 0, 0, acc);
            chain_epi<N, false>(acc, G, mw, 0.0f, 0.0f, nullptr, bar_id, wg, false);
          });
        }
      }
    }
  }
}

// The helpers (warps 9-11): each tile of each consumer, in order, goes to
// grads and into the block's db. Helper h takes the 16-byte column chunk
// h % C of rows h / C, h / C + Gn, ... (C = width / 8 chunks, Gn = kHelpers
// / C row groups): it copies each chunk out and sums its 8 columns in f32;
// once the tile is read the consumer may overwrite it, and the row groups'
// partials (double-buffered) are added into DB in order, one column per
// helper. Per sub-tile, warp 0 adds the heads' db from the f32 cotangents
// (kCr, kCd 3 and 1, or 0: the Params' channel counts). Every sum has a
// fixed order: two launches give the same bits.
template <int kCr, int kCd>
__device__ __forceinline__ void chain_help(const ChainParams& c, unsigned char* base) {
  const WgParams& q = c.q;
  const Params& p = q.p;
  const int h = threadIdx.x - kHelperBase, warp = h >> 5, lane = h & 31;
  float* DB = reinterpret_cast<float*>(base + c.off_db);
  for (int i = h; i < c.nb; i += kHelpers) DB[i] = 0.0f;
  bar_sync(kBarHelp, kHelpers);
  const int E = p.D + p.Dc;  // tiles per round: one per hidden layer
  const long long total = (long long)block_rounds(q) * E;
  long long tile = 0;
  for (int grp = blockIdx.x; grp < q.ngroups; grp += gridDim.x) {
    const int ray0 = grp * q.RB;
    const int rows = min(q.RB, p.R - ray0) * p.S;
    for (int r0 = 0; r0 < rows; r0 += kWgRows) {
      for (int e = 0; e < E; ++e, ++tile) {
        const int L = e < p.Dc ? p.D + p.Dc - 1 - e : p.D - 1 - (e - p.Dc);
        const int width = L >= p.D ? p.Wc : p.W;
        const int boff = L < p.D ? L * p.W : p.b_v0 + (L - p.D) * p.Wc;
        const int C = width >> 3, Gn = kHelpers / C;
        for (int w = 0; w < 2; ++w) {
          const int sub0 = r0 + w * 64;
          const int nvalid = max(0, min(64, rows - sub0));
          const long long grow0 = (long long)ray0 * p.S + sub0;
          if (kCr == 0 && e == 0 && warp == 0) {
            for (int ch = 0; ch < p.Cr + p.Cd; ++ch) {  // rows lane and lane + 32
              float v[2];
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int row = lane + 32 * k;
                v[k] = row >= nvalid  ? 0.0f
                       : ch < p.Cr    ? c.g_rgb[(grow0 + row) * p.Cr + ch]
                                      : c.g_den[(grow0 + row) * p.Cd + ch - p.Cr];
              }
              const float s = warp_sum(v[0] + v[1]);
              if (lane == 0) DB[ch < p.Cr ? p.b_rgb + ch : p.b_den + ch - p.Cr] += s;
            }
          } else if (e == 0 && warp == 0) {
            float v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {  // rows lane and lane + 32, 4 channels
              const int row = lane + 32 * (k >> 2), ch = k & 3;
              v[k] = row >= nvalid ? 0.0f
                     : ch < 3    ? c.g_rgb[(grow0 + row) * 3 + ch]
                                 : c.g_den[grow0 + row];
            }
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
              const float s = warp_sum(v[ch] + v[4 + ch]);
              if (lane == 0) DB[ch < 3 ? p.b_rgb + ch : p.b_den] += s;
            }
          }
          float* PART = reinterpret_cast<float*>(base + c.off_part) + (w & 1) * kHelpers * 8;
          bar_sync(kBarGFull + w, kGSync);
          if (h < Gn * C) {
            const unsigned char* G = base + c.off_g + w * c.g_bytes;
            const int c8 = h % C, rg = h / C;
            bf16* dst = c.grads + act_off(p, q.N, L) + grow0 * width + c8 * 8;
            float s[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) s[k] = 0.0f;
            for (int row = rg; row < nvalid; row += Gn) {
              const uint4 v = *reinterpret_cast<const uint4*>(
                  G + (c8 >> 3) * kTileSlab + row * kSlabBytes + (((c8 & 7) ^ (row & 7)) << 4));
              *reinterpret_cast<uint4*>(dst + (long long)row * width) = v;
              const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 f = __bfloat1622float2(b2[k]);
                s[2 * k] += f.x;
                s[2 * k + 1] += f.y;
              }
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) PART[rg * width + c8 * 8 + k] = s[k];
          }
          if (tile + 1 < total) bar_arrive(kBarGFree + w, kGSync);
          bar_sync(kBarHelp, kHelpers);
          for (int col = h; col < width; col += kHelpers) {
            float t = 0.0f;
            for (int g = 0; g < Gn; ++g) t += PART[g * width + col];
            DB[boff + col] += t;
          }
        }
      }
    }
  }
  bar_sync(kBarHelp, kHelpers);
  for (int i = h; i < c.nb; i += kHelpers) c.dbpart[(long long)blockIdx.x * c.nb + i] = DB[i];
}

// g_ray[ray, :] = the f32 sum of the ray's rows of the first view layer's
// masked g (gv: [R * S, Wc] bf16), one block per ray, a thread a column.
__global__ void g_ray_kernel(const bf16* gv, float* g_ray, int S, int Wc) {
  const bf16* g = gv + (long long)blockIdx.x * S * Wc + threadIdx.x;
  float s = 0.0f;
#pragma unroll 8
  for (int r = 0; r < S; ++r) s += __bfloat162float(g[(long long)r * Wc]);
  g_ray[(long long)blockIdx.x * Wc + threadIdx.x] = s;
}

template <int kCr, int kCd, bool kDx>
__global__ void __launch_bounds__(kWgThreads, 1) chain_wg_kernel(ChainParams c) {
  static_assert((kCr == 3 && kCd == 1) || (kCr == 0 && kCd == 0),
                "heads: the train level's 3 and 1, or any width (0)");
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_wg) + 1023) & ~uintptr_t(1023));
  const uint32_t slots = smem_u32(base);
  const uint32_t full = smem_u32(base + c.off_bar);
  const uint32_t empty = full + 8 * c.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < c.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Zero the g tiles once: a product reads whole 64-column slabs.
  for (int i = threadIdx.x; i < 2 * c.g_bytes / 16; i += kWgThreads)
    reinterpret_cast<uint4*>(base + c.off_g)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x >= 256) {  // producer warpgroup: the producer and the helpers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 256) produce_chain(c, slots, full, empty, kDx);
    if (threadIdx.x >= kHelperBase) chain_help<kCr, kCd>(c, base);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  chain_consume<kCr, kCd, kDx>(c, base, slots, full, empty);
}

// ---- wgmma m64nNk16 with both operands MN-major (imm-trans-a/b = 1) ----
// The dW GEMM's A (activations [rows, M]) and B (masked g [rows, N]) are
// stored row-major, K (the rows) outermost: MN-major for this product.
template <int N>
__device__ __forceinline__ void wgmma_mn(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_mn<32>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_mn<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_mn<96>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_mn<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_mn<160>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_mn<192>(float* d, uint64_t da, uint64_t db, int scale_d) {
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
      "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_mn<224>(float* d, uint64_t da, uint64_t db, int scale_d) {
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
      "}, %112, %113, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_mn<256>(float* d, uint64_t da, uint64_t db, int scale_d) {
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
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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

// Descriptor of an MN-major operand at shared address a (128-byte swizzle):
// a K-row is 64 MN-elements (128 bytes), 8-row groups 1024 bytes apart
// (stride byte offset), 64-element blocks along MN kTileSlab apart (leading
// byte offset): the layout of a swizzled tile whose rows are K.
__device__ __forceinline__ uint64_t sdesc_mn(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(kTileSlab >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

// ---- pass 5: dW = A^T G over the rows on wgmma ----
// A block takes 128 output rows (two consumer warpgroups of m64) by all N
// columns of one job, over one split of the rows: stages of 64 rows of A
// [:, m0 : m0 + 128] and G [:, :N] are copied as stored (16 bytes a
// thread, cp.async, four stages, two in flight) into swizzled tiles whose
// rows are K, and multiplied as MN-major operands; the f32 sums go to the
// split's partials, which pass 7 reduces in order.
constexpr int kDwThreads = 256, kDwStages = 4, kDwRows = 64;

struct DwJob {
  const bf16* A;      // [K, lda], columns [0, M) used
  const bf16* B;      // [K, Nn]
  long long out_off;  // dW block [M, Nn] (row stride out_ld) in the flat output
  int lda, M, Nn, out_ld, tiles_m, block0;
};

struct DwJobs {
  DwJob job[kMaxJobs];
  float* part;  // [splits, n_out]
  long long n_out;
  int n, splits, K, stage_bytes;
};

// Rows [k0, k0 + 64) of the job's A and B tiles into one stage; chunks past
// lda and rows past k_hi are zero-filled.
__device__ __forceinline__ void dw_stage(unsigned char* As, unsigned char* Bs, const DwJob& jb,
                                         long long k0, long long k_hi, int m0) {
  for (int idx = threadIdx.x; idx < kDwRows * 16; idx += kDwThreads) {
    const int r = idx >> 4, c = idx & 15;
    const bool v = k0 + r < k_hi && m0 + c * 8 < jb.lda;
    cp_async16(As + (c >> 3) * kTileSlab + r * kSlabBytes + (((c & 7) ^ (r & 7)) << 4),
               v ? jb.A + (k0 + r) * jb.lda + m0 + c * 8 : jb.A, v);
  }
  const int CB = jb.Nn >> 3;
  for (int idx = threadIdx.x; idx < kDwRows * CB; idx += kDwThreads) {
    const int r = idx / CB, c = idx - r * CB;
    const bool v = k0 + r < k_hi;
    cp_async16(Bs + (c >> 3) * kTileSlab + r * kSlabBytes + (((c & 7) ^ (r & 7)) << 4),
               v ? jb.B + (k0 + r) * jb.Nn + c * 8 : jb.B, v);
  }
}

__global__ void __launch_bounds__(kDwThreads, 1) dw_wg_kernel(DwJobs js) {
  extern __shared__ __align__(1024) unsigned char smem_dw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dw) + 1023) & ~uintptr_t(1023));
  const int bid = blockIdx.x;
  int jn = 0;
  while (jn + 1 < js.n && bid >= js.job[jn + 1].block0) ++jn;
  const DwJob jb = js.job[jn];
  const int local = bid - jb.block0;  // a split's m-tiles are neighbours: g is read once from HBM
  const int split = local / jb.tiles_m, m0 = (local % jb.tiles_m) * 128;
  const long long chunk = split_rows(js.K, js.splits);
  const long long k_lo = split * chunk;
  const long long k_hi = min((long long)js.K, k_lo + chunk);
  const int nk = k_hi > k_lo ? (int)((k_hi - k_lo + kDwRows - 1) / kDwRows) : 0;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  auto stage = [&](int kt) { return base + (kt % kDwStages) * js.stage_bytes; };
  auto load = [&](int kt) {
    if (kt < nk) dw_stage(stage(kt), stage(kt) + 2 * kTileSlab, jb, k_lo + (long long)kt * kDwRows,
                          k_hi, m0);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  by_width(jb.Nn, [&](auto w) {
    constexpr int N = decltype(w)::value;
    float acc[N / 2];
    zero_acc<N>(acc);
    load(0);
    load(1);
    for (int kt = 0; kt < nk; ++kt) {
      asm volatile("cp.async.wait_group 1;\n" ::);
      fence_proxy_async();
      __syncthreads();  // stage kt is in; every warpgroup's products of kt - 2 are done
      const uint32_t a = opaque(smem_u32(stage(kt)) + wg * kTileSlab);
      const uint32_t b = opaque(smem_u32(stage(kt)) + 2 * kTileSlab);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_mn<N>(acc, sdesc_mn(a + kk * 16 * kSlabBytes), sdesc_mn(b + kk * 16 * kSlabBytes),
                    1);
      wgmma_commit();
      wgmma_wait<1>();
      load(kt + 2);
    }
    wgmma_wait<0>();
    fence_acc<N / 2>(acc);
    float* part = js.part + split * js.n_out + jb.out_off;
    const int row0 = m0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2), qd = t & 3;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * qd;
      if (row0 < jb.M)
        *reinterpret_cast<float2*>(part + (long long)row0 * jb.out_ld + n) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row0 + 8 < jb.M)
        *reinterpret_cast<float2*>(part + (long long)(row0 + 8) * jb.out_ld + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  });
}

// Pass 5: the dW jobs of launch_dw (layer 0 and the skip layers' x rows
// from xs, every other product from the activations) on dw_wg_kernel, in
// launches of kMaxJobs products (each into its own out_off block: the same
// sums at any batching).
inline cudaError_t launch_dw_wg(const Params& p, const Extra& e, const Layout& l,
                                unsigned char* ws, long long n_out, int splits,
                                cudaStream_t st) {
  std::vector<long long> w_off, b_off;
  output_offsets(p, w_off, b_off);
  const bf16* acts = reinterpret_cast<const bf16*>(ws + l.acts);
  const bf16* grads = reinterpret_cast<const bf16*>(ws + l.grads);
  const bf16* x = reinterpret_cast<const bf16*>(ws + l.xs);
  const long long tW = e.N * p.W;
  DwJobs js;
  js.part = reinterpret_cast<float*>(ws + l.part);
  js.n_out = n_out; js.n = 0; js.splits = splits; js.K = (int)e.N;
  js.stage_bytes = (2 + cdiv(p.W, 64)) * kTileSlab;
  const int smem = kDwStages * js.stage_bytes + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(dw_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int nblocks = 0;
  auto flush = [&]() {
    if (js.n == 0) return cudaSuccess;
    dw_wg_kernel<<<nblocks, kDwThreads, smem, st>>>(js);
    js.n = 0;
    nblocks = 0;
    return cudaGetLastError();
  };
  auto add = [&](const bf16* A, int lda, const bf16* B, int M, int Nn, long long out_off) {
    if (err != cudaSuccess) return;
    DwJob& j = js.job[js.n++];
    j.A = A; j.B = B; j.lda = lda; j.M = M; j.Nn = Nn; j.out_off = out_off; j.out_ld = Nn;
    j.tiles_m = cdiv(M, 128);
    j.block0 = nblocks;
    nblocks += j.tiles_m * splits;
    if (js.n == kMaxJobs) err = flush();
  };
  for (int i = 0; i < p.D; ++i) {
    const bf16* g = grads + i * tW;
    if (i == 0) {
      add(x, p.KX, g, p.LX, p.W, w_off[0]);
    } else {
      add(acts + (i - 1) * tW, p.W, g, p.W, p.W, w_off[i]);
      if (i % p.skip == 0) add(x, p.KX, g, p.LX, p.W, w_off[i] + (long long)p.W * p.W);
    }
  }
  for (int j = 0; j < p.Dc; ++j) {
    const bf16* g = grads + act_off(p, e.N, p.D + j);
    const bf16* a = j == 0 ? acts + (p.D - 1) * tW : acts + act_off(p, e.N, p.D + j - 1);
    add(a, j == 0 ? p.W : p.Wc, g, j == 0 ? p.W : p.Wc, p.Wc, w_off[p.D + 1 + j]);
  }
  if (err != cudaSuccess) return err;
  return flush();
}

__global__ void __launch_bounds__(kWgThreads, 1) train_fwd_wg_kernel(WgParams q) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  forward_wg<false, true>(q, smem_wg);
}

// Pass 2: composite_train on the raw heads in global memory, kThreads / 32
// rays a block, its per-sample scratch in shared memory.
__global__ void __launch_bounds__(kThreads) train_composite_kernel(Params p, Extra e,
                                                                   const float* heads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ray0 = blockIdx.x * (kThreads / 32);
  Smem<bf16> sm;
  sm.H = nullptr; sm.X = nullptr; sm.DC = nullptr;
  sm.OUT = const_cast<float*>(heads) + (long long)ray0 * p.S * 4;
  composite_train<bf16>(p, e, sm, reinterpret_cast<float*>(smem_raw), ray0,
                        min(kThreads / 32, p.R - ray0));
}

// Byte offsets of the bf16 passes' own areas, after the backward's layout
// (level_backward.cuh::layout, which ends at base): the raw heads (unless
// heads is false), the ReLU masks and the chain's db partials (Cg head
// channels: 3 rgb and 1 density in the train level).
struct WgLayout {
  long long heads, mask, dbpart, total;
};

inline WgLayout wg_layout(long long base, int R, int S, int D, int W, int Wc, int Dc,
                          int Cg = 4, bool heads = true) {
  WgParams q{};
  q.p.R = R; q.p.S = S; q.p.D = D; q.p.W = W; q.p.Wc = Wc; q.p.Dc = Dc;
  q.RB = wg_rays(S, Wc);
  q.ngroups = cdiv(R, q.RB);
  const long long nb = (long long)D * W + Dc * Wc + Cg;
  WgLayout x;
  long long off = base;
  x.heads = off;  off += heads ? round256((long long)R * S * 16) : 0;
  x.mask = off;   off += round256(mask_words(q) * 4);
  x.dbpart = off; off += round256(kMaxChainBlocks * nb * 4);
  x.total = off;
  return x;
}

// Launch chain_wg_kernel<kCr, kCd, kDx>: one persistent block per SM, at
// most one per unit and kMaxChainBlocks; the grid (the rows of dbpart)
// goes to *grid.
template <int kCr, int kCd, bool kDx>
inline cudaError_t launch_chain(const ChainParams& c, int* grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(chain_wg_kernel<kCr, kCd, kDx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  *grid = min(min(c.q.ngroups, sms), kMaxChainBlocks);
  chain_wg_kernel<kCr, kCd, kDx><<<*grid, kWgThreads, c.bytes, st>>>(c);
  return cudaGetLastError();
}

// Passes 1-6 of the bf16 train level on the workspace (l, then x). w: the
// forward's slab stream (p.w); wt: pack_params_wgt.
inline cudaError_t launch_train_wg(Params p, Extra e, const Layout& l, const WgLayout& x,
                                   unsigned char* ws, float* out, long long n_out, int splits,
                                   cudaStream_t st) {
  WgParams q{};
  q.p = p;
  if (!init_wg(q, false)) return cudaErrorInvalidValue;
  q.acts = static_cast<bf16*>(e.acts);
  q.xs = static_cast<bf16*>(e.xs);
  q.mask = reinterpret_cast<uint32_t*>(ws + x.mask);
  q.heads = reinterpret_cast<float*>(ws + x.heads);
  q.N = e.N;
  ChainParams c;
  if (!init_chain(c, q)) return cudaErrorInvalidValue;
  c.wt = static_cast<const bf16*>(e.wt);
  c.mask = q.mask;
  c.g_rgb = e.g_rgb;
  c.g_den = e.g_den;
  c.grads = static_cast<bf16*>(e.grads);
  c.dbpart = reinterpret_cast<float*>(ws + x.dbpart);

  // 1. forward
  cudaError_t err = launch_wg(train_fwd_wg_kernel, q, st);
  if (err != cudaSuccess) return err;
  // 2. composite and its backward
  const size_t smem_c = sizeof(float) * (kThreads / 32) * p.S * 4;
  if ((err = set_smem((const void*)train_composite_kernel, smem_c)) != cudaSuccess) return err;
  train_composite_kernel<<<cdiv(p.R, kThreads / 32), kThreads, smem_c, st>>>(p, e, q.heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3. g-chain with db, then the view layer's per-ray sums
  int grid = 0;
  if ((err = launch_chain<3, 1, false>(c, &grid, st)) != cudaSuccess) return err;
  g_ray_kernel<<<p.R, p.Wc, 0, st>>>(c.grads + act_off(p, e.N, p.D), e.g_ray, p.S, p.Wc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 5. dW GEMM; 6-7. small products (db from the partials), reduction
  if ((err = launch_dw_wg(p, e, l, ws, n_out, splits, st)) != cudaSuccess) return err;
  return launch_small_reduce<bf16>(p, e, l, ws, out, n_out, splits, c.dbpart, grid, st);
}

}  // namespace
