// The wide route of train_level.cu and train_level_twopass.cu (net_width
// from 288 up, a multiple of 32; wide_forward.cuh has the bf16 forward and
// layer product, wide_f32.cuh the f32 ones): the forward keeping every
// activation in the workspace, the composite and its backward, the
// g-chain, db, dW, and the small products and reduction of
// level_backward.cuh. Passes 3-7 start from the head cotangents
// (launch_wide_backward, launch_wide_backward_f32), so mlp_bwd.cu runs them
// after its recompute, with heads of any width. Passes 1-7 below
// are the bf16 route's; the f32 route (launch_train_wide<WideF32Route>,
// launch_wide_backward_f32 at the end) runs the same sequence with
// wide_f32.cuh's GEMM for every forward and chain product, f32
// activations and masked g, and level_backward.cuh's f32 dW GEMM
// (dw_gemm_f32_kernel, db as its column sums) in place of passes 5-6.
//
// Replaces, at these widths: nerf_or_nothing_tpu/kernels/fused_level.py::
// _level_kernel and _level_kernel_twopass (the same launches: their order
// is the two-pass kernel's two phases), and with mlp_bwd.cu fused_mlp.py::
// _bwd_kernel.
//
// Bound: the products. At Config(net_width=1024), R=1024 x S=128, one
// level is 5.98 TFLOP (utils/profiling.train_level_flops), 6.05 ms at 989
// TFLOP/s, against ~4.4 GB of activations and masked g, each written once
// and read back at least once (~2.6 ms at 3.35 TB/s).
//
// Launches, one stream, no host synchronisation (they capture into the
// train step's CUDA graph):
//  1. wide_dir_kernel, wide_features_kernel, then wide_forward: a
//     wide_gemm_kernel per layer storing its activation (the ReLU mask is
//     activation > 0, read back by the chain), and the heads as [N, 4];
//  2. train_composite_kernel (train_wg.cuh): comp, acc, weights, g_rgb,
//     g_den;
//  3. wide_rgb_chain_kernel: the last view layer's masked g from the rgb
//     head's K=Cr product of the rounded f32 cotangents; then one
//     wide_gemm_kernel per chained layer, top layer first, g @ W^T from
//     pack_params_wgt's slabs (mlp_bwd: pack_params_wgx's) with the g-chain
//     epilogue (the density head's term on the way into the trunk; mlp_bwd
//     with a density head of Cd > 1 channels: the kWideChainHeads epilogue);
//  4. g_ray_kernel (train_wg.cuh): the first view layer's g summed per ray;
//  5. wide_db_kernel: every bias's db as column sums of the masked g (and
//     of the f32 head cotangents) over fixed chunks of rows, one partial
//     row a chunk;
//  6. wide_dw_kernel<BN>, one launch per product: dW = act^T g over the
//     backward's fixed split of the rows, both operands MN-major on wgmma
//     (dw_wg_kernel's design, with the output columns in blocks of at most
//     256);
//  7. launch_small_reduce (level_backward.cuh): the heads' dW, the view
//     layer's direction rows, db from the partial rows, then every split
//     partial summed in a fixed order.
// mlp_bwd.cu with input_grads adds dX (launch_wide_dx there).
// Every partial is written by exactly one block and reduced in order: no
// atomics, so two launches on the same inputs give bit-equal dW, db and dX.
// The rounding is the narrow route's: bf16 after every product, the
// density term rounded and added in bf16, the mask after rounding.

#pragma once

#include "train_wg.cuh"
#include "wide_f32.cuh"
#include "wide_forward.cuh"

namespace {

constexpr int kWideDbRows = 2048;  // rows of one db partial (at most kMaxChainBlocks of them)

// Byte offsets of the wide route's own areas after the backward's layout
// (level_backward.cuh::layout, which ends at base): the raw heads (unless
// heads is false: mlp_bwd), the direction terms and the db partial rows
// (Cg head channels: 3 rgb and 1 density in the train level).
struct WideTrainLayout {
  long long heads, dc, dbpart, total;
};

inline WideTrainLayout wide_train_layout(long long base, int R, int S, int D, int W, int Wc,
                                         int Dc, int Cg = 4, bool heads = true) {
  const long long nb = (long long)D * W + (long long)Dc * Wc + Cg;
  WideTrainLayout x;
  long long off = base;
  x.heads = off;  off += heads ? round256((long long)R * S * 16) : 0;
  x.dc = off;     off += round256((long long)R * Wc * 4);
  x.dbpart = off; off += round256(kMaxChainBlocks * nb * 4);
  x.total = off;
  return x;
}

// Element offsets of pack_params_wgt's stream (fused_level._layout_wgt):
// view layers Dc-1 .. 1, view 0's h rows, trunk layers D-1 .. 1, each as
// slabs of 64 K-rows of W^T; then W_rgb^T [Cr, Wc] and W_den^T [Cd, W].
// With nxw (pack_params_wgx, fused_level._layout_wgx), x layer i's W_x^T
// [W, nxw] slabs (x[i]) sit before trunk layer i's h rows.
struct WideChainOffsets {
  std::vector<long long> view, trunk, x;
  long long rgb, den;
};

inline WideChainOffsets wide_chain_offsets(const Params& p, const WideOffsets& o, int nxw = 0) {
  WideChainOffsets c;
  c.view.resize(p.Dc);
  c.trunk.resize(p.D);
  c.x.resize(p.D);
  long long off = 0;
  for (int j = p.Dc - 1; j >= 1; --j) {
    c.view[j] = off;
    off += (long long)o.nc * p.Wc * 64;
  }
  c.view[0] = off;
  off += (long long)o.nc * p.W * 64;
  for (int i = p.D - 1; i >= 0; --i) {
    if (nxw && x_layer(p, i)) {
      c.x[i] = off;
      off += (long long)o.nh * nxw * 64;
    }
    if (i >= 1) {
      c.trunk[i] = off;
      off += (long long)o.nh * p.W * 64;
    }
  }
  c.rgb = off;
  c.den = off + (long long)p.Cr * p.Wc;
  return c;
}

// out = the last view layer's masked g: round(round(g_rgb) @ W_rgb^T),
// zero where its activation is not > 0; kCr rgb channels (0: Cr, any),
// summed in order.
template <int kCr>
__global__ void wide_rgb_chain_kernel(const float* g_rgb, const bf16* wr, const bf16* act,
                                      bf16* out, long long N, int Wc, int Cr) {
  const int cr = kCr ? kCr : Cr;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < N * Wc;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / Wc;
    const int n = (int)(idx - row * Wc);
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < cr; ++k) s = fmaf(round_bf(g_rgb[row * cr + k]), to_f(wr[k * Wc + n]), s);
    out[idx] = to_f(act[idx]) > 0.0f ? __float2bfloat16_rn(s) : __float2bfloat16_rn(0.0f);
  }
}

// dbpart[blockIdx.y, col] = the f32 sum over rows [y * chunk, (y + 1) *
// chunk) of bias col's cotangent: a hidden layer's masked g column, or the
// heads' f32 cotangents; a thread a bias, in row order.
__global__ void wide_db_kernel(Params p, const bf16* grads, const float* g_rgb,
                               const float* g_den, float* dbpart, long long N, long long chunk) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int nb = num_biases(p);
  if (col >= nb) return;
  const long long r0 = (long long)blockIdx.y * chunk;
  const long long r1 = min(N, r0 + chunk);
  float s = 0.0f;
  if (col < p.b_den || (col >= p.b_v0 && col < p.b_rgb)) {
    const bool trunk = col < p.b_den;
    const int width = trunk ? p.W : p.Wc;
    const int c = trunk ? col : col - p.b_v0;
    const int layer = c / width;
    const bf16* g = grads + act_off(p, N, trunk ? layer : p.D + layer) + (c - layer * width);
#pragma unroll 8
    for (long long r = r0; r < r1; ++r) s += __bfloat162float(g[r * width]);
  } else {
    const bool den = col < p.b_v0;
    const float* g = den ? g_den + (col - p.b_den) : g_rgb + (col - p.b_rgb);
    const int ld = den ? p.Cd : p.Cr;
#pragma unroll 8
    for (long long r = r0; r < r1; ++r) s += g[r * ld];
  }
  dbpart[(long long)blockIdx.y * nb + col] = s;
}

// ---- dW = A^T B over the rows, output columns in blocks of BN ----
struct WideDw {
  const bf16* A;      // [K, lda], columns [0, M) are the output rows
  const bf16* B;      // [K, ldb], columns [0, Nn) are the output columns
  int lda, M, ldb, Nn, out_ld;
  long long out_off;  // the dW block [M, Nn] (row stride out_ld) in the flat output
  float* part;        // [splits, n_out]
  long long n_out;
  int splits, K;
};

template <int BN>
__host__ __device__ constexpr int wide_dw_stage_bytes() {
  return (2 + BN / 64) * kTileSlab;
}

// Block (blockIdx.x, y, z): output rows m0 .. m0 + 127 (two warpgroups of
// m64) by columns n0 .. n0 + BN - 1, over split z of the rows: stages of 64
// rows of A [:, m0 : m0 + 128] and B [:, n0 : n0 + BN] copied as stored
// (cp.async, four stages, two in flight) into swizzled tiles whose rows
// are K, multiplied as MN-major operands (dw_wg_kernel's stages).
template <int BN>
__global__ void __launch_bounds__(kDwThreads, 1) wide_dw_kernel(WideDw js) {
  extern __shared__ __align__(1024) unsigned char smem_dw[];
  unsigned char* base = align1024(smem_dw);
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * BN, split = blockIdx.z;
  const long long chunk = split_rows(js.K, js.splits);
  const long long k_lo = split * chunk;
  const long long k_hi = min((long long)js.K, k_lo + chunk);
  const int nk = k_hi > k_lo ? (int)((k_hi - k_lo + kDwRows - 1) / kDwRows) : 0;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  auto stage = [&](int kt) { return base + (kt % kDwStages) * wide_dw_stage_bytes<BN>(); };
  auto load = [&](int kt) {
    if (kt < nk) {
      unsigned char* As = stage(kt);
      unsigned char* Bs = As + 2 * kTileSlab;
      const long long k0 = k_lo + (long long)kt * kDwRows;
      for (int idx = threadIdx.x; idx < kDwRows * 16; idx += kDwThreads) {
        const int r = idx >> 4, c = idx & 15;
        const bool v = k0 + r < k_hi && m0 + c * 8 < js.lda;
        cp_async16(As + (c >> 3) * kTileSlab + r * kSlabBytes + (((c & 7) ^ (r & 7)) << 4),
                   v ? js.A + (k0 + r) * js.lda + m0 + c * 8 : js.A, v);
      }
      constexpr int CB = BN / 8;
      for (int idx = threadIdx.x; idx < kDwRows * CB; idx += kDwThreads) {
        const int r = idx / CB, c = idx - r * CB;
        const bool v = k0 + r < k_hi && n0 + c * 8 < js.Nn;
        cp_async16(Bs + (c >> 3) * kTileSlab + r * kSlabBytes + (((c & 7) ^ (r & 7)) << 4),
                   v ? js.B + (k0 + r) * js.ldb + n0 + c * 8 : js.B, v);
      }
    }
    cp_async_commit();
  };
  float acc[BN / 2];
  zero_acc<BN>(acc);
  load(0);
  load(1);
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group 1;\n" ::);
    fence_proxy_async();
    __syncthreads();  // stage kt is in; both warpgroups' products of kt - 2 are done
    const uint32_t a = opaque(smem_u32(stage(kt)) + wg * kTileSlab);
    const uint32_t b = opaque(smem_u32(stage(kt)) + 2 * kTileSlab);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_mn<BN>(acc, sdesc_mn(a + kk * 16 * kSlabBytes), sdesc_mn(b + kk * 16 * kSlabBytes),
                   1);
    wgmma_commit();
    wgmma_wait<1>();
    load(kt + 2);
  }
  wgmma_wait<0>();
  fence_acc<BN / 2>(acc);
  float* part = js.part + split * js.n_out + js.out_off;
  const int row0 = m0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2), qd = t & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * qd;
    if (n >= js.Nn) continue;
    if (row0 < js.M)
      *reinterpret_cast<float2*>(part + (long long)row0 * js.out_ld + n) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row0 + 8 < js.M)
      *reinterpret_cast<float2*>(part + (long long)(row0 + 8) * js.out_ld + n) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int BN>
inline cudaError_t launch_wide_dw_bn(const WideDw& js, cudaStream_t st) {
  constexpr int smem = kDwStages * wide_dw_stage_bytes<BN>() + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(wide_dw_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wide_dw_kernel<BN><<<dim3(cdiv(js.M, 128), cdiv(js.Nn, BN), js.splits), kDwThreads, smem,
                       st>>>(js);
  return cudaGetLastError();
}

inline cudaError_t launch_wide_dw(const WideDw& js, cudaStream_t st) {
  return js.Nn % 256 == 0 ? launch_wide_dw_bn<256>(js, st) : launch_wide_dw_bn<128>(js, st);
}

// Passes 3-7 above from the head cotangents e.g_rgb [N, Cr] and e.g_den
// [N, Cd] (kCr: 3, the train level's, or 0, any), on the activations and
// features in the workspace (l; the direction terms and db partials in
// x). e.wt: pack_params_wgt's stream, or pack_params_wgx's (co then has
// its x slabs, which only launch_wide_dx reads).
template <int kCr>
inline cudaError_t launch_wide_backward(Params p, Extra e, const Layout& l,
                                        const WideTrainLayout& x, const WideOffsets& o,
                                        const WideChainOffsets& co, unsigned char* ws,
                                        float* out, long long n_out, int splits,
                                        cudaStream_t st) {
  const long long N = e.N;
  const bf16* wt = static_cast<const bf16*>(e.wt);
  bf16* acts = static_cast<bf16*>(e.acts);
  bf16* grads = static_cast<bf16*>(e.grads);
  bf16* xs = static_cast<bf16*>(e.xs);
  float* dbpart = reinterpret_cast<float*>(ws + x.dbpart);
  auto act = [&](int L) { return acts + act_off(p, N, L); };
  auto grad = [&](int L) { return grads + act_off(p, N, L); };
  auto h = [&](int i) { return act(i); };
  auto v = [&](int j) { return act(p.D + j); };
  cudaError_t err;

  // 3. g-chain, top layer first
  {
    const long long n = N * p.Wc;
    const long long blocks = (n + 255) / 256;
    wide_rgb_chain_kernel<kCr><<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0, st>>>(
        e.g_rgb, wt + co.rgb, v(p.Dc - 1), grad(p.D + p.Dc - 1), N, p.Wc, p.Cr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  for (int j = p.Dc - 1; j >= 0; --j) {
    WideGemm g{};
    g.a0 = grad(p.D + j); g.lda0 = g.ka0 = p.Wc; g.ns0 = o.nc;
    g.b = wt + co.view[j]; g.N = j == 0 ? p.W : p.Wc; g.M = N; g.kind = kWideChain;
    g.act = j == 0 ? h(p.D - 1) : v(j - 1);
    if (j == 0) { g.gden = e.g_den; g.wden = wt + co.den; }
    g.out = j == 0 ? grad(p.D - 1) : grad(p.D + j - 1);
    if constexpr (kCr == 0) {  // heads of any width: a density head of Cd > 1 channels
      if (j == 0 && p.Cd > 1) {
        if ((err = launch_wide_gemm_mlp<kWideChainHeads>(WideGemmMlp{g, p.Cd, 0, 0}, st)) !=
            cudaSuccess)
          return err;
        continue;
      }
    }
    if ((err = launch_wide_gemm(g, st)) != cudaSuccess) return err;
  }
  for (int i = p.D - 1; i >= 1; --i) {
    WideGemm g{};
    g.a0 = grad(i); g.lda0 = g.ka0 = p.W; g.ns0 = o.nh;
    g.b = wt + co.trunk[i]; g.N = p.W; g.M = N; g.kind = kWideChain;
    g.act = h(i - 1); g.out = grad(i - 1);
    if ((err = launch_wide_gemm(g, st)) != cudaSuccess) return err;
  }
  // 4. the view layer's per-ray sums
  err = launch_columns(p.Wc, [&](int n0, int n) {
    g_ray_kernel<<<p.R, n, 0, st>>>(grad(p.D) + n0, e.g_ray + n0, p.S, p.Wc);
  });
  if (err != cudaSuccess) return err;
  // 5. db partials
  long long db_blocks = (N + kWideDbRows - 1) / kWideDbRows;
  if (db_blocks > kMaxChainBlocks) db_blocks = kMaxChainBlocks;
  const long long chunk = (N + db_blocks - 1) / db_blocks;
  wide_db_kernel<<<dim3(cdiv(num_biases(p), 256), (unsigned)db_blocks), 256, 0, st>>>(
      p, grads, e.g_rgb, e.g_den, dbpart, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 6. dW of every layer product
  std::vector<long long> w_off, b_off;
  output_offsets(p, w_off, b_off);
  auto dw = [&](const bf16* A, int lda, int M, const bf16* B, int ldb, int Nn,
                long long out_off, int out_ld) {
    WideDw js;
    js.A = A; js.B = B; js.lda = lda; js.M = M; js.ldb = ldb; js.Nn = Nn;
    js.out_ld = out_ld; js.out_off = out_off;
    js.part = reinterpret_cast<float*>(ws + l.part); js.n_out = n_out;
    js.splits = splits; js.K = (int)N;
    return launch_wide_dw(js, st);
  };
  for (int i = 0; i < p.D; ++i) {
    if (i == 0) {
      err = dw(xs, p.KX, p.LX, grad(0), p.W, p.W, w_off[0], p.W);
    } else {
      err = dw(h(i - 1), p.W, p.W, grad(i), p.W, p.W, w_off[i], p.W);
      if (err == cudaSuccess && i % p.skip == 0)
        err = dw(xs, p.KX, p.LX, grad(i), p.W, p.W, w_off[i] + (long long)p.W * p.W, p.W);
    }
    if (err != cudaSuccess) return err;
  }
  for (int j = 0; j < p.Dc; ++j) {
    const int fan_in = j == 0 ? p.W : p.Wc;
    err = dw(j == 0 ? h(p.D - 1) : v(j - 1), fan_in, fan_in, grad(p.D + j), p.Wc, p.Wc,
             w_off[p.D + 1 + j], p.Wc);
    if (err != cudaSuccess) return err;
  }
  // 7. small products, db from the partial rows, the reduction
  return launch_small_reduce<bf16>(p, e, l, ws, out, n_out, splits, dbpart, (int)db_blocks,
                                   st);
}

// ---- the f32 route (wide_f32.cuh's GEMM) ----

// The f32 route's passes from the head cotangents e.g_rgb [N, Cr] and
// e.g_den [N, Cd] on the f32 activations and features in the workspace
// (l): wide_rgb_chain_f32_kernel, then one kF32Chain GEMM per chained
// layer, top layer first, g @ W^T from pack_params_wft's hi / lo slabs
// (e.wt, at wt_off) with the density term on the way into the trunk (the
// heads' W^T from p.w: pack_params' transposed head rows); g_ray_f32_kernel; then
// level_backward.cuh's launch_products<float> as the narrow f32 route runs
// it (dw_gemm_f32_kernel: dW over the rows with db as column sums of g in
// the same pass, the small products, the fixed-order reduction).
inline cudaError_t launch_wide_backward_f32(Params p, Extra e, const Layout& l,
                                            unsigned char* ws, float* out, long long n_out,
                                            int splits, cudaStream_t st) {
  const long long N = e.N;
  const float* w = static_cast<const float*>(p.w);
  const float* wt = static_cast<const float*>(e.wt);
  const float* acts = static_cast<const float*>(e.acts);
  float* grads = static_cast<float*>(e.grads);
  auto act = [&](int L) { return acts + act_off(p, N, L); };
  auto grad = [&](int L) { return grads + act_off(p, N, L); };
  const long long lo = wide_f32_chain_len(p);  // B lo after B hi
  cudaError_t err;
  {
    const long long blocks = (N * p.Wc + 255) / 256;
    wide_rgb_chain_f32_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0, st>>>(
        e.g_rgb, w + p.w_rgb, act(p.D + p.Dc - 1), grad(p.D + p.Dc - 1), N, p.Wc, p.Cr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  for (int j = p.Dc - 1; j >= 0; --j) {
    WideGemmF32 g{};
    g.a0 = grad(p.D + j); g.lda0 = g.ka0 = p.Wc;
    g.b = wt + wt_off(p, p.D + j); g.blo = g.b + lo; g.N = j == 0 ? p.W : p.Wc; g.M = N;
    g.act = j == 0 ? act(p.D - 1) : act(p.D + j - 1);
    if (j == 0) { g.gden = e.g_den; g.wden = w + p.w_den; g.cd = p.Cd; }
    g.out = j == 0 ? grad(p.D - 1) : grad(p.D + j - 1);
    if ((err = launch_wide_gemm_f32<kF32Chain>(g, st)) != cudaSuccess) return err;
  }
  for (int i = p.D - 1; i >= 1; --i) {
    WideGemmF32 g{};
    g.a0 = grad(i); g.lda0 = g.ka0 = p.W;
    g.b = wt + wt_off(p, i); g.blo = g.b + lo; g.N = p.W; g.M = N;
    g.act = act(i - 1); g.out = grad(i - 1);
    if ((err = launch_wide_gemm_f32<kF32Chain>(g, st)) != cudaSuccess) return err;
  }
  err = launch_columns(p.Wc, [&](int n0, int n) {
    g_ray_f32_kernel<<<p.R, n, 0, st>>>(grad(p.D) + n0, e.g_ray + n0, p.S, p.Wc);
  });
  if (err != cudaSuccess) return err;
  return launch_products<float>(p, e, l, ws, out, n_out, splits, nullptr, 0, st);
}

// Pass 1 of the train level and of mlp_bwd on route r (WideBf16Route,
// or wide_f32.cuh's WideF32Route): the direction terms into dc, the
// features of all e.N rows into e.xs and the forward keeping every
// activation (e.acts at act_off); with heads, the level's raw heads
// [N, 4] there (kWideLevelHeads), else none (kWideNoHeads).
template <class Route, int kHeads>
inline cudaError_t wide_forward_keep(const Params& p, const Route& r, const Extra& e, float* dc,
                                     float* heads, cudaStream_t st) {
  using T = typename Route::T;
  const long long N = e.N;
  T* acts = static_cast<T*>(e.acts);
  T* xs = static_cast<T*>(e.xs);
  auto h = [&](int i) { return acts + act_off(p, N, i); };
  auto v = [&](int j) { return acts + act_off(p, N, p.D + j); };
  cudaError_t err = launch_columns(p.Wc, [&](int n0, int n) {
    wide_dir_kernel<T><<<p.R, n, 0, st>>>(p, r.dir(p) + n0, dc + n0, 0);
  });
  if (err != cudaSuccess) return err;
  if ((err = launch_wide_features(p, xs, 0, N, st)) != cudaSuccess) return err;
  return wide_forward<Route, kHeads>(p, r, xs, dc, N, h, v, heads ? heads + 3 : nullptr,
                                     heads ? 4 : 0, heads, heads ? 4 : 0, st);
}

// The train level on the wide route, on the workspace (l, then x):
// 1. the forward (wide_forward_keep); 2. the composite and its backward;
// 3-7. bf16: launch_wide_backward (p.w: pack_params_wg's stream; e.wt:
// pack_params_wgt's), f32: launch_wide_backward_f32 (p.w: pack_params_wf;
// e.wt: pack_params_wft).
template <class Route>
inline cudaError_t launch_train_wide(Params p, Extra e, const Layout& l,
                                     const WideTrainLayout& x, unsigned char* ws, float* out,
                                     long long n_out, int splits, cudaStream_t st) {
  Route r;
  if (!r.init(p)) return cudaErrorInvalidValue;
  float* heads = reinterpret_cast<float*>(ws + x.heads);
  float* dc = reinterpret_cast<float*>(ws + x.dc);
  cudaError_t err;
  if ((err = wide_forward_keep<Route, kWideLevelHeads>(p, r, e, dc, heads, st)) != cudaSuccess)
    return err;
  const size_t smem_c = sizeof(float) * (kThreads / 32) * p.S * 4;
  if ((err = set_smem((const void*)train_composite_kernel, smem_c)) != cudaSuccess) return err;
  train_composite_kernel<<<cdiv(p.R, kThreads / 32), kThreads, smem_c, st>>>(p, e, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (Route::kBf16)
    return launch_wide_backward<3>(p, e, l, x, r.o, wide_chain_offsets(p, r.o), ws, out, n_out,
                                   splits, st);
  else
    return launch_wide_backward_f32(p, e, l, ws, out, n_out, splits, st);
}

}  // namespace
