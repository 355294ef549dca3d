// The wide route of train_level.cu and train_level_twopass.cu (net_width
// from 288 up, a multiple of 32; wide_forward.cuh has the bf16 forward and
// layer product, wide_f32.cuh the f32 ones): the forward keeping every
// activation in the workspace, the composite and its backward, the
// g-chain, dW and db, and the small products of level_backward.cuh. Passes
// 3-6 start from the head cotangents (launch_wide_backward,
// launch_wide_backward_f32), so mlp_bwd.cu runs them after its recompute,
// with heads of any width. Passes 1-6 below are the bf16 route's; the f32
// route (launch_train_wide<WideF32Route>, launch_wide_backward_f32 at the
// end) runs the same sequence with wide_f32.cuh's GEMM for every forward
// and chain product, f32 activations and masked g, and wide_dw.cuh's f32
// dW GEMM (wide_dw_f32_kernel) in pass 5.
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
//  5. wide_dw.cuh's launch_wide_dw: dW = act^T g of every product over
//     the backward's fixed split of the rows, both operands MN-major on
//     wgmma, in one launch of the persistent wide_dw_kernel<BN> for each
//     column block (BN = 256 where it divides the product's columns, else
//     128) from a job table; each hidden bias's db as the column sums of
//     its product's masked g in the same pass; each split's tile added
//     into the output in split order;
//  6. launch_small_sum (level_backward.cuh): the heads' dW and db and the
//     view layer's direction rows, their split partials summed in order.
// mlp_bwd.cu with input_grads adds dX (launch_wide_dx there).
// Every partial is written by exactly one block and added in a fixed
// order: no atomics, so two launches on the same inputs give bit-equal
// dW, db and dX.
// The rounding is the narrow route's: bf16 after every product, the
// density term rounded and added in bf16, the mask after rounding.

#pragma once

#include "train_wg.cuh"
#include "wide_dw.cuh"
#include "wide_f32.cuh"
#include "wide_forward.cuh"

namespace {

// Byte offsets of the wide route's own areas after the backward's layout
// (level_backward.cuh::layout, which ends at base; its split partials
// there only the small products', small_outputs a row): the raw heads
// (unless heads is false: mlp_bwd), the direction terms and the dW GEMMs'
// split counters (dw_flag_bound of them).
struct WideTrainLayout {
  long long heads, dc, flags, total;
  long long n_flags;
};

inline WideTrainLayout wide_train_layout(long long base, int R, int S, int D, int W, int Wc,
                                         int Dc, int KX, bool heads = true) {
  WideTrainLayout x;
  x.n_flags = dw_flag_bound(D, W, Wc, Dc, KX);
  long long off = base;
  x.heads = off;  off += heads ? round256((long long)R * S * 16) : 0;
  x.dc = off;     off += round256((long long)R * Wc * 4);
  x.flags = off;  off += round256(x.n_flags * 4);
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

// Passes 3-6 above from the head cotangents e.g_rgb [N, Cr] and e.g_den
// [N, Cd] (kCr: 3, the train level's, or 0, any), on the activations and
// features in the workspace (l; the split counters in x). e.wt:
// pack_params_wgt's stream, or pack_params_wgx's (co then has its x slabs,
// which only launch_wide_dx reads).
template <int kCr>
inline cudaError_t launch_wide_backward(Params p, Extra e, const Layout& l,
                                        const WideTrainLayout& x, const WideOffsets& o,
                                        const WideChainOffsets& co, unsigned char* ws,
                                        float* out, int splits, cudaStream_t st) {
  const long long N = e.N;
  const bf16* wt = static_cast<const bf16*>(e.wt);
  bf16* acts = static_cast<bf16*>(e.acts);
  bf16* grads = static_cast<bf16*>(e.grads);
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
  // 5. dW and db of every layer product (wide_dw.cuh), summed into out
  err = launch_wide_dw(p, e, false, out, reinterpret_cast<int*>(ws + x.flags), x.n_flags, splits,
                       st);
  if (err != cudaSuccess) return err;
  // 6. the small products and the heads' db
  return launch_small_sum<bf16>(p, e, l, ws, out, splits, st);
}

// ---- the f32 route (wide_f32.cuh's GEMM) ----

// The f32 route's passes from the head cotangents e.g_rgb [N, Cr] and
// e.g_den [N, Cd] on the f32 activations and features in the workspace
// (l; the split counters in x): wide_rgb_chain_f32_kernel, then one
// kF32Chain GEMM per chained layer, top layer first, g @ W^T from
// pack_params_wft's hi / lo slabs (e.wt, at wt_off) with the density term
// on the way into the trunk (the heads' W^T from p.w: pack_params'
// transposed head rows); g_ray_f32_kernel; then wide_dw.cuh's
// launch_wide_dw (wide_dw_f32_kernel: dW over the rows with db as column
// sums of g in the same pass, the splits added in order into out) and
// level_backward.cuh's launch_small_sum<float> (the small products).
inline cudaError_t launch_wide_backward_f32(Params p, Extra e, const Layout& l,
                                            const WideTrainLayout& x, unsigned char* ws,
                                            float* out, int splits, cudaStream_t st) {
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
  err = launch_wide_dw(p, e, true, out, reinterpret_cast<int*>(ws + x.flags), x.n_flags, splits,
                       st);
  if (err != cudaSuccess) return err;
  return launch_small_sum<float>(p, e, l, ws, out, splits, st);
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
// 3-6. bf16: launch_wide_backward (p.w: pack_params_wg's stream; e.wt:
// pack_params_wgt's), f32: launch_wide_backward_f32 (p.w: pack_params_wf;
// e.wt: pack_params_wft).
template <class Route>
inline cudaError_t launch_train_wide(Params p, Extra e, const Layout& l,
                                     const WideTrainLayout& x, unsigned char* ws, float* out,
                                     int splits, cudaStream_t st) {
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
    return launch_wide_backward<3>(p, e, l, x, r.o, wide_chain_offsets(p, r.o), ws, out, splits,
                                   st);
  else
    return launch_wide_backward_f32(p, e, l, x, ws, out, splits, st);
}

}  // namespace
