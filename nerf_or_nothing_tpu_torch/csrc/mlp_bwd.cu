// The whole mip-NeRF MLP backward: the forward recomputed from its inputs,
// then the g-chain from the head cotangents, f32 dW/db for every layer
// and, when asked, the input cotangents dX and dD.
//
// Replaces: nerf_or_nothing_tpu/kernels/fused_mlp.py::_bwd_kernel
// (launched by _fused_mlp_bwd_impl through fused_mlp_apply's VJP).
//
// Bound: operations. At the default config (1024 rays x 128 samples) it
// needs 141.9 GFLOP to recompute the forward, 141.9 of dW products and
// 129.0 of g-chain products (412.8 GFLOP, train_level.cu's count), and
// with input_grads another 12.9 for the chain into layer 0 and the skip
// layer's x rows and 0.007 for dD: 412.8 / 425.7 GFLOP (0.4174 / 0.4305
// ms at 989 TFLOP/s) against ~30 MB of inputs and outputs.
//
// Design. The contract gives only (x, d, g_rgb, g_den), so the forward is
// recomputed, as the TPU kernel does; the rest is the train level's
// backward without the composite. bf16, on train_wg.cuh's passes:
//  1. mlp_act_wg_kernel: forward_wg<false, true, false> in mode "t" on the
//     "wg" slab stream mlp_fwd.cu reads: the activations, the features
//     (padded to KX) and the ReLU mask bits to the workspace (~570 MB at
//     131,072 rows; sized for the rows of this call), not the raw heads,
//     which the backward does not read;
//  2. chain_wg_kernel<kCr, kCd, kDx>: the warp-specialised wgmma g-chain
//     from the f32 head cotangents (heads of any width; 3 rgb / 1
//     density is its own instantiation) on the "wgx" stream
//     (fused_level.pack_params_wgx: the train level's chain slabs with
//     W_x^T of layer 0 and the skip layers among them); per-block db
//     partials; with input_grads (kDx) dX accumulated in bf16 in shared
//     memory, the deepest skip layer's x-row term first, layer 0's last,
//     written once to dx;
//  3. g_ray_kernel: the first view layer's masked g summed per ray (f32);
//  4. with input_grads, mlp_dd_kernel: dD = round(g_ray) @ W_d^T, f32;
//  5. dw_wg_kernel: dW over the rows on wgmma (the skip layers' x rows
//     from the stored features);
//  6-7. level_backward.cuh's small products (the heads' dW from the f32
//     cotangents, the direction rows, db from the chain's partials) and
//     the fixed-order reduction.
// No atomics: two launches on the same inputs give bit-equal dW, db, dX
// and dD.
// bf16 at net_width 288 and above (wide_train.cuh): the forward recomputed by
// wide_forward.cuh (a wgmma GEMM launch per layer, every activation and the
// features kept in the workspace, no heads), then wide_train.cuh's passes
// from the head cotangents (heads of any width): the g-chain GEMMs
// on the "wgx" stream, g_ray_kernel, db partials, the dW GEMMs, the small
// products and reduction; with input_grads, launch_wide_dx (a GEMM per x
// layer into dX, deepest first) and mlp_dd_kernel. f32 at net_width
// 288 and above (launch_mlp_bwd_wide_f32): the same passes with wide_f32.cuh's
// 3xTF32 wgmma GEMM for the forward, the chain and dX (launch_wide_dx_f32
// on pack_params_wfx), f32 activations, and the narrow f32 route's dW GEMM.
// f32, every layer product as 3xTF32 mma.sync (level_common.cuh's gemm,
// level_backward.cuh's dW GEMM): mlp_act_kernel (level_common.cuh's forward
// storing the activations), then passes 2-5 of level_backward.cuh (the
// g-chain with dX and dD, the dW GEMM, the small products, the
// reduction).
//
// Plain C interface (loaded with ctypes): mlp_bwd_workspace gives the
// workspace size; mlp_bwd_launch returns the first failing cudaError_t; it
// launches on the given stream, allocates nothing and does not synchronise.

#include "train_wg.cuh"
#include "wide_train.cuh"

namespace {

// f32 pass 1: the forward of the block's rays, storing the activations.
template <class T>
__global__ void __launch_bounds__(kThreads, kF32Blocks)
mlp_act_kernel(Params p, Extra e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p, 0);
  const int ray0 = blockIdx.x * p.RB;
  forward_store<T>(p, e, sm, ray0, min(p.RB, p.R - ray0), false);
}

cudaError_t launch_mlp_bwd_f32(Params p, Extra e, const Layout& l, unsigned char* ws,
                               float* out, long long n_out, int splits, cudaStream_t st) {
  typedef float T;
  const int blocks = (p.R + p.RB - 1) / p.RB;
  const size_t smem = smem_bytes<T>(p, 0);
  cudaError_t err;
  if ((err = set_smem((const void*)mlp_act_kernel<T>, smem)) != cudaSuccess) return err;
  mlp_act_kernel<T><<<blocks, kThreads, smem, st>>>(p, e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_backward<T>(p, e, l, ws, out, n_out, splits, st);
}

// bf16 pass 1: the wgmma forward keeping its activations, features and
// masks (no heads).
__global__ void __launch_bounds__(kWgThreads, 1) mlp_act_wg_kernel(WgParams q) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  forward_wg<false, true, false>(q, smem_wg);
}

// dD[ray, f] = round(g_ray[ray, :]) . W_d[f, :], an f32 sum in column
// order, one warp a ray (wd: the direction rows [Fd, Wc] of the "wg"
// stream).
__global__ void mlp_dd_kernel(const float* g_ray, const bf16* wd, float* dd, int R, int Wc,
                              int Fd) {
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= R) return;
  const float* g = g_ray + (long long)ray * Wc;
  for (int f = threadIdx.x & 31; f < Fd; f += 32) {
    float s = 0.0f;
    for (int n = 0; n < Wc; ++n) s = fmaf(round_bf(g[n]), __bfloat162float(wd[f * Wc + n]), s);
    dd[(long long)ray * Fd + f] = s;
  }
}

template <int kCr, int kCd>
cudaError_t launch_chain_of(const ChainParams& c, bool dx, int* grid, cudaStream_t st) {
  return dx ? launch_chain<kCr, kCd, true>(c, grid, st)
            : launch_chain<kCr, kCd, false>(c, grid, st);
}

// Passes 1-7 of the bf16 route on the workspace (l, then x). p.w: the
// "wg" forward stream; e.wt: the "wgx" chain stream.
cudaError_t launch_mlp_bwd_wg(Params p, Extra e, const Layout& l, const WgLayout& x,
                              unsigned char* ws, float* out, long long n_out, int splits,
                              cudaStream_t st) {
  WgParams q{};
  q.p = p;
  if (!init_wg(q, false)) return cudaErrorInvalidValue;
  q.acts = static_cast<bf16*>(e.acts);
  q.xs = static_cast<bf16*>(e.xs);
  q.mask = reinterpret_cast<uint32_t*>(ws + x.mask);
  q.heads = nullptr;
  q.N = e.N;
  ChainParams c;
  const bool dx = e.dx != nullptr;
  if (!init_chain(c, q, true, dx)) return cudaErrorInvalidValue;
  c.wt = static_cast<const bf16*>(e.wt);
  c.mask = q.mask;
  c.g_rgb = e.g_rgb;
  c.g_den = e.g_den;
  c.grads = static_cast<bf16*>(e.grads);
  c.dbpart = reinterpret_cast<float*>(ws + x.dbpart);
  c.dx = static_cast<bf16*>(e.dx);

  // 1. forward, keeping the activations
  cudaError_t err = launch_wg(mlp_act_wg_kernel, q, st);
  if (err != cudaSuccess) return err;
  // 2. g-chain with db (and dX), then the view layer's per-ray sums (and dD)
  int grid = 0;
  err = p.Cr == 3 && p.Cd == 1 ? launch_chain_of<3, 1>(c, dx, &grid, st)
                               : launch_chain_of<0, 0>(c, dx, &grid, st);
  if (err != cudaSuccess) return err;
  g_ray_kernel<<<p.R, p.Wc, 0, st>>>(c.grads + act_off(p, e.N, p.D), e.g_ray, p.S, p.Wc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (e.dd) {
    const bf16* wd = static_cast<const bf16*>(p.w) + q.w_dir;
    mlp_dd_kernel<<<cdiv(p.R, 8), 256, 0, st>>>(e.g_ray, wd, e.dd, p.R, p.Wc, p.Fd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 5. dW GEMM; 6-7. small products (db from the partials), reduction
  if ((err = launch_dw_wg(p, e, l, ws, n_out, splits, st)) != cudaSuccess) return err;
  return launch_small_reduce<bf16>(p, e, l, ws, out, n_out, splits, c.dbpart, grid, st);
}

// dX [N, LX] (e.dx, bf16) on the wide route: for x layer i = D-1 .. 0 (the
// skip layers, then layer 0) one kWideDx wide_gemm_kernel, grad(i) @ W_x,i^T
// from the x slabs of pack_params_wgx (nxw columns, those past LX zero; co
// from wide_chain_offsets with nxw), the first term rounded into dX, each
// later one rounded and added to dX in bf16 (mlp_backward_plain's order
// and rounding; each element one thread's, no atomics).
cudaError_t launch_wide_dx(const Params& p, const Extra& e, const WideOffsets& o,
                           const WideChainOffsets& co, int nxw, cudaStream_t st) {
  const bf16* wt = static_cast<const bf16*>(e.wt);
  const bf16* grads = static_cast<const bf16*>(e.grads);
  bool first = true;
  for (int i = p.D - 1; i >= 0; --i) {
    if (!x_layer(p, i)) continue;
    WideGemmMlp m{};
    WideGemm& g = m.g;
    g.a0 = grads + act_off(p, e.N, i); g.lda0 = g.ka0 = p.W; g.ns0 = o.nh;
    g.b = wt + co.x[i]; g.N = nxw; g.M = e.N;
    g.out = static_cast<bf16*>(e.dx); m.ldo = p.LX; m.accum = !first;
    const cudaError_t err = launch_wide_gemm_mlp<kWideDx>(m, st);
    if (err != cudaSuccess) return err;
    first = false;
  }
  return cudaSuccess;
}

// The bf16 route at net_width 288 and above on the workspace (l, then x).
// p.w: the "wg" forward stream; e.wt: the "wgx" chain stream.
cudaError_t launch_mlp_bwd_wide(Params p, Extra e, const Layout& l, const WideTrainLayout& x,
                                unsigned char* ws, float* out, int splits, cudaStream_t st) {
  WideBf16Route r;
  if (!r.init(p)) return cudaErrorInvalidValue;
  const WideOffsets& o = r.o;
  const int nxw = cdiv(p.KX, 32) * 32;  // fused_level.dx_width
  const WideChainOffsets co = wide_chain_offsets(p, o, nxw);
  const bf16* w = static_cast<const bf16*>(p.w);
  float* dc = reinterpret_cast<float*>(ws + x.dc);
  // 1. forward, keeping the activations and features
  cudaError_t err = wide_forward_keep<WideBf16Route, kWideNoHeads>(p, r, e, dc, nullptr, st);
  if (err != cudaSuccess) return err;
  // 2-6. g-chain, per-ray sums, dW and db, small products
  if ((err = launch_wide_backward<0>(p, e, l, x, o, co, ws, out, splits, st)) != cudaSuccess)
    return err;
  // dX and dD
  if (e.dx && (err = launch_wide_dx(p, e, o, co, nxw, st)) != cudaSuccess) return err;
  if (e.dd) {
    mlp_dd_kernel<<<cdiv(p.R, 8), 256, 0, st>>>(e.g_ray, w + o.dir, e.dd, p.R, p.Wc, p.Fd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// dX [N, LX] (e.dx, f32) on the f32 route: for x layer i = D-1 .. 0 (the
// skip layers, then layer 0) one kF32Dx GEMM, grad(i) @ W_x,i^T from
// pack_params_wfx's hi / lo slabs (e.wtx at wtx_off, columns past LX zero),
// the first term added to 0, each later one to the sum so far (the narrow
// chain's order; each element one thread's, no atomics).
cudaError_t launch_wide_dx_f32(const Params& p, const Extra& e, cudaStream_t st) {
  const float* wtx = static_cast<const float*>(e.wtx);
  const float* grads = static_cast<const float*>(e.grads);
  bool first = true;
  for (int i = p.D - 1; i >= 0; --i) {
    if (!x_layer(p, i)) continue;
    WideGemmF32 g{};
    g.a0 = grads + act_off(p, e.N, i); g.lda0 = g.ka0 = p.W;
    g.b = wtx + wtx_off(p, i); g.blo = g.b + wide_f32_dx_len(p); g.N = p.KX; g.M = e.N;
    g.out = static_cast<float*>(e.dx); g.ldo = p.LX; g.accum = !first;
    const cudaError_t err = launch_wide_gemm_f32<kF32Dx>(g, st);
    if (err != cudaSuccess) return err;
    first = false;
  }
  return cudaSuccess;
}

// The f32 route at net_width 288 and above on the workspace (l, then x): the
// forward recomputed on WideF32Route (every activation and the features
// kept, no heads), launch_wide_backward_f32 from the head cotangents, then
// with input_grads dX and dD. p.w: pack_params_wf; e.wt: pack_params_wft;
// e.wtx: pack_params_wfx.
cudaError_t launch_mlp_bwd_wide_f32(Params p, Extra e, const Layout& l, const WideTrainLayout& x,
                                    unsigned char* ws, float* out, int splits, cudaStream_t st) {
  WideF32Route r;
  if (!r.init(p)) return cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(p.w);
  float* dc = reinterpret_cast<float*>(ws + x.dc);
  cudaError_t err = wide_forward_keep<WideF32Route, kWideNoHeads>(p, r, e, dc, nullptr, st);
  if (err != cudaSuccess) return err;
  if ((err = launch_wide_backward_f32(p, e, l, x, ws, out, splits, st)) != cudaSuccess)
    return err;
  if (e.dx && (err = launch_wide_dx_f32(p, e, st)) != cudaSuccess) return err;
  if (e.dd) {
    wide_dd_f32_kernel<<<cdiv(p.R, 8), 256, 0, st>>>(e.g_ray, w + p.w_v0_bot, e.dd, p.R, p.Wc,
                                                    p.Fd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The row stride of the narrow routes' split partials (and the values the
// reduction writes): n_out rounded up to even, so that each row starts
// 8-byte aligned for the dW GEMMs' float2 stores (n_out is odd when the
// heads' channels Cr + Cd are). The wide routes' partials hold the small
// products' outputs only (small_outputs), which no float2 store writes.
inline long long partial_stride(long long n_out) { return n_out + (n_out & 1); }

}  // namespace

extern "C" {

// Bytes of workspace mlp_bwd_launch needs for these shapes (bf16: with
// the mask bits and the db partials of the Cg = Cr + Cd head channels; on
// the wide route, both dtypes, the direction terms and the split
// counters, and split partials of the small products' outputs only: Fd
// direction features, Cd density channels).
long long mlp_bwd_workspace(int dtype, int R, int S, int D, int W, int Wc, int Dc, int KX,
                            int splits, long long n_out, int Cg, int Fd, int Cd) {
  const bool wide = wide_route(dtype, W);
  const Layout l = layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits,
                          wide ? small_outputs(W, Wc, Fd, Cg - Cd, Cd) : partial_stride(n_out),
                          false);
  if (wide) return wide_train_layout(l.total, R, S, D, W, Wc, Dc, KX, false).total;
  if (dtype == 1) return wg_layout(l.total, R, S, D, W, Wc, Dc, Cg, false).total;
  return l.total;
}

// dtype: 0 = float32, 1 = bfloat16, plus kWideRoute for the wide route
// below 288 (level_common.cuh). x: [R * S, LX] and d: [R, Fd] in the
// compute type; g_rgb [R * S, Cr] and g_den [R * S, Cd] f32 (W: multiples
// of 32 up to 256, or from 288 up, the wide route, in both dtypes); bf16: w the
// "wg" forward slab stream (fused_level.pack_params_wg), wt the "wgx"
// chain stream (pack_params_wgx), wtx unused; f32: w, b pack_params'
// layout, wt pack_params_t, wtx pack_params_tx (the wide route: w
// pack_params_wf, wt pack_params_wft, wtx pack_params_wfx); grads: the flat f32 dW/db
// output of n_out values (output_offsets), with room for n_out rounded up
// to even (partial_stride; the last is scratch); dx [R * S, LX] in the compute
// type and dd [R, Fd] f32 when input_grads (else unused); workspace:
// mlp_bwd_workspace bytes, 256-byte aligned.
int mlp_bwd_launch(int dtype, const void* x, const void* d, const float* g_rgb,
                   const float* g_den, const void* w, const void* wt, const void* wtx,
                   const float* b, float* grads, long long n_out, void* dx, float* dd,
                   void* workspace, int R, int S, int D, int W, int skip, int Wc, int Dc,
                   int LX, int KX, int Fd, int Cr, int Cd, int splits, int input_grads,
                   void* stream) {
  if (R <= 0) return cudaSuccess;
  const bool wide = wide_route(dtype, W);
  Params p;
  if (!init_params(p, dtype, 1, nullptr, nullptr, x, d, nullptr, w, b, R, S, D, W, skip, Wc,
                   Dc, LX, KX, Fd, 0, 0, 0.0f, 0.0f, 0, Cr, Cd, true) ||
      splits < 1 || (long long)R * S > 2147483647LL || (input_grads && (!dx || !dd)) ||
      (input_grads && LX % 2))
    return cudaErrorInvalidValue;
  std::vector<long long> w_off, b_off;
  if (output_offsets(p, w_off, b_off) != n_out)
    return cudaErrorInvalidValue;
  n_out = partial_stride(n_out);
  const Layout l = layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits,
                          wide ? small_outputs(W, Wc, Fd, Cr, Cd) : n_out, false);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  const Extra e = make_extra(ws, l, (long long)R * S, wt, wtx, const_cast<float*>(g_rgb),
                             const_cast<float*>(g_den), input_grads ? dx : nullptr,
                             input_grads ? dd : nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    const WideTrainLayout x = wide_train_layout(l.total, R, S, D, W, Wc, Dc, KX, false);
    return (int)(dtype == 1 ? launch_mlp_bwd_wide(p, e, l, x, ws, grads, splits, st)
                            : launch_mlp_bwd_wide_f32(p, e, l, x, ws, grads, splits, st));
  }
  if (dtype == 1)
    return (int)launch_mlp_bwd_wg(p, e, l, wg_layout(l.total, R, S, D, W, Wc, Dc, Cr + Cd,
                                                     false),
                                  ws, grads, n_out, splits, st);
  return (int)launch_mlp_bwd_f32(p, e, l, ws, grads, n_out, splits, st);
}

// The weights it reads (fused_mlp.pack_mlp_params): in bf16 the "wg"
// forward slab stream and the "wgx" chain stream; in f32 on the wide route
// the "wf" hi / lo slab streams (pack_params_wf, _wft, _wfx).
const char* mlp_bwd_weight_layout() { return "wf"; }

}  // extern "C"
