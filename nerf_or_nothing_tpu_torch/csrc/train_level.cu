// One train level of mip-NeRF: MLP forward, activations, compositing, the
// loss gradient g_scale * (comp - pixel), the compositing backward, the
// activation VJPs and the MLP backward with f32 dW/db for every layer.
//
// Replaces: nerf_or_nothing_tpu/kernels/fused_level.py::_level_kernel
// (launched by _fused_level_impl through fused_level_train).
//
// Bound: operations. At the default config one level (1024 rays x 128
// samples) needs 141.9 GFLOP of forward products, 141.9 of dW products and
// 129.0 of g-chain products (no chain into layer 0, the skip layer's x
// rows or the direction rows: there is no dX or dD), 412.8 GFLOP against
// ~40 MB of inputs and outputs.
//
// Design. The TPU kernel keeps a 2048-row tile's activations in VMEM; one
// row's activations are (8*256 + 128) * 2 B = 4,352 B here, so a 64-row
// tile would need 272 KB of shared memory and a whole ray 544 KB. So the
// level runs as several launches on one stream, all hand-written, with
// the activations and masked gradients parked in a global workspace
// (bf16: ~570 MB each at the default config, ~0.34 ms of HBM traffic each
// way).
// bf16 (train_wg.cuh): the wgmma forward keeping its activations and ReLU
// masks, the composite and its backward, the wgmma g-chain with per-block
// db, then the dW GEMM over the rows, the small head and direction-row
// products and the fixed-order reduction of level_backward.cuh.
// bf16 at net_width 288 and above (wide_train.cuh): one wgmma GEMM launch per
// layer product, in column blocks of at most 256, every activation and
// masked g in the workspace (a [64, 1024] tile would take 128 KB of the
// block's shared memory), then the same composite, small products and
// reduction. f32 at net_width 288 and above (wide_train.cuh's
// launch_train_wide<WideF32Route>): the same sequence with one 3xTF32
// wgmma GEMM launch per forward and chain product (wide_f32.cuh,
// column blocks of 128), f32 activations and masked g in the workspace
// (~8.7 GB at Config(net_width=1024)), then passes 3-5 of the narrow f32
// route.
// f32: five launches, every layer product as three TF32 tensor-core
// passes (3xTF32 mma.sync: each f32 operand split into a TF32 high and low
// part, lo*hi + hi*lo + hi*hi summed in f32; TF32 runs at 495 TFLOP/s
// dense, so the 412.8 GFLOP of f32 work are bound at 2.502 ms, where f32
// FMA would be at 6.162 ms): train_fwd_kernel (level_common.cuh's forward
// storing the activations and features, then one warp per ray runs the
// composite, the loss gradient and the composite backward), then passes
// 2-5 of level_backward.cuh (shared with mlp_bwd.cu), without dX or dD.
// Activations and masked g are f32 in the workspace (~1.14 GB each at the
// default config).
// No atomics, so two launches on the same inputs give bit-equal dW.
//
// Plain C interface (loaded with ctypes): train_level_workspace gives the
// workspace size; train_level_launch returns the first failing
// cudaError_t; it launches on the given stream, allocates nothing and does
// not synchronise.

#include "train_wg.cuh"
#include "wide_train.cuh"

namespace {

// f32 pass 1: the render kernel's forward, keeping the activations, then
// the composite and its backward.
__global__ void __launch_bounds__(kThreads, kF32Blocks)
train_fwd_kernel(Params p, Extra e) {
  typedef float T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p, p.S);
  float* EX = reinterpret_cast<float*>(smem_raw +
                                       smem_bytes<T>(p, p.S));
  const int ray0 = blockIdx.x * p.RB;
  const int nr = min(p.RB, p.R - ray0);
  forward_store<T>(p, e, sm, ray0, nr, true);
  composite_train<T>(p, e, sm, EX, ray0, nr);
}

cudaError_t launch_train_f32(Params p, Extra e, const Layout& l, unsigned char* ws, float* out,
                             long long n_out, int splits, cudaStream_t st) {
  typedef float T;
  // 1. forward, composite and its backward
  const int blocks = (p.R + p.RB - 1) / p.RB;
  const size_t smem_f = smem_bytes<T>(p, p.S) +
                        sizeof(float) * p.RB * p.S * 4;
  cudaError_t err;
  if ((err = set_smem((const void*)train_fwd_kernel, smem_f)) != cudaSuccess) return err;
  train_fwd_kernel<<<blocks, kThreads, smem_f, st>>>(p, e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 2-5. g-chain, dW, small products, reduction
  return launch_backward<T>(p, e, l, ws, out, n_out, splits, st);
}

}  // namespace

extern "C" {

// Bytes of workspace train_level_launch needs for these shapes (Fd: the
// direction features; on the wide route the split partials hold the small
// products' outputs only).
long long train_level_workspace(int dtype, int R, int S, int D, int W, int Wc, int Dc, int KX,
                                int splits, long long n_out, int Fd) {
  const bool wide = wide_route(dtype, W);
  const Layout l = layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits,
                          wide ? small_outputs(W, Wc, Fd, 3, 1) : n_out, true);
  if (wide) return wide_train_layout(l.total, R, S, D, W, Wc, Dc, KX).total;
  return dtype == 1 ? wg_layout(l.total, R, S, D, W, Wc, Dc).total : l.total;
}

// dtype: 0 = float32, 1 = bfloat16, plus kWideRoute for the wide route
// below 288 (level_common.cuh). mode: 0 = "mv" (IPE in the kernel), 1 =
// "t" (encoded features). W up to 256, or from 288 up (the wide route,
// both dtypes; no ceiling but the card's memory). w, wt: bf16 pack_params_wg's forward slab stream and
// pack_params_wgt's chain stream; f32 pack_params' layout and the chained
// layers' W^T (pack_params_t), on the wide route pack_params_wf's and
// pack_params_wft's hi / lo slabs; grads: the flat f32 dW/db
// output of n_out values (see output_offsets); workspace:
// train_level_workspace bytes, 256-byte aligned.
int train_level_launch(int dtype, int mode, const float* means, const float* vars,
                       const void* x, const void* d, const float* delta, const float* pixels,
                       const float* gsc, const void* w, const void* wt, const float* b,
                       float* comp, float* acc, float* weights, float* grads,
                       long long n_out, void* workspace, int R, int S, int D, int W, int skip,
                       int Wc, int Dc, int LX, int KX, int Fd, int min_deg, int fast,
                       float density_bias, float rgb_padding, int white_bkgd, int splits,
                       void* stream) {
  if (R <= 0) return cudaSuccess;
  const bool wide = wide_route(dtype, W);
  Params p;
  if (!init_params(p, dtype, mode, means, vars, x, d, delta, w, b, R, S, D, W, skip, Wc, Dc,
                   LX, KX, Fd, min_deg, fast, density_bias, rgb_padding, white_bkgd, 3, 1,
                   true) ||
      splits < 1 || (long long)R * S > 2147483647LL)
    return cudaErrorInvalidValue;
  p.comp = comp; p.acc = acc; p.weights = weights;
  std::vector<long long> w_off, b_off;
  if (output_offsets(p, w_off, b_off) != n_out)
    return cudaErrorInvalidValue;
  const int esize = dtype == 1 ? 2 : 4;
  const Layout l = layout(esize, R, S, D, W, Wc, Dc, KX, splits,
                          wide ? small_outputs(W, Wc, Fd, 3, 1) : n_out, true);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  Extra e = make_extra(ws, l, (long long)R * S, wt, nullptr,
                       reinterpret_cast<float*>(ws + l.g_rgb),
                       reinterpret_cast<float*>(ws + l.g_den), nullptr, nullptr);
  e.pixels = pixels; e.gsc = gsc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    const WideTrainLayout x = wide_train_layout(l.total, R, S, D, W, Wc, Dc, KX);
    return (int)(dtype == 1 ? launch_train_wide<WideBf16Route>(p, e, l, x, ws, grads, splits, st)
                            : launch_train_wide<WideF32Route>(p, e, l, x, ws, grads, splits, st));
  }
  if (dtype == 1)
    return (int)launch_train_wg(p, e, l, wg_layout(l.total, R, S, D, W, Wc, Dc), ws, grads,
                                n_out, splits, st);
  return (int)launch_train_f32(p, e, l, ws, grads, n_out, splits, st);
}

// The weights it reads (fused_level.pack_train_level): in bf16 the "wg"
// forward slab stream and the "wgt" chain stream; in f32 on the wide route
// the "wf" hi / lo slab streams (pack_params_wf, pack_params_wft).
const char* train_level_weight_layout() { return "wf"; }

}  // extern "C"
