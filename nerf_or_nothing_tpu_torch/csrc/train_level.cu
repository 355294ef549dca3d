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
// Design (simple first version). The TPU kernel keeps a 2048-row tile's
// activations in VMEM; one row's activations are (8*256 + 128) * 2 B =
// 4,352 B here, so a 64-row tile would need 272 KB of shared memory and a
// whole ray 544 KB. So the level runs as five launches on one stream, all
// hand-written, with the activations and masked gradients parked in a
// global workspace (bf16: ~570 MB each at the default config, ~0.34 ms of
// HBM traffic each way):
//  1. train_fwd_kernel: the render kernel's forward (level_common.cuh:
//     in-kernel IPE, mma.sync layers, heads), which also stores every
//     layer's post-ReLU activations and the features (padded to KX),
//     then one warp per ray runs the composite, the loss gradient and the
//     composite backward (suffix sum as total - inclusive prefix) and
//     writes comp, acc, weights and the f32 head cotangents g_rgb, g_den;
//  2-5. the g-chain, the dW GEMM over the rows, the small head and
//     direction-row products and the fixed-order reduction of
//     level_backward.cuh (shared with mlp_bwd.cu), without dX or dD.
// No atomics, so two launches on the same inputs give bit-equal dW. f32:
// the same passes with FMA loops (no TF32), for checking the algorithm.
//
// Plain C interface (loaded with ctypes): train_level_workspace gives the
// workspace size; train_level_launch returns the first failing
// cudaError_t; it launches on the given stream, allocates nothing and does
// not synchronise.

#include "level_backward.cuh"

namespace {

// Pass 1: the render kernel's forward, keeping the activations, then the
// composite and its backward.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
train_fwd_kernel(Params p, Extra e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p);
  float* EX = reinterpret_cast<float*>(smem_raw +
                                       smem_bytes<T>(p.ldh, p.ldx, p.RB, p.Wc, p.S));
  const int ray0 = blockIdx.x * p.RB;
  const int nr = min(p.RB, p.R - ray0);
  forward_store<T>(p, e, sm, ray0, nr, true);
  composite_train<T>(p, e, sm, EX, ray0, nr);
}

template <class T>
cudaError_t launch_train(Params p, Extra e, const Layout& l, unsigned char* ws, float* out,
                         long long n_out, int splits, cudaStream_t st) {
  // 1. forward, composite and its backward
  const int blocks = (p.R + p.RB - 1) / p.RB;
  const size_t smem_f = smem_bytes<T>(p.ldh, p.ldx, p.RB, p.Wc, p.S) +
                        sizeof(float) * p.RB * p.S * 4;
  cudaError_t err;
  if ((err = set_smem((const void*)train_fwd_kernel<T>, smem_f)) != cudaSuccess) return err;
  train_fwd_kernel<T><<<blocks, kThreads, smem_f, st>>>(p, e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 2-5. g-chain, dW, small products, reduction
  return launch_backward<T>(p, e, l, ws, out, n_out, splits, st);
}

}  // namespace

extern "C" {

// Bytes of workspace train_level_launch needs for these shapes.
long long train_level_workspace(int dtype, int R, int S, int D, int W, int Wc, int Dc, int KX,
                                int splits, long long n_out) {
  return layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits, n_out, true).total;
}

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = "mv" (IPE in the kernel),
// 1 = "t" (encoded features). w: pack_params' layout; wt: the chained
// layers' W^T (pack_params_t); grads: the flat f32 dW/db output of
// n_out values (see output_offsets); workspace: train_level_workspace
// bytes, 256-byte aligned.
int train_level_launch(int dtype, int mode, const float* means, const float* vars,
                       const void* x, const void* d, const float* delta, const float* pixels,
                       const float* gsc, const void* w, const void* wt, const float* b,
                       float* comp, float* acc, float* weights, float* grads,
                       long long n_out, void* workspace, int R, int S, int D, int W, int skip,
                       int Wc, int Dc, int LX, int KX, int Fd, int min_deg, int fast,
                       float density_bias, float rgb_padding, int white_bkgd, int splits,
                       void* stream) {
  if (R <= 0) return cudaSuccess;
  Params p;
  if (!init_params(p, dtype, mode, means, vars, x, d, delta, w, b, R, S, D, W, skip, Wc, Dc,
                   LX, KX, Fd, min_deg, fast, density_bias, rgb_padding, white_bkgd) ||
      splits < 1 || (long long)R * S > 2147483647LL)
    return cudaErrorInvalidValue;
  p.comp = comp; p.acc = acc; p.weights = weights;
  long long w_off[64], b_off[64];
  if (D + 2 + Dc > 64 || output_offsets(p, w_off, b_off) != n_out)
    return cudaErrorInvalidValue;
  const int esize = dtype == 1 ? 2 : 4;
  const Layout l = layout(esize, R, S, D, W, Wc, Dc, KX, splits, n_out, true);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  Extra e = make_extra(ws, l, (long long)R * S, wt, nullptr,
                       reinterpret_cast<float*>(ws + l.g_rgb),
                       reinterpret_cast<float*>(ws + l.g_den), nullptr, nullptr);
  e.pixels = pixels; e.gsc = gsc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? (int)launch_train<bf16>(p, e, l, ws, grads, n_out, splits, st)
                    : (int)launch_train<float>(p, e, l, ws, grads, n_out, splits, st);
}

}  // extern "C"
