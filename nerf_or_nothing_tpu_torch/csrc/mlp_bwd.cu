// The whole mip-NeRF MLP backward: the forward recomputed from its inputs,
// then the g-chain from the head cotangents, f32 dW/db for every layer
// and, when asked, the input cotangents dX and dD.
//
// Replaces: nerf_or_nothing_tpu/kernels/fused_mlp.py::_bwd_kernel
// (launched by _fused_mlp_bwd_impl through fused_mlp_apply's VJP).
//
// Bound: operations. At the default config (1024 rays x 128 samples) it
// needs 141.9 GFLOP to recompute the forward, 141.9 of dW products and
// 129.0 of g-chain products, and with input_grads another 12.9 for the
// chain into layer 0 and the skip layer's x rows and 0.007 for dD:
// 554.7 / 567.6 GFLOP against ~30 MB of inputs and outputs.
//
// Design (simple first version): the train-level kernel's passes with the
// composite taken out, since the contract gives only (x, d, g_rgb, g_den)
// and the forward must be recomputed, as the TPU kernel does:
//  1. mlp_act_kernel: the forward (level_common.cuh: mma.sync layers),
//     storing the features (padded to KX) and every layer's post-ReLU
//     activations to a global workspace (bf16: ~570 MB at 131,072 rows;
//     the workspace is sized for the rows of this call, never for a
//     render chunk, which runs no backward);
//  2-5. level_backward.cuh (shared with train_level.cu): the g-chain with
//     dX accumulated in bf16 (the deepest skip layer's x-row term first,
//     layer 0's chain last) and dD from the per-ray g sums, the dW GEMM
//     over the rows, the heads' and direction rows' small products, and
//     the fixed-order reduction. No atomics: two launches on the same
//     inputs give bit-equal dW/db.
// f32: the same passes with FMA loops (no TF32), for checking in f32.
//
// Plain C interface (loaded with ctypes): mlp_bwd_workspace gives the
// workspace size; mlp_bwd_launch returns the first failing cudaError_t; it
// launches on the given stream, allocates nothing and does not synchronise.

#include "level_backward.cuh"

namespace {

// Pass 1: the forward of the block's rays, storing the activations.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
mlp_act_kernel(Params p, Extra e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p);
  const int ray0 = blockIdx.x * p.RB;
  forward_store<T>(p, e, sm, ray0, min(p.RB, p.R - ray0), false);
}

template <class T>
cudaError_t launch_mlp_bwd(Params p, Extra e, const Layout& l, unsigned char* ws, float* out,
                           long long n_out, int splits, cudaStream_t st) {
  const int blocks = (p.R + p.RB - 1) / p.RB;
  const size_t smem = smem_bytes<T>(p.ldh, p.ldx, p.RB, p.Wc, 0);
  cudaError_t err;
  if ((err = set_smem((const void*)mlp_act_kernel<T>, smem)) != cudaSuccess) return err;
  mlp_act_kernel<T><<<blocks, kThreads, smem, st>>>(p, e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_backward<T>(p, e, l, ws, out, n_out, splits, st);
}

}  // namespace

extern "C" {

// Bytes of workspace mlp_bwd_launch needs for these shapes.
long long mlp_bwd_workspace(int dtype, int R, int S, int D, int W, int Wc, int Dc, int KX,
                            int splits, long long n_out) {
  return layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits, n_out, false).total;
}

// dtype: 0 = float32, 1 = bfloat16. x: [R * S, LX] and d: [R, Fd] in the
// compute type; g_rgb [R * S, Cr] and g_den [R * S, Cd] f32; w, b:
// pack_params' layout; wt: pack_params_t; wtx: pack_params_tx; grads: the
// flat f32 dW/db output of n_out values (output_offsets); dx [R * S, LX]
// in the compute type and dd [R, Fd] f32 when input_grads (else unused);
// workspace: mlp_bwd_workspace bytes, 256-byte aligned.
int mlp_bwd_launch(int dtype, const void* x, const void* d, const float* g_rgb,
                   const float* g_den, const void* w, const void* wt, const void* wtx,
                   const float* b, float* grads, long long n_out, void* dx, float* dd,
                   void* workspace, int R, int S, int D, int W, int skip, int Wc, int Dc,
                   int LX, int KX, int Fd, int Cr, int Cd, int splits, int input_grads,
                   void* stream) {
  if (R <= 0) return cudaSuccess;
  Params p;
  if (!init_params(p, dtype, 1, nullptr, nullptr, x, d, nullptr, w, b, R, S, D, W, skip, Wc,
                   Dc, LX, KX, Fd, 0, 0, 0.0f, 0.0f, 0, Cr, Cd) ||
      splits < 1 || (long long)R * S > 2147483647LL || (input_grads && (!dx || !dd)))
    return cudaErrorInvalidValue;
  long long w_off[64], b_off[64];
  if (D + 2 + Dc > 64 || output_offsets(p, w_off, b_off) != n_out)
    return cudaErrorInvalidValue;
  const Layout l = layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits, n_out, false);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  const Extra e = make_extra(ws, l, (long long)R * S, wt, wtx, const_cast<float*>(g_rgb),
                             const_cast<float*>(g_den), input_grads ? dx : nullptr,
                             input_grads ? dd : nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? (int)launch_mlp_bwd<bf16>(p, e, l, ws, grads, n_out, splits, st)
                    : (int)launch_mlp_bwd<float>(p, e, l, ws, grads, n_out, splits, st);
}

}  // extern "C"
