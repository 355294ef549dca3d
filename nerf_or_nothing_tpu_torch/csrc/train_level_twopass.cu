// One train level of mip-NeRF in two phases: the same function as
// train_level.cu (MLP forward, compositing, the loss gradient g_scale *
// (comp - pixel), the compositing backward and the MLP backward with f32
// dW/db for every layer), input mode "t" (encoded features) only.
//
// Replaces: nerf_or_nothing_tpu/kernels/fused_level.py::_level_kernel_twopass
// (the same pallas_call as _level_kernel on a (tiles, 2) grid, selected by
// kernel_probes fl_variant=twopass in mode "t").
//
// Bound: operations, as train_level.cu: at the default config one level
// (1024 rays x 128 samples) needs 141.9 GFLOP of forward products, 141.9
// of dW products and 129.0 of g-chain products, 412.8 GFLOP, 0.4174 ms at
// the H100 SXM's 989 TFLOP/s bf16 peak, against ~40 MB of inputs and
// outputs.
//
// Design. The TPU kernel's idea is to keep the dependent chain of products
// (forward, then the g-chain layer after layer) apart from the independent
// dW products: phase 0 runs the forward, the composite and the whole
// g-chain of a tile with no dW product competing for the matrix unit, and
// parks the activations and masked g in VMEM scratch; phase 1 runs only the
// dW products of that tile. Here a 2048-row tile's activations (4,352 B a
// row in bf16) do not fit on chip, so they go to a global workspace, and
// the phases are launches:
//  A. twopass_chain_kernel (phase 0): each block owns whole rays, as
//     train_level.cu's pass 1: the forward storing the features and every
//     layer's activations (forward_store), the composite and its backward
//     (composite_train), then, in the same launch, the g-chain of its own
//     rays (chain_rays, level_backward.cuh, shared with train_level.cu's
//     chain_kernel), which reads back the activations the block has just
//     written and stores the masked g in the compute type. The chain also
//     takes every layer's db where the TPU kernel takes it, in f32 from the
//     masked g (the heads' from the f32 cotangents), into one partial per
//     block. The per-ray f32 g_ray is stored in f32 and rounded to the
//     compute type where it is multiplied, which gives the values the TPU
//     kernel's compute-type scratch holds. This removes train_level's
//     separate chain launch, its reload of the head cotangents and one
//     grid-wide wait. One ray a block (RB = 1 at S >= 64): the ray's
//     activations (557 KB at the default config) are written and read back
//     within one block's life; with two blocks on each of the 132 SMs about
//     147 MB are in flight against the 50 MB L2, so most of the read-back
//     comes from HBM.
//  B. the dW products only (launch_products in level_backward.cuh): the dW
//     GEMM over the rows for every layer (act^T g, the skip layers' x rows,
//     the view layer's h rows) and the small products (both heads from the
//     f32 cotangents, the view layer's direction rows d^T g_ray), with no
//     db in the GEMM; the small-product launch also sums the per-block db
//     partials over the blocks, in order, split as the dW rows are.
//  C. the fixed-order reduction of the split partials (reduce_kernel).
// The TPU kernel adds dW across tiles in its resident outputs because its
// grid runs in order; blocks here run in no order, so the cross-block sums
// are passes B and C. No atomics: two launches on the same inputs give
// bit-equal dW/db. f32: the same launches with FMA loops (no TF32), for
// checking the algorithm only.
//
// Plain C interface (loaded with ctypes), the same as train_level.cu's:
// train_level_twopass_workspace gives the workspace size;
// train_level_twopass_launch returns the first failing cudaError_t; it
// launches on the given stream, allocates nothing and does not synchronise.

#include "level_backward.cuh"

namespace {

// Phase 0: forward, composite and its backward, the g-chain and db of the
// block's rays; dbpart [blocks, num_biases] gets the block's db.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
twopass_chain_kernel(Params p, Extra e, float* dbpart) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p);
  float* EX = reinterpret_cast<float*>(smem_raw +
                                       smem_bytes<T>(p.ldh, p.ldx, p.RB, p.Wc, p.S));
  const int ray0 = blockIdx.x * p.RB;
  const int nr = min(p.RB, p.R - ray0);
  forward_store<T>(p, e, sm, ray0, nr, true);
  composite_train<T>(p, e, sm, EX, ray0, nr);
  // The block's cotangents are in global memory and its shared memory is
  // the chain's from here on.
  __syncthreads();
  float* DB = reinterpret_cast<float*>(smem_raw + align16(chain_smem<T>(p, false)));
  chain_rays<T>(p, e, smem_raw, ray0, nr, DB);
  const int nb = num_biases(p);
  for (int idx = threadIdx.x; idx < nb; idx += kThreads)
    dbpart[(long long)blockIdx.x * nb + idx] = DB[idx];
}

inline int blocks_of(int R, int S) {
  const int RB = S >= kBM ? 1 : kBM / S;  // init_params' rays per block
  return (R + RB - 1) / RB;
}

template <class T>
cudaError_t launch_twopass(Params p, Extra e, const Layout& l, unsigned char* ws,
                           float* dbpart, float* out, long long n_out, int splits,
                           cudaStream_t st) {
  // A. forward, composite and its backward, g-chain, db partials
  const int blocks = blocks_of(p.R, p.S);
  const size_t smem_f = smem_bytes<T>(p.ldh, p.ldx, p.RB, p.Wc, p.S) +
                        sizeof(float) * p.RB * p.S * 4;
  const size_t smem_c = align16(chain_smem<T>(p, false)) + sizeof(float) * num_biases(p);
  const size_t smem = smem_f > smem_c ? smem_f : smem_c;
  cudaError_t err;
  if ((err = set_smem((const void*)twopass_chain_kernel<T>, smem)) != cudaSuccess) return err;
  twopass_chain_kernel<T><<<blocks, kThreads, smem, st>>>(p, e, dbpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // B-C. dW products, db partials summed, the fixed-order reduction
  return launch_products<T>(p, e, l, ws, out, n_out, splits, dbpart, blocks, st);
}

}  // namespace

extern "C" {

// Bytes of workspace train_level_twopass_launch needs for these shapes:
// train_level's, then the per-block db partials (3 rgb / 1 density head).
long long train_level_twopass_workspace(int dtype, int R, int S, int D, int W, int Wc, int Dc,
                                        int KX, int splits, long long n_out) {
  const long long nb = (long long)D * W + 1 + (long long)Dc * Wc + 3;
  return layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits, n_out, true).total +
         round256((long long)blocks_of(R, S) * nb * 4);
}

// The arguments of train_level_launch; mode must be 1 ("t"): the means and
// vars pointers are not read.
int train_level_twopass_launch(int dtype, int mode, const float* means, const float* vars,
                               const void* x, const void* d, const float* delta,
                               const float* pixels, const float* gsc, const void* w,
                               const void* wt, const float* b, float* comp, float* acc,
                               float* weights, float* grads, long long n_out, void* workspace,
                               int R, int S, int D, int W, int skip, int Wc, int Dc, int LX,
                               int KX, int Fd, int min_deg, int fast, float density_bias,
                               float rgb_padding, int white_bkgd, int splits, void* stream) {
  if (R <= 0) return cudaSuccess;
  Params p;
  if (mode != 1 ||
      !init_params(p, dtype, mode, means, vars, x, d, delta, w, b, R, S, D, W, skip, Wc, Dc,
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
  float* dbpart = reinterpret_cast<float*>(ws + l.total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? (int)launch_twopass<bf16>(p, e, l, ws, dbpart, grads, n_out, splits, st)
             : (int)launch_twopass<float>(p, e, l, ws, dbpart, grads, n_out, splits, st);
}

}  // extern "C"
