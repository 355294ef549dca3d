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
// the phases are launches.
// bf16: train_wg.cuh's passes (launch_train_wg), which already run in that
// order: phase 0 is the wgmma forward keeping its activations and ReLU
// masks, the composite and its backward, the warp-specialised wgmma
// g-chain with per-block db partials and the per-ray sums; phase 1 is the
// wgmma dW GEMM over the rows, the small head and direction-row products
// (db summed from the chain's partials) and the fixed-order reduction.
// The chain reads only the forward's mask bits, not its activations, and
// no dW product shares an SM with it. The function and the launches are
// train_level.cu's bf16 ones, so both give the same bits.
// bf16 at net_width 288 and above: train_level.cu's wide route
// (wide_train.cuh's launch_train_wide), whose launches also run in the
// two phases' order: phase 0 the forward GEMMs, the composite, the g-chain
// GEMMs, the per-ray sums and db partials; phase 1 the dW GEMMs, the small
// products and the reduction. The same launches as train_level's wide
// route, so the same bits. f32 at net_width 288 and above: train_level.cu's f32
// wide route (launch_train_wide<WideF32Route>), whose phase 1 is the dW
// GEMM with db as its column sums, the small products and the reduction;
// the same launches as train_level's, so the same bits.
// f32, every layer product as 3xTF32 mma.sync (level_common.cuh's gemm,
// level_backward.cuh's dW GEMM):
//  A. twopass_chain_kernel (phase 0): each block owns whole rays: the
//     forward storing the features and every layer's activations
//     (forward_store), the composite and its backward (composite_train),
//     then, in the same launch, the g-chain of its own rays (chain_rays,
//     level_backward.cuh), which reads back the activations the block has
//     just written, stores the masked g and takes every layer's db into
//     one partial per block (the heads' from the f32 cotangents);
//  B. the dW products only (launch_products in level_backward.cuh): the dW
//     GEMM over the rows for every layer, the small products, and the sum
//     of the per-block db partials over the blocks, in order;
//  C. the fixed-order reduction of the split partials (reduce_kernel).
// The TPU kernel adds dW across tiles in its resident outputs because its
// grid runs in order; blocks here run in no order, so the cross-block sums
// are separate passes. No atomics: two launches on the same inputs give
// bit-equal dW/db.
//
// Plain C interface (loaded with ctypes), the same as train_level.cu's:
// train_level_twopass_workspace gives the workspace size;
// train_level_twopass_launch returns the first failing cudaError_t; it
// launches on the given stream, allocates nothing and does not synchronise.

#include "train_wg.cuh"
#include "wide_train.cuh"

namespace {

// f32 phase 0: forward, composite and its backward, the g-chain and db of
// the block's rays; dbpart [blocks, num_biases] gets the block's db.
template <class T>
__global__ void __launch_bounds__(kThreads, kF32Blocks)
twopass_chain_kernel(Params p, Extra e, float* dbpart) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p, p.S);
  float* EX = reinterpret_cast<float*>(smem_raw +
                                       smem_bytes<T>(p, p.S));
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
  const size_t smem_f = smem_bytes<T>(p, p.S) +
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
// train_level's on the wide route (W >= 288 or kWideRoute: the backward's
// layout, then the wide route's areas) and in bf16 (then the bf16 passes' areas); f32 below 288, the
// backward's layout, then the per-block db partials (3 rgb / 1 density
// head). Fd: the direction features (the wide route's small products).
long long train_level_twopass_workspace(int dtype, int R, int S, int D, int W, int Wc, int Dc,
                                        int KX, int splits, long long n_out, int Fd) {
  const bool wide = wide_route(dtype, W);
  const Layout l = layout(dtype == 1 ? 2 : 4, R, S, D, W, Wc, Dc, KX, splits,
                          wide ? small_outputs(W, Wc, Fd, 3, 1) : n_out, true);
  if (wide) return wide_train_layout(l.total, R, S, D, W, Wc, Dc, KX).total;
  if (dtype == 1) return wg_layout(l.total, R, S, D, W, Wc, Dc).total;
  const long long nb = (long long)D * W + 1 + (long long)Dc * Wc + 3;
  return l.total + round256((long long)blocks_of(R, S) * nb * 4);
}

// The arguments of train_level_launch; mode must be 1 ("t"): the means and
// vars pointers are not read. w, wt: bf16 pack_params_wg's forward slab
// stream and pack_params_wgt's chain stream (fused_level.
// pack_train_level); f32 pack_params' layout and pack_params_t, on the
// wide route pack_params_wf and pack_params_wft.
int train_level_twopass_launch(int dtype, int mode, const float* means, const float* vars,
                               const void* x, const void* d, const float* delta,
                               const float* pixels, const float* gsc, const void* w,
                               const void* wt, const float* b, float* comp, float* acc,
                               float* weights, float* grads, long long n_out, void* workspace,
                               int R, int S, int D, int W, int skip, int Wc, int Dc, int LX,
                               int KX, int Fd, int min_deg, int fast, float density_bias,
                               float rgb_padding, int white_bkgd, int splits, void* stream) {
  if (R <= 0) return cudaSuccess;
  const bool wide = wide_route(dtype, W);
  Params p;
  if (mode != 1 ||
      !init_params(p, dtype, mode, means, vars, x, d, delta, w, b, R, S, D, W, skip, Wc, Dc,
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
  float* dbpart = reinterpret_cast<float*>(ws + l.total);
  return (int)launch_twopass<float>(p, e, l, ws, dbpart, grads, n_out, splits, st);
}

// The weights it reads, as train_level's: bf16 "wg" / "wgt", f32 on the
// wide route "wf" (fused_level.pack_train_level).
const char* train_level_twopass_weight_layout() { return "wf"; }

}  // extern "C"
