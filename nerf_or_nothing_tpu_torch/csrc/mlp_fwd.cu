// The whole mip-NeRF MLP forward in one launch: encoded positions and
// per-ray direction features in, the raw rgb and density heads out (f32).
//
// Replaces: nerf_or_nothing_tpu/kernels/fused_mlp.py::_fwd_kernel
// (launched by _fused_mlp_fwd_impl through fused_mlp_apply).
//
// Bound: operations. At the default config one sample row costs
// 2 * (sum(fan_in * fan_out) - 27 * 128) = 1,082,624 FLOP of bf16 matrix
// products (the view layer's 27 direction rows are multiplied once per
// ray), while it moves 192 bytes of features in and 16 bytes of heads
// out: 1024 rays x 128 samples are 141.9 GFLOP against ~27 MB, far above
// the card's ~295 FLOP/byte ridge.
//
// bf16: forward_wg.cuh, the render kernel's forward (render_level.cu)
// without its composite: one persistent block per SM, a producer thread
// streaming the packed weights (pack_params_wg) slab by slab into a ring
// with cp.async.bulk, two consumer warpgroups of 64 rows multiplying each
// slab with wgmma from shared memory (weights read from L2 once per 128
// rows; the earlier mma.sync version read them per 64 rows), sums started
// from the bias, one-instruction epilogues in place behind a warpgroup
// barrier, the heads (any width) as N=8 wgmma products, one a group of 8
// channels, written
// straight to raw_rgb / raw_den. Helper warps load the next round's
// features and each unit's direction term d @ W_dir while the consumers
// multiply.
// bf16 at net_width 288 and above (wide_forward.cuh, mlp_fwd_wide_launch): one
// wgmma GEMM launch per layer, in column blocks of at most 256, over
// chunks of whole rays of at most 2^18 rows whose activations go through
// a workspace the wrapper allocates (mlp_fwd_wide_workspace: ~1.1 GB at
// W=1024 for any R; eval at fuse_level=False calls this on 16,384 rays x
// 128 samples, whose one activation buffer would be 4.3 GB), then the
// heads (8 channels a launch) straight to raw_rgb / raw_den. f32 at
// net_width 288 and above: the same launches through mlp_fwd_wide_launch with
// wide_f32.cuh's 3xTF32 wgmma GEMM and f32 activations (~2.2 GB of
// workspace at W=1024).
// f32: level_common.cuh's forward_tile<float> on pack_params' row-major
// layout, every layer product as 3xTF32 mma.sync (render_level.cu's f32
// forward without the composite), one block of 256 threads per RB =
// max(1, 64 / S) rays.
//
// Plain C interface (loaded with ctypes): mlp_fwd_launch and
// mlp_fwd_wide_launch return the first failing cudaError_t; they launch on
// the given stream, allocate nothing and do not synchronise.

#include "forward_wg.cuh"
#include "wide_f32.cuh"
#include "wide_forward.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, kF32Blocks)
mlp_fwd_kernel(Params p, float* raw_rgb, float* raw_den) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<float> sm = carve<float>(smem_raw, p, 0);
  const int ray0 = blockIdx.x * p.RB;
  const int nr = min(p.RB, p.R - ray0);
  const int rows = nr * p.S;
  direction_term<float>(p, sm, ray0, nr);
  for (int sub0 = 0; sub0 < rows; sub0 += kBM) {
    const long long grow0 = (long long)ray0 * p.S + sub0;
    forward_tile<float, false>(p, sm, sub0, min(kBM, rows - sub0), grow0,
                               raw_den + grow0 * p.Cd, p.Cd, raw_rgb + grow0 * p.Cr, p.Cr,
                               nullptr, nullptr, 0);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1) mlp_fwd_wg_kernel(WgParams q) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  forward_wg<false>(q, smem_wg);
}

cudaError_t launch_f32(Params p, float* raw_rgb, float* raw_den, cudaStream_t stream) {
  const size_t smem = smem_bytes<float>(p, 0);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.R + p.RB - 1) / p.RB;
  mlp_fwd_kernel<<<blocks, kThreads, smem, stream>>>(p, raw_rgb, raw_den);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x: [R * S, LX] and d: [R, Fd] in the
// compute type; w: pack_params_wg's slabs (bf16) or pack_params' layout
// (f32), b: the biases in layer order; raw_rgb [R * S, Cr] and
// raw_den [R * S, Cd] f32. Widths must satisfy the wrapper's checks (W, Wc
// multiples of 32 up to 256, wider bf16 through mlp_fwd_wide_launch; KX a
// multiple of 16 >= LX; heads of at least 1 channel).
int mlp_fwd_launch(int dtype, const void* x, const void* d, const void* w, const float* b,
                   float* raw_rgb, float* raw_den, int R, int S, int D, int W, int skip,
                   int Wc, int Dc, int LX, int KX, int Fd, int Cr, int Cd, void* stream) {
  if (R <= 0) return cudaSuccess;
  Params p;
  if (!init_params(p, dtype, 1, nullptr, nullptr, x, d, nullptr, w, b, R, S, D, W, skip, Wc,
                   Dc, LX, KX, Fd, 0, 0, 0.0f, 0.0f, 0, Cr, Cd) ||
      (long long)R * S > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return (int)launch_f32(p, raw_rgb, raw_den, st);
  WgParams q{};
  q.p = p;
  q.raw_rgb = raw_rgb;
  q.raw_den = raw_den;
  if (!init_wg(q, false)) return cudaErrorInvalidValue;
  return (int)launch_wg(mlp_fwd_wg_kernel, q, st);
}

// The weight layout it reads: in bf16 pack_params_wg's slab stream, in f32
// on the wide route pack_params_wf's (fused_level.pack_forward).
const char* mlp_fwd_weight_layout() { return "wf"; }

// Bytes of workspace mlp_fwd_wide_launch needs for these shapes.
long long mlp_fwd_wide_workspace(int dtype, int R, int S, int W, int Wc, int KX) {
  return wide_render_layout(R, S, W, Wc, KX, dtype == 1 ? 2 : 4).total;
}

// The wide route: net_width 288 and above (a multiple of 32, Wc <= W),
// and any narrower width whose config the narrow kernel's shared memory
// does not hold (fused_level.takes_wide):
// mlp_fwd_launch's arguments (bf16: w pack_params_wg's stream; f32:
// pack_params_wf, wide_f32.cuh), and a workspace of
// mlp_fwd_wide_workspace bytes, 256-byte aligned.
int mlp_fwd_wide_launch(int dtype, const void* x, const void* d, const void* w, const float* b,
                        float* raw_rgb, float* raw_den, int R, int S, int D, int W, int skip,
                        int Wc, int Dc, int LX, int KX, int Fd, int Cr, int Cd, void* workspace,
                        void* stream) {
  if (R <= 0) return cudaSuccess;
  Params p;
  if (!init_params(p, dtype, 1, nullptr, nullptr, x, d, nullptr, w, b, R, S, D, W, skip, Wc, Dc,
                   LX, KX, Fd, 0, 0, 0.0f, 0.0f, 0, Cr, Cd, true) ||
      (long long)R * S > 2147483647LL)
    return cudaErrorInvalidValue;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_forward_wide<WideBf16Route, kWideAnyHeads>(p, ws, raw_rgb, raw_den, st);
  return (int)launch_forward_wide<WideF32Route, kWideAnyHeads>(p, ws, raw_rgb, raw_den, st);
}

}  // extern "C"
