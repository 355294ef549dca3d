// One render level of mip-NeRF in one launch: in-kernel IPE, the whole MLP
// forward, the colour/density activations and alpha compositing.
//
// Replaces: nerf_or_nothing_tpu/kernels/fused_level.py::_render_kernel
// (launched by _fused_render_impl through fused_level_render).
//
// Bound: operations. At the default config one sample row costs
// 2 * (sum(fan_in * fan_out) - 27 * 128) = 1,082,624 FLOP of bf16 matrix
// products (the view layer's 27 direction rows, 6,912 FLOP, are multiplied
// once per ray), while it moves about 32 bytes (mean/var and delta in, its
// weight out); at 16384 rays x 128 samples that is 2.27 TFLOP against
// ~69 MB, far above the card's ~295 FLOP/byte ridge. Everything between
// the inputs and the three outputs stays on chip.
//
// bf16 (the render path): forward_wg.cuh, one persistent block per SM of
// two consumer warpgroups, a producer thread and three helper warps; the
// layer products are wgmma with both operands in shared memory, the packed
// weights (pack_params_wg) streamed into a ring of slabs by cp.async.bulk;
// each slab feeds both consumers of 64 rows, so L2 is read once per 128
// rows (the earlier mma.sync design read every weight fragment from L2 per
// 64 rows, ~63 FLOP a byte, and ran the IPE, epilogues, heads and
// composite while its tensor cores idled). A unit of work is whole rays
// (128 rows, or one ray over several rounds when S > 128). The helpers
// write the next round's features (the IPE with the explicitly rounded
// polynomials of ops/fastmath.py, bit-equal to the plain version) while
// the consumers multiply, and composite each round's raw heads by one warp
// per ray (the transmittance scan carried across rounds), writing comp,
// acc and weights.
//
// At net_width 288 and above (render_level_wide_launch): one GEMM launch per
// layer, over chunks of whole rays whose activations go through a
// workspace the wrapper allocates (render_level_wide_workspace), then the
// composite; bf16 (wide_forward.cuh) on wgmma in column blocks of at most
// 256, f32 (wide_f32.cuh) as 3xTF32 wgmma in column blocks of 128.
//
// f32: forward_tile<float> of level_common.cuh on pack_params' row-major
// layout, each layer product as three TF32 tensor-core passes (3xTF32
// mma.sync, the weights staged in shared memory by cp.async; 3 x 2.27
// TFLOP of TF32 work at R=16384 x S=128, bound 13.76 ms at 495 / 3 TFLOP/s).
// One block of 256 threads owns RB = max(1, 64 / S) whole rays and walks
// their rows in 64-row sub-tiles, then composites them; two blocks an SM.
// (wgmma in TF32, K-major operands only, would be another function.)
//
// Plain C interface (loaded with ctypes): render_level_launch returns the
// cudaError_t of the launch; it launches on the given stream, allocates
// nothing and does not synchronise.

#include "forward_wg.cuh"
#include "wide_f32.cuh"
#include "wide_forward.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, kF32Blocks)
render_level_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<float> sm = carve<float>(smem_raw, p, p.S);
  const int ray0 = blockIdx.x * p.RB;
  const int nr = min(p.RB, p.R - ray0);
  const int rows = nr * p.S;

  // Direction term of the first view layer, once per ray: d @ W_bot.
  direction_term<float>(p, sm, ray0, nr);
  for (int sub0 = 0; sub0 < rows; sub0 += kBM) {
    float* out = sm.OUT + sub0 * 4;  // raw r, g, b, density per row
    forward_tile<float, false>(p, sm, sub0, min(kBM, rows - sub0),
                               (long long)ray0 * p.S + sub0, out + 3, 4, out, 4, nullptr,
                               nullptr, 0);
  }
  composite<float>(p, sm, ray0, nr);
}

__global__ void __launch_bounds__(kWgThreads, 1) render_level_wg_kernel(WgParams q) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  forward_wg<true>(q, smem_wg);
}

cudaError_t launch_f32(Params p, cudaStream_t stream) {
  const size_t smem = smem_bytes<float>(p, p.S);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      render_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.R + p.RB - 1) / p.RB;
  render_level_kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (w: pack_params_wg's slabs for bf16,
// pack_params' row-major layout for f32). mode: 0 = "mv" (IPE in the kernel),
// 1 = "t" (encoded features). Widths must satisfy the wrapper's checks
// (W, Wc multiples of 32 up to 256; KX a multiple of 16 >= LX).
int render_level_launch(int dtype, int mode, const float* means, const float* vars,
                        const void* x, const void* d, const float* delta,
                        const void* w, const float* b, float* comp, float* acc,
                        float* weights, int R, int S, int D, int W, int skip, int Wc,
                        int Dc, int LX, int KX, int Fd, int min_deg, int fast,
                        float density_bias, float rgb_padding, int white_bkgd,
                        void* stream) {
  if (R <= 0) return cudaSuccess;
  Params p;
  if (!init_params(p, dtype, mode, means, vars, x, d, delta, w, b, R, S, D, W, skip, Wc,
                   Dc, LX, KX, Fd, min_deg, fast, density_bias, rgb_padding, white_bkgd))
    return cudaErrorInvalidValue;
  p.comp = comp; p.acc = acc; p.weights = weights;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return (int)launch_f32(p, st);
  WgParams q{};
  q.p = p;
  if (!init_wg(q, true)) return cudaErrorInvalidValue;
  return (int)launch_wg(render_level_wg_kernel, q, st);
}

// The weight layout it reads: in bf16 pack_params_wg's slab stream, in f32
// on the wide route pack_params_wf's (fused_level.pack_forward).
const char* render_level_weight_layout() { return "wf"; }

// Bytes of workspace render_level_wide_launch needs for these shapes.
long long render_level_wide_workspace(int dtype, int R, int S, int W, int Wc, int KX) {
  return wide_render_layout(R, S, W, Wc, KX, dtype == 1 ? 2 : 4).total;
}

// The wide route: net_width 288 and above (a multiple of 32, Wc <= W),
// and any narrower width whose config the narrow kernel's shared memory
// does not hold (fused_level.takes_wide):
// render_level_launch's arguments (bf16: wide_forward.cuh on the "wg"
// stream; f32: wide_f32.cuh on pack_params_wf), and a workspace of
// render_level_wide_workspace bytes, 256-byte aligned.
int render_level_wide_launch(int dtype, int mode, const float* means, const float* vars,
                             const void* x, const void* d, const float* delta, const void* w,
                             const float* b, float* comp, float* acc, float* weights, int R,
                             int S, int D, int W, int skip, int Wc, int Dc, int LX, int KX,
                             int Fd, int min_deg, int fast, float density_bias,
                             float rgb_padding, int white_bkgd, void* workspace, void* stream) {
  if (R <= 0) return cudaSuccess;
  Params p;
  if (!init_params(p, dtype, mode, means, vars, x, d, delta, w, b, R, S, D, W, skip, Wc, Dc, LX,
                   KX, Fd, min_deg, fast, density_bias, rgb_padding, white_bkgd, 3, 1, true))
    return cudaErrorInvalidValue;
  p.comp = comp; p.acc = acc; p.weights = weights;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_forward_wide<WideBf16Route, kWideLevelHeads>(p, ws, nullptr, nullptr, st);
  return (int)launch_forward_wide<WideF32Route, kWideLevelHeads>(p, ws, nullptr, nullptr, st);
}

}  // extern "C"
