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
// Design (simple first version): the render kernel (render_level.cu)
// without its composite. One block of 256 threads owns whole rays
// (RB = max(1, 64 / S) rays) and walks their rows in 64-row sub-tiles;
// features [64, KX] and one activation buffer [64, W] live in shared
// memory; every layer is bf16 mma.sync with f32 accumulators (weights in
// fragment order, straight from L2) and a ReLU epilogue rounded to bf16;
// the skip layer is one accumulation over [h | x]; the view layer's
// d @ W_bot is computed once per ray and added in the epilogue; the heads
// (1-8 channels each) are f32 dot products of bf16 values, one warp per
// row, written straight to the outputs. f32: FMA loops (no TF32), for
// checking the algorithm in f32. Shared device code: level_common.cuh.
//
// Plain C interface (loaded with ctypes): mlp_fwd_launch returns the
// cudaError_t of the launch; it launches on the given stream, allocates
// nothing and does not synchronise.

#include "level_common.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(kThreads, 2)
mlp_fwd_kernel(Params p, float* raw_rgb, float* raw_den) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p);
  const int ray0 = blockIdx.x * p.RB;
  const int nr = min(p.RB, p.R - ray0);
  const int rows = nr * p.S;
  direction_term<T>(p, sm, ray0, nr);
  for (int sub0 = 0; sub0 < rows; sub0 += kBM) {
    const long long grow0 = (long long)ray0 * p.S + sub0;
    forward_tile<T, false>(p, sm, sub0, min(kBM, rows - sub0), grow0, raw_den + grow0 * p.Cd,
                           p.Cd, raw_rgb + grow0 * p.Cr, p.Cr, nullptr, nullptr, 0);
  }
}

template <class T>
cudaError_t launch(Params p, float* raw_rgb, float* raw_den, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.ldh, p.ldx, p.RB, p.Wc, 0);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.R + p.RB - 1) / p.RB;
  mlp_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(p, raw_rgb, raw_den);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x: [R * S, LX] and d: [R, Fd] in the
// compute type; w, b: pack_params' layout; raw_rgb [R * S, Cr] and
// raw_den [R * S, Cd] f32. Widths must satisfy the wrapper's checks (W, Wc
// multiples of 32 up to 256; KX a multiple of 16 >= LX; heads of 1-8).
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
  return dtype == 1 ? (int)launch<bf16>(p, raw_rgb, raw_den, st)
                    : (int)launch<float>(p, raw_rgb, raw_den, st);
}

}  // extern "C"
