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
// Design (simple first version):
//  - one block of 256 threads owns whole rays (RB = max(1, 64 / S) rays)
//    and walks their rows in sub-tiles of 64 rows; any S and any ray count
//    (the last block is ragged and masked);
//  - per sub-tile, the IPE features [64, KX] and one activation buffer
//    [64, W] live in shared memory; each layer accumulates the whole K in
//    registers, then the block synchronises and writes the epilogue
//    (bias, ReLU in f32, rounding to the compute type) back in place;
//  - bf16: tensor-core mma.sync.m16n8k16 with f32 accumulators, A
//    fragments by ldmatrix from shared memory; weights are pre-packed by
//    the wrapper in fragment order, so each lane loads one 8-byte word per
//    8x16 weight fragment, straight from L2 (the ~1.1 MB of weights stay
//    resident there). Weight reads are what limits this design, so each
//    warp owns all 64 rows of the sub-tile and a disjoint set of n8
//    column tiles: every weight fragment is read once per 64 rows (a
//    2 x 4 warp grid that read it twice was 1.43x slower), and the next
//    k-step's fragments load while the current one multiplies;
//  - f32: plain FMA loops (no TF32), for checking the algorithm in f32;
//  - the skip layer is one accumulation over [h | x]; the view layer's
//    direction term d @ W_bot is computed once per ray and added in the
//    epilogue; the two heads are f32 dot products of compute-type values;
//  - raw head outputs of the block's rays stay in shared memory, then one
//    warp per ray runs the transmittance scan (warp shuffle scan with a
//    carry) and writes comp, acc and weights.
//  - the IPE transcendentals use the polynomials of ops/fastmath.py with
//    explicitly rounded operations (no FMA contraction), so they are
//    bit-equal to the plain PyTorch version.
//
// The device functions (IPE, layers, heads, the sub-tile forward,
// composite) live in level_common.cuh, shared with the other kernels.
//
// Plain C interface (loaded with ctypes): render_level_launch returns the
// cudaError_t of the launch; it launches on the given stream, allocates
// nothing and does not synchronise.

#include "level_common.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(kThreads, 2)
render_level_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, p);
  const int ray0 = blockIdx.x * p.RB;
  const int nr = min(p.RB, p.R - ray0);
  const int rows = nr * p.S;

  // Direction term of the first view layer, once per ray: d @ W_bot.
  direction_term<T>(p, sm, ray0, nr);
  for (int sub0 = 0; sub0 < rows; sub0 += kBM) {
    float* out = sm.OUT + sub0 * 4;  // raw r, g, b, density per row
    forward_tile<T, false>(p, sm, sub0, min(kBM, rows - sub0), (long long)ray0 * p.S + sub0,
                           out + 3, 4, out, 4, nullptr, nullptr, 0);
  }
  composite<T>(p, sm, ray0, nr);
}

template <class T>
cudaError_t launch(Params p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.ldh, p.ldx, p.RB, p.Wc, p.S);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      render_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.R + p.RB - 1) / p.RB;
  render_level_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = "mv" (IPE in the kernel),
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
  return dtype == 1 ? (int)launch<bf16>(p, st) : (int)launch<float>(p, st);
}

}  // extern "C"
