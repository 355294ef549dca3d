// The wide route's f32 layer GEMM alone (wide_f32.cuh: wide_gemm_f32_kernel
// through launch_wide_gemm_f32, which the five kernels' wide f32 routes
// call for every layer product), behind a plain C entry for the card tests
// and for timing versions of the GEMM in turns
// (nerf_or_nothing_tpu_torch/kernels/wide_gemm.py). It replaces no TPU
// kernel of its own: it is a part of the wide f32 routes of
// nerf_or_nothing_tpu/kernels/fused_level.py::_level_kernel,
// ::_level_kernel_twopass, ::_render_kernel and fused_mlp.py::_fwd_kernel,
// ::_bwd_kernel. It uses only what every version of that header has had
// (WideGemmF32 and launch_wide_gemm_f32), so an earlier version builds from
// this file put beside that version's headers: the caller passes B both as
// the hi / lo slab streams (read where the header defines WIDE_F32_SLABS)
// and row-major [ka0 + ka1, N] (read by the earlier mma.sync version).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwide_gemm_f32.so wide_gemm_f32.cu

#include "wide_f32.cuh"

extern "C" {

// out = epilogue(a0 @ B0 + a1 @ B1) as the wide f32 route launches it;
// kind: 0 the forward (bias, dc, S), 1 the g-chain (act; gden / wden with
// cd density channels, or null), 2 dX (out [M, ldo], accum). B: b_rows
// row-major, b_hi / b_lo the slab streams. Returns the CUDA error code.
int wide_gemm_f32_launch(int kind, const float* a0, int lda0, int ka0, const float* a1, int lda1,
                         int ka1, const float* b_rows, const float* b_hi, const float* b_lo,
                         int N, long long M, const float* bias, const float* dc, int S,
                         const float* act, const float* gden, const float* wden, int cd,
                         float* out, int ldo, int accum, void* stream) {
  WideGemmF32 g{};
  g.a0 = a0; g.lda0 = lda0; g.ka0 = ka0;
  g.a1 = a1; g.lda1 = lda1; g.ka1 = ka1;
#ifdef WIDE_F32_SLABS
  g.b = b_hi; g.blo = b_lo;
  (void)b_rows;
#else
  g.b = b_rows;
  (void)b_hi; (void)b_lo;
#endif
  g.N = N; g.M = M; g.bias = bias; g.dc = dc; g.S = S;
  g.act = act; g.gden = gden; g.wden = wden; g.cd = cd;
  g.out = out; g.ldo = ldo; g.accum = accum;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32Fwd: return (int)launch_wide_gemm_f32<kF32Fwd>(g, st);
    case kF32Chain: return (int)launch_wide_gemm_f32<kF32Chain>(g, st);
    case kF32Dx: return (int)launch_wide_gemm_f32<kF32Dx>(g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
