// The wide route's bf16 layer GEMM alone (wide_gemm.cuh: wide_gemm_kernel
// through launch_wide_gemm / launch_wide_gemm_mlp, which the five kernels'
// wide routes call for every layer product), behind a plain C entry for the
// card tests and for timing versions of the GEMM in turns
// (nerf_or_nothing_tpu_torch/kernels/wide_gemm.py). It replaces no TPU
// kernel of its own: it is a part of the wide routes of
// nerf_or_nothing_tpu/kernels/fused_level.py::_level_kernel,
// ::_level_kernel_twopass, ::_render_kernel and fused_mlp.py::_fwd_kernel,
// ::_bwd_kernel. It uses only what every version of the wide route's
// header has had (WideGemm, WideGemmMlp, launch_wide_gemm and
// launch_wide_gemm_mlp), so an earlier version builds from this file put
// beside that version's headers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwide_gemm.so wide_gemm.cu

#include "wide_forward.cuh"

extern "C" {

// out = epilogue(a0 @ B0 + a1 @ B1) as the wide route launches it; kind:
// 0 the forward (bias, dc, S), 1 the g-chain (act; gden / wden with one
// density channel or null), 2 the g-chain with cd density channels, 3 dX
// (out [M, ldo], accum). Returns the CUDA error code.
int wide_gemm_launch(int kind, const void* a0, int lda0, int ka0, int ns0, const void* a1,
                     int lda1, int ka1, int ns1, const void* b, int N, long long M,
                     const float* bias, const float* dc, int S, const void* act,
                     const float* gden, const void* wden, int cd, void* out, int ldo,
                     int accum, void* stream) {
  WideGemmMlp m{};
  WideGemm& g = m.g;
  g.a0 = static_cast<const bf16*>(a0); g.lda0 = lda0; g.ka0 = ka0; g.ns0 = ns0;
  g.a1 = static_cast<const bf16*>(a1); g.lda1 = lda1; g.ka1 = ka1; g.ns1 = ns1;
  g.b = static_cast<const bf16*>(b); g.N = N; g.M = M; g.kind = kind;
  g.bias = bias; g.dc = dc; g.S = S; g.act = static_cast<const bf16*>(act);
  g.gden = gden; g.wden = static_cast<const bf16*>(wden); g.out = static_cast<bf16*>(out);
  m.cd = cd; m.ldo = ldo; m.accum = accum;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kWideFwd:
    case kWideChain: return (int)launch_wide_gemm(g, st);
    case kWideChainHeads: return (int)launch_wide_gemm_mlp<kWideChainHeads>(m, st);
    case kWideDx: return (int)launch_wide_gemm_mlp<kWideDx>(m, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
