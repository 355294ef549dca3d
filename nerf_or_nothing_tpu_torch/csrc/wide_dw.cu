// The wide routes' dW GEMMs alone (wide_dw.cuh: wide_dw_kernel<BN> in
// bf16, wide_dw_f32_kernel in f32 with db, which wide_train.cuh's
// launch_wide_backward and launch_wide_backward_f32 run for every dW
// product of a level), one product behind a plain C entry for the card
// tests and for timing versions in turns (nerf_or_nothing_tpu_torch/
// kernels/wide_gemm.py). It replaces no TPU kernel of its own: it is a
// part of the wide routes of nerf_or_nothing_tpu/kernels/fused_level.py::
// _level_kernel, ::_level_kernel_twopass and fused_mlp.py::_bwd_kernel.
// Put beside the headers of a version without wide_dw.cuh (no
// WIDE_DW_TABLE), it launches that version's dW GEMMs on the same product:
// wide_train.cuh's wide_dw_kernel<BN> through launch_wide_dw(WideDw) in
// bf16, level_backward.cuh's dw_gemm_f32_kernel in f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwide_dw.so wide_dw.cu

#include "wide_train.cuh"

extern "C" {

// Each split's partial of dW = A^T B into its row of part [splits, n_out]
// (the [M, Nn] block at 0, row stride Nn) for A [K, lda] (columns [0, M))
// and B [K, ldb] (columns [0, Nn)), in bf16 (f32 = 0) or f32 (with B's
// column sums at db_off of each row, or none: -1), over the train level's
// splits of the K rows (split_rows). Returns the CUDA error code.
int wide_dw_launch(int f32, const void* A, int lda, int M, const void* B, int ldb, int Nn, int K,
                   int splits, float* part, long long n_out, long long db_off, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef WIDE_DW_TABLE
  return (int)launch_wide_dw_one(f32 != 0, A, lda, M, B, ldb, Nn, K, splits, part, n_out, db_off,
                                 st);
#else
  if (f32) {
    GemmJobs gj;
    GemmJob& j = gj.job[0];
    j.A = A; j.B = B; j.lda = lda; j.ldb = ldb; j.M = M; j.Nn = Nn; j.K = K;
    j.out_off = 0; j.out_ld = Nn; j.db_off = db_off;
    j.tiles_m = (M + kTM - 1) / kTM; j.block0 = 0;
    gj.part = part; gj.n_out = n_out; gj.n = 1; gj.splits = splits;
    const int blocks = j.tiles_m * ((Nn + kTN - 1) / kTN) * splits;
    dw_gemm_f32_kernel<<<blocks, kGemmThreads, 0, st>>>(gj);
    return (int)cudaGetLastError();
  }
  WideDw js;
  js.A = static_cast<const bf16*>(A); js.B = static_cast<const bf16*>(B);
  js.lda = lda; js.M = M; js.ldb = ldb; js.Nn = Nn; js.out_ld = Nn; js.out_off = 0;
  js.part = part; js.n_out = n_out; js.splits = splits; js.K = K;
  return (int)launch_wide_dw(js, st);
#endif
}

}  // extern "C"
