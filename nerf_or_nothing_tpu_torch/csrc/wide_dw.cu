// The wide routes' dW GEMMs alone (wide_dw.cuh: wide_dw_kernel<BN> in
// bf16, wide_dw_f32_kernel in f32, both with db and the splits added into
// the output in order, which wide_train.cuh's launch_wide_backward and
// launch_wide_backward_f32 run for every dW product of a level), one
// product behind a plain C entry for the card tests and for timing
// versions in turns (nerf_or_nothing_tpu_torch/kernels/wide_gemm.py). It
// replaces no TPU kernel of its own: it is a part of the wide routes of
// nerf_or_nothing_tpu/kernels/fused_level.py::_level_kernel,
// ::_level_kernel_twopass and fused_mlp.py::_bwd_kernel.
// Put beside the headers of a version whose dW GEMMs write each split's
// partial (without WIDE_DW_REDUCED), it launches that version's kernels
// on the same product through wide_dw_launch instead.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwide_dw.so wide_dw.cu

#include "wide_train.cuh"

extern "C" {

#ifdef WIDE_DW_REDUCED
// Split counters (ints) wide_dw_reduced_launch needs for a product of M
// output rows and Nn columns.
long long wide_dw_flag_count(int M, int Nn) { return kDwParts * dw_tiles(M, Nn); }

// dW = A^T B summed over the train level's splits of the K rows
// (split_rows) in split order into out (the [M, Nn] block at 0, row
// stride Nn) for A [K, lda] (columns [0, M)) and B [K, ldb] (columns [0,
// Nn)), and B's column sums db at db_off of out (or none: -1), in bf16
// (f32 = 0) or f32; flags: n_flags ints of workspace (wide_dw_flag_count).
// Returns the CUDA error code.
int wide_dw_reduced_launch(int f32, const void* A, int lda, int M, const void* B, int ldb,
                           int Nn, int K, int splits, float* out, long long db_off, int* flags,
                           long long n_flags, void* stream) {
  return (int)launch_wide_dw_one(f32 != 0, A, lda, M, B, ldb, Nn, K, splits, out, db_off, flags,
                                 n_flags, static_cast<cudaStream_t>(stream));
}
#else
// Each split's partial of dW = A^T B into its row of part [splits, n_out]
// (the [M, Nn] block at 0, row stride Nn), f32 B's column sums at db_off
// of each row (or none: -1).
int wide_dw_launch(int f32, const void* A, int lda, int M, const void* B, int ldb, int Nn, int K,
                   int splits, float* part, long long n_out, long long db_off, void* stream) {
  return (int)launch_wide_dw_one(f32 != 0, A, lda, M, B, ldb, Nn, K, splits, part, n_out, db_off,
                                 static_cast<cudaStream_t>(stream));
}
#endif

}  // extern "C"
