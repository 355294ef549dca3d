// The wide f32 route of every kernel (render_level.cu, mlp_fwd.cu, and the
// forwards of train_level.cu, train_level_twopass.cu and mlp_bwd.cu; the
// backward is wide_train.cuh's launch_wide_backward_f32): net_width a
// multiple of 32 from 288 up, with no ceiling but the card's memory
// (net_width_condition a multiple of 32 up to net_width), where the narrow
// f32 kernels' [64, W] activation tile no longer fits a block (256 KB at
// W=1024 of the 227 KB).
//
// Replaces, at these widths in f32, the same TPU kernels as its callers:
// nerf_or_nothing_tpu/kernels/fused_level.py::_render_kernel (render),
// ::_level_kernel and ::_level_kernel_twopass (train), fused_mlp.py::
// _fwd_kernel (mlp_fwd) and ::_bwd_kernel (mlp_bwd).
//
// Bound: the products, at the 3xTF32 rate (495 / 3 = 165 TFLOP/s of f32
// work on an H100 SXM): one row of a W=1024 layer is 2 x 1024^2 FLOP
// against 8 KB of f32 activations in and out, 256 FLOP a byte, above the
// ~49 FLOP/B ridge of that rate.
//
// The launch sequence is the bf16 wide route's (wide_forward.cuh): every
// activation and masked g in global memory, in f32, one GEMM launch a
// layer product, here wide_gemm_f32_kernel<kKind>: out = epilogue(A @ B)
// over blocks of 128 rows x 128 columns (a layer of N columns takes
// ceil(N / 128) column blocks). A is one or two row-major f32 activations
// (the skip layers' [h | x]), B the layer's row-major f32 weights as the
// narrow route packs them (fused_level.pack_params: trunk layers [K, W],
// the view layers' h rows [W, Wc] and [Wc, Wc]; pack_params_t: W^T of the
// chained layers; pack_params_tx: W^T of the x rows), so no packer is
// added. 8 warps of 32 x 64 outputs each (two m16 by eight n8 fragments,
// the narrow route's 64 accumulators a thread), stages of 32 k-values of
// A and B copied by cp.async into padded tiles (three stages, two in
// flight), every product as level_common.cuh's 3xTF32 mma.sync: each
// k-step's three passes start from zero and their sum is added to the f32
// accumulator round-to-nearest (level_common.cuh's note: accumulated in
// the mma over a layer, the tensor core's truncation flips ReLU masks
// against the plain version). The epilogues:
//  - kF32Fwd: the first view layer's per-ray direction term, the bias, ReLU;
//  - kF32Chain: the density head's term (into the trunk, over cd channels),
//    then zero where the layer below's activation is not > 0;
//  - kF32Dx: mlp_bwd's dX, the deeper x layers' sum in out plus this term.
// Every output element is one thread's: no atomics, fixed sums, so two
// launches on the same inputs give the same bits.
// WideF32Route runs wide_forward.cuh's drivers (the features and
// direction-term kernels are theirs, instantiated in f32) on this GEMM and
// on wide_head_f32_kernel, the heads as one warp a row from pack_params'
// transposed head rows [C, K], 8 channels a launch. A simple design that is right first: no
// wgmma (its TF32 form is untried), every activation through HBM.

#pragma once

#include "wide_forward.cuh"

namespace {

constexpr int kF32GemmThreads = 256;
constexpr int kF32BM = 128, kF32BN = 128, kF32BK = 32, kF32Stages = 3;
constexpr int kF32Lda = kF32BK + 4;  // A fragments' 8 rows x 4 columns hit 32 banks
constexpr int kF32Ldb = kF32BN + 8;  // B fragments' 4 rows x 8 columns hit 32 banks
constexpr int kF32StageFloats = kF32BM * kF32Lda + kF32BK * kF32Ldb;
constexpr int kF32GemmSmem = kF32Stages * kF32StageFloats * 4;

enum { kF32Fwd = 0, kF32Chain = 1, kF32Dx = 2 };

// One layer product and its epilogue (wide_gemm_f32_kernel).
struct WideGemmF32 {
  const float* a0;     // A, first part: [M, lda0], columns [0, ka0) read
  const float* a1;     // second part (layer 0's and the skip layers' x rows), or null
  int lda0, ka0, lda1, ka1;
  const float* b;      // [ka0 + ka1, N] row-major: a0's rows, then a1's
  int N;               // columns of the product (a multiple of 16)
  long long M;         // rows
  const float* bias;   // kF32Fwd: [N]
  const float* dc;     // kF32Fwd, first view layer: [rays, N], ray = row / S
  int S;
  const float* act;    // kF32Chain: the layer below's activation [M, N]
  const float* gden;   // kF32Chain into the trunk: the density cotangents [M, cd]
  const float* wden;   // and W_den^T [cd, N]
  int cd;
  float* out;          // [M, N]; kF32Dx: [M, ldo], columns < ldo
  int ldo, accum;      // kF32Dx: out already holds the deeper x layers' sum
};

// Block (blockIdx.x, blockIdx.y): rows m0 .. m0 + 127 by columns
// n0 .. n0 + 127. Warp w: rows 32 (w & 3), columns 64 (w >> 2) of the block
// (a warp whose columns all lie past N only stages).
template <int kKind>
__global__ void __launch_bounds__(kF32GemmThreads, 2) wide_gemm_f32_kernel(WideGemmF32 g) {
  extern __shared__ __align__(16) float smem_f32[];
  const long long m0 = (long long)blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * kF32BN;
  const int nk0 = cdiv(g.ka0, kF32BK);
  const int nk = nk0 + (g.a1 ? cdiv(g.ka1, kF32BK) : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int gq = lane >> 2, tq = lane & 3;
  auto tile_a = [&](int kt) { return smem_f32 + (kt % kF32Stages) * kF32StageFloats; };
  // Stage kt: A rows m0.. columns k0 .. k0 + 31 of its part, B rows of the
  // same k-values, zeros past M, past the part's ka and past N.
  auto load = [&](int kt) {
    if (kt < nk) {
      const bool first = kt < nk0;
      const float* a = first ? g.a0 : g.a1;
      const int lda = first ? g.lda0 : g.lda1, ka = first ? g.ka0 : g.ka1;
      const int k0 = (first ? kt : kt - nk0) * kF32BK;
      const float* b = g.b + (long long)((first ? 0 : g.ka0) + k0) * g.N;
      float* as = tile_a(kt);
      float* bs = as + kF32BM * kF32Lda;
      for (int idx = threadIdx.x; idx < kF32BM * (kF32BK / 4); idx += kF32GemmThreads) {
        const int r = idx >> 3, c = (idx & 7) * 4;
        const bool v = m0 + r < g.M && k0 + c < ka;
        cp_async16(as + r * kF32Lda + c, v ? a + (m0 + r) * lda + k0 + c : a, v);
      }
      for (int idx = threadIdx.x; idx < kF32BK * (kF32BN / 4); idx += kF32GemmThreads) {
        const int r = idx >> 5, c = (idx & 31) * 4;
        const bool v = k0 + r < ka && n0 + c < g.N;
        cp_async16(bs + r * kF32Ldb + c, v ? b + (long long)r * g.N + n0 + c : g.b, v);
      }
    }
    cp_async_commit();
  };
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  const bool active = n0 + wn < g.N;
  load(0);
  load(1);
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // stage kt is in; every warp's products of kt - 1 are done
    load(kt + 2);
    if (!active) continue;
    const float* as = tile_a(kt) + (wm + gq) * kF32Lda + tq;
    const float* bs = tile_a(kt) + kF32BM * kF32Lda + tq * kF32Ldb + wn + gq;
#pragma unroll
    for (int k8 = 0; k8 < kF32BK; k8 += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        load_a_split(as + mt * 16 * kF32Lda + k8, kF32Lda, ahi[mt], alo[mt]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bs[k8 * kF32Ldb + 8 * nt], bh0, bl0);
        split_tf32(bs[(k8 + 4) * kF32Ldb + 8 * nt], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_3xtf32(part, ahi[mt], alo[mt], bh0, bh1, bl0, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
        }
      }
    }
  }
  cp_async_wait_all();
  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + 16 * mt + gq + 8 * h;
      if (row >= g.M) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn + 8 * nt + 2 * tq;
        if (col >= g.N) continue;  // N is a multiple of 16: col + 1 < N too
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if constexpr (kKind == kF32Fwd) {
          // the plain version's (acc + dc) + b, then ReLU
          if (g.dc) {
            const float* dr = g.dc + (row / g.S) * g.N + col;
            v0 += dr[0];
            v1 += dr[1];
          }
          *reinterpret_cast<float2*>(g.out + row * g.N + col) =
              make_float2(fmaxf(v0 + __ldg(g.bias + col), 0.0f),
                          fmaxf(v1 + __ldg(g.bias + col + 1), 0.0f));
        } else if constexpr (kKind == kF32Chain) {
          // g + g_den @ W_den^T (an f32 sum over the cd channels in order),
          // then the mask of the layer below
          if (g.gden) {
            float t0 = -0.0f, t1 = -0.0f;
            for (int k = 0; k < g.cd; ++k) {
              const float gd = g.gden[row * g.cd + k];
              t0 = fmaf(gd, g.wden[(long long)k * g.N + col], t0);
              t1 = fmaf(gd, g.wden[(long long)k * g.N + col + 1], t1);
            }
            v0 += t0;
            v1 += t1;
          }
          const float2 a = *reinterpret_cast<const float2*>(g.act + row * g.N + col);
          *reinterpret_cast<float2*>(g.out + row * g.N + col) =
              make_float2(a.x > 0.0f ? v0 : 0.0f, a.y > 0.0f ? v1 : 0.0f);
        } else {
          // dX: the first (deepest) x layer's term added to 0, each later
          // one to the sum so far (the narrow chain's X += acc)
          if (col >= g.ldo) continue;  // the zero-padded columns of W_x^T
          float* o = g.out + row * g.ldo + col;
          o[0] = (g.accum ? o[0] : 0.0f) + v0;
          if (col + 1 < g.ldo) o[1] = (g.accum ? o[1] : 0.0f) + v1;
        }
      }
    }
}

template <int kKind>
inline cudaError_t launch_wide_gemm_f32(const WideGemmF32& g, cudaStream_t st) {
  if (g.M <= 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      wide_gemm_f32_kernel<kKind>, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32GemmSmem);
  if (err != cudaSuccess) return err;
  wide_gemm_f32_kernel<kKind>
      <<<dim3((unsigned)((g.M + kF32BM - 1) / kF32BM), cdiv(g.N, kF32BN)), kF32GemmThreads,
         kF32GemmSmem, st>>>(g);
  return cudaGetLastError();
}

// out[row * ld + c] = A[row, :K] . w[c, :K] + b[c] for c < nc (1-8), one
// warp a row: a head as pack_params stores it (transposed, [nc, K]),
// staged kWideHeadK k-values at a time as wide_head_kernel stages its
// own (each lane's k-values 4 lane + 128 i, ascending across the chunks):
// the same bits at any chunking.
__global__ void __launch_bounds__(kThreads) wide_head_f32_kernel(const float* A, int K,
                                                                 long long M, const float* w,
                                                                 const float* b, float* out,
                                                                 int ld, int nc) {
  __shared__ float ws[8 * kWideHeadK];
  const bool once = K <= kWideHeadK;
  auto stage = [&](int kc, int kn) {
    for (int idx = threadIdx.x; idx < nc * kn; idx += kThreads) {
      const int c = idx / kn, k = idx - c * kn;
      ws[c * kWideHeadK + k] = w[(long long)c * K + kc + k];
    }
  };
  if (once) {
    stage(0, K);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long row0 = (long long)blockIdx.x * (kThreads / 32); row0 < M;
       row0 += (long long)gridDim.x * (kThreads / 32)) {
    const long long row = row0 + warp;
    const bool live = row < M;
    const float* a = A + row * K;
    float s[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = 0.0f;
    for (int kc = 0; kc < K; kc += kWideHeadK) {
      const int kn = min(kWideHeadK, K - kc);
      if (!once) {
        __syncthreads();  // every warp's reads of the previous chunk are done
        stage(kc, kn);
        __syncthreads();
      }
      for (int k0 = lane * 4; live && k0 < kn; k0 += 128) {
        const float4 v = *reinterpret_cast<const float4*>(a + kc + k0);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c < nc) s[c] = fmaf(e[q], ws[c * kWideHeadK + k0 + q], s[c]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c >= nc) break;
      const float v = warp_sum(s[c]);
      if (lane == 0) out[row * ld + c] = v + b[c];
    }
  }
}

inline cudaError_t launch_wide_head_f32(const float* A, int K, long long M, const float* w,
                                        const float* b, float* out, int ld, int nc,
                                        cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  const long long want = (M + kThreads / 32 - 1) / (kThreads / 32);
  wide_head_f32_kernel<<<(unsigned)(want < 8192 ? want : 8192), kThreads, 0, st>>>(
      A, K, M, w, b, out, ld, nc);
  return cudaGetLastError();
}

// The f32 route's parts of wide_forward.cuh's drivers (wide_forward,
// launch_forward_wide; wide_train.cuh's launch_train_wide): the layer
// products as wide_gemm_f32_kernel on pack_params' layout at init_params'
// offsets (the trunk layers' in order, each [K, W] with the x rows last),
// the heads from its transposed head rows [C, K].
struct WideF32Route {
  using T = float;
  static constexpr bool kBf16 = false;
  std::vector<long long> trunk;
  bool init(const Params& p) {
    trunk.resize(p.D);
    long long off = 0;
    for (int i = 0; i < p.D; ++i) {
      trunk[i] = off;
      off += (long long)((i == 0 ? 0 : p.W) + ((i == 0 || i % p.skip == 0) ? p.KX : 0)) * p.W;
    }
    return true;
  }
  long long trunk_off(const Params&, int i) const { return trunk[i]; }
  long long view_off(const Params& p, int j) const {
    return j == 0 ? p.w_v0_top : p.w_v1 + (long long)(j - 1) * p.Wc * p.Wc;
  }
  const float* dir(const Params& p) const { return static_cast<const float*>(p.w) + p.w_v0_bot; }
  // out [M, N] = ReLU(a0 @ B + a1 @ B_x + dc + bias), a0 [M, k0], a1 the
  // features of an x layer (or null), B at w_off in the layout.
  cudaError_t fwd(const Params& p, const float* a0, int k0, const float* a1, int N, long long M,
                  long long w_off, const float* bias, const float* dc, float* out,
                  cudaStream_t st) const {
    WideGemmF32 g{};
    g.a0 = a0; g.lda0 = g.ka0 = k0;
    if (a1) { g.a1 = a1; g.lda1 = g.ka1 = p.KX; }
    g.b = static_cast<const float*>(p.w) + w_off; g.N = N; g.M = M;
    g.bias = bias; g.S = p.S; g.dc = dc; g.out = out;
    return launch_wide_gemm_f32<kF32Fwd>(g, st);
  }
  // The rgb head (rgb) or the density head on A [M, K] to out (row stride
  // ld), a launch for each group of 8 channels (rows c0 .. of [C, K]).
  template <int kHeads>
  cudaError_t head(const Params& p, bool rgb, const float* A, long long M, float* out, int ld,
                   cudaStream_t st) const {
    const int C = rgb ? p.Cr : p.Cd, K = rgb ? p.Wc : p.W;
    const float* w = static_cast<const float*>(p.w) + (rgb ? p.w_rgb : p.w_den);
    const float* b = p.b + (rgb ? p.b_rgb : p.b_den);
    for (int c0 = 0; c0 < C; c0 += 8) {
      const cudaError_t err = launch_wide_head_f32(A, K, M, w + (long long)c0 * K, b + c0,
                                                   out + c0, ld, C - c0 < 8 ? C - c0 : 8, st);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
};

// The last view layer's masked g: round-free g_rgb @ W_rgb^T (f32, the Cr
// channels in order; wr: pack_params' rgb head rows [Cr, Wc]), zero where
// its activation is not > 0.
__global__ void wide_rgb_chain_f32_kernel(const float* g_rgb, const float* wr, const float* act,
                                          float* out, long long N, int Wc, int Cr) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < N * Wc;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / Wc;
    const int n = (int)(idx - row * Wc);
    float s = 0.0f;
    for (int k = 0; k < Cr; ++k) s = fmaf(g_rgb[row * Cr + k], wr[k * Wc + n], s);
    out[idx] = act[idx] > 0.0f ? s : 0.0f;
  }
}

// g_ray[ray, :] = the f32 sum in row order of the ray's rows of the first
// view layer's masked g (gv: [R * S, Wc] f32), a thread a column.
__global__ void g_ray_f32_kernel(const float* gv, float* g_ray, int S, int Wc) {
  const float* g = gv + (long long)blockIdx.x * S * Wc + threadIdx.x;
  float s = 0.0f;
#pragma unroll 8
  for (int r = 0; r < S; ++r) s += g[(long long)r * Wc];
  g_ray[(long long)blockIdx.x * Wc + threadIdx.x] = s;
}

// dD[ray, f] = g_ray[ray, :] . W_d[f, :] (f32, FMA in column order; wd:
// pack_params' direction rows [Fd, Wc]), one warp a ray.
__global__ void wide_dd_f32_kernel(const float* g_ray, const float* wd, float* dd, int R, int Wc,
                                   int Fd) {
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= R) return;
  const float* g = g_ray + (long long)ray * Wc;
  for (int f = threadIdx.x & 31; f < Fd; f += 32) {
    float s = 0.0f;
    for (int n = 0; n < Wc; ++n) s = fmaf(g[n], wd[f * Wc + n], s);
    dd[(long long)ray * Fd + f] = s;
  }
}

}  // namespace
