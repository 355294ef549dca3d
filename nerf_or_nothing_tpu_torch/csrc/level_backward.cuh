// The MLP backward passes shared by the train-level, two-pass train-level
// and MLP-backward kernels (train_level.cu, train_level_twopass.cu,
// mlp_bwd.cu), and the train level's composite backward (composite_train).
// Their f32 instantiations run launch_backward on the activations the
// forward stored, every layer product as 3xTF32 mma.sync (level_common.cuh:
// gemm for the chain, dw_gemm_f32_kernel for dW):
//  2. chain_kernel (the device function chain_rays, which the two-pass
//     kernel's phase 0 also calls): the g-chain, 64 rows at a time: rgb
//     head, view branch, density head, trunk; each layer's g is masked by
//     its activation > 0 and stored; the view layer's per-ray f32 sum g_ray
//     is kept in shared memory (and with a db accumulator, every layer's
//     db). The chain multiplies g by W^T, packed once per step row-major.
//     With dx, the chain also runs into layer 0 and each skip layer's x
//     rows (W^T of the x rows, packed the same way) and accumulates dX, the
//     deepest skip layer first and layer 0 last; with dd, each block
//     multiplies its rays' g_ray by the view layer's direction rows;
//  3. dw_gemm_f32_kernel: dW = act^T g for every layer as a tiled GEMM over
//     the rows (64 x 64 tiles, 4 warps of 32 x 32, the next 32 rows of act
//     and g loading by cp.async while these multiply), split over the rows
//     into a fixed number of chunks, with db as column sums of g in the
//     same pass; the blocks of one chunk of rows run together, so its act
//     and g rows are read from L2 by every tile after the first;
//  4. small_tn_kernel: the heads' dW/db from the f32 cotangents and the
//     view layer's direction rows d^T g_ray, 8 warps per 32 outputs;
//  5. reduce_kernel: the split partials summed in a fixed order.
// launch_products runs passes 3-5 alone (the two-pass kernel's phase 1).
// The bf16 routes (train_wg.cuh) share the composite, passes 4-5
// (launch_small_reduce), the workspace layout and the output offsets.
// No atomics: every partial is written by exactly one block and reduced in
// order, so two launches on the same inputs give bit-equal dW.

#pragma once

#include "level_common.cuh"

namespace {

constexpr int kGemmThreads = 128;
// f32 dW tile: 64 x 64 outputs, 32 rows a stage (the split chunks of rows
// are multiples of kTK); 128 x 128 tiles of 8 warps ran slower on the card.
constexpr int kTM = 64, kTN = 64, kTK = 32;
// Products of one dW launch (a kernel parameter, so a fixed table): a
// backward with more goes in launches of kMaxJobs, each product into its
// own out_off block, so the sums are the same at any batching.
constexpr int kMaxJobs = 24;
constexpr int kSmallThreads = 256;

struct Extra {
  const float* pixels;  // [R, 3] (train level)
  const float* gsc;     // [R] dL/dcomp scale (train level)
  const void* wt;       // W^T of the chained layers, compute type
  const void* wtx;      // W^T of layer 0 and the skip layers' x rows [W, KX] each
  void* acts;           // per layer [N, width]: trunk 0..D-1, view 0..Dc-1
  void* grads;          // masked g, same layout
  void* xs;             // [N, KX] features, zero-padded to KX columns
  float* g_rgb;         // [N, Cr]
  float* g_den;         // [N, Cd]
  float* g_ray;         // [R, Wc]
  void* dx;             // [N, LX] compute type, or null: no dX
  float* dd;            // [R, Fd], or null: no dD
  long long N;
};

__host__ __device__ inline long long wt_off(const Params& p, int layer) {
  // trunk i >= 1: [W, W] at (i - 1) W^2; view 0: [Wc, W]; view j >= 1: [Wc, Wc]
  if (layer < p.D) return (long long)(layer - 1) * p.W * p.W;
  const long long v0 = (long long)(p.D - 1) * p.W * p.W;
  const int j = layer - p.D;
  return j == 0 ? v0 : v0 + (long long)p.W * p.Wc + (long long)(j - 1) * p.Wc * p.Wc;
}

__host__ __device__ inline long long wtx_off(const Params& p, int layer) {
  // layer 0 at 0, skip layer i at (i / skip) W KX
  return (long long)(layer / p.skip) * p.W * p.KX;
}

// The forward of the block's rays, storing the features and every layer's
// activations (the activation pass of both backward kernels); heads into
// OUT (4 per row) with heads, as the composite needs them.
template <class T>
__device__ void forward_store(const Params& p, const Extra& e, const Smem<T>& sm,
                              int ray0, int nr, bool heads) {
  const int rows = nr * p.S;
  direction_term<T>(p, sm, ray0, nr);
  for (int sub0 = 0; sub0 < rows; sub0 += kBM) {
    float* out = heads ? sm.OUT + sub0 * 4 : nullptr;
    forward_tile<T, true>(p, sm, sub0, min(kBM, rows - sub0), (long long)ray0 * p.S + sub0,
                          heads ? out + 3 : nullptr, 4, out, 4, static_cast<T*>(e.xs),
                          static_cast<T*>(e.acts), e.N);
  }
}

// The train level's composite (train_level.cu, train_level_twopass.cu):
// one warp per ray, the forward composite (as composite()), then the loss
// gradient, the composite backward and the activation VJPs. EX holds per
// sample w, trans, alpha, dL/dw.
template <class T>
__device__ void composite_train(const Params& p, const Extra& e, const Smem<T>& sm,
                                float* EX, int ray0, int nr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float pad = p.rgb_padding, scale = 1.0f + 2.0f * pad;
  for (int r = warp; r < nr; r += kThreads / 32) {
    const long long ray = ray0 + r;
    const float* out = sm.OUT + r * p.S * 4;
    float* ex = EX + r * p.S * 4;
    float carry = 0.0f, a_acc = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    for (int s0 = 0; s0 < p.S; s0 += 32) {
      const int s = s0 + lane;
      const bool valid = s < p.S;
      float sd = 0.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
      if (valid) {
        const float* o = out + s * 4;
        sd = softplus(o[3] + p.density_bias) * p.delta[ray * p.S + s];
        rr = sigmoid(o[0]) * scale - pad;
        rg = sigmoid(o[1]) * scale - pad;
        rb = sigmoid(o[2]) * scale - pad;
      }
      float incl = sd;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float trans = expf(-(carry + excl));
      const float alpha = 1.0f - expf(-sd);
      const float w = valid ? alpha * trans : 0.0f;
      if (valid) {
        p.weights[ray * p.S + s] = w;
        ex[s * 4 + 0] = w;
        ex[s * 4 + 1] = trans;
        ex[s * 4 + 2] = alpha;
      }
      a_acc += w;
      cr += w * rr;
      cg += w * rg;
      cb += w * rb;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    a_acc = warp_sum(a_acc);
    const float bg = p.white_bkgd ? 1.0f - a_acc : 0.0f;
    const float c0 = warp_sum(cr) + bg, c1 = warp_sum(cg) + bg, c2 = warp_sum(cb) + bg;
    if (lane == 0) {
      p.comp[ray * 3 + 0] = c0;
      p.comp[ray * 3 + 1] = c1;
      p.comp[ray * 3 + 2] = c2;
      p.acc[ray] = a_acc;
    }
    // dL/dcomp, then dL/dw and the total of w * dL/dw.
    const float gs = e.gsc[ray];
    const float g0 = gs * (c0 - e.pixels[ray * 3 + 0]);
    const float g1 = gs * (c1 - e.pixels[ray * 3 + 1]);
    const float g2 = gs * (c2 - e.pixels[ray * 3 + 2]);
    float total = 0.0f;
    for (int s = lane; s < p.S; s += 32) {
      const float* o = out + s * 4;
      float dl = g0 * (sigmoid(o[0]) * scale - pad) + g1 * (sigmoid(o[1]) * scale - pad) +
                 g2 * (sigmoid(o[2]) * scale - pad);
      if (p.white_bkgd) dl -= g0 + g1 + g2;
      ex[s * 4 + 3] = dl;
      total += dl * ex[s * 4 + 0];
    }
    total = warp_sum(total);
    // suffix_s = total - inclusive prefix of w * dL/dw
    carry = 0.0f;
    for (int s0 = 0; s0 < p.S; s0 += 32) {
      const int s = s0 + lane;
      const bool valid = s < p.S;
      const float wdw = valid ? ex[s * 4 + 3] * ex[s * 4 + 0] : 0.0f;
      float incl = wdw;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (valid) {
        const float w = ex[s * 4 + 0], trans = ex[s * 4 + 1], alpha = ex[s * 4 + 2];
        const float dl = ex[s * 4 + 3];
        const float suffix = total - (carry + incl);
        const float dalpha = dl * trans - suffix / fmaxf(1.0f - alpha, 1e-10f);
        const float dsigma = dalpha * (1.0f - alpha) * p.delta[ray * p.S + s];
        const float* o = out + s * 4;
        const long long row = ray * p.S + s;
        const float gk[3] = {g0, g1, g2};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float sg = sigmoid(o[k]);
          e.g_rgb[row * 3 + k] = (gk[k] * w) * (sg * (1.0f - sg) * scale);
        }
        e.g_den[row] = dsigma * sigmoid(o[3] + p.density_bias);
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// H[:, :N] = acc (+ sum_k gd[row, k] * wden[k, col]): the chain product
// of one layer, with the density head's term on the view chain. Call
// after a barrier.
__device__ __forceinline__ void chain_epilogue(const Params& p, const Smem<float>& sm,
                                               const AccF32& acc, int N, const float* gd,
                                               const float* wden) {
  const int c0 = acc_col0(N);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt) {
      if (frag_valid(N, nt)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = acc_row(mt, e), col = c0 + 8 * nt + (e & 1);
          float v = acc.v[mt][nt][e];
          if (gd)
            for (int k = 0; k < p.Cd; ++k) v += gd[row * p.Cd + k] * wden[k * p.W + col];
          sm.H[row * p.ldh + col] = v;
        }
      }
    }
}

// X[:, :KX] += acc: one term of dX.
__device__ __forceinline__ void dx_epilogue(const Params& p, const Smem<float>& sm,
                                            const AccF32& acc) {
  const int c0 = acc_col0(p.KX);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt)
      if (frag_valid(p.KX, nt))
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.X[acc_row(mt, e) * p.ldx + c0 + 8 * nt + (e & 1)] += acc.v[mt][nt][e];
}

// H[row, :width] *= (activation > 0) for the sub-tile's rows (rows past
// nvalid become 0), 16 bytes a thread; the masked g also goes to the
// workspace for dW.
template <class T>
__device__ void mask_store(const Params& p, const Smem<T>& sm, int width, const T* act,
                           T* grad, long long grow0, int nvalid) {
  constexpr int vec = 16 / sizeof(T);
  const int per_row = width / vec;
  for (int idx = threadIdx.x; idx < kBM * per_row; idx += kThreads) {
    const int row = idx / per_row, c = (idx - row * per_row) * vec;
    uint4* h = reinterpret_cast<uint4*>(sm.H + row * p.ldh + c);
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row < nvalid) {
      const long long g = (grow0 + row) * width + c;
      const uint4 av = *reinterpret_cast<const uint4*>(act + g);
      const uint4 hv = *h;
      const T* a = reinterpret_cast<const T*>(&av);
      const T* hh = reinterpret_cast<const T*>(&hv);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < vec; ++e)
        if (to_f(a[e]) > 0.0f) o[e] = hh[e];
      *reinterpret_cast<uint4*>(grad + g) = out;
    }
    *h = out;
  }
}

// H, X (with dx), the staged weights of gemm, then GR, GD and GRAY.
template <class T>
__host__ __device__ inline size_t chain_smem(const Params& p, bool dx) {
  return align16(sizeof(T) * kBM * p.ldh) + (dx ? align16(sizeof(T) * kBM * p.ldx) : 0) +
         wstage_bytes(dx && p.KX > p.W ? p.KX : p.W) +
         sizeof(float) * (kBM * (p.Cr + p.Cd) + p.RB * p.Wc);
}

// Biases of the flat bias layout (layer order; the Params b_* offsets).
__host__ __device__ inline int num_biases(const Params& p) { return p.b_rgb + p.Cr; }

// DB[col] += sum over the 64 rows of H[:, col] (f32), col < width; rows
// past the sub-tile's valid rows are 0 after mask_store.
template <class T>
__device__ __forceinline__ void db_rows(const Params& p, const Smem<T>& sm, int width,
                                        float* DB) {
  if (threadIdx.x < width) {
    float s = 0.0f;
    for (int row = 0; row < kBM; ++row) s += to_f(sm.H[row * p.ldh + threadIdx.x]);
    DB[threadIdx.x] += s;
  }
}

// The g-chain of rays [ray0, ray0 + nr), 64 rows at a time, in the
// chain_smem bytes at smem_raw (pass 2, and phase 0 of
// train_level_twopass.cu). DB (shared, num_biases floats, or null): every
// layer's db, summed in f32 from each sub-tile's masked g as the chain
// makes it, the heads' from the f32 cotangents; ends with a barrier.
template <class T>
__device__ void chain_rays(const Params& p, const Extra& e, unsigned char* smem_raw, int ray0,
                           int nr, float* DB) {
  Smem<T> sm;
  size_t off = align16(sizeof(T) * kBM * p.ldh);
  sm.H = reinterpret_cast<T*>(smem_raw);
  sm.X = nullptr; sm.DC = nullptr; sm.OUT = nullptr;
  if (e.dx) {  // the sub-tile's dX
    sm.X = reinterpret_cast<T*>(smem_raw + off);
    off += align16(sizeof(T) * kBM * p.ldx);
  }
  sm.WS = reinterpret_cast<float*>(smem_raw + off);
  off += wstage_bytes(e.dx && p.KX > p.W ? p.KX : p.W);
  float* GR = reinterpret_cast<float*>(smem_raw + off);
  float* GD = GR + kBM * p.Cr;
  float* GRAY = GD + kBM * p.Cd;  // [RB, Wc] per-ray f32 sum of the view layer's g
  const T* w = static_cast<const T*>(p.w);
  const T* wt = static_cast<const T*>(e.wt);
  const T* wtx = static_cast<const T*>(e.wtx);
  const T* acts = static_cast<const T*>(e.acts);
  T* grads = static_cast<T*>(e.grads);
  T* dx = static_cast<T*>(e.dx);
  const int rows = nr * p.S;
  const int tid = threadIdx.x;
  const int Cg = p.Cr + p.Cd;
  for (int idx = tid; idx < p.RB * p.Wc; idx += kThreads) GRAY[idx] = 0.0f;
  if (DB)
    for (int idx = tid; idx < num_biases(p); idx += kThreads) DB[idx] = 0.0f;

  AccF32 acc;
  for (int sub0 = 0; sub0 < rows; sub0 += kBM) {
    const int nvalid = min(kBM, rows - sub0);
    const long long grow0 = (long long)ray0 * p.S + sub0;
    for (int idx = tid; idx < kBM * Cg; idx += kThreads) {
      const int row = idx / Cg, c = idx - row * Cg;
      float v = 0.0f;
      if (row < nvalid)
        v = c < p.Cr ? e.g_rgb[(grow0 + row) * p.Cr + c]
                     : e.g_den[(grow0 + row) * p.Cd + c - p.Cr];
      if (c < p.Cr) GR[row * p.Cr + c] = v; else GD[row * p.Cd + c - p.Cr] = v;
    }
    if (dx)
      for (int idx = tid; idx < kBM * p.ldx; idx += kThreads) sm.X[idx] = from_f<T>(0.0f);
    __syncthreads();
    if (DB && tid < Cg) {  // the heads' db from the f32 cotangents
      float s = 0.0f;
      for (int row = 0; row < nvalid; ++row)
        s += tid < p.Cr ? GR[row * p.Cr + tid] : GD[row * p.Cd + tid - p.Cr];
      DB[tid < p.Cr ? p.b_rgb + tid : p.b_den + tid - p.Cr] += s;
    }
    // rgb head: g = round(round(g_rgb) @ W_rgb^T)
    {
      const T* wr = w + p.w_rgb;  // [Cr, Wc]
      for (int idx = tid; idx < kBM * p.Wc; idx += kThreads) {
        const int row = idx / p.Wc, col = idx - row * p.Wc;
        float s = 0.0f;
        for (int k = 0; k < p.Cr; ++k)
          s = fmaf(to_f(from_f<T>(GR[row * p.Cr + k])), to_f(wr[k * p.Wc + col]), s);
        sm.H[row * p.ldh + col] = from_f<T>(s);
      }
    }
    __syncthreads();
    for (int j = p.Dc - 1; j >= 0; --j) {
      const long long off_j = act_off(p, e.N, p.D + j);
      mask_store<T>(p, sm, p.Wc, acts + off_j, grads + off_j, grow0, nvalid);
      __syncthreads();
      if (DB) db_rows<T>(p, sm, p.Wc, DB + p.b_v0 + j * p.Wc);
      if (j == 0) {
        for (int idx = tid; idx < nr * p.Wc; idx += kThreads) {
          const int r = idx / p.Wc, col = idx - r * p.Wc;
          const int lo = max(r * p.S, sub0) - sub0;
          const int hi = min((r + 1) * p.S, sub0 + nvalid) - sub0;
          float s = 0.0f;
          for (int row = lo; row < hi; ++row) s += to_f(sm.H[row * p.ldh + col]);
          GRAY[idx] += s;
        }
      }
      const int N = j == 0 ? p.W : p.Wc;
      gemm(p, sm, p.Wc, 0, wt + wt_off(p, p.D + j), N, acc);
      __syncthreads();
      chain_epilogue(p, sm, acc, N, j == 0 ? GD : nullptr, w + p.w_den);
      __syncthreads();
    }
    for (int i = p.D - 1; i >= 0; --i) {
      const long long off_i = act_off(p, e.N, i);
      mask_store<T>(p, sm, p.W, acts + off_i, grads + off_i, grow0, nvalid);
      __syncthreads();
      if (DB) db_rows<T>(p, sm, p.W, DB + i * p.W);
      if (dx && (i == 0 || i % p.skip == 0)) {
        // X += round(g @ W_x^T); gemm reads only H
        gemm(p, sm, p.W, 0, wtx + wtx_off(p, i), p.KX, acc);
        dx_epilogue(p, sm, acc);
        if (i == 0) {
          __syncthreads();
          for (int idx = tid; idx < nvalid * p.LX; idx += kThreads) {
            const int row = idx / p.LX, col = idx - row * p.LX;
            dx[(grow0 + row) * p.LX + col] = sm.X[row * p.ldx + col];
          }
          __syncthreads();
        }
      }
      if (i == 0) break;
      gemm(p, sm, p.W, 0, wt + wt_off(p, i), p.W, acc);
      __syncthreads();
      chain_epilogue(p, sm, acc, p.W, nullptr, w);
      __syncthreads();
    }
  }
  for (int idx = tid; idx < nr * p.Wc; idx += kThreads)
    e.g_ray[(long long)ray0 * p.Wc + idx] = GRAY[idx];
  if (e.dd) {
    // dD[ray, f] = round(g_ray[ray, :]) . W_v0[W + f, :]
    __syncthreads();
    const T* wb = w + p.w_v0_bot;  // [Fd, Wc]
    for (int idx = tid; idx < nr * p.Fd; idx += kThreads) {
      const int r = idx / p.Fd, f = idx - r * p.Fd;
      float s = 0.0f;
      for (int n = 0; n < p.Wc; ++n)
        s = fmaf(to_f(from_f<T>(GRAY[r * p.Wc + n])), to_f(wb[f * p.Wc + n]), s);
      e.dd[(long long)(ray0 + r) * p.Fd + f] = s;
    }
  }
  __syncthreads();
}

// Pass 2: the g-chain of the block's rays.
template <class T>
__global__ void __launch_bounds__(kThreads, kF32Blocks)
chain_kernel(Params p, Extra e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ray0 = blockIdx.x * p.RB;
  chain_rays<T>(p, e, smem_raw, ray0, min(p.RB, p.R - ray0), nullptr);
}

// ---- dW = A^T B over the rows, split into chunks of rows ----
struct GemmJob {
  const void* A;      // [K, lda] compute type, columns [0, M) used
  const void* B;      // [K, ldb] compute type, columns [0, Nn) used
  long long out_off;  // dW block [M, Nn] (row stride out_ld) in the flat output
  long long db_off;   // column sums of B, or -1
  int lda, ldb, M, Nn, K, out_ld, tiles_m, block0;
};

struct GemmJobs {
  GemmJob job[kMaxJobs];
  float* part;  // [splits, n_out]
  long long n_out;
  int n, splits;
};

__host__ __device__ inline long long split_rows(int K, int splits) {
  return ((long long)(K + splits - 1) / splits + kTK - 1) / kTK * kTK;
}

constexpr int kDwLd = kTM + 8;  // row stride of a staged dW tile: 32 banks per fragment

// Rows [k0, k0 + kTK) of the tile's A and B columns into As / Bs (zeros
// past k_hi and past the row strides).
__device__ __forceinline__ void dw_stage_f32(float (*As)[kDwLd], float (*Bs)[kDwLd],
                                             const GemmJob& jb, long long k0, long long k_hi,
                                             int m0, int n0) {
  const float* A = static_cast<const float*>(jb.A);
  const float* B = static_cast<const float*>(jb.B);
  for (int idx = threadIdx.x; idx < kTK * (kTM / 4); idx += kGemmThreads) {
    const int r = idx / (kTM / 4), c = (idx - r * (kTM / 4)) * 4;
    const bool rv = k0 + r < k_hi;
    const bool av = rv && m0 + c < jb.lda, bv = rv && n0 + c < jb.ldb;
    cp_async16(&As[r][c], av ? A + (k0 + r) * jb.lda + m0 + c : A, av);
    cp_async16(&Bs[r][c], bv ? B + (k0 + r) * jb.ldb + n0 + c : B, bv);
  }
}

// f32: 64 x 64 tiles, 3xTF32 mma.sync; warp w owns rows 32 (w & 1) and
// columns 32 (w >> 1) of the tile (two m16 by four n8 fragments). Tile
// after tile of one chunk of rows, so those rows stay in L2.
__global__ void __launch_bounds__(kGemmThreads)
dw_gemm_f32_kernel(GemmJobs js) {
  __shared__ __align__(16) float As[2][kTK][kDwLd];  // As[k][m] = A[k0 + k][m0 + m]
  __shared__ __align__(16) float Bs[2][kTK][kDwLd];  // Bs[k][n] = B[k0 + k][n0 + n]
  const int bid = blockIdx.x, tid = threadIdx.x;
  int jn = 0;
  while (jn + 1 < js.n && bid >= js.job[jn + 1].block0) ++jn;
  const GemmJob jb = js.job[jn];
  const int local = bid - jb.block0;
  const int tiles = jb.tiles_m * ((jb.Nn + kTN - 1) / kTN);
  const int tile = local % tiles, split = local / tiles;
  const int tm = tile % jb.tiles_m, tn = tile / jb.tiles_m;
  const int m0 = tm * kTM, n0 = tn * kTN;
  const long long chunk = split_rows(jb.K, js.splits);
  const long long k_lo = split * chunk;
  const long long k_hi = min((long long)jb.K, k_lo + chunk);
  const bool want_db = jb.db_off >= 0 && tm == 0;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = ((tid >> 5) & 1) * 32, wn = (tid >> 6) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  float dbs = 0.0f;
  const int steps = k_hi > k_lo ? (int)((k_hi - k_lo + kTK - 1) / kTK) : 0;
  if (steps > 0) dw_stage_f32(As[0], Bs[0], jb, k_lo, k_hi, m0, n0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < steps)
      dw_stage_f32(As[(s + 1) & 1], Bs[(s + 1) & 1], jb, k_lo + (long long)(s + 1) * kTK,
                   k_hi, m0, n0);
    cp_async_commit();
    const float(*a)[kDwLd] = As[s & 1];
    const float(*b)[kDwLd] = Bs[s & 1];
    if (want_db && tid < kTN) {
#pragma unroll 8
      for (int r = 0; r < kTK; ++r) dbs += b[r][tid];
    }
    float st[2][4][4];  // the stage's sums, added to acc round-to-nearest
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.0f;
#pragma unroll
    for (int k8 = 0; k8 < kTK; k8 += 8) {
      // A^T fragments: rows m of A^T are columns of the staged A rows.
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = wm + 16 * mt + g;
        split_tf32(a[k8 + t][m], ahi[mt][0], alo[mt][0]);
        split_tf32(a[k8 + t][m + 8], ahi[mt][1], alo[mt][1]);
        split_tf32(a[k8 + t + 4][m], ahi[mt][2], alo[mt][2]);
        split_tf32(a[k8 + t + 4][m + 8], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[k8 + t][wn + 8 * nt + g], bh0, bl0);
        split_tf32(b[k8 + t + 4][wn + 8 * nt + g], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_3xtf32(st[mt][nt], ahi[mt], alo[mt], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += st[mt][nt][e];
  }
  float* part = js.part + split * js.n_out;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * mt + g + 8 * (e >> 1);
        const int n = n0 + wn + 8 * nt + 2 * t + (e & 1);
        if (m < jb.M && n < jb.Nn)
          part[jb.out_off + (long long)m * jb.out_ld + n] = acc[mt][nt][e];
      }
  if (want_db && tid < kTN && n0 + tid < jb.Nn) part[jb.db_off + n0 + tid] = dbs;
}

// ---- small products: out[a, c] = sum_rows round(A[r, a]) round(B[r, c]) ----
struct SmallJob {
  const void* A;      // [K, lda] compute type, or null: column sums of B
  const float* B;     // [K, ldb] f32
  long long out_off;  // [KA, NB] (or [NB]) at out_off of the output
  long long part_off; // and at part_off of each split's partial row
  int lda, ldb, KA, NB, K, block0, nblk;
};

struct SmallJobs {
  SmallJob job[8];
  float* part;
  long long n_out;  // the partial rows' stride
  int n, splits;
};

// 32 outputs per block (one per lane); the 8 warps take interleaved rows of
// the split, and their sums are added in warp order.
template <class T>
__global__ void __launch_bounds__(kSmallThreads)
small_tn_kernel(SmallJobs js) {
  __shared__ float red[kSmallThreads / 32][32];
  const int bid = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int jn = 0;
  while (jn + 1 < js.n && bid >= js.job[jn + 1].block0) ++jn;
  const SmallJob jb = js.job[jn];
  const int local = bid - jb.block0;
  const int split = local % js.splits;
  const int idx = (local / js.splits) * 32 + lane;
  const int KA = jb.A ? jb.KA : 1;
  const bool valid = idx < KA * jb.NB;
  const int a = valid ? idx / jb.NB : 0, c = valid ? idx - a * jb.NB : 0;
  const long long chunk = split_rows(jb.K, js.splits);
  const long long k_lo = split * chunk;
  const long long k_hi = min((long long)jb.K, k_lo + chunk);
  const T* A = static_cast<const T*>(jb.A);
  constexpr int nw = kSmallThreads / 32;
  float s = 0.0f;
  if (valid) {
    if (A) {
      for (long long r = k_lo + warp; r < k_hi; r += nw)
        s = fmaf(to_f(A[r * jb.lda + a]), to_f(from_f<T>(jb.B[r * jb.ldb + c])), s);
    } else {
      for (long long r = k_lo + warp; r < k_hi; r += nw) s += jb.B[r * jb.ldb + c];
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && valid) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < nw; ++w) t += red[w][lane];
    js.part[split * js.n_out + jb.part_off + (long long)a * jb.NB + c] = t;
  }
}

// The wide routes' reduction: out at each small job's offsets = its n
// partials of js.part [splits, n] (small_tn_kernel's, at part_off) summed
// in split order (reduce_kernel's sum, for the small products only).
__global__ void small_sum_kernel(SmallJobs js, float* out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int jn = 0;
    while (jn + 1 < js.n && i >= js.job[jn + 1].part_off) ++jn;
    float s = 0.0f;
    for (int k = 0; k < js.splits; ++k) s += js.part[k * n + i];
    out[js.job[jn].out_off + (i - js.job[jn].part_off)] = s;
  }
}

__global__ void reduce_kernel(const float* part, float* out, long long n, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

// ---- host side ----
struct Layout {  // byte offsets into the workspace
  long long acts, grads, xs, g_rgb, g_den, g_ray, part, total;
};

// own_g: the workspace also holds the f32 head cotangents of 3 rgb and 1
// density channel (the train level computes them; mlp_bwd takes them in).
inline Layout layout(int esize, long long R, long long S, int D, int W, int Wc, int Dc, int KX,
                     int splits, long long n_out, bool own_g) {
  const long long N = R * S;
  const long long act = N * ((long long)D * W + (long long)Dc * Wc) * esize;
  Layout l;
  long long off = 0;
  l.acts = off;  off += round256(act);
  l.grads = off; off += round256(act);
  l.xs = off;    off += round256(N * KX * esize);
  l.g_rgb = off; off += own_g ? round256(N * 3 * 4) : 0;
  l.g_den = off; off += own_g ? round256(N * 4) : 0;
  l.g_ray = off; off += round256(R * Wc * 4);
  l.part = off;  off += round256((long long)splits * n_out * 4);
  l.total = off;
  return l;
}

// Flat output: dW of every layer ([fan_in, fan_out] row-major, layer
// order), then every bias. w_off / b_off per layer (resized to the D + 2 +
// Dc layers).
inline long long output_offsets(const Params& p, std::vector<long long>& w_off,
                                std::vector<long long>& b_off) {
  const int L = p.D + 2 + p.Dc;
  std::vector<int> fin(L), fout(L);
  w_off.resize(L);
  b_off.resize(L);
  for (int i = 0; i < p.D; ++i) {
    fin[i] = (i == 0 ? 0 : p.W) + ((i == 0 || i % p.skip == 0) ? p.LX : 0);
    fout[i] = p.W;
  }
  fin[p.D] = p.W; fout[p.D] = p.Cd;
  for (int j = 0; j < p.Dc; ++j) {
    fin[p.D + 1 + j] = j == 0 ? p.W + p.Fd : p.Wc;
    fout[p.D + 1 + j] = p.Wc;
  }
  fin[L - 1] = p.Wc; fout[L - 1] = p.Cr;
  long long off = 0;
  for (int l = 0; l < L; ++l) { w_off[l] = off; off += (long long)fin[l] * fout[l]; }
  for (int l = 0; l < L; ++l) { b_off[l] = off; off += fout[l]; }
  return off;
}

inline cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Passes 3-5 on the stored activations, masked g and e.g_rgb / e.g_den /
// e.g_ray; the summed dW/db go to out (output_offsets' layout). db is
// taken as column sums of g in passes 3 and 4, or, with dbpart, is the
// column sums of the per-block partials dbpart [db_blocks, num_biases] that
// the chain took (train_level_twopass.cu), and passes 3-4 multiply only.
// launch_dw is pass 3, launch_small_reduce passes 4-5, launch_products both.
template <class T>
cudaError_t launch_dw(Params p, Extra e, const Layout& l, unsigned char* ws, long long n_out,
                      int splits, const float* dbpart, cudaStream_t st) {
  const long long N = e.N;
  const T* acts = reinterpret_cast<const T*>(ws + l.acts);
  const T* grads = reinterpret_cast<const T*>(ws + l.grads);

  // 3. dW (/ db) GEMMs over the rows, kMaxJobs products a launch
  std::vector<long long> w_off, b_off;
  output_offsets(p, w_off, b_off);
  float* part = reinterpret_cast<float*>(ws + l.part);
  const T* x = reinterpret_cast<const T*>(ws + l.xs);
  const int ldx = p.KX;
  const int tile = kTM;
  GemmJobs gj;
  gj.part = part; gj.n_out = n_out; gj.n = 0; gj.splits = splits;
  int nblocks = 0;
  auto flush = [&]() {
    if (gj.n == 0) return cudaSuccess;
    dw_gemm_f32_kernel<<<nblocks, kGemmThreads, 0, st>>>(gj);
    gj.n = 0;
    nblocks = 0;
    return cudaGetLastError();
  };
  cudaError_t err = cudaSuccess;
  auto add = [&](const T* A, int lda, const T* B, int ldb, int M, int Nn, long long out_off,
                 int out_ld, long long db_off) {
    if (err != cudaSuccess) return;
    GemmJob& j = gj.job[gj.n++];
    j.A = A; j.B = B; j.lda = lda; j.ldb = ldb; j.M = M; j.Nn = Nn; j.K = (int)N;
    j.out_off = out_off; j.out_ld = out_ld; j.db_off = dbpart ? -1 : db_off;
    j.tiles_m = (M + tile - 1) / tile;
    j.block0 = nblocks;
    nblocks += j.tiles_m * ((Nn + tile - 1) / tile) * splits;
    if (gj.n == kMaxJobs) err = flush();
  };
  const long long tW = (long long)N * p.W;
  for (int i = 0; i < p.D; ++i) {
    const T* g = grads + (long long)i * tW;
    if (i == 0) {
      add(x, ldx, g, p.W, p.LX, p.W, w_off[0], p.W, b_off[0]);
    } else {
      add(acts + (long long)(i - 1) * tW, p.W, g, p.W, p.W, p.W, w_off[i], p.W, b_off[i]);
      if (i % p.skip == 0)
        add(x, ldx, g, p.W, p.LX, p.W, w_off[i] + (long long)p.W * p.W, p.W, -1);
    }
  }
  for (int j = 0; j < p.Dc; ++j) {
    const int layer = p.D + 1 + j;
    const T* g = grads + act_off(p, N, p.D + j);
    const T* a = j == 0 ? acts + (long long)(p.D - 1) * tW : acts + act_off(p, N, p.D + j - 1);
    add(a, j == 0 ? p.W : p.Wc, g, p.Wc, j == 0 ? p.W : p.Wc, p.Wc, w_off[layer], p.Wc,
        b_off[layer]);
  }
  if (err != cudaSuccess) return err;
  return flush();
}

// The small products of a level: the density head's dW, the view layer's
// direction rows (over the rays' summed g), the rgb head's dW, and db:
// with dbpart the column sums of its db_blocks rows, else the heads' db
// as column sums of their cotangents (the other biases' db then come with
// dW). Their partials at their outputs' offsets of part rows n_out apart,
// or with packed one after another (part_off), and *n_small the outputs.
template <class T>
SmallJobs small_jobs(const Params& p, const Extra& e, const Layout& l, unsigned char* ws,
                     long long n_out, int splits, const float* dbpart, int db_blocks, bool packed,
                     int* blocks, long long* n_small) {
  const int L = p.D + 2 + p.Dc;
  const long long N = e.N;
  const T* acts = reinterpret_cast<const T*>(ws + l.acts);
  const long long tW = (long long)N * p.W;
  std::vector<long long> w_off, b_off;
  output_offsets(p, w_off, b_off);
  SmallJobs sj;
  sj.part = reinterpret_cast<float*>(ws + l.part); sj.n_out = n_out; sj.n = 0;
  sj.splits = splits;
  int sblocks = 0;
  long long packed_off = 0;
  auto add_small = [&](const T* A, int lda, const float* B, int ldb, int KA, int NB, int K,
                       long long out_off) {
    SmallJob& j = sj.job[sj.n++];
    j.A = A; j.B = B; j.lda = lda; j.ldb = ldb; j.KA = KA; j.NB = NB; j.K = K;
    j.out_off = out_off;
    j.part_off = packed ? packed_off : out_off;
    packed_off += (long long)(A ? KA : 1) * NB;
    j.nblk = ((A ? KA : 1) * NB + 31) / 32;
    j.block0 = sblocks;
    sblocks += j.nblk * splits;
  };
  const T* h_last = acts + (long long)(p.D - 1) * tW;
  const T* v_last = acts + act_off(p, N, p.D + p.Dc - 1);
  add_small(h_last, p.W, e.g_den, p.Cd, p.W, p.Cd, (int)N, w_off[p.D]);
  add_small(static_cast<const T*>(p.d), p.Fd, e.g_ray, p.Wc, p.Fd, p.Wc, p.R,
            w_off[p.D + 1] + (long long)p.W * p.Wc);
  add_small(v_last, p.Wc, e.g_rgb, p.Cr, p.Wc, p.Cr, (int)N, w_off[L - 1]);
  if (dbpart) {
    const int nb = num_biases(p);
    add_small(nullptr, 0, dbpart, nb, 1, nb, db_blocks, b_off[0]);
  } else {
    add_small(nullptr, 0, e.g_den, p.Cd, 1, p.Cd, (int)N, b_off[p.D]);
    add_small(nullptr, 0, e.g_rgb, p.Cr, 1, p.Cr, (int)N, b_off[L - 1]);
  }
  *blocks = sblocks;
  *n_small = packed_off;
  return sj;
}

// The outputs of the wide routes' small products (small_jobs without
// dbpart): the density head's dW [W, Cd], the direction rows [Fd, Wc], the
// rgb head's dW [Wc, Cr] and the heads' db.
inline long long small_outputs(int W, int Wc, int Fd, int Cr, int Cd) {
  return (long long)W * Cd + (long long)Fd * Wc + (long long)Wc * Cr + Cr + Cd;
}

// Passes 4-5 of launch_products: the small products, then every split
// partial (n_out a row: the dW GEMM's and the small products') summed in
// order into out.
template <class T>
cudaError_t launch_small_reduce(Params p, Extra e, const Layout& l, unsigned char* ws,
                                float* out, long long n_out, int splits, const float* dbpart,
                                int db_blocks, cudaStream_t st) {
  int sblocks = 0;
  long long n_small = 0;
  const SmallJobs sj =
      small_jobs<T>(p, e, l, ws, n_out, splits, dbpart, db_blocks, false, &sblocks, &n_small);
  small_tn_kernel<T><<<sblocks, kSmallThreads, 0, st>>>(sj);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rblocks = (n_out + 255) / 256;
  reduce_kernel<<<(int)(rblocks < 4096 ? rblocks : 4096), 256, 0, st>>>(sj.part, out, n_out,
                                                                        splits);
  return cudaGetLastError();
}

// The wide routes' passes after dW (which adds its splits into out
// itself): the small products with the heads' db, their partials packed
// in l.part (small_outputs a row), summed in split order into out.
template <class T>
cudaError_t launch_small_sum(Params p, Extra e, const Layout& l, unsigned char* ws, float* out,
                             int splits, cudaStream_t st) {
  const long long n = small_outputs(p.W, p.Wc, p.Fd, p.Cr, p.Cd);
  int sblocks = 0;
  long long n_small = 0;
  const SmallJobs sj = small_jobs<T>(p, e, l, ws, n, splits, nullptr, 0, true, &sblocks, &n_small);
  if (n_small != n) return cudaErrorInvalidValue;
  small_tn_kernel<T><<<sblocks, kSmallThreads, 0, st>>>(sj);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long blocks = (n + 255) / 256;
  small_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(sj, out, n);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_products(Params p, Extra e, const Layout& l, unsigned char* ws,
                            float* out, long long n_out, int splits, const float* dbpart,
                            int db_blocks, cudaStream_t st) {
  cudaError_t err = launch_dw<T>(p, e, l, ws, n_out, splits, dbpart, st);
  if (err != cudaSuccess) return err;
  return launch_small_reduce<T>(p, e, l, ws, out, n_out, splits, dbpart, db_blocks, st);
}

// Passes 2-5 on the stored activations and e.g_rgb / e.g_den; the summed
// dW/db go to out (output_offsets' layout).
template <class T>
cudaError_t launch_backward(Params p, Extra e, const Layout& l, unsigned char* ws,
                            float* out, long long n_out, int splits, cudaStream_t st) {
  // 2. g-chain (and dX, dD)
  const int blocks = (p.R + p.RB - 1) / p.RB;
  const size_t smem_c = chain_smem<T>(p, e.dx != nullptr);
  cudaError_t err;
  if ((err = set_smem((const void*)chain_kernel<T>, smem_c)) != cudaSuccess) return err;
  chain_kernel<T><<<blocks, kThreads, smem_c, st>>>(p, e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_products<T>(p, e, l, ws, out, n_out, splits, nullptr, 0, st);
}

// The workspace and the Extra block of one backward launch: activations,
// masked g, features and split partials in ws (layout l), cotangents in g_rgb
// / g_den (the workspace's own with own_g).
inline Extra make_extra(unsigned char* ws, const Layout& l, long long N, const void* wt,
                        const void* wtx, float* g_rgb, float* g_den, void* dx, float* dd) {
  Extra e;
  e.pixels = nullptr; e.gsc = nullptr; e.wt = wt; e.wtx = wtx;
  e.acts = ws + l.acts; e.grads = ws + l.grads; e.xs = ws + l.xs;
  e.g_rgb = g_rgb; e.g_den = g_den;
  e.g_ray = reinterpret_cast<float*>(ws + l.g_ray);
  e.dx = dx; e.dd = dd;
  e.N = N;
  return e;
}

}  // namespace
