// The MLP backward passes shared by the train-level, two-pass train-level
// and MLP-backward kernels (train_level.cu, train_level_twopass.cu,
// mlp_bwd.cu), and the train level's composite backward (composite_train).
// Given the head cotangents and the activations that the forward stored,
// launch_backward runs:
//  2. chain_kernel (the device function chain_rays, which the two-pass
//     kernel's phase 0 also calls): the g-chain, 64 rows at a time, in
//     the compute type after every product: rgb head, view branch,
//     density head, trunk; each layer's g is masked by its activation > 0
//     and stored; the view layer's per-ray f32 sum g_ray is kept in
//     shared memory (and with a db accumulator, every layer's db). The chain
//     multiplies g by W^T, packed once per step in the same mma fragment
//     order as the forward weights. With dx, the chain also runs into
//     layer 0 and each skip layer's x rows (W^T of the x rows, packed the
//     same way) and accumulates dX in the compute type, the deepest skip
//     layer first and layer 0 last; with dd, each block multiplies its
//     rays' g_ray (rounded) by the view layer's direction rows;
//  3. dw_gemm_*_kernel: dW = act^T g for every layer as a tiled GEMM over
//     the rows (bf16: 128 x 128 output tiles, two cp.async stages,
//     ldmatrix.trans fragments), split over the rows into a fixed number
//     of chunks, with db as column sums of g in the same pass;
//  4. small_tn_kernel: the heads' dW/db from the f32 cotangents and the
//     view layer's direction rows d^T g_ray, 8 warps per 32 outputs;
//  5. reduce_kernel: the split partials summed in a fixed order.
// launch_products runs passes 3-5 alone (the two-pass kernel's phase 1).
// No atomics: every partial is written by exactly one block and reduced in
// order, so two launches on the same inputs give bit-equal dW. f32: the
// same passes with FMA loops (no TF32), for checking the algorithm in f32.

#pragma once

#include "level_common.cuh"

namespace {

constexpr int kGemmThreads = 128;
constexpr int kTM = 64, kTN = 64, kTK = 32;  // dW tile: 64 x 64 outputs, 32 rows a step
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

// H[:, :N] = round(acc) (+ round(sum_k round(gd[row, k]) * wden[k, col]),
// then rounded): the chain product of one layer, in the compute type, with
// the density head's term on the view chain. Call after a barrier.
__device__ __forceinline__ void chain_epilogue(const Params& p, const Smem<bf16>& sm,
                                               const AccBF16& acc, int N, const float* gd,
                                               const bf16* wden) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NTT = N >> 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mi * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (warp + 8 * j < NTT) {
          const int col = (warp + 8 * j) * 8 + 2 * t;
          float v0 = __bfloat162float(__float2bfloat16_rn(acc.v[mi][j][2 * hh]));
          float v1 = __bfloat162float(__float2bfloat16_rn(acc.v[mi][j][2 * hh + 1]));
          if (gd) {
            float t0 = 0.0f, t1 = 0.0f;
            for (int k = 0; k < p.Cd; ++k) {
              const float gr = __bfloat162float(__float2bfloat16_rn(gd[row * p.Cd + k]));
              t0 += gr * __bfloat162float(wden[k * p.W + col]);
              t1 += gr * __bfloat162float(wden[k * p.W + col + 1]);
            }
            v0 += __bfloat162float(__float2bfloat16_rn(t0));
            v1 += __bfloat162float(__float2bfloat16_rn(t1));
          }
          *reinterpret_cast<__nv_bfloat162*>(sm.H + row * p.ldh + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

__device__ __forceinline__ void chain_epilogue(const Params& p, const Smem<float>& sm,
                                               const AccF32& acc, int N, const float* gd,
                                               const float* wden) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int NJ = N >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) {
      if (j < NJ) {
        const int col = tx + 16 * j;
        float v = acc.v[i][j];
        if (gd)
          for (int k = 0; k < p.Cd; ++k) v += gd[row * p.Cd + k] * wden[k * p.W + col];
        sm.H[row * p.ldh + col] = v;
      }
    }
  }
}

// X[:, :KX] = round(X + round(acc)): one term of dX, in the compute type.
__device__ __forceinline__ void dx_epilogue(const Params& p, const Smem<bf16>& sm,
                                            const AccBF16& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NTT = p.KX >> 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mi * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (warp + 8 * j < NTT) {
          const int col = (warp + 8 * j) * 8 + 2 * t;
          __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(sm.X + row * p.ldx + col);
          const float2 cur = __bfloat1622float2(*xp);
          const float v0 = cur.x + __bfloat162float(__float2bfloat16_rn(acc.v[mi][j][2 * hh]));
          const float v1 =
              cur.y + __bfloat162float(__float2bfloat16_rn(acc.v[mi][j][2 * hh + 1]));
          *xp = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

__device__ __forceinline__ void dx_epilogue(const Params& p, const Smem<float>& sm,
                                            const AccF32& acc) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int NJ = p.KX >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j)
      if (j < NJ) sm.X[(4 * ty + i) * p.ldx + tx + 16 * j] += acc.v[i][j];
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

template <class T>
__host__ __device__ inline size_t chain_smem(const Params& p, bool dx) {
  return align16(sizeof(T) * kBM * p.ldh) + (dx ? align16(sizeof(T) * kBM * p.ldx) : 0) +
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

  typename AccOf<T>::type acc;
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
__global__ void __launch_bounds__(kThreads, 2)
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

__device__ __forceinline__ void dw_tile(float (*As)[kTK + 8], float (*Bs)[kTK + 8],
                                        float* acc) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < kTK; ++k) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = As[ty * 8 + i][k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][k];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], b[j], acc[i * 4 + j]);
  }
}

// (row, col) within the 64 x 64 tile of accumulator element e
__device__ __forceinline__ void dw_coord(int e, int* m, int* n) {
  *m = (threadIdx.x >> 4) * 8 + (e >> 2);
  *n = (threadIdx.x & 15) + 16 * (e & 3);
}

__host__ __device__ inline long long split_rows(int K, int splits) {
  return ((long long)(K + splits - 1) / splits + kTK - 1) / kTK * kTK;
}

// f32: 64 x 64 tiles, FMA loops, the tiles stored transposed.
__global__ void __launch_bounds__(kGemmThreads)
dw_gemm_f32_kernel(GemmJobs js) {
  typedef float T;
  __shared__ __align__(16) T As[kTM][kTK + 8];  // As[m][k] = A[k][m0 + m]
  __shared__ __align__(16) T Bs[kTN][kTK + 8];  // Bs[n][k] = B[k][n0 + n]
  const int bid = blockIdx.x, tid = threadIdx.x;
  int jn = 0;
  while (jn + 1 < js.n && bid >= js.job[jn + 1].block0) ++jn;
  const GemmJob jb = js.job[jn];
  const int local = bid - jb.block0;
  const int split = local % js.splits, tile = local / js.splits;
  const int tm = tile % jb.tiles_m, tn = tile / jb.tiles_m;
  const int m0 = tm * kTM, n0 = tn * kTN;
  const long long chunk = split_rows(jb.K, js.splits);
  const long long k_lo = split * chunk;
  const long long k_hi = min((long long)jb.K, k_lo + chunk);
  const T* A = static_cast<const T*>(jb.A);
  const T* B = static_cast<const T*>(jb.B);
  const bool want_db = jb.db_off >= 0 && tm == 0;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float dbs = 0.0f;
  for (long long k0 = k_lo; k0 < k_hi; k0 += kTK) {
    for (int idx = tid; idx < kTK * kTM; idx += kGemmThreads) {
      const int r = idx / kTM, c = idx - r * kTM;
      const bool rv = k0 + r < k_hi;
      As[c][r] = (rv && m0 + c < jb.M) ? A[(k0 + r) * jb.lda + m0 + c] : from_f<T>(0.0f);
      Bs[c][r] = (rv && n0 + c < jb.Nn) ? B[(k0 + r) * jb.ldb + n0 + c] : from_f<T>(0.0f);
    }
    __syncthreads();
    if (want_db && tid < kTN) {
#pragma unroll 8
      for (int r = 0; r < kTK; ++r) dbs += to_f(Bs[tid][r]);
    }
    dw_tile(As, Bs, acc);
    __syncthreads();
  }
  float* part = js.part + split * js.n_out;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int m, n;
    dw_coord(i, &m, &n);
    if (m0 + m < jb.M && n0 + n < jb.Nn)
      part[jb.out_off + (long long)(m0 + m) * jb.out_ld + n0 + n] = acc[i];
  }
  if (want_db && tid < kTN && n0 + tid < jb.Nn) part[jb.db_off + n0 + tid] = dbs;
}

// bf16: 128 x 128 tiles, 8 warps of 64 x 32 outputs; each 32-row stage of
// A[:, m0:] and B[:, n0:] is copied as stored (row-major, 16 bytes a
// thread by cp.async, two stages in flight) and read as mma fragments by
// ldmatrix.trans.
constexpr int kBT = 128, kBK = 32, kBThreads = 256, kBLd = kBT + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Rows [k0, k0 + kBK): 8-column chunks past lda / ldb and rows past k_hi
// are zero-filled.
__device__ __forceinline__ void dw_load(bf16 (*As)[kBLd], bf16 (*Bs)[kBLd], const GemmJob& jb,
                                        const bf16* A, const bf16* B, long long k0,
                                        long long k_hi, int m0, int n0) {
  for (int idx = threadIdx.x; idx < kBK * (kBT / 8); idx += kBThreads) {
    const int r = idx / (kBT / 8), c = (idx - r * (kBT / 8)) * 8;
    const bool rv = k0 + r < k_hi;
    const bool av = rv && m0 + c < jb.lda, bv = rv && n0 + c < jb.ldb;
    cp_async16(&As[r][c], av ? A + (k0 + r) * jb.lda + m0 + c : A, av);
    cp_async16(&Bs[r][c], bv ? B + (k0 + r) * jb.ldb + n0 + c : B, bv);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kBThreads, 2)
dw_gemm_bf16_kernel(GemmJobs js) {
  __shared__ __align__(16) bf16 As[2][kBK][kBLd];
  __shared__ __align__(16) bf16 Bs[2][kBK][kBLd];
  const int bid = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int jn = 0;
  while (jn + 1 < js.n && bid >= js.job[jn + 1].block0) ++jn;
  const GemmJob jb = js.job[jn];
  const int local = bid - jb.block0;
  const int split = local % js.splits, tile = local / js.splits;
  const int tm = tile % jb.tiles_m, tn = tile / jb.tiles_m;
  const int m0 = tm * kBT, n0 = tn * kBT;
  const long long chunk = split_rows(jb.K, js.splits);
  const long long k_lo = split * chunk;
  const long long k_hi = min((long long)jb.K, k_lo + chunk);
  const bf16* A = static_cast<const bf16*>(jb.A);
  const bf16* B = static_cast<const bf16*>(jb.B);
  const bool want_db = jb.db_off >= 0 && tm == 0;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int q = lane >> 3, i8 = lane & 7;

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;
  float dbs = 0.0f;
  const int nk = k_hi > k_lo ? (int)((k_hi - k_lo + kBK - 1) / kBK) : 0;
  if (nk > 0) dw_load(As[0], Bs[0], jb, A, B, k_lo, k_hi, m0, n0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      dw_load(As[st ^ 1], Bs[st ^ 1], jb, A, B, k_lo + (long long)(kt + 1) * kBK, k_hi,
              m0, n0);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (want_db && tid < kBT) {
#pragma unroll 8
      for (int r = 0; r < kBK; ++r) dbs += __bfloat162float(Bs[st][r][tid]);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(a[mi], &As[st][kk + i8 + ((q >> 1) << 3)][wm + mi * 16 + ((q & 1) << 3)]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldmatrix_x4_trans(b[nb], &Bs[st][kk + i8 + ((q & 1) << 3)][wn + nb * 16 + ((q >> 1) << 3)]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint2 bb;
          bb.x = b[nj >> 1][(nj & 1) * 2];
          bb.y = b[nj >> 1][(nj & 1) * 2 + 1];
          mma_bf16(acc[mi][nj], a[mi], bb);
        }
    }
    __syncthreads();
  }
  float* part = js.part + split * js.n_out;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + g + 8 * (e >> 1);
        const int n = n0 + wn + nj * 8 + 2 * t + (e & 1);
        if (m < jb.M && n < jb.Nn)
          part[jb.out_off + (long long)m * jb.out_ld + n] = acc[mi][nj][e];
      }
  if (want_db && tid < kBT && n0 + tid < jb.Nn) part[jb.db_off + n0 + tid] = dbs;
}

// ---- small products: out[a, c] = sum_rows round(A[r, a]) round(B[r, c]) ----
struct SmallJob {
  const void* A;      // [K, lda] compute type, or null: column sums of B
  const float* B;     // [K, ldb] f32
  long long out_off;
  int lda, ldb, KA, NB, K, out_ld, block0, nblk;
};

struct SmallJobs {
  SmallJob job[8];
  float* part;
  long long n_out;
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
    js.part[split * js.n_out + jb.out_off + (long long)a * jb.out_ld + c] = t;
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

inline long long round256(long long n) { return (n + 255) / 256 * 256; }

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
// order), then every bias. w_off / b_off per layer.
inline long long output_offsets(const Params& p, long long* w_off, long long* b_off) {
  const int L = p.D + 2 + p.Dc;
  int fin[64], fout[64];
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
template <class T>
cudaError_t launch_products(Params p, Extra e, const Layout& l, unsigned char* ws,
                            float* out, long long n_out, int splits, const float* dbpart,
                            int db_blocks, cudaStream_t st) {
  const int L = p.D + 2 + p.Dc;
  if (L > 64) return cudaErrorInvalidValue;
  const long long N = e.N;
  const T* acts = reinterpret_cast<const T*>(ws + l.acts);
  const T* grads = reinterpret_cast<const T*>(ws + l.grads);
  cudaError_t err;

  // 3. dW (/ db) GEMMs over the rows
  long long w_off[64], b_off[64];
  output_offsets(p, w_off, b_off);
  float* part = reinterpret_cast<float*>(ws + l.part);
  const T* x = reinterpret_cast<const T*>(ws + l.xs);
  const int ldx = p.KX;
  const int tile = sizeof(T) == 2 ? kBT : kTM;
  GemmJobs gj;
  gj.part = part; gj.n_out = n_out; gj.n = 0; gj.splits = splits;
  int nblocks = 0;
  auto add = [&](const T* A, int lda, const T* B, int ldb, int M, int Nn, long long out_off,
                 int out_ld, long long db_off) {
    GemmJob& j = gj.job[gj.n++];
    j.A = A; j.B = B; j.lda = lda; j.ldb = ldb; j.M = M; j.Nn = Nn; j.K = (int)N;
    j.out_off = out_off; j.out_ld = out_ld; j.db_off = dbpart ? -1 : db_off;
    j.tiles_m = (M + tile - 1) / tile;
    j.block0 = nblocks;
    nblocks += j.tiles_m * ((Nn + tile - 1) / tile) * splits;
  };
  const long long tW = (long long)N * p.W;
  int n_jobs = p.Dc;
  for (int i = 0; i < p.D; ++i) n_jobs += (i > 0 && i % p.skip == 0) ? 2 : 1;
  if (n_jobs > kMaxJobs) return cudaErrorInvalidValue;
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
  if (sizeof(T) == 2)
    dw_gemm_bf16_kernel<<<nblocks, kBThreads, 0, st>>>(gj);
  else
    dw_gemm_f32_kernel<<<nblocks, kGemmThreads, 0, st>>>(gj);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 4. heads, the view layer's direction rows (and db)
  SmallJobs sj;
  sj.part = part; sj.n_out = n_out; sj.n = 0; sj.splits = splits;
  int sblocks = 0;
  auto add_small = [&](const T* A, int lda, const float* B, int ldb, int KA, int NB, int K,
                       long long out_off, int out_ld) {
    SmallJob& j = sj.job[sj.n++];
    j.A = A; j.B = B; j.lda = lda; j.ldb = ldb; j.KA = KA; j.NB = NB; j.K = K;
    j.out_off = out_off; j.out_ld = out_ld;
    j.nblk = ((A ? KA : 1) * NB + 31) / 32;
    j.block0 = sblocks;
    sblocks += j.nblk * splits;
  };
  const T* h_last = acts + (long long)(p.D - 1) * tW;
  const T* v_last = acts + act_off(p, N, p.D + p.Dc - 1);
  add_small(h_last, p.W, e.g_den, p.Cd, p.W, p.Cd, (int)N, w_off[p.D], p.Cd);
  add_small(static_cast<const T*>(p.d), p.Fd, e.g_ray, p.Wc, p.Fd, p.Wc, p.R,
            w_off[p.D + 1] + (long long)p.W * p.Wc, p.Wc);
  add_small(v_last, p.Wc, e.g_rgb, p.Cr, p.Wc, p.Cr, (int)N, w_off[L - 1], p.Cr);
  if (dbpart) {
    const int nb = num_biases(p);
    add_small(nullptr, 0, dbpart, nb, 1, nb, db_blocks, b_off[0], nb);
  } else {
    add_small(nullptr, 0, e.g_den, p.Cd, 1, p.Cd, (int)N, b_off[p.D], p.Cd);
    add_small(nullptr, 0, e.g_rgb, p.Cr, 1, p.Cr, (int)N, b_off[L - 1], p.Cr);
  }
  small_tn_kernel<T><<<sblocks, kSmallThreads, 0, st>>>(sj);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 5. the split partials, summed in order
  const long long rblocks = (n_out + 255) / 256;
  reduce_kernel<<<(int)(rblocks < 4096 ? rblocks : 4096), 256, 0, st>>>(part, out, n_out,
                                                                        splits);
  return cudaGetLastError();
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
