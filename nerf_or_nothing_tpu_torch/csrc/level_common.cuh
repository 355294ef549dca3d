// Device functions shared by the hand-written kernels (render_level.cu,
// train_level.cu, mlp_fwd.cu, mlp_bwd.cu): the kernel parameter block, the
// in-kernel IPE with the polynomial transcendentals of ops/fastmath.py,
// the MLP forward layer (bf16 mma.sync or f32 FMA) and its ReLU epilogue,
// the two heads, the forward of one 64-row sub-tile, and the forward
// composite.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;        // rows per sub-tile
constexpr int kMI = kBM / 16;  // bf16: a warp owns all rows, 4 m16 tiles
constexpr int kMaxNT = 4;      // bf16: n8 tiles warp + 8j per warp (N <= 256)
constexpr int kMaxNJ = 16;     // f32 path: columns per thread (N <= 256)

typedef __nv_bfloat16 bf16;

struct Params {
  const float* means;   // [N, 3] (mode mv)
  const float* vars;    // [N, 3] (mode mv)
  const void* x;        // [N, LX] compute type (mode t)
  const void* d;        // [R, Fd] compute type
  const float* delta;   // [R, S]
  const void* w;        // packed weights, compute type
  const float* b;       // biases, f32, layer order
  float* comp;          // [R, 3]
  float* acc;           // [R]
  float* weights;       // [R, S]
  long long w_den, w_v0_top, w_v0_bot, w_v1, w_rgb;   // element offsets
  int b_den, b_v0, b_rgb;
  int R, S, RB;
  int D, W, skip, Wc, Dc, LX, KX, Fd;
  int min_deg, F, mode, fast, white_bkgd;
  int Cr, Cd;           // head channels: rgb, density
  float density_bias, rgb_padding;
  int ldh, ldx;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---- polynomial transcendentals (ops/fastmath.py), no contraction ----
#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn

__device__ __forceinline__ void fast_sincos(float x, float* s, float* c) {
  float k = floorf(ADD(MUL(x, 0.3183098861837907f), 0.5f));
  float r = SUB(x, MUL(k, 3.140625f));
  r = SUB(r, MUL(k, 9.67502593994140625e-4f));
  r = SUB(r, MUL(k, 1.509957990978376432e-7f));
  float sign = SUB(1.0f, MUL(2.0f, (float)(((int)k) & 1)));
  float r2 = MUL(r, r);
  float p = -2.3889859e-8f;
  p = ADD(MUL(p, r2), 2.7525562e-6f);
  p = ADD(MUL(p, r2), -1.9840874e-4f);
  p = ADD(MUL(p, r2), 8.3333310e-3f);
  p = ADD(MUL(p, r2), -1.6666667e-1f);
  float sp = ADD(r, MUL(r, MUL(r2, p)));
  float q = -2.75573192239858925e-7f;
  q = ADD(MUL(q, r2), 2.48015873015873016e-5f);
  q = ADD(MUL(q, r2), -1.38888888888888894e-3f);
  q = ADD(MUL(q, r2), 4.16666666666666644e-2f);
  q = ADD(MUL(q, r2), -0.5f);
  float cp = ADD(1.0f, MUL(r2, q));
  *s = MUL(sign, sp);
  *c = MUL(sign, cp);
}

__device__ __forceinline__ float fast_exp_neg(float x) {
  float t = MUL(-x, 1.4426950408889634f);
  float tc = fmaxf(t, -126.0f);
  float k = floorf(tc);
  float f = SUB(tc, k);
  float p = 1.54035303933816099e-4f;
  p = ADD(MUL(p, f), 1.33335581464284411e-3f);
  p = ADD(MUL(p, f), 9.61812910762847687e-3f);
  p = ADD(MUL(p, f), 5.55041086648215800e-2f);
  p = ADD(MUL(p, f), 2.40226506959100694e-1f);
  p = ADD(MUL(p, f), 6.93147180559945286e-1f);
  float pow2f = ADD(1.0f, MUL(f, p));
  float pow2k = __int_as_float((((int)k) + 127) << 23);
  float out = MUL(pow2k, pow2f);
  return t < -125.0f ? 0.0f : out;
}

#undef MUL
#undef ADD
#undef SUB

// ---- shared-memory layout ----
template <class T>
struct Smem {
  T* H;       // [kBM, ldh] activations (trunk, then view branch)
  T* X;       // [kBM, ldx] encoded positions
  float* DC;  // [RB, Wc] per-ray d @ W_bot of the first view layer
  float* OUT; // [RB * S, 4] raw r, g, b, density of the block's rows
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <class T>
__host__ __device__ inline size_t smem_bytes(int ldh, int ldx, int RB, int Wc, int S) {
  return align16(sizeof(T) * kBM * ldh) + align16(sizeof(T) * kBM * ldx) +
         align16(sizeof(float) * RB * Wc) + sizeof(float) * RB * S * 4;
}

template <class T>
__device__ Smem<T> carve(unsigned char* base, const Params& p) {
  Smem<T> s;
  size_t off = 0;
  s.H = reinterpret_cast<T*>(base + off);
  off += align16(sizeof(T) * kBM * p.ldh);
  s.X = reinterpret_cast<T*>(base + off);
  off += align16(sizeof(T) * kBM * p.ldx);
  s.DC = reinterpret_cast<float*>(base + off);
  off += align16(sizeof(float) * p.RB * p.Wc);
  s.OUT = reinterpret_cast<float*>(base + off);
  return s;
}

// ---- IPE / feature load into X for rows [grow0, grow0 + nvalid) ----
template <class T>
__device__ void load_features(const Params& p, const Smem<T>& sm, long long grow0,
                              int nvalid) {
  const int tid = threadIdx.x;
  if (p.mode == 0) {
    const int per_row = 3 * p.F;
    for (int idx = tid; idx < kBM * per_row; idx += kThreads) {
      const int row = idx / per_row;
      const int rem = idx - row * per_row;
      const int i = rem / 3;
      const int a = rem - i * 3;
      float fs = 0.0f, fc = 0.0f;
      if (row < nvalid) {
        const long long g = (grow0 + row) * 3 + a;
        const float scale = ldexpf(1.0f, p.min_deg + i);
        const float y = __fmul_rn(p.means[g], scale);
        const float v = __fmul_rn(__fmul_rn(p.vars[g], 0.5f), __fmul_rn(scale, scale));
        float s, c, damp;
        if (p.fast) {
          fast_sincos(y, &s, &c);
          damp = fast_exp_neg(v);
        } else {
          s = sinf(y);
          c = cosf(y);
          damp = expf(-v);
        }
        fs = __fmul_rn(damp, s);
        fc = __fmul_rn(damp, c);
      }
      T* xr = sm.X + row * p.ldx + 6 * i + a;
      xr[0] = from_f<T>(fs);
      xr[3] = from_f<T>(fc);
    }
    const int pad = p.KX - 6 * p.F;
    for (int idx = tid; idx < kBM * pad; idx += kThreads) {
      const int row = idx / pad;
      sm.X[row * p.ldx + 6 * p.F + (idx - row * pad)] = from_f<T>(0.0f);
    }
  } else {
    const T* x = static_cast<const T*>(p.x);
    for (int idx = tid; idx < kBM * p.KX; idx += kThreads) {
      const int row = idx / p.KX;
      const int col = idx - row * p.KX;
      T v = from_f<T>(0.0f);
      if (row < nvalid && col < p.LX) v = x[(grow0 + row) * p.LX + col];
      sm.X[row * p.ldx + col] = v;
    }
  }
}

// ---- one dense layer: acc = [H[:, :kh] | X[:, :kx]] @ Wl ----
// bf16: each warp owns all 64 rows and the n8 column tiles warp + 8j, so
// a weight fragment is read once per 64 rows.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The 16x16 A fragment at p (row-major, 16-byte aligned rows): lanes 0-15
// address rows 0-15 at column 0, lanes 16-31 the same rows at column 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

struct AccBF16 { float v[kMI][kMaxNT][4]; };
struct AccF32 { float v[4][kMaxNJ]; };

__device__ __forceinline__ void gemm(const Params& p, const Smem<bf16>& sm, int kh,
                                     int kx, const bf16* wl, int N, AccBF16& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NTT = N >> 3;
  const int KT = (kh + kx) >> 4;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[mi][j][e] = 0.0f;

  // n8 tile warp + 8j of the fragment-ordered weights; the fragments of
  // step kt+1 load while step kt multiplies.
  const uint2* wl_lane = reinterpret_cast<const uint2*>(wl) + (size_t)warp * KT * 32 + lane;
  uint2 bcur[kMaxNT], bnxt[kMaxNT];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
    if (warp + 8 * j < NTT) bcur[j] = __ldg(wl_lane + (size_t)j * 8 * KT * 32);
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
        if (warp + 8 * j < NTT)
          bnxt[j] = __ldg(wl_lane + ((size_t)j * 8 * KT + kt + 1) * 32);
    }
    const bf16* a0;
    int lda;
    if ((kt << 4) < kh) {
      a0 = sm.H + arow * p.ldh + (kt << 4) + acol; lda = p.ldh;
    } else {
      a0 = sm.X + arow * p.ldx + (kt << 4) - kh + acol; lda = p.ldx;
    }
    uint32_t afr[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) ldmatrix_x4(afr[mi], a0 + mi * 16 * lda);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
        if (warp + 8 * j < NTT) mma_bf16(acc.v[mi][j], afr[mi], bcur[j]);
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) bcur[j] = bnxt[j];
  }
}

// H[:, :N] = round(relu(acc (+ DC[ray]) + bias)); call after a barrier.
__device__ __forceinline__ void epilogue(const Params& p, const Smem<bf16>& sm,
                                         const AccBF16& acc, const float* bias, int N,
                                         const float* dc, int sub0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NTT = N >> 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mi * 16 + g + 8 * hh;
      const float* dcr = nullptr;
      if (dc) dcr = dc + min((sub0 + row) / p.S, p.RB - 1) * p.Wc;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (warp + 8 * j < NTT) {
          const int col = (warp + 8 * j) * 8 + 2 * t;
          float v0 = acc.v[mi][j][2 * hh];
          float v1 = acc.v[mi][j][2 * hh + 1];
          if (dcr) { v0 += dcr[col]; v1 += dcr[col + 1]; }
          v0 = fmaxf(v0 + bias[col], 0.0f);
          v1 = fmaxf(v1 + bias[col + 1], 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(sm.H + row * p.ldh + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// f32: 16 x 16 threads; a thread owns rows 4*ty..4*ty+3, columns tx + 16*j.
__device__ __forceinline__ void gemm(const Params& p, const Smem<float>& sm, int kh,
                                     int kx, const float* wl, int N, AccF32& acc) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int NJ = N >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) acc.v[i][j] = 0.0f;
  const int K = kh + kx;
  for (int k = 0; k < K; ++k) {
    const float* A;
    int lda, kk;
    if (k < kh) {
      A = sm.H; lda = p.ldh; kk = k;
    } else {
      A = sm.X; lda = p.ldx; kk = k - kh;
    }
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * lda + kk];
    const float* wr = wl + (size_t)k * N + tx;
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) {
      if (j < NJ) {
        const float wv = __ldg(wr + 16 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc.v[i][j] = fmaf(a[i], wv, acc.v[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void epilogue(const Params& p, const Smem<float>& sm,
                                         const AccF32& acc, const float* bias, int N,
                                         const float* dc, int sub0) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int NJ = N >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    const float* dcr = nullptr;
    if (dc) dcr = dc + min((sub0 + row) / p.S, p.RB - 1) * p.Wc;
#pragma unroll
    for (int j = 0; j < kMaxNJ; ++j) {
      if (j < NJ) {
        const int col = tx + 16 * j;
        float v = acc.v[i][j];
        if (dcr) v += dcr[col];
        sm.H[row * p.ldh + col] = fmaxf(v + bias[col], 0.0f);
      }
    }
  }
}

template <class T> struct AccOf;
template <> struct AccOf<bf16> { typedef AccBF16 type; };
template <> struct AccOf<float> { typedef AccF32 type; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[row * ld + c] = H[row, :K] . w[c, :K] + b[c] for c < nc
template <class T>
__device__ void head(const Params& p, const Smem<T>& sm, const T* w, const float* b,
                     int K, int nc, float* out, int ld, int nvalid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < nvalid; row += kThreads / 32) {
    const T* h = sm.H + row * p.ldh;
    for (int c = 0; c < nc; ++c) {
      const T* wc = w + c * K;
      float s = 0.0f;
      for (int k = lane; k < K; k += 32) s = fmaf(to_f(h[k]), to_f(wc[k]), s);
      s = warp_sum(s);
      if (lane == 0) out[row * ld + c] = s + b[c];
    }
  }
}

// DC[r, :] = d[ray0 + r, :] @ W_bot of the first view layer, once per
// ray (f32 sum of compute-type products), for the block's nr rays.
template <class T>
__device__ void direction_term(const Params& p, const Smem<T>& sm, int ray0, int nr) {
  const T* d = static_cast<const T*>(p.d);
  const T* wb = static_cast<const T*>(p.w) + p.w_v0_bot;
  for (int idx = threadIdx.x; idx < p.RB * p.Wc; idx += kThreads) {
    const int r = idx / p.Wc, n = idx - r * p.Wc;
    float s = 0.0f;
    if (r < nr) {
      const T* dr = d + (long long)(ray0 + r) * p.Fd;
      for (int k = 0; k < p.Fd; ++k) s = fmaf(to_f(dr[k]), to_f(wb[k * p.Wc + n]), s);
    }
    sm.DC[idx] = s;
  }
}

__host__ __device__ inline long long act_off(const Params& p, long long N, int layer) {
  // trunk layer i < D at i * N * W; view layer j at D * N * W + j * N * Wc
  return layer < p.D ? (long long)layer * N * p.W
                     : (long long)p.D * N * p.W + (long long)(layer - p.D) * N * p.Wc;
}

// rows [0, nvalid) of a shared tile -> dst rows grow0.., 16 bytes a thread
template <class T>
__device__ void store_rows(const T* src, int ld, int width, T* dst, long long grow0,
                           int nvalid) {
  constexpr int vec = 16 / sizeof(T);
  const int per_row = width / vec;
  for (int idx = threadIdx.x; idx < nvalid * per_row; idx += kThreads) {
    const int row = idx / per_row, c = idx - row * per_row;
    *reinterpret_cast<uint4*>(dst + (grow0 + row) * width + c * vec) =
        *reinterpret_cast<const uint4*>(src + row * ld + c * vec);
  }
}

// The MLP forward of one sub-tile of rows [grow0, grow0 + nvalid): the
// features into X, the trunk (layer 0 reads X, skip layers [H | X], the
// rest H), the density head, the view branch (its first layer adds DC of
// the row's ray) and the rgb head; ends with a barrier. Head outputs go to
// den / rgb (row stride den_ld / rgb_ld) unless null. kStore: the
// features (padded to KX) go to xs and every layer's activations to
// acts + act_off (N rows per layer).
template <class T, bool kStore>
__device__ void forward_tile(const Params& p, const Smem<T>& sm, int sub0, int nvalid,
                             long long grow0, float* den, int den_ld, float* rgb,
                             int rgb_ld, T* xs, T* acts, long long N) {
  const T* w = static_cast<const T*>(p.w);
  load_features<T>(p, sm, grow0, nvalid);
  __syncthreads();
  if (kStore) store_rows<T>(sm.X, p.ldx, p.KX, xs, grow0, nvalid);

  typename AccOf<T>::type acc;
  const T* wl = w;
  const float* bl = p.b;
  for (int i = 0; i < p.D; ++i) {
    const int kh = i == 0 ? 0 : p.W;
    const int kx = (i == 0 || i % p.skip == 0) ? p.KX : 0;
    gemm(p, sm, kh, kx, wl, p.W, acc);
    __syncthreads();
    epilogue(p, sm, acc, bl, p.W, nullptr, sub0);
    __syncthreads();
    if (kStore) store_rows<T>(sm.H, p.ldh, p.W, acts + act_off(p, N, i), grow0, nvalid);
    wl += (long long)(kh + kx) * p.W;
    bl += p.W;
  }

  if (den) head<T>(p, sm, w + p.w_den, p.b + p.b_den, p.W, p.Cd, den, den_ld, nvalid);
  for (int j = 0; j < p.Dc; ++j) {
    const T* wv = j == 0 ? w + p.w_v0_top : w + p.w_v1 + (long long)(j - 1) * p.Wc * p.Wc;
    gemm(p, sm, j == 0 ? p.W : p.Wc, 0, wv, p.Wc, acc);
    __syncthreads();
    epilogue(p, sm, acc, p.b + p.b_v0 + j * p.Wc, p.Wc, j == 0 ? sm.DC : nullptr, sub0);
    __syncthreads();
    if (kStore)
      store_rows<T>(sm.H, p.ldh, p.Wc, acts + act_off(p, N, p.D + j), grow0, nvalid);
  }
  if (rgb) head<T>(p, sm, w + p.w_rgb, p.b + p.b_rgb, p.Wc, p.Cr, rgb, rgb_ld, nvalid);
  __syncthreads();
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// One warp per ray: activations, exclusive transmittance scan, outputs.
template <class T>
__device__ void composite(const Params& p, const Smem<T>& sm, int ray0, int nr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float pad = p.rgb_padding;
  for (int r = warp; r < nr; r += kThreads / 32) {
    const long long ray = ray0 + r;
    float carry = 0.0f, a_acc = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    for (int s0 = 0; s0 < p.S; s0 += 32) {
      const int s = s0 + lane;
      const bool valid = s < p.S;
      float sd = 0.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
      if (valid) {
        const float* o = sm.OUT + (r * p.S + s) * 4;
        const float sigma = softplus(o[3] + p.density_bias);
        sd = sigma * p.delta[ray * p.S + s];
        rr = sigmoid(o[0]) * (1.0f + 2.0f * pad) - pad;
        rg = sigmoid(o[1]) * (1.0f + 2.0f * pad) - pad;
        rb = sigmoid(o[2]) * (1.0f + 2.0f * pad) - pad;
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
      if (valid) p.weights[ray * p.S + s] = w;
      a_acc += w;
      cr += w * rr;
      cg += w * rg;
      cb += w * rb;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    a_acc = warp_sum(a_acc);
    cr = warp_sum(cr);
    cg = warp_sum(cg);
    cb = warp_sum(cb);
    if (lane == 0) {
      const float bg = p.white_bkgd ? 1.0f - a_acc : 0.0f;
      p.comp[ray * 3 + 0] = cr + bg;
      p.comp[ray * 3 + 1] = cg + bg;
      p.comp[ray * 3 + 2] = cb + bg;
      p.acc[ray] = a_acc;
    }
  }
}

// The kernel parameters of one level (weight offsets of pack_params'
// layout, row strides of the shared-memory tiles); false for widths the
// kernels do not take: W, Wc multiples of 32 up to 256, Wc <= W, KX a
// multiple of 16 >= LX, LX = 6F in mode "mv", heads of 1-8 channels.
// dtype: 0 = float32, 1 = bfloat16; mode: 0 = "mv" (IPE in the kernel),
// 1 = "t" (features).
inline bool init_params(Params& p, int dtype, int mode, const float* means,
                        const float* vars, const void* x, const void* d,
                        const float* delta, const void* w, const float* b, int R, int S,
                        int D, int W, int skip, int Wc, int Dc, int LX, int KX, int Fd,
                        int min_deg, int fast, float density_bias, float rgb_padding,
                        int white_bkgd, int Cr = 3, int Cd = 1) {
  if (W % 32 || Wc % 32 || W > 256 || Wc > 256 || Wc > W || KX % 16 || KX < LX ||
      D < 1 || Dc < 1 || skip < 1 || S < 1 || (mode == 0 && 6 * (LX / 6) != LX) ||
      Cr < 1 || Cr > 8 || Cd < 1 || Cd > 8)
    return false;
  p.means = means; p.vars = vars; p.x = x; p.d = d; p.delta = delta;
  p.w = w; p.b = b; p.comp = nullptr; p.acc = nullptr; p.weights = nullptr;
  long long off = 0;
  for (int i = 0; i < D; ++i) {
    const int K = (i == 0 ? 0 : W) + ((i == 0 || i % skip == 0) ? KX : 0);
    off += (long long)K * W;
  }
  p.w_den = off;      off += (long long)Cd * W;
  p.w_v0_top = off;   off += (long long)W * Wc;
  p.w_v0_bot = off;   off += (long long)Fd * Wc;
  p.w_v1 = off;       off += (long long)(Dc - 1) * Wc * Wc;
  p.w_rgb = off;
  p.b_den = D * W;
  p.b_v0 = p.b_den + Cd;
  p.b_rgb = p.b_v0 + Dc * Wc;
  p.R = R; p.S = S; p.RB = S >= kBM ? 1 : kBM / S;
  p.D = D; p.W = W; p.skip = skip; p.Wc = Wc; p.Dc = Dc; p.LX = LX; p.KX = KX; p.Fd = Fd;
  p.min_deg = min_deg; p.F = LX / 6; p.mode = mode; p.fast = fast;
  p.Cr = Cr; p.Cd = Cd;
  p.white_bkgd = white_bkgd; p.density_bias = density_bias; p.rgb_padding = rgb_padding;
  p.ldh = W + (dtype == 1 ? 8 : 4);
  p.ldx = KX + (dtype == 1 ? 8 : 4);
  return true;
}

}  // namespace
