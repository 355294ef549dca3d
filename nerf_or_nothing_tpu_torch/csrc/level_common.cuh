// Device functions shared by the hand-written kernels (render_level.cu,
// train_level.cu, mlp_fwd.cu, mlp_bwd.cu): the kernel parameter block, the
// in-kernel IPE with the polynomial transcendentals of ops/fastmath.py,
// and the f32 instantiations' forward: the MLP layer product on the
// tensor cores as three TF32 passes (gemm: 3xTF32 mma.sync, the weights
// staged in shared memory by cp.async) and its ReLU epilogue, the two
// heads, the forward of one 64-row sub-tile, the forward composite. The
// bf16 routes run forward_wg.cuh and train_wg.cuh.
//
// 3xTF32: an f32 operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (10 explicit mantissa bits each), and a product
// a * b is taken as a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, the two small
// terms first, f32 sums; a_lo * b_lo (~2^-22 of |a b|) is dropped. Each
// term's product is exact (11 x 11 significant bits), so a product is off
// by at most ~3 x 2^-22 of |a b| before the f32 sums, where one TF32 pass
// is off by ~2^-11; ops/math_utils.dense_3xtf32 is its plain model. The
// tensor core truncates its sums, so the three passes of one k-step start
// from zero and their partial sum is added to the f32 accumulator with a
// round-to-nearest add (every 32 rows in the dW GEMM): accumulated in the
// mma over a whole layer, the truncation's bias moves pre-activations far
// enough to flip ReLU masks against the plain version, and so dW; summed
// this way, the f32 routes agree with the plain version about as closely
// as FMA loops.
// Dense TF32 runs at 495 TFLOP/s on an H100 SXM (wgmma), so the three
// passes (165 TFLOP/s of f32 work) are above the 67 TFLOP/s of f32 FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;        // rows per sub-tile
constexpr int kMaxNT = 8;      // f32 path: n8 tiles of a warp (N <= 256)
constexpr int kWK = 8;         // f32 path: K rows of a staged weight tile (one mma k-step)
// f32 kernels: two blocks an SM (their tiles fit twice in shared memory at
// 128 registers a thread); one block an SM with deeper weight rings ran
// slower on the card.
constexpr int kF32Blocks = 2;

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
  float* WS;  // f32: two staged weight tiles [kWK, wtile_ld(N)] (gemm)
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Workspace areas start at multiples of 256 bytes.
inline long long round256(long long n) { return (n + 255) / 256 * 256; }

// The per-ray kernels that run a thread a column of a row of Wc columns
// (wide_dir_kernel, g_ray_kernel, g_ray_f32_kernel; one block a ray) go
// in launches of up to kColumnBlock columns, the most threads a block may
// have: launch(n0, n) launches columns n0 to n0 + n - 1 on pointers offset
// by n0 (the row stride stays Wc), so each column's sum is the same at any
// Wc, and up to Wc = 1024 it is one launch, as before.
constexpr int kColumnBlock = 1024;
template <class F>
inline cudaError_t launch_columns(int Wc, F launch) {
  for (int n0 = 0; n0 < Wc; n0 += kColumnBlock) {
    launch(n0, Wc - n0 < kColumnBlock ? Wc - n0 : kColumnBlock);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Row stride (floats) of a staged [kWK, N] weight tile: N rounded up to 32,
// plus 8, so that the B fragments' 4 rows x 8 columns hit 32 banks.
__host__ __device__ inline int wtile_ld(int N) { return (N + 31) / 32 * 32 + 8; }

// Bytes of gemm's two staged weight tiles for products of up to N columns.
__host__ __device__ inline size_t wstage_bytes(int N) {
  return sizeof(float) * 2 * kWK * wtile_ld(N);
}

// The f32 kernels' tiles: H, X, DC, OUT (S rows a ray; 0: none), then the
// staged weights (carve's layout).
template <class T>
__host__ __device__ inline size_t smem_bytes(const Params& p, int S) {
  return align16(sizeof(T) * kBM * p.ldh) + align16(sizeof(T) * kBM * p.ldx) +
         align16(sizeof(float) * p.RB * p.Wc) + align16(sizeof(float) * p.RB * S * 4) +
         wstage_bytes(p.W);
}

template <class T>
__device__ Smem<T> carve(unsigned char* base, const Params& p, int S) {
  Smem<T> s;
  size_t off = 0;
  s.H = reinterpret_cast<T*>(base + off);
  off += align16(sizeof(T) * kBM * p.ldh);
  s.X = reinterpret_cast<T*>(base + off);
  off += align16(sizeof(T) * kBM * p.ldx);
  s.DC = reinterpret_cast<float*>(base + off);
  off += align16(sizeof(float) * p.RB * p.Wc);
  s.OUT = reinterpret_cast<float*>(base + off);
  off += align16(sizeof(float) * p.RB * S * 4);
  s.WS = reinterpret_cast<float*>(base + off);
  return s;
}

// The IPE of coordinate g (row * 3 + axis) at frequency i: the damped
// sine and cosine, columns 6i + axis and 6i + axis + 3 of the row.
__device__ __forceinline__ void ipe_item(const Params& p, long long g, int i, float* fs,
                                         float* fc) {
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
  *fs = __fmul_rn(damp, s);
  *fc = __fmul_rn(damp, c);
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
      if (row < nvalid) ipe_item(p, (grow0 + row) * 3 + a, i, &fs, &fc);
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

// 16 bytes from global to shared memory (zeros with !pred, gmem then not
// read); gemm's weight tiles, the f32 dW tiles and train_wg.cuh's stages.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's cp.async groups.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- 3xTF32 on mma.sync.m16n8k8 ----
// x -> (hi, lo) TF32 bit patterns, hi = rna(x), lo = rna(x - hi).
// hi by cvt.rna (inf and NaN stay non-finite, so a NaN input reaches the
// products); for finite x, x - hi is finite and at most 2^-11 |x|, so its
// rna is two integer operations on the bit pattern (the 13 low bits
// rounded off, ties away from zero), bit-equal to cvt.rna and faster on
// the card than a second cvt. Rounding hi the integer way too would turn
// the card's NaN (0x7FFFFFFF) into -0 and hide it from dW.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// d += a b for one m16n8k8 TF32 tile, f32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three passes: a_lo b_hi, a_hi b_lo, then a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi, const uint32_t* alo,
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// The A fragment of rows r, r + 8 and columns c, c + 4 of a row-major
// f32 tile (lane: r = row0 + lane / 4, c = col0 + lane % 4), split.
__device__ __forceinline__ void load_a_split(const float* a, int lda, uint32_t* hi,
                                             uint32_t* lo) {
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[8 * lda], hi[1], lo[1]);
  split_tf32(a[4], hi[2], lo[2]);
  split_tf32(a[8 * lda + 4], hi[3], lo[3]);
}

// ---- one dense layer: acc = [H[:, :kh] | X[:, :kx]] @ Wl ----
// 8 warps over the 64 x N product: warp w owns rows 32 (w & 1) .. + 32
// (two m16 tiles) and columns (w >> 1) warp_cols(N) .. + warp_cols(N) (up to
// kMaxNT n8 tiles); acc.v[mt][nt] is the m16n8 accumulator fragment.
struct AccF32 { float v[2][kMaxNT][4]; };

__device__ __forceinline__ int warp_cols(int N) { return (N + 31) / 32 * 8; }

// Whether n8 fragment nt of this thread's warp holds columns < N.
__device__ __forceinline__ bool frag_valid(int N, int nt) {
  const int wc = warp_cols(N);
  return 8 * nt < wc && (threadIdx.x >> 6) * wc + 8 * nt < N;
}

// Row and column of accumulator element e of fragment (mt, nt) in this
// thread (c0 from acc_col0).
__device__ __forceinline__ int acc_row(int mt, int e) {
  return ((threadIdx.x >> 5) & 1) * 32 + mt * 16 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}

__device__ __forceinline__ int acc_col0(int N) {
  return (threadIdx.x >> 6) * warp_cols(N) + 2 * (threadIdx.x & 3);
}

// Stage weight rows [k0, k0 + kWK) of wl [K, N] into ws (row stride ldw).
__device__ __forceinline__ void stage_weights(float* ws, const float* wl, int k0, int N,
                                              int ldw) {
  const int per_row = N >> 2;
  for (int idx = threadIdx.x; idx < kWK * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx - r * per_row) << 2;
    cp_async16(ws + r * ldw + c, wl + (size_t)(k0 + r) * N + c, true);
  }
}

// gemm's product with NT n8 fragments a warp, all of them valid (the full
// width, N = 32 NT), or with NT = 0 the fragments of warp_cols(N) that
// hold columns < N (a branch between the fragments, which the full width
// avoids: it ran slower on the card).
template <int NT>
__device__ __forceinline__ void gemm_nt(const Params& p, const Smem<float>& sm, int kh,
                                        int kx, const float* wl, int N, AccF32& acc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ldw = wtile_ld(N);
  const int row0 = ((threadIdx.x >> 5) & 1) * 32 + g;
  const int col0 = (threadIdx.x >> 6) * warp_cols(N);
  const int nk = (kh + kx) / kWK;
  __syncthreads();
  stage_weights(sm.WS, wl, 0, N, ldw);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk)
      stage_weights(sm.WS + ((kt + 1) & 1) * kWK * ldw, wl, (kt + 1) * kWK, N, ldw);
    cp_async_commit();
    const int k0 = kt * kWK;
    const float* A;
    int lda;
    if (k0 < kh) {
      A = sm.H + k0; lda = p.ldh;
    } else {
      A = sm.X + (k0 - kh); lda = p.ldx;
    }
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      load_a_split(A + (row0 + 16 * mt) * lda + t, lda, ahi[mt], alo[mt]);
    const float* B = sm.WS + (kt & 1) * kWK * ldw + t * ldw + col0 + g;
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt) {
      if (NT ? nt < NT : frag_valid(N, nt)) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(B[8 * nt], bh0, bl0);
        split_tf32(B[4 * ldw + 8 * nt], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_3xtf32(part, ahi[mt], alo[mt], bh0, bh1, bl0, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc.v[mt][nt][e] += part[e];
        }
      }
    }
  }
}

// Starts with a barrier (the previous product's readers of the staged
// weights are done; the caller's writes of H / X are visible) and leaves
// the staged tiles to the next call's barrier. K = kh + kx is a multiple
// of kWK, kh of 32; N a multiple of 16 (W, Wc, KX). The weight tile of the
// next kWK rows loads (cp.async) while this one multiplies.
__device__ __forceinline__ void gemm(const Params& p, const Smem<float>& sm, int kh,
                                     int kx, const float* wl, int N, AccF32& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[mt][nt][e] = 0.0f;
  if (warp_cols(N) == 8 * kMaxNT)
    gemm_nt<kMaxNT>(p, sm, kh, kx, wl, N, acc);
  else
    gemm_nt<0>(p, sm, kh, kx, wl, N, acc);
}

__device__ __forceinline__ void epilogue(const Params& p, const Smem<float>& sm,
                                         const AccF32& acc, const float* bias, int N,
                                         const float* dc, int sub0) {
  const int c0 = acc_col0(N);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = acc_row(mt, 2 * h);
      const float* dcr = nullptr;
      if (dc) dcr = dc + min((sub0 + row) / p.S, p.RB - 1) * p.Wc;
#pragma unroll
      for (int nt = 0; nt < kMaxNT; ++nt) {
        if (frag_valid(N, nt)) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = c0 + 8 * nt + j;
            float v = acc.v[mt][nt][2 * h + j];
            if (dcr) v += dcr[col];
            sm.H[row * p.ldh + col] = fmaxf(v + bias[col], 0.0f);
          }
        }
      }
    }
}

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

  AccF32 acc;
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

// The dtype argument of the entry points: 0 = float32, 1 = bfloat16, plus
// kWideRoute for the wide route below kWideMinW (fused_level.route_code:
// where the narrow kernels' shared memory does not hold the config).
constexpr int kWideRoute = 2;

// The kernel parameters of one level (weight offsets of pack_params'
// layout, row strides of the shared-memory tiles); false for widths the
// kernels do not take: W, Wc multiples of 32 up to 256 (with wide, any
// W: every kernel's wide route), Wc <= W, KX a multiple of 16 >= LX,
// LX = 6F in mode "mv", heads of at least 1 channel.
// dtype: 0 = float32, 1 = bfloat16; mode: 0 = "mv" (IPE in the kernel),
// 1 = "t" (features).
inline bool init_params(Params& p, int dtype, int mode, const float* means,
                        const float* vars, const void* x, const void* d,
                        const float* delta, const void* w, const float* b, int R, int S,
                        int D, int W, int skip, int Wc, int Dc, int LX, int KX, int Fd,
                        int min_deg, int fast, float density_bias, float rgb_padding,
                        int white_bkgd, int Cr = 3, int Cd = 1, bool wide = false) {
  if (W % 32 || Wc % 32 || (!wide && W > 256) || Wc > W || KX % 16 ||
      KX < LX ||
      D < 1 || Dc < 1 || skip < 1 || S < 1 || (mode == 0 && 6 * (LX / 6) != LX) ||
      Cr < 1 || Cd < 1)
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
