// The wide route of every kernel in bf16 (render_level.cu, mlp_fwd.cu, and
// the forwards of train_level.cu, train_level_twopass.cu and mlp_bwd.cu):
// net_width a multiple of 32 from 288 up, with no ceiling but the card's
// memory (net_width_condition a multiple of 32 up to net_width), where the
// narrow kernels' activation tiles no longer fit a block (one bf16
// [64, 1024] tile is 128 KB of the 227 KB); below 288 wherever the narrow
// kernels' shared memory does not hold the config (wide location
// features, large heads or many biases: fused_level.takes_wide, the
// dtype's kWideRoute). No kernel here sizes a block or a shared array by a
// width: the GEMMs take any N and K in column blocks and 64-k stages, the
// features go straight to global memory, the per-ray kernels go in
// launches of up to kColumnBlock columns (launch_columns), and the heads
// stage their weights kWideHeadK k-values at a time, a launch for each
// group of 8 channels. The f32 route runs the same
// launch sequence on its own GEMM (wide_f32.cuh), which reuses
// wide_composite_kernel and wide_render_layout here.
//
// Replaces, at these widths, the same TPU kernels as its callers:
// nerf_or_nothing_tpu/kernels/fused_level.py::_render_kernel (render),
// ::_level_kernel and ::_level_kernel_twopass (train; the backward is
// wide_train.cuh), fused_mlp.py::_fwd_kernel (mlp_fwd) and ::_bwd_kernel
// (mlp_bwd, which recomputes the forward).
//
// Bound: the products. One row of a W=1024 layer is 2 x 1024^2 FLOP
// against 4 KB of activations in and out, 512 FLOP a byte, above the
// card's ~295 FLOP/B ridge (at W=512: 256 FLOP/B, near it). So the level
// runs as a sequence of launches on one stream with every activation
// parked in global memory:
//  - wide_features_kernel: the IPE of level_common.cuh's ipe_item (or the
//    features of mode "t"), zero-padded to KX columns;
//  - wide_dir_kernel: the first view layer's direction term d @ W_dir, one
//    f32 row of Wc per ray;
//  - wide_gemm_kernel<BN, kKind> (wide_gemm.cuh), one launch per layer
//    product: out = epilogue(A @ B), A one or two row-major bf16
//    activations (the skip layers' [h | x]), B the layer's slabs of the
//    packed stream; the epilogue is the forward's (direction term, bias,
//    ReLU, round), the g-chain's (round, the density head's term, the mask
//    of the layer below's activation > 0), mlp_bwd's density term over
//    Cd > 1 channels or its dX, written to a separate buffer, so the input
//    stays readable by every column block;
//  - wide_head_kernel<NC>: NC = 1-8 channels of a head as one warp per row
//    (a head of more channels in groups of 8, a launch a group);
//  - render: wide_composite_kernel, level_common.cuh's composite on the
//    raw heads in global memory; mlp_fwd: the heads straight to raw_rgb /
//    raw_den. The rows go in chunks of whole rays (kWideChunkRows), so two
//    activation buffers stay ~0.5 GB at W=1024 whatever R is.
// Every activation goes through HBM; the layer GEMM is the part built for
// speed (persistent blocks, a TMA producer, wide_gemm.cuh).

#pragma once

#include "wide_gemm.cuh"

namespace {

constexpr int kWideMinW = 288;      // narrower widths take the narrow kernels where they fit
constexpr int kWideHeadK = 1024;    // k-values of a head's weights a block stages at once
constexpr long long kWideChunkRows = 1LL << 18;  // render, mlp_fwd: rows of a chunk of rays

// Whether an entry point whose dtype argument is dtype takes the wide
// route: W >= kWideMinW, or kWideRoute added (level_common.cuh); dtype
// then holds the compute type alone (0 or 1).
inline bool wide_route(int& dtype, int W) {
  const bool wide = W >= kWideMinW || (dtype & kWideRoute);
  dtype &= 1;
  return wide;
}

// The heads of wide_forward: none (mlp_bwd's recompute), the level
// kernels' 3 rgb / 1 density into [M, 4], or 1-8 channels each (mlp_fwd).
enum { kWideNoHeads = 0, kWideLevelHeads = 1, kWideAnyHeads = 2 };

// Element offsets of every matrix in pack_params_wg's stream
// (fused_level._layout_wg): trunk layer i (its h slabs, then its x slabs
// for layer 0 and the skip layers), the density head (groups of 8
// channels, each its own slabs of 8 rows), the view layers, the rgb head,
// then the direction rows [Fd, Wc] row-major.
struct WideOffsets {
  std::vector<long long> trunk, view;
  long long den, rgb, dir;
  int nh, nc, nx;
};

inline bool wide_offsets(const Params& p, WideOffsets& o) {
  o.trunk.resize(p.D);
  o.view.resize(p.Dc);
  o.nh = cdiv(p.W, 64);
  o.nc = cdiv(p.Wc, 64);
  o.nx = cdiv(p.KX, 64);
  long long off = 0;
  for (int i = 0; i < p.D; ++i) {
    o.trunk[i] = off;
    off += (long long)((i == 0 ? 0 : o.nh) + ((i == 0 || i % p.skip == 0) ? o.nx : 0)) * p.W * 64;
  }
  o.den = off;     off += (long long)o.nh * head_cols(p.Cd) * 64;
  o.view[0] = off; off += (long long)o.nh * p.Wc * 64;
  for (int j = 1; j < p.Dc; ++j) {
    o.view[j] = off;
    off += (long long)o.nc * p.Wc * 64;
  }
  o.rgb = off;     off += (long long)o.nc * head_cols(p.Cr) * 64;
  o.dir = off;
  return true;
}

// xs[r, :KX] for rows r < rows, the features of level rows row0 + r: the
// IPE of load_features (ipe_item, mode "mv": a thread an item's two
// columns) or the given features (mode "t": a thread a column),
// zero-padded, written straight to global memory, so that no shared
// memory grows with KX. T: the route's activation type (bf16; float on
// wide_f32.cuh's route).
template <class T>
__global__ void __launch_bounds__(kThreads) wide_features_kernel(Params p, T* xs, long long row0,
                                                                 long long rows) {
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  if (p.mode == 0) {
    const int per_row = 3 * p.F, pad = p.KX - 6 * p.F;
    for (long long idx = t0; idx < rows * per_row; idx += step) {
      const long long r = idx / per_row;
      const int rem = (int)(idx - r * per_row), i = rem / 3, a = rem - 3 * i;
      float fs, fc;
      ipe_item(p, (row0 + r) * 3 + a, i, &fs, &fc);
      T* xr = xs + r * p.KX + 6 * i + a;
      xr[0] = from_f<T>(fs);
      xr[3] = from_f<T>(fc);
    }
    for (long long idx = t0; idx < rows * pad; idx += step) {
      const long long r = idx / pad;
      xs[r * p.KX + 6 * p.F + (idx - r * pad)] = from_f<T>(0.0f);
    }
  } else {
    const T* x = static_cast<const T*>(p.x);
    for (long long idx = t0; idx < rows * p.KX; idx += step) {
      const long long r = idx / p.KX;
      const int col = (int)(idx - r * p.KX);
      xs[idx] = col < p.LX ? x[(row0 + r) * p.LX + col] : from_f<T>(0.0f);
    }
  }
}

// dc[r, n] = d[ray0 + r, :] . W_dir[:, n] (compute-type operands, f32 FMA
// in k order), one block of up to kColumnBlock threads a ray, a thread a
// column (launch_columns): the first view layer's direction rows.
template <class T>
__global__ void wide_dir_kernel(Params p, const T* wd, float* dc, int ray0) {
  const int r = blockIdx.x, n = threadIdx.x;
  const T* d = static_cast<const T*>(p.d) + (long long)(ray0 + r) * p.Fd;
  float s = 0.0f;
  for (int k = 0; k < p.Fd; ++k) s = fmaf(to_f(d[k]), to_f(wd[k * p.Wc + n]), s);
  dc[(long long)r * p.Wc + n] = s;
}

// Head weight c at k of the forward stream's head slabs (8 rows a slab,
// fused_level._wg_head; row c's 16-byte chunk q at position q ^ c).
__device__ __forceinline__ float wide_head_w(const bf16* w, int c, int k) {
  return to_f(w[(k >> 6) * kHeadN * 64 + c * 64 + ((((k & 63) >> 3) ^ c) << 3) + (k & 7)]);
}

// out[row * ld + c] = A[row, :K] . w[:, c] + b[c] for c < NC (1-8), one
// warp a row: a head of the forward stream, its columns unswizzled into
// shared memory kWideHeadK k-values at a time. With K up to kWideHeadK
// they are staged once for all the block's rows; above it the block's 8
// warps take 8 rows a round together and stage each chunk in turn, so
// every warp meets each chunk's barriers. Each lane sums its k-values
// (8 lane + 256 i) in ascending order across the chunks (kWideHeadK a
// multiple of 256), then one warp_sum: the same bits at any chunking.
template <int NC>
__global__ void __launch_bounds__(kThreads) wide_head_kernel(const bf16* A, int K, long long M,
                                                             const bf16* w, const float* b,
                                                             float* out, int ld) {
  __shared__ float ws[NC * kWideHeadK];
  const bool once = K <= kWideHeadK;
  auto stage = [&](int kc, int kn) {
    for (int idx = threadIdx.x; idx < NC * kn; idx += kThreads) {
      const int c = idx / kn, k = idx - c * kn;
      ws[c * kWideHeadK + k] = wide_head_w(w, c, kc + k);
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
    const bf16* a = A + row * K;
    float s[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = 0.0f;
    for (int kc = 0; kc < K; kc += kWideHeadK) {
      const int kn = min(kWideHeadK, K - kc);
      if (!once) {
        __syncthreads();  // every warp's reads of the previous chunk are done
        stage(kc, kn);
        __syncthreads();
      }
      for (int k0 = lane * 8; live && k0 < kn; k0 += 256) {
        const uint4 v = *reinterpret_cast<const uint4*>(a + kc + k0);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            s[c] = fmaf(to_f(e[q]), ws[c * kWideHeadK + k0 + q], s[c]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float v = warp_sum(s[c]);
      if (lane == 0) out[row * ld + c] = v + b[c];
    }
  }
}

template <int NC>
inline cudaError_t launch_wide_head(const bf16* A, int K, long long M, const bf16* w,
                                    const float* b, float* out, int ld, cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  const long long want = (M + kThreads / 32 - 1) / (kThreads / 32);
  wide_head_kernel<NC><<<(unsigned)(want < 8192 ? want : 8192), kThreads, 0, st>>>(
      A, K, M, w, b, out, ld);
  return cudaGetLastError();
}

// A head of nc = NC .. 8 channels (mlp_fwd's heads), a template so that
// only the sources that launch it build its eight kernels.
template <int NC = 1>
inline cudaError_t launch_wide_head_n(int nc, const bf16* A, int K, long long M, const bf16* w,
                                      const float* b, float* out, int ld, cudaStream_t st) {
  if constexpr (NC > 8) {
    return cudaErrorInvalidValue;
  } else {
    if (nc == NC) return launch_wide_head<NC>(A, K, M, w, b, out, ld, st);
    return launch_wide_head_n<NC + 1>(nc, A, K, M, w, b, out, ld, st);
  }
}

// Rays ray0 + blockIdx.x * 8 .. of a render chunk whose rows start at ray0:
// composite() on the raw heads [rows, 4] in global memory, one warp a ray.
__global__ void __launch_bounds__(kThreads) wide_composite_kernel(Params p, const float* heads,
                                                                  int ray0, int nr) {
  const int r0 = blockIdx.x * (kThreads / 32);
  Smem<bf16> sm;
  sm.H = nullptr; sm.X = nullptr; sm.DC = nullptr; sm.WS = nullptr;
  sm.OUT = const_cast<float*>(heads) + (long long)r0 * p.S * 4;
  composite<bf16>(p, sm, ray0 + r0, min(kThreads / 32, nr - r0));
}

// The bf16 route's parts of the drivers below (wide_forward,
// launch_forward_wide; wide_train.cuh's launch_train_wide): the layer
// products as wide_gemm_kernel on pack_params_wg's slab stream at
// wide_offsets, the heads from its swizzled head slabs. wide_f32.cuh's
// WideF32Route is the f32 route's.
struct WideBf16Route {
  using T = bf16;
  static constexpr bool kBf16 = true;
  WideOffsets o;
  bool init(const Params& p) { return wide_offsets(p, o); }
  long long trunk_off(const Params&, int i) const { return o.trunk[i]; }
  long long view_off(const Params&, int j) const { return o.view[j]; }
  const bf16* dir(const Params& p) const { return static_cast<const bf16*>(p.w) + o.dir; }
  // out [M, N] = ReLU(a0 @ B + a1 @ B_x + dc + bias), a0 [M, k0], a1 the
  // features of an x layer (or null), B at w_off in the stream (the
  // forward epilogue alone, so the forward kernels build no other).
  cudaError_t fwd(const Params& p, const bf16* a0, int k0, const bf16* a1, int N, long long M,
                  long long w_off, const float* bias, const float* dc, bf16* out,
                  cudaStream_t st) const {
    WideGemm g{};
    g.a0 = a0; g.lda0 = g.ka0 = k0; g.ns0 = cdiv(k0, 64);
    if (a1) { g.a1 = a1; g.lda1 = g.ka1 = p.KX; g.ns1 = o.nx; }
    g.b = static_cast<const bf16*>(p.w) + w_off; g.N = N; g.M = M; g.kind = kWideFwd;
    g.bias = bias; g.S = p.S; g.dc = dc; g.out = out;
    return launch_wide_gemm_mlp<kWideFwd>(WideGemmMlp{g, 1, 0, 0}, st);
  }
  // The rgb head (rgb) or the density head on A [M, K] to out (row stride
  // ld); heads of any width (kWideAnyHeads) a launch a group of kHeadN
  // channels, on the group's slabs and column-offset pointers.
  template <int kHeads>
  cudaError_t head(const Params& p, bool rgb, const bf16* A, long long M, float* out, int ld,
                   cudaStream_t st) const {
    const int K = rgb ? p.Wc : p.W;
    const bf16* w = static_cast<const bf16*>(p.w) + (rgb ? o.rgb : o.den);
    const float* b = p.b + (rgb ? p.b_rgb : p.b_den);
    if constexpr (kHeads == kWideLevelHeads) {
      return rgb ? launch_wide_head<3>(A, K, M, w, b, out, ld, st)
                 : launch_wide_head<1>(A, K, M, w, b, out, ld, st);
    } else {
      const int C = rgb ? p.Cr : p.Cd;
      const long long group = (long long)(rgb ? o.nc : o.nh) * kHeadN * 64;
      for (int c0 = 0; c0 < C; c0 += kHeadN) {
        const cudaError_t err = launch_wide_head_n(C - c0 < kHeadN ? C - c0 : kHeadN, A, K, M,
                                                   w + c0 / kHeadN * group, b + c0, out + c0,
                                                   ld, st);
        if (err != cudaSuccess) return err;
      }
      return cudaSuccess;
    }
  }
};

// The forward's products of rows [0, M) of one batch of rays (the train
// level's whole level, mlp_bwd's recompute, or one chunk of a render or of
// mlp_fwd) on route r (WideBf16Route, or wide_f32.cuh's WideF32Route):
// features in xs [M, KX], the direction term in dc [rays, Wc]; trunk layer
// i writes h(i), view layer j writes v(j) (h, v: the caller's buffers,
// [M, W] / [M, Wc]); kHeads (kWide*Heads): the density head after the
// trunk to den (row stride den_ld) and the rgb head after the view layers
// to rgb (rgb_ld).
template <class Route, int kHeads, class H, class V>
inline cudaError_t wide_forward(const Params& p, const Route& r, const typename Route::T* xs,
                                const float* dc, long long M, H h, V v, float* den, int den_ld,
                                float* rgb, int rgb_ld, cudaStream_t st) {
  cudaError_t err;
  for (int i = 0; i < p.D; ++i) {
    const bool skip = i > 0 && i % p.skip == 0;
    if ((err = r.fwd(p, i == 0 ? xs : h(i - 1), i == 0 ? p.KX : p.W, skip ? xs : nullptr, p.W,
                     M, r.trunk_off(p, i), p.b + (long long)i * p.W, nullptr, h(i), st)) !=
        cudaSuccess)
      return err;
  }
  if constexpr (kHeads != kWideNoHeads) {
    if ((err = r.template head<kHeads>(p, false, h(p.D - 1), M, den, den_ld, st)) != cudaSuccess)
      return err;
  }
  for (int j = 0; j < p.Dc; ++j) {
    if ((err = r.fwd(p, j == 0 ? h(p.D - 1) : v(j - 1), j == 0 ? p.W : p.Wc, nullptr, p.Wc, M,
                     r.view_off(p, j), p.b + p.b_v0 + (long long)j * p.Wc,
                     j == 0 ? dc : nullptr, v(j), st)) != cudaSuccess)
      return err;
  }
  if constexpr (kHeads != kWideNoHeads)
    return r.template head<kHeads>(p, true, v(p.Dc - 1), M, rgb, rgb_ld, st);
  return cudaSuccess;
}

template <class T>
inline cudaError_t launch_wide_features(const Params& p, T* xs, long long row0, long long rows,
                                        cudaStream_t st) {
  if (rows <= 0) return cudaSuccess;
  const long long want = (rows * p.KX + kThreads - 1) / kThreads;
  wide_features_kernel<T><<<(unsigned)(want < (1 << 20) ? want : (1 << 20)), kThreads, 0, st>>>(
      p, xs, row0, rows);
  return cudaGetLastError();
}

// The workspace of the render route and of mlp_fwd's (byte offsets):
// features, two activation buffers and the raw heads of one chunk of rays,
// the direction terms of all rays; esize: bytes of an activation (bf16 2,
// f32 4).
struct WideRenderLayout {
  long long rays, xs, h0, h1, heads, dc, total;
};

inline WideRenderLayout wide_render_layout(int R, int S, int W, int Wc, int KX, int esize) {
  WideRenderLayout l;
  l.rays = kWideChunkRows / S < 1 ? 1 : kWideChunkRows / S;
  if (l.rays > R) l.rays = R;
  const long long rows = l.rays * S;
  long long off = 0;
  l.xs = off;    off += round256(rows * KX * esize);
  l.h0 = off;    off += round256(rows * W * esize);
  l.h1 = off;    off += round256(rows * W * esize);
  l.heads = off; off += round256(rows * 16);
  l.dc = off;    off += round256((long long)R * Wc * 4);
  l.total = off;
  return l;
}

// The forward over chunks of whole rays on route Route: features, the
// layers alternating between two buffers, then kWideLevelHeads (render):
// the heads to the workspace and the composite; kWideAnyHeads (mlp_fwd):
// the heads straight to raw_rgb [R * S, Cr] and raw_den [R * S, Cd].
template <class Route, int kHeads>
inline cudaError_t launch_forward_wide(const Params& p, unsigned char* ws, float* raw_rgb,
                                       float* raw_den, cudaStream_t st) {
  using T = typename Route::T;
  Route r;
  if (!r.init(p)) return cudaErrorInvalidValue;
  const WideRenderLayout l = wide_render_layout(p.R, p.S, p.W, p.Wc, p.KX, sizeof(T));
  T* xs = reinterpret_cast<T*>(ws + l.xs);
  T* buf[2] = {reinterpret_cast<T*>(ws + l.h0), reinterpret_cast<T*>(ws + l.h1)};
  float* heads = reinterpret_cast<float*>(ws + l.heads);
  float* dc = reinterpret_cast<float*>(ws + l.dc);
  cudaError_t err = launch_columns(p.Wc, [&](int n0, int n) {
    wide_dir_kernel<T><<<p.R, n, 0, st>>>(p, r.dir(p) + n0, dc + n0, 0);
  });
  if (err != cudaSuccess) return err;
  // Trunk layer i writes buf[i & 1]; view layer j the other buffer of the
  // one it reads, so the density head still finds h(D - 1).
  const int last = (p.D - 1) & 1;
  auto h = [&](int i) { return buf[i & 1]; };
  auto v = [&](int j) { return buf[(last + 1 + j) & 1]; };
  for (int ray0 = 0; ray0 < p.R; ray0 += (int)l.rays) {
    const int nr = p.R - ray0 < l.rays ? p.R - ray0 : (int)l.rays;
    const long long rows = (long long)nr * p.S, row0 = (long long)ray0 * p.S;
    if ((err = launch_wide_features(p, xs, row0, rows, st)) != cudaSuccess) return err;
    const float* dcc = dc + (long long)ray0 * p.Wc;
    if constexpr (kHeads == kWideLevelHeads) {
      if ((err = wide_forward<Route, kHeads>(p, r, xs, dcc, rows, h, v, heads + 3, 4, heads, 4,
                                             st)) != cudaSuccess)
        return err;
      wide_composite_kernel<<<cdiv(nr, kThreads / 32), kThreads, 0, st>>>(p, heads, ray0, nr);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    } else {
      if ((err = wide_forward<Route, kHeads>(p, r, xs, dcc, rows, h, v, raw_den + row0 * p.Cd,
                                             p.Cd, raw_rgb + row0 * p.Cr, p.Cr, st)) !=
          cudaSuccess)
        return err;
    }
  }
  return cudaSuccess;
}

}  // namespace
