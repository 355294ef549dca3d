"""The f32 wide route of every kernel (net_width 288-1024 in f32:
``csrc/wide_f32.cuh`` and ``csrc/wide_train.cuh``'s f32 passes) on the
CPU:

- a Python model of the f32 wide kernels' reads of their streams:
  ``pack_params_wf`` (``pack_params``' layout at ``init_params``' offsets
  for the heads' transposed rows and the direction rows, then the forward
  products' slabs at ``WideF32Route``'s offsets, hi's copy then lo's),
  ``pack_params_wft`` at ``wt_off`` and ``pack_params_wfx`` at
  ``wtx_off``; every layer product as ``wide_gemm_f32_kernel`` takes it (A
  zero-padded to stages of 32 k-values per part and split into TF32 hi /
  lo, B's hi / lo slabs unswizzled, column blocks of 128, each
  k8 step's three passes lo·hi + hi·lo + hi·hi summed, then added to the
  f32 sums in k order), run as a forward, a g-chain (the density term over
  Cd channels from ``pack_params``' W_den rows), dX (deepest x layer
  first) and dD at net_width 288 (a partial column block) and 512 (two
  skip layers, two view layers), against ``mlp_forward_acts`` /
  ``mlp_backward_plain``;
- the packers' slab streams (``pack_params_wf``, ``_wft``, ``_wfx``):
  hi is ``ops/math_utils.tf32_round`` of the weights, hi + lo rebuilds
  them within 2^-22 of |w|, a NaN stays a NaN, the padding is exact
  zeros; which packing each launch gets (``f32_slabs``, ``repack_f32``);
  ``kernels/wide_gemm.py``'s f32 GEMM case read the kernel's way against
  ``wide_gemm_f32_plain``;
- the guards: f32 at 260, 288, 512, 1024 and 400 / 200 passes every
  route's config checks (``uses_wide`` true, each wrapper gets to its
  device check on CPU tensors);
- the reference the card holds this route to (``utils/parity.py``'s
  ``reference_products``: the plain versions with f64 layer products, for
  f32 on the wide route only), and the card test's MLP whose forward
  every f32 computation takes exactly
  (``test_torch_kernel_cuda.exact_forward_inputs``).

The split products of the plain train and render levels at 288 and 512
against JAX's interpreted kernels are ``tests/test_torch_tf32_split.py``'s
``wide_*`` cases; the kernels themselves are held against the plain
versions on a card (``test_torch_kernel_cuda.py -k wide``, and
``chip_smoke.py``'s ``wide_f32`` phase).

Config: depth 3, skip at 2, net_width_condition 128, S=8, R=4, inputs made
with numpy from a seed. Tolerance: the f32 parity band (1e-6, 1e-3) of
``nerf_or_nothing_tpu/utils/parity.py`` as a normalized error < 1.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_kernel_cuda import WIDE as CARD_WIDE  # noqa: E402
from test_torch_kernel_cuda import exact_forward_inputs  # noqa: E402
from test_torch_wide import WIDE, close, refused_routes  # noqa: E402

from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import wide_gemm as wg  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import math_utils as mu  # noqa: E402
from nerf_or_nothing_tpu_torch.utils import parity  # noqa: E402

BK = fl.F32_SLAB_K  # wide_gemm_f32_kernel's k-stage: 32 k-values of A and B
K8 = 8  # a k-step: three TF32 passes summed, then added to the f32 sums


def f32_offsets(cfg):
    """``csrc/level_common.cuh::init_params``: element offsets of each
    matrix in ``pack_params``' f32 layout, the stream's length, and the
    bias offsets."""
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    kx = fl.padded_location_features(cfg)
    o = {"trunk": []}
    off = 0
    for i in range(D):
        o["trunk"].append(off)
        off += ((0 if i == 0 else W)
                + (kx if i == 0 or i % cfg.skip_layer == 0 else 0)) * W
    o["den"] = off
    off += cfg.num_density_channels * W
    o["v0_top"] = off
    off += W * Wc
    o["v0_bot"] = off
    off += cfg.direction_features * Wc
    o["v1"] = off
    off += (Dc - 1) * Wc * Wc
    o["rgb"] = off
    o["end"] = off + cfg.num_rgb_channels * Wc
    o["b_den"] = D * W
    o["b_v0"] = o["b_den"] + cfg.num_density_channels
    o["b_rgb"] = o["b_v0"] + Dc * Wc
    return o


def wt_off(cfg, layer):
    """``csrc/level_backward.cuh::wt_off``: W^T of trunk layer i >= 1
    [W, W], of the first view layer's h rows [Wc, W], of view layer j >= 1
    [Wc, Wc] in ``pack_params_t``."""
    D, W, Wc = cfg.net_depth, cfg.net_width, cfg.net_width_condition
    if layer < D:
        return (layer - 1) * W * W
    j = layer - D
    v0 = (D - 1) * W * W
    return v0 if j == 0 else v0 + W * Wc + (j - 1) * Wc * Wc


def wtx_off(cfg, layer):
    """``csrc/level_backward.cuh::wtx_off``: W_x^T [W, KX] of layer 0 and of
    each skip layer in ``pack_params_tx``."""
    return ((layer // cfg.skip_layer) * cfg.net_width
            * fl.padded_location_features(cfg))


def wf_offsets(cfg):
    """``csrc/wide_f32.cuh::WideF32Route::init``: element offsets of each
    forward product's slabs in one copy (hi or lo) of ``pack_params_wf``'s
    streams, and the copy's length."""
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    nh, nc = -(-W // BK), -(-Wc // BK)
    nx = -(-fl.padded_location_features(cfg) // BK)
    o = {"trunk": [], "view": []}
    off = 0
    for i in range(D):
        o["trunk"].append(off)
        off += ((0 if i == 0 else nh)
                + (nx if i == 0 or i % cfg.skip_layer == 0 else 0)) * W * BK
    o["view"].append(off)
    off += nh * Wc * BK
    for _ in range(1, Dc):
        o["view"].append(off)
        off += nc * Wc * BK
    o["len"] = off
    return o


def unslab(stream, off, ns, N):
    """B [ns * 32, N] from ``ns`` slabs at ``off`` as the kernel reads them:
    slab s, row n holds k-values 32 s .. 32 s + 31 of column n, its
    16-byte chunk c at position c ^ (n % 8)."""
    t = stream[off:off + ns * N * BK].view(ns, N, 8, BK // 8)
    n = torch.arange(N)[:, None]
    t = t[:, n, torch.arange(8)[None, :] ^ (n % 8)]  # [slab, n, chunk, e]
    return t.reshape(ns, N, BK).permute(0, 2, 1).reshape(ns * BK, N)


def k8_sums(A, Bh, Bl):
    """A @ B as ``wide_gemm_f32_kernel`` sums it: A split into TF32 hi / lo
    (``split_tf32``, as the consumers split it), each k8 step's
    lo·hi + hi·lo + hi·hi exact (f64) and rounded to f32, then added to the
    f32 sums in k order."""
    a_hi, a_lo = (t.double() for t in mu.split_tf32(A))
    Bh, Bl = Bh.double(), Bl.double()
    M, N = A.shape[0], Bh.shape[1]
    acc = torch.zeros(M, N)
    steps = A.shape[1] // K8
    for s0 in range(0, steps, 64):
        k = slice(s0 * K8, min(steps, s0 + 64) * K8)
        ah, al = (t[:, k].reshape(M, -1, K8) for t in (a_hi, a_lo))
        bh, bl = (t[k].reshape(-1, K8, N) for t in (Bh, Bl))
        part = (torch.einsum("msk,skn->smn", al, bh)
                + torch.einsum("msk,skn->smn", ah, bl)
                + torch.einsum("msk,skn->smn", ah, bh)).float()
        for p in part:
            acc = acc + p
    return acc


def gemm(parts, hi, lo, off, N):
    """``wide_gemm_f32_kernel``'s product: A the parts side by side, each
    zero-padded to whole stages of ``BK`` columns; B hi and lo the streams'
    slabs at ``off`` (each part's in order), in column blocks of
    ``F32_BN``; sums as ``k8_sums``."""
    a_cols, b_hi, b_lo = [], [], []
    for a in parts:
        ka = a.shape[1]
        ns = -(-ka // BK)
        ap = torch.zeros(a.shape[0], ns * BK)
        ap[:, :ka] = a
        a_cols.append(ap)
        b_hi.append(unslab(hi, off, ns, N))
        b_lo.append(unslab(lo, off, ns, N))
        off += ns * N * BK
    A, Bh, Bl = torch.cat(a_cols, 1), torch.cat(b_hi), torch.cat(b_lo)
    bn = wg.F32_BN
    return torch.cat([k8_sums(A, Bh[:, n0:n0 + bn], Bl[:, n0:n0 + bn])
                      for n0 in range(0, N, bn)], 1)


def head(a, stream, off, K, C):
    """``wide_head_f32_kernel``'s head without its bias: a @ the
    transposed rows [C, K] at ``off``, f32 sums."""
    return (a.double() @ stream[off:off + C * K].view(C, K).double().t()
            ).float()


def wide_f32_model(params, cfg, x, d, R, S, g_rgb, g_den):
    """The f32 wide route written from its kernels' reads. Returns
    (raw_rgb, raw_den, activations, masked g by layer index, d_params as
    ``mlp_backward_plain`` gives them, dX, dD)."""
    dt = torch.float32
    wf, b = fl.pack_params_wf(params, cfg, dt)
    wft = fl.pack_params_wft(params, cfg, dt)
    wfx = fl.pack_params_wfx(params, cfg, dt)
    o, so = f32_offsets(cfg), wf_offsets(cfg)
    w = wf[:o["end"]]  # pack_params' layout: the heads, the direction rows
    assert wf.numel() == o["end"] + 2 * so["len"] == fl.packed_wf_size(cfg)
    hi, lo = wf[o["end"]:o["end"] + so["len"]], wf[o["end"] + so["len"]:]
    T, TX = fl.packed_t_size(cfg), fl.packed_tx_size(cfg)
    assert wft.numel() == 2 * T and wfx.numel() == 2 * TX
    t_hi, t_lo, x_hi, x_lo = wft[:T], wft[T:], wfx[:TX], wfx[TX:]
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    Cr, Cd, LX, Fd = (cfg.num_rgb_channels, cfg.num_density_channels,
                      cfg.location_features, cfg.direction_features)
    kx = fl.padded_location_features(cfg)
    N = R * S
    xs = torch.zeros(N, kx)
    xs[:, :LX] = x

    def skip(i):
        return i > 0 and i % cfg.skip_layer == 0

    acts, h = [], None
    for i in range(D):
        parts = [xs] if i == 0 else [h, xs] if skip(i) else [h]
        h = torch.relu(gemm(parts, hi, lo, so["trunk"][i], W)
                       + b[i * W:(i + 1) * W])
        acts.append(h)
    raw_den = head(h, w, o["den"], W, Cd) + b[o["b_den"]:o["b_den"] + Cd]
    w_dir = w[o["v0_bot"]:o["v0_bot"] + Fd * Wc].view(Fd, Wc)
    dc = (d.double() @ w_dir.double()).float()
    for j in range(Dc):
        a = acts[D - 1] if j == 0 else acts[-1]
        z = gemm([a], hi, lo, so["view"][j], Wc)
        if j == 0:
            z = (z.view(R, S, Wc) + dc[:, None, :]).view(N, Wc)
        bv = o["b_v0"] + j * Wc
        acts.append(torch.relu(z + b[bv:bv + Wc]))
    raw_rgb = (head(acts[-1], w, o["rgb"], Wc, Cr)
               + b[o["b_rgb"]:o["b_rgb"] + Cr])

    grads = {}
    w_rgb = w[o["rgb"]:o["rgb"] + Cr * Wc].view(Cr, Wc)
    g = (g_rgb.double() @ w_rgb.double()).float() * (acts[D + Dc - 1] > 0)
    grads[D + Dc - 1] = g
    for j in range(Dc - 1, -1, -1):
        z = gemm([g], t_hi, t_lo, wt_off(cfg, D + j), W if j == 0 else Wc)
        if j == 0:  # the density term, the heads' W^T from pack_params
            w_den = w[o["den"]:o["den"] + Cd * W].view(Cd, W)
            z = z + (g_den.double() @ w_den.double()).float()
        below = D - 1 if j == 0 else D + j - 1
        g = z * (acts[below] > 0)
        grads[below] = g
    for i in range(D - 1, 0, -1):
        g = gemm([g], t_hi, t_lo, wt_off(cfg, i), W) * (acts[i - 1] > 0)
        grads[i - 1] = g
    dx = None
    for i in range(D - 1, -1, -1):
        if i == 0 or skip(i):
            term = gemm([grads[i]], x_hi, x_lo, wtx_off(cfg, i), kx)[:, :LX]
            dx = term if dx is None else dx + term
    g_ray = grads[D].view(R, S, Wc).sum(1)
    dd = (g_ray.double() @ w_dir.double().t()).float()

    def dw(a, g):
        return mu.dense_3xtf32(a.t().contiguous(), g)

    def db(g):
        return g.double().sum(0).float()

    # layer order: dw_gemm_f32_kernel's products, the heads' small ones
    d_params = []
    for i in range(D):
        a = xs[:, :LX] if i == 0 else acts[i - 1]
        dwi = dw(a, grads[i])
        if skip(i):
            dwi = torch.cat([dwi, dw(xs[:, :LX], grads[i])])
        d_params.append((dwi, db(grads[i])))
    d_params.append((dw(acts[D - 1], g_den), db(g_den)))
    for j in range(Dc):
        if j == 0:
            dwj = torch.cat([dw(acts[D - 1], grads[D]), dw(d, g_ray)])
        else:
            dwj = dw(acts[D + j - 1], grads[D + j])
        d_params.append((dwj, db(grads[D + j])))
    d_params.append((dw(acts[D + Dc - 1], g_rgb), db(g_rgb)))
    return raw_rgb, raw_den, acts, grads, d_params, dx, dd


@pytest.mark.parametrize("kw", [
    dict(net_width=288, net_width_condition=96),
    dict(net_width=512, net_depth=5, net_depth_condition=2,
         net_width_condition=256, num_rgb_channels=5,
         num_density_channels=2),
], ids=["w288", "w512_d5_dc2_heads_5_2"])
def test_wide_f32_kernel_reads_of_the_f32_streams(kw):
    """Forward, g-chain, dW, dX and dD through the f32 wide kernels'
    offsets and reads of ``pack_params_wf`` / ``pack_params_wft`` /
    ``pack_params_wfx`` (a partial column block at 288; two skip layers, a
    second view layer and heads of 5 / 2 channels at 512) with the kernel's
    k8 sums against ``mlp_forward_acts`` and ``mlp_backward_plain`` in the
    f32 band."""
    cfg = Config(**dict(WIDE, compute_dtype="float32", **kw))
    assert fl.uses_wide(cfg) and fl.kernel_cfg(cfg) is cfg
    R, S = 4, cfg.num_samples
    rng = np.random.default_rng(17)
    params = tmlp.init_mlp(torch.Generator().manual_seed(5), cfg)
    params = [(w, torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)
                                   * 0.1)) for w, b in params]

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    x = randn(R * S, cfg.location_features) * 0.5
    d = randn(R, cfg.direction_features) * 0.5
    g_rgb = randn(R * S, cfg.num_rgb_channels)
    g_den = randn(R * S, cfg.num_density_channels)
    raw_rgb, raw_den, acts, grads, got, dx, dd = wide_f32_model(
        params, cfg, x, d, R, S, g_rgb, g_den)
    dt = torch.float32
    p_rgb, p_den, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    close(raw_rgb.numpy(), p_rgb.numpy(), "float32", "raw_rgb")
    close(raw_den.numpy(), p_den.numpy(), "float32", "raw_den")
    for k, (a, r) in enumerate(zip(acts, hs + vs)):
        close(a.numpy(), r.numpy(), "float32", f"act{k}")
    d_params, p_dx, p_dd = fl.mlp_backward_plain(
        params, cfg, x, d, hs, vs, g_rgb, g_den, R, S, dt, input_grads=True)
    assert len(got) == len(d_params)
    for layer, ((dw, db), (rw, rb)) in enumerate(zip(got, d_params)):
        close(dw.numpy(), rw.numpy(), "float32", f"dW{layer}")
        close(db.numpy(), rb.numpy(), "float32", f"db{layer}")
    close(dx.numpy(), p_dx.numpy(), "float32", "dX")
    close(dd.numpy(), p_dd.numpy(), "float32", "dD")


ADMITTED = [
    ("f32 at 260", dict(net_width=260)),
    ("f32 at 288", dict(net_width=288)),
    ("f32 above 256", dict(net_width=512)),
    ("f32 at 1024", dict(net_width=1024)),
    ("f32 at 400 / 200", dict(net_width=400, net_width_condition=200)),
]


@pytest.mark.parametrize("what,kw", ADMITTED, ids=[c[0] for c in ADMITTED])
def test_f32_wide_routes_are_admitted(what, kw):
    """f32 at a kernel net_width of 288-1024 (260 and 400 / 200 through
    ``kernel_cfg``'s padding) takes the wide route and passes every config
    check of every route (the level kernels' heads and, with heads of any
    channel count, the MLP kernels'); on CPU tensors each
    wrapper gets to its device check, and nothing is launched."""
    cfg = Config(**dict(WIDE, compute_dtype="float32", **kw))
    S = cfg.num_samples
    kc = fl.kernel_cfg(cfg)
    assert 288 <= kc.net_width <= 1024 and kc.net_width % 32 == 0, what
    assert fl.uses_wide(cfg), what
    fl.check_kernel_config(cfg)
    fl.check_kernel_config(cfg.replace(num_rgb_channels=8,
                                       num_density_channels=8),
                           any_heads=True)
    for kernel in fl.KERNELS:
        for input_grads in (True, False):
            assert fl.takes_wide(cfg, kernel, S, input_grads), what
    counters = (fl.train_level, fl.render_level, fl.train_level_twopass,
                fm.mlp_fwd, fm.mlp_bwd)
    before = [fn.launches for fn in counters]
    for name, call in refused_routes(cfg).items():
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("kw,f64", [
    (dict(net_width=288, compute_dtype="float32"), True),
    (dict(net_width=260, compute_dtype="float32"), True),
    (dict(net_width=288), False),
    (dict(net_width=256, compute_dtype="float32"), False),
], ids=["f32_288", "f32_260", "bf16_288", "f32_256"])
def test_reference_products_on_the_wide_f32_route(kw, f64):
    """``reference_products``: for f32 on the wide route (260 through
    ``kernel_cfg``'s padding) the plain versions' layer products
    (``fused_level.dense``) are taken in f64 and rounded to f32 inside the
    block, and the plain forward stays in the f32 band of its f32 one;
    bf16 and the narrow f32 route keep the plain version; ``dense`` is
    restored after the block."""
    cfg = Config(**dict(WIDE, **kw))
    assert parity.f64_reference(cfg) is f64
    rng = np.random.default_rng(3)
    h, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((16, 300), (300, 40)))
    R, S = 2, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(4), cfg)
    x = torch.from_numpy(rng.normal(
        size=(R * S, cfg.location_features)).astype(np.float32))
    d = torch.from_numpy(rng.normal(
        size=(R, cfg.direction_features)).astype(np.float32))
    plain = fm.mlp_fwd_plain(params, cfg, x, d, S)
    with parity.reference_products(cfg):
        assert (fl.dense is not tmlp.dense) is f64
        if f64:
            assert torch.equal(fl.dense(h, w, torch.float32),
                               (h.double() @ w.double()).float())
        ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
    assert fl.dense is tmlp.dense
    for a, b in zip(plain, ref):
        close(a, b, cfg.compute_dtype)


@pytest.mark.parametrize("heads", [(4, 2), (5, 2)], ids=["4_2", "5_2"])
def test_exact_forward_inputs_take_every_product_exactly(heads):
    """The card test's MLP for random cotangents in f32
    (``exact_forward_inputs``, depth 8 with a skip at 4, net_width 288):
    its forward gives the same bits with f32 products, with f64 products
    and with the 3xTF32 split the kernels take (``dense_3xtf32``), every
    activation an integer below 2^22, so every f32 computation takes the
    same ReLU masks."""
    cfg = Config(**dict(CARD_WIDE, net_width=288, compute_dtype="float32",
                        num_rgb_channels=heads[0],
                        num_density_channels=heads[1]))
    R, S = 2, cfg.num_samples
    params, x, d, _, _ = exact_forward_inputs(cfg, R, 5, torch.device("cpu"))

    def forward(dense):
        saved = fl.dense
        fl.dense = dense
        try:
            return fl.mlp_forward_acts(params, cfg, x, d, R, S,
                                       torch.float32)
        finally:
            fl.dense = saved

    f32 = forward(tmlp.dense)
    flat = lambda o: [*o[:2], *o[2], *o[3]]  # noqa: E731
    for dense in (lambda h, w, dt: (h.double() @ w.double()).float(),
                  lambda h, w, dt: mu.dense_3xtf32(h, w)):
        for a, b in zip(flat(f32), flat(forward(dense))):
            assert torch.equal(a, b)
    for h in [*f32[2], *f32[3]]:
        assert torch.equal(h, h.round()) and float(h.abs().max()) < 2.0**22
    assert float(f32[2][-1].max()) > 0


def slab_products(params, cfg):
    """(name, stream, (hi, lo), offset, slabs, N, B) of every product in the f32 wide
    packs of ``params`` at ``cfg`` (weights embedded at ``kernel_cfg``):
    ``pack_params_wf``'s forward B (each part's rows, the x rows padded),
    ``pack_params_wft``'s W^T and ``pack_params_wfx``'s W_x^T, each stream
    as (hi, lo)."""
    kc = fl.kernel_cfg(cfg)
    ep = fl.embed_params(params, cfg)
    dt = torch.float32
    n_w = fl.packed_sizes(cfg)[0]
    wf = fl.pack_params_wf(params, cfg, dt)[0]
    L = fl.packed_wfs_size(cfg)
    T, TX = fl.packed_t_size(cfg), fl.packed_tx_size(cfg)
    wft = fl.pack_params_wft(params, cfg, dt)
    wfx = fl.pack_params_wfx(params, cfg, dt)
    streams = {"wf": (wf[n_w:n_w + L], wf[n_w + L:]),
               "wft": (wft[:T], wft[T:]), "wfx": (wfx[:TX], wfx[TX:])}
    D, Dc, W, Wc = (kc.net_depth, kc.net_depth_condition, kc.net_width,
                    kc.net_width_condition)
    lx, kx = kc.location_features, fl.padded_location_features(kc)
    so = wf_offsets(kc)
    out = []

    def xrows(i):
        w = ep[i][0]
        x = torch.zeros(-(-kx // BK) * BK, W)
        x[:lx] = w if i == 0 else w[W:]
        return x

    for i in range(D):
        off = so["trunk"][i]
        if i > 0:
            out.append((f"fwd{i}h", "wf", off, W // BK, W, ep[i][0][:W]))
            off += W * W
        if i == 0 or i % kc.skip_layer == 0:
            out.append((f"fwd{i}x", "wf", off, -(-kx // BK), W, xrows(i)))
            out.append((f"dx{i}", "wfx", wtx_off(kc, i), W // BK, kx,
                        xrows(i)[:kx].t()))
        if i > 0:
            out.append((f"chain{i}", "wft", wt_off(kc, i), W // BK, W,
                        ep[i][0][:W].t()))
    for j in range(Dc):
        w = ep[D + 1 + j][0]
        out.append((f"fwd_v{j}", "wf", so["view"][j], w.shape[0] // BK if j
                    else W // BK, Wc, w[:W] if j == 0 else w))
        out.append((f"chain_v{j}", "wft", wt_off(kc, D + j), Wc // BK,
                    W if j == 0 else Wc, (w[:W] if j == 0 else w).t()))
    return [(n, s, streams[s], off, ns, N, B) for n, s, off, ns, N, B in out]


SLAB_CONFIGS = [
    dict(net_width=288, net_width_condition=96),
    dict(net_width=512, net_depth=5, net_depth_condition=2,
         net_width_condition=256),
    dict(net_width=400, net_width_condition=200),
    dict(net_width=64, net_width_condition=32, max_deg_point=40),
]


@pytest.mark.parametrize("kw", SLAB_CONFIGS,
                         ids=["w288", "w512_d5_dc2", "400_200_padded",
                              "64_32_deg40"])
def test_f32_slab_streams_hold_the_split_weights(kw):
    """Every product in ``pack_params_wf`` / ``_wft`` / ``_wfx``, read back
    the kernel's way (``unslab`` at ``WideF32Route``'s, ``wt_off``'s and
    ``wtx_off``'s offsets): hi is ``tf32_round`` of the (embedded) weights
    bit for bit, hi + lo is within 2^-22 of |w| of them, and every padded
    element (x rows past the features, columns past them in dX) is an
    exact zero in both; the streams are exactly as long as the products."""
    cfg = Config(**dict(WIDE, compute_dtype="float32", **kw))
    params = tmlp.init_mlp(torch.Generator().manual_seed(9), cfg)
    used, length = {}, {}
    for name, stream, (hi, lo), off, ns, N, B in slab_products(params, cfg):
        h, lw = unslab(hi, off, ns, N), unslab(lo, off, ns, N)
        assert h.shape == B.shape, name
        assert torch.equal(h, mu.tf32_round(B)), name
        assert bool(((h.double() + lw.double() - B.double()).abs()
                     <= 2.0**-22 * B.double().abs()).all()), name
        assert bool((h[B == 0] == 0).all() and (lw[B == 0] == 0).all()), name
        used[stream] = used.get(stream, 0) + ns * N * BK
        length[stream] = hi.numel()
    assert used == length


def test_tf32_pair_keeps_nan_inf_and_zeros():
    """``fused_level.tf32_pair`` on edge values: hi has 10 explicit mantissa
    bits (the low 13 bits zero) and is ``tf32_round``; a NaN of any payload
    stays a NaN in hi and lo (hi the quiet NaN, which the tensor core's
    truncation keeps); inf stays inf in hi; signed zeros split exactly;
    normal values (away from the subnormals, which TF32 rounds away, and
    from the top, where hi rounds to inf) rebuild within 2^-22."""
    bits = np.array([0x7F800001, 0x7FC00000, 0xFFFFFFFF, 0x7F800000,
                     0xFF800000, 0x00000000, 0x80000000, 0x00000001,
                     0x3F801000, 0x3F800FFF, 0xBF812345, 0x7F7FFFFF],
                    dtype=np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    pair = fl.tf32_pair(x)
    hi, lo = pair[:x.numel()], pair[x.numel():]
    hb = hi.view(torch.int32)
    nan = torch.isnan(x)
    assert bool(torch.isnan(hi[nan]).all() and torch.isnan(lo[nan]).all())
    assert bool((hb[nan] == 0x7FC00000).all())
    fin = torch.isfinite(x)
    assert bool((hb[fin] & 0x1FFF == 0).all())
    assert torch.equal(hi[~nan], mu.tf32_round(x)[~nan])
    assert bool(torch.isinf(hi[torch.isinf(x)]).all())
    assert torch.equal(hb[5:7], x.view(torch.int32)[5:7])
    assert bool((lo[5:7] == 0).all())
    normal = fin & (x.abs() > 2.0**-100) & (hi.abs() < 3e38)
    assert bool(((hi[normal].double() + lo[normal].double()
                  - x[normal].double()).abs()
                 <= 2.0**-22 * x[normal].double().abs()).all())


@pytest.mark.parametrize("kw,layout,wide,slabs,repack", [
    (dict(net_width=288), "wf", None, True, False),
    (dict(net_width=288), "wg", None, False, False),
    (dict(net_width=64, net_width_condition=32), "wf", None, False, True),
    (dict(net_width=64, net_width_condition=32), "wf", True, True, True),
    (dict(net_width=288, compute_dtype="bfloat16"), "wf", None, False,
     False),
], ids=["wide", "parent_layout", "narrow", "narrow_on_wide_route", "bf16"])
def test_f32_packs_follow_the_route(kw, layout, wide, slabs, repack):
    """``f32_slabs``: f32 kernels reading ``"wf"`` get the hi / lo slab
    streams where every launch takes the wide route (kernel net_width above
    256), or for a launch on the wide route (``wide``); a version reading
    ``"wg"`` and bf16 keep their layouts. ``pack_forward``,
    ``pack_train_level`` and ``pack_mlp_params`` give tensors of the sizes
    their wrappers check (``forward_weights_size``, ``train_weight_sizes``,
    ``fused_mlp._check_packed``), and ``repack_f32`` names the launches
    whose route the default packing does not serve."""
    cfg = Config(**dict(WIDE, **dict(dict(compute_dtype="float32"), **kw)))
    dt = tmlp.compute_dtype(cfg)
    assert fl.f32_slabs(cfg, layout, wide) is slabs
    params = tmlp.init_mlp(torch.Generator().manual_seed(2), cfg)
    w, b = fl.pack_forward(params, cfg, dt, layout, wide)
    assert w.numel() == fl.forward_weights_size(cfg, layout, wide)
    tw = fl.pack_train_level(params, cfg, dt, layout, wide)
    assert (tw[0].numel(), tw[2].numel()) == fl.train_weight_sizes(
        cfg, layout, wide)
    if slabs:
        assert w.numel() == fl.packed_wf_size(cfg)
        assert tw[2].numel() == 2 * fl.packed_t_size(cfg)
    packed = fm.pack_mlp_params(params, cfg, dt, layout=layout, wide=wide)
    fm._check_packed(cfg, packed, w.device, layout, layout, wide)
    assert fl.repack_f32(cfg, layout, True) is repack
    assert fl.repack_f32(cfg, layout, fl.uses_wide(cfg)) is False


GEMM_F32_CASES = [
    ("fwd_skip_dc", "fwd", 37, 160, 96, 48, dict(dc=True, S=8)),
    ("chain_cd3", "chain", 29, 288, 64, 0, dict(cd=3)),
    ("chain_no_den", "chain", 17, 96, 128, 0, dict(den=False)),
    ("dx_accum", "dx", 23, 48, 96, 0, dict(ldo=40, accum=True)),
]


@pytest.mark.parametrize("name,kind,M,N,K0,K1,kw", GEMM_F32_CASES,
                         ids=[c[0] for c in GEMM_F32_CASES])
def test_f32_gemm_case_read_the_kernel_way(name, kind, M, N, K0, K1, kw):
    """``kernels/wide_gemm.py``'s f32 case, which the card tests and
    ``chip_smoke.py`` launch: b is the hi / lo slabs of w0 then w1 (each
    part padded to whole slabs) and b_rows the row-major [K0 + K1, N] the
    earlier version reads; the product read from b the kernel's way
    (``unslab``, ``k8_sums``) with ``wide_f32.cuh``'s epilogue agrees with
    ``wide_gemm_f32_plain`` (f64 products) in the f32 band."""
    c = wg.gemm_case(kind, M, N, K0, K1, seed=4, dtype=torch.float32, **kw)
    assert torch.equal(c["b_rows"], torch.cat(
        [c["w0"]] + ([c["w1"]] if K1 else [])))
    half = c["b"].numel() // 2
    hi, lo = c["b"][:half], c["b"][half:]
    parts = [c["a0"]] + ([c["a1"]] if K1 else [])
    acc = gemm(parts, hi, lo, 0, N)
    ws = [c["w0"]] + ([c["w1"]] if K1 else [])
    assert half == sum(-(-w.shape[0] // BK) * BK * N for w in ws)
    if kind == "fwd":
        if c["dc"] is not None:
            acc = acc + c["dc"].repeat_interleave(c["S"], 0)[:M]
        got = torch.relu(acc + c["bias"])
    elif kind == "dx":
        got = c["out0"] + acc[:, :c["ldo"]]
    else:
        if c["gden"] is not None:
            acc = acc + (c["gden"].double() @ c["wden"].double()).float()
        got = torch.where(c["act"] > 0, acc, 0.0)
    close(got.numpy(), wg.wide_gemm_f32_plain(c).numpy(), "float32", name)
