"""The f32 wide route of every kernel (net_width 288-1024 in f32:
``csrc/wide_f32.cuh`` and ``csrc/wide_train.cuh``'s f32 passes) on the
CPU:

- a Python model of the f32 wide kernels' reads of the narrow f32 route's
  streams: ``pack_params`` at ``init_params``' offsets (trunk layers
  [K, W] with the skip layers' [h | x] rows, the heads' transposed rows,
  the view layers, the direction rows), ``pack_params_t`` at ``wt_off``
  and ``pack_params_tx`` at ``wtx_off``; every layer product as
  ``wide_gemm_f32_kernel`` takes it (A zero-padded to stages of 32
  k-values per part, B in column blocks of 128, zero past N, the 3xTF32
  split of ``ops/math_utils.dense_3xtf32``), run as a forward, a g-chain
  (the density term over Cd channels from ``pack_params``' W_den rows), dX
  (deepest x layer first) and dD at net_width 288 (a partial column
  block) and 512 (two skip layers, two view layers), against
  ``mlp_forward_acts`` / ``mlp_backward_plain``;
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
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import math_utils as mu  # noqa: E402
from nerf_or_nothing_tpu_torch.utils import parity  # noqa: E402

BN, BK = 128, 32  # wide_gemm_f32_kernel's column block and k-stage


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


def gemm(parts, stream, off, N):
    """``wide_gemm_f32_kernel``'s product: A the parts side by side, each
    zero-padded to whole stages of ``BK`` columns; B the stream's row-major
    rows at ``off`` (each part's ka rows in order, zero past ka within a
    stage), in column blocks of ``BN`` zero past N; every product through
    the 3xTF32 split."""
    a_cols, b_rows, k = [], [], 0
    nb = -(-N // BN) * BN
    for a in parts:
        ka = a.shape[1]
        kp = -(-ka // BK) * BK
        ap = torch.zeros(a.shape[0], kp)
        ap[:, :ka] = a
        bp = torch.zeros(kp, nb)
        bp[:ka, :N] = stream[off + k * N:off + (k + ka) * N].view(ka, N)
        a_cols.append(ap)
        b_rows.append(bp)
        k += ka
    A, B = torch.cat(a_cols, 1), torch.cat(b_rows, 0)
    return torch.cat([mu.dense_3xtf32(A, B[:, n0:n0 + BN])
                      for n0 in range(0, nb, BN)], 1)[:, :N]


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
    w, b = fl.pack_params(params, cfg, dt)
    wt = fl.pack_params_t(params, cfg, dt)
    wtx = fl.pack_params_tx(params, cfg, dt)
    o = f32_offsets(cfg)
    assert o["end"] == w.numel()
    assert wt.numel() == fl.packed_t_size(cfg)
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
        h = torch.relu(gemm(parts, w, o["trunk"][i], W) + b[i * W:(i + 1) * W])
        acts.append(h)
    raw_den = head(h, w, o["den"], W, Cd) + b[o["b_den"]:o["b_den"] + Cd]
    w_dir = w[o["v0_bot"]:o["v0_bot"] + Fd * Wc].view(Fd, Wc)
    dc = (d.double() @ w_dir.double()).float()
    for j in range(Dc):
        a = acts[D - 1] if j == 0 else acts[-1]
        z = gemm([a], w, o["v0_top"] if j == 0
                 else o["v1"] + (j - 1) * Wc * Wc, Wc)
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
        z = gemm([g], wt, wt_off(cfg, D + j), W if j == 0 else Wc)
        if j == 0:  # the density term, the heads' W^T from pack_params
            w_den = w[o["den"]:o["den"] + Cd * W].view(Cd, W)
            z = z + (g_den.double() @ w_den.double()).float()
        below = D - 1 if j == 0 else D + j - 1
        g = z * (acts[below] > 0)
        grads[below] = g
    for i in range(D - 1, 0, -1):
        g = gemm([g], wt, wt_off(cfg, i), W) * (acts[i - 1] > 0)
        grads[i - 1] = g
    dx = None
    for i in range(D - 1, -1, -1):
        if i == 0 or skip(i):
            term = gemm([grads[i]], wtx, wtx_off(cfg, i), kx)[:, :LX]
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
    offsets and reads of ``pack_params`` / ``pack_params_t`` /
    ``pack_params_tx`` (a partial column block at 288; two skip layers, a
    second view layer and heads of 5 / 2 channels at 512) against
    ``mlp_forward_acts`` and ``mlp_backward_plain`` in the f32 band."""
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
