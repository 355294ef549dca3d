"""The bf16 forward kernels' weight stream (``pack_params_wg``, read by
``csrc/forward_wg.cuh``) and their shared-memory budget, on the CPU.

A plain-Python model of the slab stream (slabs of 64 K-rows, each W^T rows
of 128 bytes with the 16-byte chunk c of row n at position c ^ (n % 8))
unpacks the pack back into every layer's weights, and a forward that
multiplies slab by slab from that model matches ``render_level_plain`` and
``mlp_fwd_plain``. Those plain versions are held against the JAX package's
interpreted ``_render_kernel`` / ``_fwd_kernel`` in
``tests/test_torch_fused_level.py`` and ``tests/test_torch_fused_mlp.py``.

Tolerances: the pack is a permutation with zero padding, so unpacking is
exact; the slab-by-slab forward runs in f32 (f64 sums) against the plain
f32 versions, within the f32 parity band (1e-6, 1e-3).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402

F32_BAND = (1e-6, 1e-3)

CONFIGS = {
    "config": dict(),
    "narrow": dict(net_width=64, net_width_condition=32, num_samples=8,
                   net_depth=3, skip_layer=2, max_deg_point=4),
    "depth5_skip2": dict(net_width=96, net_width_condition=64, net_depth=5,
                         skip_layer=2, num_samples=16, max_deg_point=6),
    "heads_4_2": dict(net_width=64, net_width_condition=32, net_depth=5,
                      skip_layer=2, num_rgb_channels=4, num_density_channels=2,
                      num_samples=24, max_deg_point=4),
    # location_features 60: the feature slab is padded from 64 columns
    # and its last k-step from 48 rows
    "lx60_w224": dict(net_width=224, net_width_condition=160, net_depth=4,
                      skip_layer=3, max_deg_point=10, num_samples=12),
}


def config(name, **kw):
    return Config(**dict(CONFIGS[name], compute_dtype="float32", **kw))


def params_of(cfg, seed=0):
    return tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg)


class Stream:
    """Reads ``pack_params_wg``'s slab stream front to back."""

    def __init__(self, flat):
        self.flat = np.asarray(flat, dtype=np.float64)
        self.pos = 0

    def slabs(self, k, n):
        """The next ceil(k / 64) slabs of an n-column matrix, as [k_pad, n]."""
        ns = -(-k // 64)
        out = np.empty((ns * 64, n))
        for s in range(ns):
            slab = self.flat[self.pos:self.pos + n * 64].reshape(n, 8, 8)
            self.pos += n * 64
            for row in range(n):
                for p in range(8):  # chunk c sits at position c ^ (row % 8)
                    c = p ^ (row % 8)
                    out[s * 64 + c * 8:s * 64 + c * 8 + 8, row] = slab[row, p]
        return out

    def rest(self):
        return self.flat[self.pos:]


def unpack(flat, cfg):
    """Every layer as the stream stores it: (h rows, x rows) of the trunk
    layers, the 8-column heads, the view layers, the direction rows."""
    D, W, Wc = cfg.net_depth, cfg.net_width, cfg.net_width_condition
    lx = cfg.location_features
    st = Stream(flat)
    trunk = []
    for i in range(D):
        h = st.slabs(W, W) if i > 0 else None
        x = st.slabs(lx, W) if i == 0 or i % cfg.skip_layer == 0 else None
        trunk.append((h, x))
    den = st.slabs(W, 8)
    views = [st.slabs(W if j == 0 else Wc, Wc)
             for j in range(cfg.net_depth_condition)]
    rgb = st.slabs(Wc, 8)
    wdir = st.rest().reshape(cfg.direction_features, Wc)
    return trunk, den, views, rgb, wdir


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wg_pack_unpacks_to_every_layer(name):
    cfg = config(name)
    params = params_of(cfg)
    w, b = fl.pack_params_wg(params, cfg, torch.float32)
    assert w.shape == (fl.packed_wg_size(cfg),)
    assert torch.equal(b, torch.cat([bb.reshape(-1) for _, bb in params]))
    trunk, den, views, rgb, wdir = unpack(w, cfg)
    D, W, lx = cfg.net_depth, cfg.net_width, cfg.location_features
    P = [p.double().numpy() for p, _ in params]
    for i, (h, x) in enumerate(trunk):
        if h is not None:
            np.testing.assert_array_equal(h[:W], P[i][:W])
            assert not h[W:].any()
        if x is not None:
            xw = P[i] if i == 0 else P[i][W:]
            np.testing.assert_array_equal(x[:lx], xw)
            assert not x[lx:].any()  # zero padding to whole slabs
    for head, p, c in ((den, P[D], cfg.num_density_channels),
                       (rgb, P[-1], cfg.num_rgb_channels)):
        k = p.shape[0]
        np.testing.assert_array_equal(head[:k, :c], p)
        assert not head[:, c:].any() and not head[k:].any()  # zero padding
    Wc = cfg.net_width_condition
    np.testing.assert_array_equal(views[0][:W], P[D + 1][:W])
    for j in range(1, cfg.net_depth_condition):
        np.testing.assert_array_equal(views[j][:Wc], P[D + 1 + j])
    np.testing.assert_array_equal(wdir, P[D + 1][W:])


def slab_forward(flat, b_flat, cfg, x, d, S):
    """The kernel's forward from the stream model: each product summed
    slab by slab (64 K-rows at a time) in f64, ReLU epilogues, the
    direction term once per ray, 8-column heads cut to their channels.
    Returns raw_rgb [N, C_rgb], raw_den [N, C_den]."""
    trunk, den, views, rgb, wdir = unpack(flat, cfg)
    D, W, Wc = cfg.net_depth, cfg.net_width, cfg.net_width_condition
    b = np.asarray(b_flat, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    xp = np.zeros((x.shape[0], -(-x.shape[1] // 64) * 64))
    xp[:, :x.shape[1]] = x

    def product(parts):
        acc = 0.0
        for a, w in parts:
            a = np.pad(a, ((0, 0), (0, w.shape[0] - a.shape[1])))
            for s in range(0, w.shape[0], 64):
                acc = acc + a[:, s:s + 64] @ w[s:s + 64]
        return acc

    h, off = None, 0
    for i, (wh, wx) in enumerate(trunk):
        parts = ([(h, wh)] if wh is not None else []) + (
            [(xp, wx)] if wx is not None else [])
        h = np.maximum(product(parts) + b[off:off + W], 0.0)
        off += W
    cd, cr = cfg.num_density_channels, cfg.num_rgb_channels
    raw_den = product([(h, den)])[:, :cd] + b[off:off + cd]
    off += cd
    dc = np.asarray(d, dtype=np.float64) @ wdir
    for j, wv in enumerate(views):
        z = product([(h, wv)])
        if j == 0:
            z = z + np.repeat(dc, S, axis=0)
        h = np.maximum(z + b[off:off + Wc], 0.0)
        off += Wc
    raw_rgb = product([(h, rgb)])[:, :cr] + b[off:off + cr]
    return raw_rgb, raw_den


def normalized_err(a, b, atol, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    band = atol + rtol * np.abs(b) + rtol * np.abs(b).max()
    return float((np.abs(a - b) / band).max())


def inputs(cfg, R, seed):
    rng = np.random.default_rng(seed)
    S = cfg.num_samples
    means = torch.from_numpy(rng.normal(size=(R * S, 3)).astype(np.float32))
    covs = torch.from_numpy(rng.uniform(0, 0.02, (R * S, 3)).astype(np.float32))
    d = torch.from_numpy(
        (rng.normal(size=(R, cfg.direction_features)) * 0.5).astype(np.float32))
    delta = torch.from_numpy(rng.uniform(0.01, 0.1, (R, S)).astype(np.float32))
    return means, covs, d, delta


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wg_slab_forward_matches_mlp_fwd_plain(name):
    cfg = config(name)
    R, S = 5, cfg.num_samples
    params = params_of(cfg, seed=1)
    means, covs, d, _ = inputs(cfg, R, 2)
    x = fl.encode_mv(cfg, means, covs, torch.float32)
    w, b = fl.pack_params_wg(params, cfg, torch.float32)
    got = slab_forward(w, b, cfg, x, d, S)
    ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
    for a, r in zip(got, ref):
        assert a.shape == tuple(r.shape)
        assert normalized_err(a, r, *F32_BAND) < 1.0


@pytest.mark.parametrize("name", ["config", "narrow", "depth5_skip2",
                                  "lx60_w224"])
def test_wg_slab_forward_matches_render_level_plain(name):
    """The slab forward's heads through a numpy composite against
    ``render_level_plain`` (mode "mv", white background)."""
    cfg = config(name)
    R, S = 4, cfg.num_samples
    params = params_of(cfg, seed=3)
    means, covs, d, delta = inputs(cfg, R, 4)
    w, b = fl.pack_params_wg(params, cfg, torch.float32)
    x = fl.encode_mv(cfg, means, covs, torch.float32)
    raw_rgb, raw_den = slab_forward(w, b, cfg, x, d, S)
    pad = cfg.rgb_padding
    rgb = (1.0 / (1.0 + np.exp(-raw_rgb)) * (1 + 2 * pad) - pad).reshape(R, S, 3)
    z = raw_den[:, 0] + cfg.density_bias
    sigma = (np.maximum(z, 0) + np.log1p(np.exp(-np.abs(z)))).reshape(R, S)
    sd = sigma * delta.double().numpy()
    trans = np.exp(-np.concatenate([np.zeros((R, 1)), np.cumsum(sd, 1)[:, :-1]], 1))
    weights = (1.0 - np.exp(-sd)) * trans
    acc = weights.sum(1)
    comp = (weights[..., None] * rgb).sum(1) + (1.0 - acc[:, None])
    ref = fl.render_level_plain(params, cfg, (means, covs), d, delta, True,
                                "mv")
    for a, r in zip((comp, acc, weights), ref):
        assert normalized_err(a, r, *F32_BAND) < 1.0


def test_pack_forward_picks_the_layout_per_dtype():
    """bf16: the slab stream; f32: ``pack_params``' row-major layout."""
    cfg = Config()
    params = params_of(cfg)
    w16, _ = fl.pack_forward(params, cfg, torch.bfloat16)
    assert torch.equal(w16, fl.pack_params_wg(params, cfg, torch.bfloat16)[0])
    w32, _ = fl.pack_forward(params, cfg, torch.float32)
    assert torch.equal(w32, fl.pack_params(params, cfg, torch.float32)[0])
    for dt, layout, n in ((torch.bfloat16, "wg", fl.packed_wg_size(cfg)),
                          (torch.float32, "wg", fl.packed_sizes(cfg)[0]),
                          (torch.bfloat16, "fwd", fl.packed_sizes(cfg)[0])):
        c = cfg.replace(compute_dtype="float32" if dt == torch.float32
                        else "bfloat16")
        assert fl.forward_weights_size(c, layout) == n


@pytest.mark.parametrize("composite", [True, False])
def test_wg_smem_fits_every_admitted_config(composite):
    """Every width that ``check_kernel_config`` admits, at the feature
    widths of max_deg_point 4-32 and S from 1 to 1024, fits a block, and
    the router keeps the forwards on the narrow route."""
    sizes = []
    for W in range(32, 257, 32):
        for Wc in range(32, W + 1, 32):
            for deg in (4, 16, 32):
                cfg = Config(net_width=W, net_width_condition=Wc,
                             max_deg_point=deg)
                fl.check_kernel_config(cfg)
                for S in (1, 8, 24, 64, 128, 256, 1024):
                    nbytes, stages = fl.wg_smem(cfg, S, composite)
                    assert nbytes is not None and nbytes <= fl.SMEM_LIMIT
                    assert stages >= 2
                    assert not fl.takes_wide(
                        cfg, "render_level" if composite else "mlp_fwd", S)
                    sizes.append(nbytes)
    # the default config keeps a ring of at least 3 slabs
    assert fl.wg_smem(Config(), 128, composite)[1] >= 3
    assert max(sizes) <= fl.SMEM_LIMIT


def test_wg_rejected_config_raises_in_the_wrappers():
    """Features too wide for two tiles and a ring of two slabs, which both
    wrappers refused, take the wide route: on CPU tensors they reach the
    device check (f32's tiles still fit, on the narrow route)."""
    cfg = Config(max_deg_point=80)  # location_features 480: 8 slabs
    assert fl.wg_smem(cfg, 128, True)[0] is None
    R, S = 2, cfg.num_samples
    means, covs, d, delta = inputs(cfg, R, 5)
    d16 = d.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.render_level_cuda(params_of(cfg), cfg, (means, covs), d16, delta,
                             True, "mv")
    x = torch.zeros((R * S, cfg.location_features), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.mlp_fwd_cuda(params_of(cfg), cfg, x, d16)
    for kernel in ("render_level", "mlp_fwd"):
        assert fl.takes_wide(cfg, kernel, S)
        assert not fl.takes_wide(cfg.replace(compute_dtype="float32"),
                                 kernel, S)
