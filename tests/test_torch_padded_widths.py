"""Widths that are not multiples of 32, and net_width_condition above
net_width, on the kernels' streams, on the CPU (``fused_level.kernel_cfg``:
the kernels run at the widths rounded up to 32, on weights embedded in
zeros, and the wrappers drop the padded rows and columns of dW/db).

- Every packed layout at the real config is the layout at the kernel
  config of the embedded weights; the stream models of
  ``tests/test_torch_wg_layout.py``, ``test_torch_train_wg.py`` and
  ``test_torch_mlp_bwd_wg.py`` unpack it at the kernel config to the real
  layers embedded in zeros; the biases are zero on the padded columns.
- The kernels' function on the padded streams (those stream models, and
  ``test_torch_wide.wide_model`` for the bf16 forward, run at the kernel
  config), with the grads passed through the wrappers' un-embedding,
  against the JAX package's interpreted ``_level_kernel``,
  ``_render_kernel``, ``_fwd_kernel`` and ``_bwd_kernel`` at the real
  config; the padded entries of dW/db are exactly 0.
- The un-embedding inverts the embedding bit for bit; configs that need
  no padding keep their config object and their streams.
- The guard admits every row below and still refuses what is not ported.
- Two train steps against JAX's at 48 / 16 and 32 / 64.

Rows (W / Wc, depth): 16 / 8, 2; 32 / 16, 3; 48 / 16, 8 (two view
layers); 96 / 48, 4; 32 / 64, 8; 400 / 200, 8 (in f32 the f32 wide
route's model, ``test_torch_wide_f32.wide_f32_model``). max_deg_point 4, S=8 (JAX's CPU dot refuses bf16 x bf16 =
f32 at S=16), R=4, skip at 4, inputs from numpy with a seed. Tolerances:
``utils/parity.PARITY_BANDS``, f32 (1e-6, 1e-3) and bf16 (2e-3, 3e-2), as
a normalized error < 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu.kernels import fused_mlp as jfm  # noqa: E402
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_render as j_render,
)
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_train as j_level,
)
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops.render import (  # noqa: E402
    interval_lengths,
)
from test_torch_mlp_bwd_wg import slab_backward as mlp_slab_backward  # noqa: E402
from test_torch_mlp_bwd_wg import unpack_wgx  # noqa: E402
from test_torch_train_level import J, T, level_case  # noqa: E402
from test_torch_train_step import branch_kw, check_two_steps  # noqa: E402
from test_torch_train_wg import (  # noqa: E402
    forward_and_cotangents,
    slab_backward,
    unembed_d_params,
    unpack_wgt,
)
from test_torch_wg_layout import slab_forward, unpack  # noqa: E402
from test_torch_wide import close, wide_model  # noqa: E402
from test_torch_wide_f32 import wide_f32_model  # noqa: E402

BASE = dict(max_deg_point=4, num_samples=8)
ROWS = {
    "16_8": dict(net_width=16, net_width_condition=8, net_depth=2),
    "32_16": dict(net_width=32, net_width_condition=16, net_depth=3),
    "48_16": dict(net_width=48, net_width_condition=16, net_depth=8,
                  net_depth_condition=2),
    "96_48": dict(net_width=96, net_width_condition=48, net_depth=4),
    "32_64": dict(net_width=32, net_width_condition=64, net_depth=8),
    "400_200": dict(net_width=400, net_width_condition=200, net_depth=8),
}
KERNEL_WIDTHS = {"16_8": (32, 32), "32_16": (32, 32), "48_16": (64, 32),
                 "96_48": (96, 64), "32_64": (64, 64), "400_200": (416, 224)}
# (row, dtype) pairs the card takes: every row in both dtypes
CASES = [(r, dt) for r in sorted(ROWS) for dt in ("float32", "bfloat16")]
KINDS = ("fwd", "t", "tx", "wg", "wgt", "wgx", "wfs", "wfts", "wfxs")
R = 4


def row_cfg(row, dtype="bfloat16"):
    return Config(**dict(BASE, **ROWS[row], compute_dtype=dtype))


def params_of(cfg, seed=0):
    """Glorot weights and nonzero biases (so a bias that lands on a padded
    column would show)."""
    rng = np.random.default_rng(seed + 100)
    return [(w, torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)
                                 * 0.1))
            for w, b in tmlp.init_mlp(torch.Generator().manual_seed(seed),
                                      cfg)]


def compare_grads(got, ref, dtype):
    assert len(got) == len(ref)
    for k, ((dw, db), (rw, rb)) in enumerate(zip(got, ref)):
        close(dw.numpy(), rw, dtype, f"dW{k}")
        close(db.numpy(), rb, dtype, f"db{k}")


def block_embedded(e, m, rows, krows):
    """``e`` holds ``m``'s row blocks at the start of its padded blocks and
    its columns first, zeros elsewhere."""
    e, m = np.asarray(e, np.float64), np.asarray(m, np.float64)
    want = np.zeros_like(e)
    r0 = k0 = 0
    for r, kr in zip(rows, krows):
        want[k0:k0 + r, :m.shape[1]] = m[r0:r0 + r]
        r0, k0 = r0 + r, k0 + kr
    np.testing.assert_array_equal(e, want)


# ---------------------------------------------------------------------------
# The streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", sorted(ROWS))
def test_streams_embed_the_real_layers(row):
    """Each of the nine layouts, in both dtypes, packed at the real config is
    that layout of the embedded weights at ``kernel_cfg``; the slab stream
    models unpack it at ``kernel_cfg`` to the real layers embedded in
    zeros; the biases are zero on the padded columns; every size is the
    kernel config's."""
    cfg = row_cfg(row)
    kc = fl.kernel_cfg(cfg)
    assert (kc.net_width, kc.net_width_condition) == KERNEL_WIDTHS[row]
    assert fl.kernel_cfg(kc) is kc
    params = params_of(cfg)
    ep = fl.embed_params(params, cfg)
    blocks, kblocks = fl._layer_blocks(cfg), fl._layer_blocks(kc)
    for (w, b), (ew, eb), (rows, _), (krows, kcols) in zip(
            params, ep, blocks, kblocks):
        block_embedded(ew, w, rows, krows)
        assert eb.shape == (kcols,)
        np.testing.assert_array_equal(eb[:b.shape[0]], b)
        assert not eb[b.shape[0]:].any()
    for dt in (torch.float32, torch.bfloat16):
        for kind in KINDS:
            got = fl._gather(params, cfg, dt, kind)
            ref = fl._LAYOUTS[kind]([(w.to(dt), None) for w, _ in ep], kc,
                                    dt == torch.bfloat16)
            assert torch.equal(got, ref), (kind, dt)
        c = cfg.replace(compute_dtype="float32" if dt == torch.float32
                        else "bfloat16")
        w_fwd, b_flat = fl.pack_forward(params, c, dt)
        assert torch.equal(b_flat, torch.cat([b for _, b in ep]))
        assert (w_fwd.numel(), b_flat.numel()) == (
            fl.forward_weights_size(c, "wf"), fl.packed_sizes(c)[1])
    # the slab stream models at the kernel config, in f32
    dt = torch.float32
    P = [w.double().numpy() for w, _ in ep]
    D, W, Wc = kc.net_depth, kc.net_width, kc.net_width_condition
    trunk, den, views, rgb, wdir = unpack(
        fl.pack_params_wg(params, cfg, dt)[0], kc)
    for i, (h, x) in enumerate(trunk):
        if h is not None:
            np.testing.assert_array_equal(h[:W], P[i][:W])
        if x is not None:
            np.testing.assert_array_equal(x[:kc.location_features],
                                          P[0] if i == 0 else P[i][W:])
    np.testing.assert_array_equal(den[:W, :1], P[D])
    np.testing.assert_array_equal(views[0][:W], P[D + 1][:W])
    np.testing.assert_array_equal(wdir, P[D + 1][W:])
    np.testing.assert_array_equal(rgb[:Wc, :3], P[-1])
    views_t, trunk_t, wrgb, wden = unpack_wgt(
        fl.pack_params_wgt(params, cfg, dt), kc)
    for i, wt in trunk_t.items():
        np.testing.assert_array_equal(wt[:W], P[i][:W].T)
    np.testing.assert_array_equal(views_t[0][:Wc], P[D + 1][:W].T)
    for j in range(1, kc.net_depth_condition):
        np.testing.assert_array_equal(views_t[j][:Wc], P[D + 1 + j].T)
    np.testing.assert_array_equal(wrgb, P[-1].T)
    np.testing.assert_array_equal(wden, P[D].T)
    *_, xrows, _, _ = unpack_wgx(fl.pack_params_wgx(params, cfg, dt), kc)
    lx = kc.location_features
    for i, wt in xrows.items():
        np.testing.assert_array_equal(wt[:W, :lx],
                                      (P[0] if i == 0 else P[i][W:]).T)
    assert fl.pack_params_wgx(params, cfg, dt).numel() == fl.packed_wgx_size(
        cfg) == fl.packed_wgx_size(kc)
    assert fl.pack_params_wgt(params, cfg, dt).numel() == fl.packed_wgt_size(
        cfg)
    assert fl.pack_params_t(params, cfg, dt).numel() == fl.packed_t_size(cfg)
    assert fl.pack_params_tx(params, cfg, dt).numel() == fl.packed_tx_size(
        cfg)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_unembedding_inverts_the_embedding(row):
    """A random flat of grads at the real config, embedded (every dW, then
    every db, at the kernel widths) and un-embedded, comes back bit-equal;
    ``unpack_grads`` of it has the real shapes."""
    cfg = row_cfg(row)
    n = tmlp.num_params(cfg)
    flat = torch.from_numpy(np.random.default_rng(5).normal(size=n)
                            .astype(np.float32))
    ep = fl.embed_params(fl.unpack_grads(flat, cfg), cfg)
    padded = torch.cat([w.reshape(-1) for w, _ in ep] + [b for _, b in ep])
    assert padded.numel() == tmlp.num_params(fl.kernel_cfg(cfg))
    back = fl.unembed_grads(padded, cfg)
    assert torch.equal(back, flat)
    assert [tuple(w.shape) for w, _ in fl.unpack_grads(back, cfg)] == \
        tmlp.layer_dims(cfg)


ADMITTED = {
    "Config()": Config(),
    "net_width_1024": Config(net_width=1024),
    "float32": Config(compute_dtype="float32"),
    "narrow_64_32": Config(**dict(BASE, net_width=64, net_width_condition=32,
                                  net_depth=3, skip_layer=2)),
    "64_64_heads_4_2": Config(**dict(BASE, net_width=64,
                                     net_width_condition=64, net_depth=5,
                                     skip_layer=2, num_rgb_channels=4,
                                     num_density_channels=2)),
}


@pytest.mark.parametrize("name", sorted(ADMITTED))
def test_admitted_configs_pack_as_before(name):
    """Where the parent already admits the widths, ``kernel_cfg`` is the
    config itself, every stream is byte-equal to the layout run on the
    unpadded index, the biases are their concatenation and the grads pass
    the un-embedding untouched."""
    cfg = ADMITTED[name]
    assert fl.kernel_cfg(cfg) is cfg
    params = params_of(cfg)
    flat = torch.cat([torch.zeros(1)] + [w.reshape(-1) for w, _ in params])
    for dt in (torch.float32, torch.bfloat16):
        for kind in KINDS:
            idx, off = [], 1
            for i, o in tmlp.layer_dims(cfg):
                idx.append((torch.arange(off, off + i * o).view(i, o), None))
                off += i * o
            ref = flat.to(dt)[fl._LAYOUTS[kind](idx, cfg,
                                                dt == torch.bfloat16)]
            assert torch.equal(fl._gather(params, cfg, dt, kind), ref), kind
        assert torch.equal(fl.pack_params_wg(params, cfg, dt)[1],
                           torch.cat([b for _, b in params]))
    g = torch.randn(tmlp.num_params(cfg))
    assert fl.unembed_grads(g, cfg) is g
    assert fl.embed_params(params, cfg) is params


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------


def test_guard_admits_every_row_and_refuses_the_rest():
    """Every row (in each dtype the card takes) passes the level kernels'
    guard and the MLP kernels' (heads of any channel count), and takes the
    narrow route of every kernel (400 / 200 the wide one); f32 at
    net_width 260 (288 after padding) takes the wide route;
    net_width_condition 300 (320 after padding) and net_width 1025 (1056)
    take it too, in both dtypes, with no ceiling; heads of 9 channels,
    which the MLP kernels refused while a head was one group of 8, are
    taken."""
    for row, dtype in CASES:
        cfg = row_cfg(row, dtype)
        for any_heads in (False, True):
            fl.check_kernel_config(cfg, any_heads=any_heads)
        for kernel in fl.KERNELS:
            for input_grads in (True, False):
                assert (fl.takes_wide(cfg, kernel, 128, input_grads)
                        == (row == "400_200"))
        assert fl.uses_wide(cfg) == (row == "400_200")
    f32_260 = Config(net_width=260, compute_dtype="float32")
    assert fl.uses_wide(f32_260)
    for any_heads in (False, True):
        fl.check_kernel_config(f32_260, any_heads=any_heads)
    for kw, widths in ((dict(net_width=512, net_width_condition=300),
                        (512, 320)),
                       (dict(net_width=1025), (1056, 128))):
        for dtype in ("bfloat16", "float32"):
            cfg = Config(**kw, compute_dtype=dtype)
            kc = fl.kernel_cfg(cfg)
            assert (kc.net_width, kc.net_width_condition) == widths
            assert fl.uses_wide(cfg)
            for any_heads in (False, True):
                fl.check_kernel_config(cfg, any_heads=any_heads)
            fl.check_kernel_config(cfg.replace(num_rgb_channels=9),
                                   any_heads=True)


# ---------------------------------------------------------------------------
# The kernels' function on the padded streams, against JAX
# ---------------------------------------------------------------------------


def forward_model(params, cfg, dt, x, d):
    """raw_rgb, raw_den of the forward kernels' stream models at the kernel
    config: ``slab_forward`` on ``pack_params_wg``'s stream in f32
    (``wide_f32_model``, the f32 wide kernels' reads, on the wide route),
    the wide kernels' reads (``wide_model``: the bf16 rounding points) in
    bf16."""
    kc = fl.kernel_cfg(cfg)
    S = cfg.num_samples
    if dt == torch.float32 and fl.uses_wide(cfg):
        g = (torch.zeros(x.shape[0], cfg.num_rgb_channels),
             torch.zeros(x.shape[0], cfg.num_density_channels))
        return wide_f32_model(fl.embed_params(params, cfg), kc, x.float(),
                              d.float(), d.shape[0], S, *g)[:2]
    if dt == torch.float32:
        w, b = fl.pack_params_wg(params, cfg, dt)
        return [torch.from_numpy(a) for a in slab_forward(w, b, kc, x, d, S)]
    g = torch.zeros(x.shape[0], 3), torch.zeros(x.shape[0], 1)
    raw_rgb, raw_den, _, _ = wide_model(fl.embed_params(params, cfg), kc, x,
                                        d, d.shape[0], S, *g)
    return raw_rgb, raw_den


@pytest.mark.parametrize("mode", ["t", "mv"])
@pytest.mark.parametrize("row,dtype", CASES)
def test_padded_train_level_matches_jax_level_kernel(row, dtype, mode):
    """The train level at the kernel config (the forward and composite
    backward at the embedded weights; the g-chain and dW/db of the chain
    stream model, ``slab_backward`` in bf16 and the f32 one of
    ``test_torch_mlp_bwd_wg`` in f32, ``wide_f32_model`` on the f32 wide
    route) against JAX's interpreted
    ``_level_kernel`` at the real config: comp, acc, weights and every
    dW/db."""
    kw = dict(BASE, **ROWS[row], compute_dtype=dtype)
    jc, tc, jp, tp, c = level_case(kw, R, 3, mask=[1.0, 4.0, 0.0, 2.0])
    kc, dt = fl.kernel_cfg(tc), tmlp.compute_dtype(tc)
    S = tc.num_samples
    common = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]), J(c["pixels"]),
              J(c["g_scale"]), True)
    if mode == "mv":
        ref = j_level(jp, jc, None, *common, tile=16,
                      means_covs=(J(c["means"]), J(c["covs"])))
        x = fl.encode_mv(tc, T(c["means"]).reshape(-1, 3),
                         T(c["covs"]).reshape(-1, 3), dt)
    else:
        ref = j_level(jp, jc, J(c["x"]), *common, tile=16)
        x = T(c["x"]).reshape(R * S, -1).to(dt)
    d = T(c["dir_enc"]).to(dt)
    delta = interval_lengths(T(c["t_vals"]), T(c["dirs"]))
    ep = fl.embed_params(tp, tc)
    hs, vs, (comp, acc, weights, g_rgb, g_den) = forward_and_cotangents(
        ep, kc, x, d, delta, T(c["pixels"]), T(c["g_scale"]))
    for name, a, r in zip(("comp", "acc", "weights"), (comp, acc, weights),
                          ref[:3]):
        close(a.numpy(), r, dtype, name)
    if dt == torch.bfloat16:
        got = slab_backward(fl.pack_params_wgt(tp, tc, dt).float(), kc, x, d,
                            hs, vs, g_rgb, g_den[:, None], R, S)
    elif fl.uses_wide(tc):
        got = wide_f32_model(ep, kc, x, d, R, S, g_rgb, g_den[:, None])[4]
    else:
        got = mlp_slab_backward(kc, dt, ep, x, d, hs, vs, g_rgb,
                                g_den[:, None], R, S, False)[0]
    compare_grads(unembed_d_params(got, tc), ref[3], dtype)


@pytest.mark.parametrize("row,dtype", CASES)
def test_padded_render_level_matches_jax_render_kernel(row, dtype):
    """The render level in mode "mv": the forward stream model at the
    kernel config and the composite, against JAX's interpreted
    ``_render_kernel`` at the real config."""
    kw = dict(BASE, **ROWS[row], compute_dtype=dtype)
    jc, tc, jp, tp, c = level_case(kw, R, 4)
    dt = tmlp.compute_dtype(tc)
    ref = j_render(jp, jc, None, J(c["dir_enc"]), J(c["t_vals"]),
                   J(c["dirs"]), True, tile=16,
                   means_covs=(J(c["means"]), J(c["covs"])))
    x = fl.encode_mv(tc, T(c["means"]).reshape(-1, 3),
                     T(c["covs"]).reshape(-1, 3), dt)
    raw_rgb, raw_den = forward_model(tp, tc, dt, x, T(c["dir_enc"]).to(dt))
    delta = interval_lengths(T(c["t_vals"]), T(c["dirs"]))
    out = fl._composite_backward(tc, raw_rgb.float(), raw_den[:, 0].float(),
                                 delta, T(c["pixels"]), T(c["g_scale"]),
                                 True)
    for name, a, r in zip(("comp", "acc", "weights"), out[:3], ref):
        close(a.numpy(), r, dtype, name)


def mlp_inputs(tc, seed):
    rng = np.random.default_rng(seed)
    S, f32 = tc.num_samples, np.float32
    x = (rng.normal(size=(R, S, tc.location_features)) * 0.5).astype(f32)
    d = (rng.normal(size=(R, tc.direction_features)) * 0.5).astype(f32)
    g_rgb = rng.normal(size=(R * S, 3)).astype(f32)
    g_den = rng.normal(size=(R * S, 1)).astype(f32)
    return x, d, g_rgb, g_den


@pytest.mark.parametrize("row,dtype", CASES)
def test_padded_mlp_fwd_matches_jax_fwd_kernel(row, dtype):
    """``mlp_fwd``'s stream model at the kernel config against JAX's
    interpreted ``_fwd_kernel`` (``fused_mlp_apply``) at the real config:
    raw_rgb and raw_den."""
    kw = dict(BASE, **ROWS[row], compute_dtype=dtype)
    _, tc, jp, tp, _ = level_case(kw, R, 5)
    jc = level_case(kw, 1, 5)[0]
    x, d, _, _ = mlp_inputs(tc, 6)
    dt = tmlp.compute_dtype(tc)
    ref = jfm.fused_mlp_apply(jp, jc, J(x), J(d), tile=8)
    got = forward_model(tp, tc, dt, T(x).reshape(R * tc.num_samples, -1)
                        .to(dt), T(d).to(dt))
    for name, a, r in zip(("raw_rgb", "raw_den"), got, ref):
        close(a.numpy(), np.asarray(r).reshape(a.shape), dtype, name)


@pytest.mark.parametrize("row,dtype", CASES)
def test_padded_mlp_bwd_matches_jax_bwd_kernel(row, dtype):
    """``mlp_bwd``'s chain stream model (``pack_params_wgx``) at the kernel
    config with input_grads, against JAX's interpreted ``_bwd_kernel`` at
    the real config: every dW/db (padded entries exactly 0 before they are
    dropped), dX and dD."""
    kw = dict(BASE, **ROWS[row], compute_dtype=dtype)
    jc, tc, jp, tp, _ = level_case(kw, R, 7)
    x, d, g_rgb, g_den = mlp_inputs(tc, 8)
    S, dt = tc.num_samples, tmlp.compute_dtype(tc)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jfm._fused_mlp_bwd_impl(
        jp, J(x).reshape(R * S, -1).astype(jdt), J(d).astype(jdt), J(g_rgb),
        J(g_den), cfg=jc, tile=8, s=S, input_grads=True)
    kc, ep = fl.kernel_cfg(tc), fl.embed_params(tp, tc)
    xt, dtt = T(x).reshape(R * S, -1).to(dt), T(d).to(dt)
    _, _, hs, vs = fl.mlp_forward_acts(ep, kc, xt, dtt, R, S, dt)
    if dt == torch.float32 and fl.uses_wide(tc):
        got, dx, dd = wide_f32_model(ep, kc, xt, dtt, R, S, T(g_rgb),
                                     T(g_den))[4:]
    else:
        got, dx, dd = mlp_slab_backward(kc, dt, ep, xt, dtt, hs, vs,
                                        T(g_rgb), T(g_den), R, S, True)
    compare_grads(unembed_d_params(got, tc), ref[0], dtype)
    close(dx, np.asarray(ref[1], np.float32), dtype, "dX")
    close(dd, np.asarray(ref[2], np.float32), dtype, "dD")


# ---------------------------------------------------------------------------
# A whole train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", ["48_16", "32_64"])
def test_two_padded_train_steps_match_jax(row):
    """``test_torch_train_step``'s two fused-level steps against JAX's at
    the row's widths and the tiny config's depth (on the CPU the plain
    level, which the card's kernels are held against)."""
    w = {k: ROWS[row][k] for k in ("net_width", "net_width_condition")}
    check_two_steps(branch_kw("fused_level", **w), True)
