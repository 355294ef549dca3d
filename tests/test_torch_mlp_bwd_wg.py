"""``mlp_bwd``'s bf16 route on ``csrc/train_wg.cuh``'s passes, on the CPU:
its g-chain stream with the x rows (``pack_params_wgx``), the arithmetic of
a chain that multiplies slab by slab from it (dX and dD included), its
shared-memory budget and the wrapper's checks.

A plain-Python model of the slab stream (``test_torch_wg_layout.Stream``)
unpacks the pack back into every chained layer's W^T, the x rows' W^T
(zero-padded to ``dx_width`` columns) and the heads' W^T. A g-chain that
multiplies slab by slab from that model with the kernel's rounding points
(the compute type after every product; the density head's term over its
channels rounded once and added in the compute type; the ReLU mask after
rounding; dX accumulated in the compute type, the deepest skip layer's
term first and layer 0's last; dD from the rounded per-ray sums), and the
dW/db over the rows from its masked g, match ``mlp_backward_plain`` and
the JAX package's ``_bwd_kernel`` (interpret mode, bf16 at S=8 as
``tests/test_torch_train_wg.py`` notes).

Tolerances: unpacking is a permutation with zero padding, so exact; the
model (f64 sums) against the plain version in the plain version's dtype
within that dtype's parity band of ``nerf_or_nothing_tpu/utils/
parity.py`` (f32 (1e-6, 1e-3), bf16 (2e-3, 3e-2)) as a normalized error
< 1, and against JAX in bf16 within the bf16 band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from test_torch_fused_mlp import J, as_dt, mlp_case  # noqa: E402
from test_torch_train_wg import (  # noqa: E402
    bf,
    normalized_err,
    slab_product,
    unembed_d_params,
)
from test_torch_wg_layout import Stream  # noqa: E402

from nerf_or_nothing_tpu.kernels import fused_mlp as jfm  # noqa: E402

BANDS = {"float32": (1e-6, 1e-3), "bfloat16": (2e-3, 3e-2)}

CONFIGS = {
    "config": dict(),
    "narrow": dict(net_width=64, net_width_condition=32, net_depth=3,
                   skip_layer=2, max_deg_point=4, num_samples=8),
    "depth5_skip2": dict(net_width=96, net_width_condition=64, net_depth=5,
                         skip_layer=2, net_depth_condition=2, max_deg_point=6,
                         num_samples=16),
    # location_features 60: the x rows padded to 64 columns
    "lx60_w224": dict(net_width=224, net_width_condition=160, net_depth=4,
                      skip_layer=3, max_deg_point=10, num_samples=12),
    "heads_8_8": dict(net_width=64, net_width_condition=32, net_depth=5,
                      skip_layer=2, max_deg_point=4, num_samples=8,
                      num_rgb_channels=8, num_density_channels=8),
}
HEADS = [(3, 1), (1, 1), (8, 8)]


def params_of(cfg, seed=0):
    return tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg)


def x_layers(cfg):
    return [i for i in range(cfg.net_depth)
            if i == 0 or i % cfg.skip_layer == 0]


def unpack_wgx(flat, cfg):
    """The chain stream with the x rows as the kernel reads it: {view j:
    W^T [K_pad, N]}, {trunk i: W^T [K_pad, N]} (h rows), {x layer i: W_x^T
    [W_pad, dx_width]}, then W_rgb^T [C_rgb, Wc] and W_den^T [C_den, W]."""
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    W, Wc, nxw = cfg.net_width, cfg.net_width_condition, fl.dx_width(cfg)
    st = Stream(flat)
    views = {j: st.slabs(Wc, Wc) for j in range(Dc - 1, 0, -1)}
    views[0] = st.slabs(Wc, W)
    trunk, xrows = {}, {}
    for i in range(D - 1, -1, -1):
        if i in x_layers(cfg):
            xrows[i] = st.slabs(W, nxw)
        if i > 0:
            trunk[i] = st.slabs(W, W)
    rest = st.rest()
    cr, cd = cfg.num_rgb_channels, cfg.num_density_channels
    assert rest.size == cr * Wc + cd * W
    return (views, trunk, xrows, rest[:cr * Wc].reshape(cr, Wc),
            rest[cr * Wc:].reshape(cd, W))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wgx_pack_unpacks_to_every_chained_layer(name, dtype):
    cfg = Config(**CONFIGS[name])
    params = params_of(cfg)
    flat = fl.pack_params_wgx(params, cfg, dtype)
    assert flat.shape == (fl.packed_wgx_size(cfg),) and flat.dtype == dtype
    views, trunk, xrows, wrgb, wden = unpack_wgx(flat.float(), cfg)
    D, W, Wc = cfg.net_depth, cfg.net_width, cfg.net_width_condition
    lx, nxw = cfg.location_features, fl.dx_width(cfg)
    assert nxw % 32 == 0 and lx <= nxw < lx + 32
    P = [p.to(dtype).double().numpy() for p, _ in params]
    for i, wt in trunk.items():
        np.testing.assert_array_equal(wt[:W], P[i][:W].T)
        assert not wt[W:].any()
    for i, wt in xrows.items():
        np.testing.assert_array_equal(wt[:W, :lx], (P[0] if i == 0
                                                    else P[i][W:]).T)
        assert not wt[W:].any() and not wt[:, lx:].any()
    assert sorted(xrows) == x_layers(cfg)
    np.testing.assert_array_equal(views[0][:Wc], P[D + 1][:W].T)
    for j in range(1, cfg.net_depth_condition):
        np.testing.assert_array_equal(views[j][:Wc], P[D + 1 + j].T)
    np.testing.assert_array_equal(wrgb, P[-1].T)
    np.testing.assert_array_equal(wden, P[D].T)
    # the train kernel's stream is the same without the x rows
    assert fl.packed_wgx_size(cfg) - fl.packed_wgt_size(cfg) == (
        len(x_layers(cfg)) * -(-W // 64) * 64 * nxw)


def slab_backward(cfg, dt, params, x, d, hs, vs, g_rgb, g_den, R, S,
                  input_grads):
    """The bf16 route's g-chain from the stream model (``rnd`` the compute
    type's rounding), dX and dD with ``input_grads``, and dW/db over the
    rows from its masked g (f64 sums). Returns (d_params, dx, dd) as
    ``mlp_backward_plain``."""
    rnd = bf if dt == torch.bfloat16 else (
        lambda a: np.asarray(a, np.float32).astype(np.float64))
    views, trunk, xrows, wrgb, wden = unpack_wgx(
        fl.pack_params_wgx(params, cfg, dt).float(), cfg)
    fd, Wc = cfg.direction_features, cfg.net_width_condition
    w_dir = fl.pack_params_wg(params, cfg, dt)[0][-fd * Wc:].double().numpy()
    D, Dc, lx = cfg.net_depth, cfg.net_depth_condition, cfg.location_features
    f = lambda t: t.double().numpy()  # noqa: E731
    hs, vs, x, d = [f(h) for h in hs], [f(v) for v in vs], f(x), f(d)
    g_rgb, g_den = f(g_rgb), f(g_den)
    grads = {}
    g = rnd(rnd(g_rgb) @ wrgb) * (vs[-1] > 0)
    grads[D + Dc - 1] = g
    for j in range(Dc - 1, 0, -1):
        g = rnd(slab_product(g, views[j])) * (vs[j - 1] > 0)
        grads[D + j - 1] = g
    g = rnd(rnd(slab_product(g, views[0])) + rnd(rnd(g_den) @ wden))
    g = g * (hs[-1] > 0)
    grads[D - 1] = g
    dx = None
    for i in range(D - 1, -1, -1):
        if input_grads and i in xrows:
            term = rnd(slab_product(g, xrows[i]))[:, :lx]
            dx = term if dx is None else rnd(dx + term)
        if i == 0:
            break
        g = rnd(slab_product(g, trunk[i])) * (hs[i - 1] > 0)
        grads[i - 1] = g
    d_params = []
    for i in range(D):
        a = x if i == 0 else hs[i - 1]
        dw = a.T @ grads[i]
        if i > 0 and i % cfg.skip_layer == 0:
            dw = np.concatenate([dw, x.T @ grads[i]])
        d_params.append((dw, grads[i].sum(0)))
    d_params.append((hs[-1].T @ rnd(g_den), g_den.sum(0)))
    g_ray = None
    for j in range(Dc):
        gv = grads[D + j]
        a = hs[-1] if j == 0 else vs[j - 1]
        dw = a.T @ gv
        if j == 0:
            g_ray = gv.reshape(R, S, -1).sum(1)
            dw = np.concatenate([dw, d.T @ rnd(g_ray)])
        d_params.append((dw, gv.sum(0)))
    d_params.append((vs[-1].T @ rnd(g_rgb), g_rgb.sum(0)))
    dd = rnd(g_ray) @ w_dir.reshape(fd, Wc).T if input_grads else None
    return d_params, dx, dd


def check_outputs(got, ref, dtype):
    """(d_params, dx, dd) against the reference's, within ``dtype``'s band."""
    band = BANDS[dtype]
    assert len(got[0]) == len(ref[0])
    for k, ((dw, db), (rw, rb)) in enumerate(zip(got[0], ref[0])):
        rw, rb = np.asarray(rw, np.float64), np.asarray(rb, np.float64)
        assert dw.shape == rw.shape and db.shape == rb.shape, k
        assert normalized_err(dw, rw, *band) < 1.0, ("dW", k)
        assert normalized_err(db, rb, *band) < 1.0, ("db", k)
    for what, a, b in (("dX", got[1], ref[1]), ("dD", got[2], ref[2])):
        if b is None:
            assert a is None
            continue
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, what
        assert normalized_err(a, b, *band) < 1.0, what


def cotangents(cfg, N, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(N, c)).astype(np.float32))
            for c in (cfg.num_rgb_channels, cfg.num_density_channels)]


@pytest.mark.parametrize("input_grads", [True, False])
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}_{h[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_chain_with_dx_matches_mlp_backward_plain(dtype, heads,
                                                       input_grads):
    """Depth 5 with skips at 2 and 4 (dX sums two x-row terms and layer
    0's), two view layers, ragged rays; every dW/db, dX and dD."""
    cfg = Config(**dict(CONFIGS["depth5_skip2"], compute_dtype=dtype,
                        num_rgb_channels=heads[0],
                        num_density_channels=heads[1]))
    R, S = 3, cfg.num_samples
    dt = tmlp.compute_dtype(cfg)
    params = params_of(cfg, seed=1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(R * S, cfg.location_features))
                         .astype(np.float32) * 0.5).to(dt)
    d = torch.from_numpy(rng.normal(size=(R, cfg.direction_features))
                         .astype(np.float32) * 0.5).to(dt)
    g_rgb, g_den = cotangents(cfg, R * S, 3)
    _, _, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    got = slab_backward(cfg, dt, params, x, d, hs, vs, g_rgb, g_den, R, S,
                        input_grads)
    d_params, dx, dd = fl.mlp_backward_plain(params, cfg, x, d, hs, vs, g_rgb,
                                             g_den, R, S, dt, input_grads)
    ref = ([(w.numpy(), b.numpy()) for w, b in d_params],
           None if dx is None else dx.float().numpy(),
           None if dd is None else dd.numpy())
    check_outputs(got, ref, dtype)


@pytest.mark.parametrize("input_grads", [True, False])
@pytest.mark.parametrize("heads", [(3, 1), (8, 8)],
                         ids=lambda h: f"{h[0]}_{h[1]}")
def test_slab_chain_with_dx_matches_jax_bwd_kernel(heads, input_grads):
    """The slab model's dW/db, dX and dD (on the port's forward) against
    the interpreted JAX ``_bwd_kernel`` in bf16, skips at 2 and 4. The
    model runs at the kernel widths (``kernel_cfg``: 32 / 16 packs as
    32 / 32), its grads through the un-embedding."""
    kw = dict(net_depth=5, net_width=32, net_depth_condition=1,
              net_width_condition=16, skip_layer=2, max_deg_point=4,
              compute_dtype="bfloat16", num_rgb_channels=heads[0],
              num_density_channels=heads[1])
    R, S = 4, 8
    jc, tc, jp, tp, x, d, g_rgb, g_den = mlp_case(kw, R, S, seed=11)
    ref = jfm._fused_mlp_bwd_impl(
        jp, J(x).reshape(R * S, -1).astype(jnp.bfloat16),
        J(d).astype(jnp.bfloat16), J(g_rgb), J(g_den), cfg=jc, tile=8, s=S,
        input_grads=input_grads)
    dt = torch.bfloat16
    xt, dtt = as_dt(x, tc).reshape(R * S, -1), as_dt(d, tc)
    kc, ep = fl.kernel_cfg(tc), fl.embed_params(tp, tc)
    _, _, hs, vs = fl.mlp_forward_acts(ep, kc, xt, dtt, R, S, dt)
    got = slab_backward(kc, dt, ep, xt, dtt, hs, vs, torch.from_numpy(g_rgb),
                        torch.from_numpy(g_den), R, S, input_grads)
    got = ([(w.numpy(), b.numpy()) for w, b in unembed_d_params(got[0], tc)],
           *got[1:])
    ref = (ref[0], None if not input_grads else np.asarray(ref[1], np.float32),
           None if not input_grads else np.asarray(ref[2], np.float32))
    check_outputs(got, ref, "bfloat16")


@pytest.mark.parametrize("dx", [False, True])
def test_mlp_bwd_chain_smem_fits_every_admitted_width(dx):
    """Every width ``check_kernel_config`` admits, heads of 1-8 channels
    each, the feature widths of max_deg_point 4-32: the chain (with the dX
    partials and x-row slots of ``input_grads``) and the recomputed
    forward fit a block, and the router keeps ``mlp_bwd`` on the narrow
    route."""
    for W in range(32, 257, 32):
        for Wc in range(32, W + 1, 32):
            for deg in (4, 16, 32):
                for heads in ((1, 1), (3, 1), (8, 8)):
                    cfg = Config(net_width=W, net_width_condition=Wc,
                                 max_deg_point=deg, num_rgb_channels=heads[0],
                                 num_density_channels=heads[1])
                    fl.check_kernel_config(cfg, any_heads=True)
                    nbytes, stages = fl.chain_wg_smem(cfg, dx=dx)
                    assert nbytes is not None and nbytes <= fl.SMEM_LIMIT
                    assert stages >= 2
                    assert not fl.takes_wide(cfg, "mlp_bwd",
                                             cfg.num_samples, dx)
    # without dX the chain is the train kernel's; the dX partials cost the
    # default config one of its four slots
    assert fl.chain_wg_smem(Config()) == fl.chain_wg_smem(Config(), dx=False)
    assert fl.chain_wg_smem(Config(), dx=True)[1] == 3


@pytest.mark.parametrize("kw,input_grads,what", [
    (dict(max_deg_point=44), True, "CUDA tensor"),
    (dict(max_deg_point=44), False, "CUDA tensor"),
    (dict(net_depth=100), False, "CUDA tensor"),
    (dict(max_deg_point=80), False, "CUDA tensor")])
def test_mlp_bwd_rejected_config_raises_before_launch(kw, input_grads, what):
    """x rows wider than 256 columns (dX) and features too wide for the
    recomputed forward, which the bf16 narrow route refused, now take the
    wide route (CPU tensors then reach the device check); so do 102
    layers, whose biases the bf16 g-chain's shared memory does not hold
    (f32 keeps the narrow route there)."""
    cfg = Config(**kw)
    params = params_of(cfg.replace(net_depth=min(cfg.net_depth, 8)))
    R, S = 2, cfg.num_samples
    x = torch.zeros(R * S, cfg.location_features, dtype=torch.bfloat16)
    d = torch.zeros(R, cfg.direction_features, dtype=torch.bfloat16)
    g_rgb, g_den = torch.zeros(R * S, 3), torch.zeros(R * S, 1)
    before = fm.mlp_bwd.launches
    with pytest.raises(ValueError, match=what):
        fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den, input_grads)
    assert fm.mlp_bwd.launches == before
    f32 = cfg.replace(compute_dtype="float32")
    if "net_depth" in kw:
        assert fl.takes_wide(cfg, "mlp_bwd", S, input_grads)
        assert not fl.takes_wide(f32, "mlp_bwd", S, True)
    else:  # the narrow f32 dX product is at most 256 columns wide
        wide = kw["max_deg_point"] > 64 or input_grads
        assert fl.takes_wide(cfg, "mlp_bwd", S, input_grads) == wide
        assert fl.takes_wide(f32, "mlp_bwd", S, True)


def test_pack_mlp_params_per_route():
    """bf16 ``"wg"``: the forward's stream, the biases and the chain stream
    with the x rows; f32, and the ``mma.sync`` kernel's ``"fwd"``: the
    recompute weights, W^T and x-row W^T besides. ``_check_packed`` takes
    each route's tuple and refuses the other's."""
    cfg = Config(**CONFIGS["narrow"])
    params = params_of(cfg)
    bf16 = torch.bfloat16
    w, b, wt = fm.pack_mlp_params(params, cfg, bf16)
    assert torch.equal(w, fl.pack_params_wg(params, cfg, bf16)[0])
    assert torch.equal(wt, fl.pack_params_wgx(params, cfg, bf16))
    assert torch.equal(b, torch.cat([bb.reshape(-1) for _, bb in params]))
    fm._check_packed(cfg, (w, b, wt), w.device, bwd_layout="wg")
    old = fm.pack_mlp_params(params, cfg, bf16, layout="fwd")
    assert len(old) == 5 and torch.equal(old[0], w)
    ref = (fl.pack_params(params, cfg, bf16)[0],
           fl.pack_params_t(params, cfg, bf16),
           fl.pack_params_tx(params, cfg, bf16))
    assert all(torch.equal(a, r) for a, r in zip(old[2:], ref))
    fm._check_packed(cfg, old, w.device, bwd_layout="fwd")
    with pytest.raises(ValueError, match="3 tensors"):
        fm._check_packed(cfg, old, w.device, bwd_layout="wg")
    f32 = cfg.replace(compute_dtype="float32")
    packed = fm.pack_mlp_params(params, f32, torch.float32)
    assert len(packed) == 5 and packed[2] is packed[0]
    fm._check_packed(f32, packed, w.device, bwd_layout="wg")
    assert len(fm.pack_mlp_params(params, cfg, bf16, backward=False)) == 2
