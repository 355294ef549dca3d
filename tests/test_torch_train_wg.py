"""The bf16 train kernel's g-chain stream (``pack_params_wgt``, read by
``csrc/train_wg.cuh``), its arithmetic, its shared-memory budget and the
train step's packing per route, on the CPU.

A plain-Python model of the slab stream (slabs of 64 K-rows, each row of
W^T's K-major form, i.e. W's own rows, 128 bytes with the 16-byte chunk c
of row n at position c ^ (n % 8)) unpacks the pack back into every chained
layer's W^T and the heads' W^T. A g-chain that multiplies slab by slab
from that model, with the kernel's rounding points (bf16 after every
product, the density head's term rounded and added in bf16, the ReLU mask
after rounding), and the dW/db over the rows from its masked g, match
``mlp_backward_plain`` and the JAX package's ``_level_kernel`` (interpret
mode, as ``tests/test_torch_train_level.py`` runs it).

Tolerances: unpacking is a permutation with zero padding, so exact; the
model against the plain version and the JAX kernel, both in bf16, within
the bf16 parity band (2e-3, 3e-2) of ``nerf_or_nothing_tpu/utils/
parity.py`` as a normalized error < 1 (the model sums each product in f64,
the others in f32, so a bf16 rounding may land one step apart).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops.render import interval_lengths  # noqa: E402
from test_torch_train_level import J, T, level_case  # noqa: E402
from test_torch_wg_layout import Stream  # noqa: E402

from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_train as j_level,
)

BF16_BAND = (2e-3, 3e-2)

CONFIGS = {
    "config": dict(),
    "narrow": dict(net_width=64, net_width_condition=32, net_depth=3,
                   skip_layer=2, max_deg_point=4, num_samples=8),
    "two_view_layers": dict(net_width=96, net_width_condition=64,
                            net_depth=5, skip_layer=2, net_depth_condition=3,
                            max_deg_point=6, num_samples=16),
    "w224": dict(net_width=224, net_width_condition=160, net_depth=4,
                 skip_layer=3, max_deg_point=10, num_samples=12),
}


def params_of(cfg, seed=0):
    return tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg)


def unpack_wgt(flat, cfg):
    """The chain stream as the kernel reads it: {view j: W^T [K_pad, N]},
    {trunk i: W^T [K_pad, N]} (K = fan_out, N = fan_in, h rows only), then
    W_rgb^T [C_rgb, Wc] and W_den^T [C_den, W]."""
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    W, Wc = cfg.net_width, cfg.net_width_condition
    st = Stream(flat)
    views = {j: st.slabs(Wc, Wc) for j in range(Dc - 1, 0, -1)}
    views[0] = st.slabs(Wc, W)
    trunk = {i: st.slabs(W, W) for i in range(D - 1, 0, -1)}
    rest = st.rest()
    cr, cd = cfg.num_rgb_channels, cfg.num_density_channels
    assert rest.size == cr * Wc + cd * W
    return views, trunk, rest[:cr * Wc].reshape(cr, Wc), rest[cr * Wc:].reshape(cd, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wgt_pack_unpacks_to_every_chained_layer(name, dtype):
    cfg = Config(**CONFIGS[name])
    params = params_of(cfg)
    flat = fl.pack_params_wgt(params, cfg, dtype)
    assert flat.shape == (fl.packed_wgt_size(cfg),) and flat.dtype == dtype
    views, trunk, wrgb, wden = unpack_wgt(flat.float(), cfg)
    D, W, Wc = cfg.net_depth, cfg.net_width, cfg.net_width_condition
    P = [p.to(dtype).double().numpy() for p, _ in params]
    for i, wt in trunk.items():
        np.testing.assert_array_equal(wt[:W], P[i][:W].T)
        assert not wt[W:].any()  # K zero-padded to whole slabs
    np.testing.assert_array_equal(views[0][:Wc], P[D + 1][:W].T)
    assert not views[0][Wc:].any()
    for j in range(1, cfg.net_depth_condition):
        np.testing.assert_array_equal(views[j][:Wc], P[D + 1 + j].T)
        assert not views[j][Wc:].any()
    np.testing.assert_array_equal(wrgb, P[-1].T)
    np.testing.assert_array_equal(wden, P[D].T)


def test_pack_train_level_layouts():
    """bf16: the forward's slab stream and the chain stream; f32 and the
    mma.sync kernel's layout: ``pack_train_params``."""
    cfg = Config(**CONFIGS["narrow"])
    params = params_of(cfg)
    w, b, wt = fl.pack_train_level(params, cfg, torch.bfloat16)
    assert torch.equal(w, fl.pack_params_wg(params, cfg, torch.bfloat16)[0])
    assert torch.equal(wt, fl.pack_params_wgt(params, cfg, torch.bfloat16))
    assert torch.equal(b, torch.cat([bb.reshape(-1) for _, bb in params]))
    assert fl.train_weight_sizes(cfg, "wg") == (w.numel(), wt.numel())
    for dt, layout in ((torch.float32, "wg"), (torch.bfloat16, "fwd")):
        got = fl.pack_train_level(params, cfg, dt, layout)
        ref = fl.pack_train_params(params, cfg, dt)
        assert all(torch.equal(a, r) for a, r in zip(got, ref))
        c = cfg.replace(compute_dtype="float32" if dt == torch.float32
                        else "bfloat16")
        assert fl.train_weight_sizes(c, layout) == (
            fl.packed_sizes(cfg)[0], fl.packed_t_size(cfg))


def bf(a):
    """Round to bf16 (nearest even), back in f64."""
    return torch.from_numpy(np.asarray(a, np.float64)).to(
        torch.bfloat16).double().numpy()


def slab_product(g, wt):
    """g [n, K] @ wt [K_pad, N], summed slab by slab (64 K-rows) in f64."""
    gp = np.zeros((g.shape[0], wt.shape[0]))
    gp[:, :g.shape[1]] = g
    acc = np.zeros((g.shape[0], wt.shape[1]))
    for s in range(0, wt.shape[0], 64):
        acc = acc + gp[:, s:s + 64] @ wt[s:s + 64]
    return acc


def slab_backward(wt_flat, cfg, x, d, hs, vs, g_rgb, g_den, R, S):
    """The bf16 kernel's g-chain from the stream model and dW/db over the
    rows from its masked g (f64 sums of bf16 operands). Returns d_params
    in layer order, as ``mlp_backward_plain``."""
    views, trunk, wrgb, wden = unpack_wgt(wt_flat, cfg)
    D, Dc, W = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    f = lambda t: t.double().numpy()  # noqa: E731
    hs, vs, x, d = [f(h) for h in hs], [f(v) for v in vs], f(x), f(d)
    g_rgb, g_den = f(g_rgb), f(g_den)
    # the chain, top layer first: masked g of every hidden layer
    grads = {}
    g = bf(bf(g_rgb) @ wrgb) * (vs[-1] > 0)
    grads[D + Dc - 1] = g
    for j in range(Dc - 1, 0, -1):
        g = bf(slab_product(g, views[j])) * (vs[j - 1] > 0)
        grads[D + j - 1] = g
    g = bf(bf(slab_product(g, views[0])) + bf(bf(g_den) @ wden))
    g = g * (hs[-1] > 0)
    grads[D - 1] = g
    for i in range(D - 1, 0, -1):
        g = bf(slab_product(g, trunk[i])) * (hs[i - 1] > 0)
        grads[i - 1] = g
    d_params = []
    for i in range(D):
        a = x if i == 0 else hs[i - 1]
        dw = a.T @ grads[i]
        if i > 0 and i % cfg.skip_layer == 0:
            dw = np.concatenate([dw, x.T @ grads[i]])
        d_params.append((dw, grads[i].sum(0)))
    d_params.append((hs[-1].T @ bf(g_den), g_den.sum(0)))
    for j in range(Dc):
        gv = grads[D + j]
        a = hs[-1] if j == 0 else vs[j - 1]
        dw = a.T @ gv
        if j == 0:
            g_ray = gv.reshape(R, S, -1).sum(1)
            dw = np.concatenate([dw, d.T @ bf(g_ray)])
        d_params.append((dw, gv.sum(0)))
    d_params.append((vs[-1].T @ bf(g_rgb), g_rgb.sum(0)))
    return d_params


def normalized_err(a, b, atol, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    band = atol + rtol * np.abs(b) + rtol * np.abs(b).max()
    return float((np.abs(a - b) / band).max())


def unembed_d_params(d_params, cfg):
    """A stream model's d_params at ``kernel_cfg(cfg)``'s widths as the
    wrappers return them at ``cfg``'s: the padded entries of dW/db must be
    exactly 0, then the un-embedding drops them (``unembed_grads``).
    Returns a list of (dW, db) f64 tensors."""
    flat = torch.cat([torch.as_tensor(np.asarray(a, np.float64)).reshape(-1)
                      for k in (0, 1) for a in (p[k] for p in d_params)])
    assert flat.numel() == tmlp.num_params(fl.kernel_cfg(cfg))
    pad = torch.ones(flat.numel(), dtype=torch.bool)
    pad[fl._unembed_index(cfg, torch.device("cpu"))] = False
    assert not flat[pad].any(), "a padded dW/db entry is not 0"
    return fl.unpack_grads(fl.unembed_grads(flat, cfg), cfg)


def check_d_params(got, ref):
    assert len(got) == len(ref)
    for k, ((dw, db), (rw, rb)) in enumerate(zip(got, ref)):
        rw, rb = np.asarray(rw), np.asarray(rb)
        assert dw.shape == rw.shape and db.shape == rb.shape, k
        assert normalized_err(dw, rw, *BF16_BAND) < 1.0, ("dW", k)
        assert normalized_err(db, rb, *BF16_BAND) < 1.0, ("db", k)


def level_inputs(cfg, R, seed):
    rng = np.random.default_rng(seed)
    S = cfg.num_samples
    T_ = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    means = T_(rng.normal(size=(R * S, 3)))
    covs = T_(rng.uniform(0, 0.02, (R * S, 3)))
    d = T_(rng.normal(size=(R, cfg.direction_features)) * 0.5)
    t_vals = T_(np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1))
    dirs = T_(rng.normal(size=(R, 3)))
    pixels = T_(rng.uniform(size=(R, 3)))
    mask = rng.uniform(0.5, 2.0, R)
    mask[::3] = 0.0
    g_scale = T_((2.0 * mask / mask.sum())[:, None])
    return means, covs, d, interval_lengths(t_vals, dirs), pixels, g_scale


def forward_and_cotangents(params, cfg, x, d, delta, pixels, g_scale):
    """The plain forward's activations and the composite backward's head
    cotangents (``level_train_plain``'s first half)."""
    dt = tmlp.compute_dtype(cfg)
    R, S = delta.shape
    raw_rgb, raw_den, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    out = fl._composite_backward(cfg, raw_rgb, raw_den[:, 0], delta, pixels,
                                 g_scale, True)
    return hs, vs, out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slab_chain_and_dw_match_mlp_backward_plain(name):
    cfg = Config(**dict(CONFIGS[name], compute_dtype="bfloat16"))
    R, S = 4, cfg.num_samples
    params = params_of(cfg, seed=1)
    means, covs, d, delta, pixels, g_scale = level_inputs(cfg, R, 2)
    dt = torch.bfloat16
    x, d = fl.encode_mv(cfg, means, covs, dt), d.to(dt)
    hs, vs, (_, _, _, g_rgb, g_den) = forward_and_cotangents(
        params, cfg, x, d, delta, pixels, g_scale)
    got = slab_backward(fl.pack_params_wgt(params, cfg, dt).float(), cfg, x,
                        d, hs, vs, g_rgb, g_den[:, None], R, S)
    ref, _, _ = fl.mlp_backward_plain(params, cfg, x, d, hs, vs, g_rgb,
                                      g_den[:, None], R, S, dt)
    check_d_params(got, [(w.numpy(), b.numpy()) for w, b in ref])


@pytest.mark.parametrize("mode", ["t", "mv"])
@pytest.mark.parametrize("kw", [
    dict(net_depth=3, net_width=32, net_width_condition=16, skip_layer=2,
         max_deg_point=4, num_samples=8),
    dict(net_depth=5, net_width=64, net_width_condition=32, skip_layer=2,
         net_depth_condition=2, max_deg_point=4, num_samples=8),
], ids=["small", "two_view_layers"])
def test_slab_chain_and_dw_match_jax_level_kernel(kw, mode):
    """The slab model's dW/db (on the port's forward and composite
    backward) against the interpreted JAX ``_level_kernel`` in bf16. The
    models run at the kernel widths (``kernel_cfg``: 32 / 16 packs as
    32 / 32), their grads through the un-embedding."""
    kw = dict(kw, compute_dtype="bfloat16")
    R = 5
    jc, tc, jp, tp, c = level_case(kw, R, 3, mask=[1.0, 4.0, 0.0, 2.0, 1.0])
    common = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]), J(c["pixels"]),
              J(c["g_scale"]), True)
    S, dt = tc.num_samples, torch.bfloat16
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
    kc = fl.kernel_cfg(tc)
    hs, vs, (comp, acc, weights, g_rgb, g_den) = forward_and_cotangents(
        fl.embed_params(tp, tc), kc, x, d, delta, T(c["pixels"]),
        T(c["g_scale"]))
    for a, r in zip((comp, acc, weights), ref[:3]):
        assert normalized_err(a.numpy(), np.asarray(r), *BF16_BAND) < 1.0
    got = slab_backward(fl.pack_params_wgt(tp, tc, dt).float(), kc, x, d, hs,
                        vs, g_rgb, g_den[:, None], R, S)
    check_d_params(unembed_d_params(got, tc), ref[3])


@pytest.mark.parametrize("S", [64, 128, 256])
def test_train_wg_smem_fits_every_admitted_width(S):
    """Every width ``check_kernel_config`` admits, at the feature widths of
    max_deg_point 4-32: the forward and the g-chain fit a block."""
    for W in range(32, 257, 32):
        for Wc in range(32, W + 1, 32):
            for deg in (4, 16, 32):
                cfg = Config(net_width=W, net_width_condition=Wc,
                             max_deg_point=deg, num_samples=S)
                fl.check_kernel_config(cfg)
                for nbytes, stages in (fl.wg_smem(cfg, S, False),
                                       fl.chain_wg_smem(cfg)):
                    assert nbytes is not None and nbytes <= fl.SMEM_LIMIT
                    assert stages >= 2
                for kernel in ("train_level", "train_level_twopass"):
                    assert not fl.takes_wide(cfg, kernel, S)
    # the default config keeps a ring of 4 chain slabs
    assert fl.chain_wg_smem(Config())[1] == 4


@pytest.mark.parametrize("kw,what", [(dict(max_deg_point=80), "CUDA tensor"),
                                     (dict(net_depth=100), "CUDA tensor")])
def test_train_wg_rejected_config_raises_before_launch(kw, what):
    """Features too wide for the forward's tiles, which the bf16 narrow
    route refused, take the wide route (CPU tensors then reach the device
    check), and so do more biases than the chain's shared memory holds
    (102 layers; f32 keeps the narrow route there): ``train_level_cuda``
    raises before any launch, naming the device."""
    cfg = Config(**kw)
    S = cfg.num_samples
    assert (fl.wg_smem(cfg, S, False)[0] is None
            or fl.chain_wg_smem(cfg)[0] is None)
    params = params_of(cfg.replace(net_depth=min(cfg.net_depth, 8)))
    R = 2
    means, covs, d, delta, pixels, g_scale = level_inputs(cfg, R, 0)
    before = fl.train_level.launches
    with pytest.raises(ValueError, match=what):
        fl.train_level_cuda(params, cfg, (means, covs), d.to(torch.bfloat16),
                            delta, pixels, g_scale, True, "mv")
    assert fl.train_level.launches == before
    f32 = cfg.replace(compute_dtype="float32")
    if "net_depth" in kw:
        assert fl.takes_wide(cfg, "train_level", S)
        assert not fl.takes_wide(f32, "train_level", S)
    else:  # the f32 tiles still fit at 480 feature columns
        assert fl.takes_wide(cfg, "train_level", S)
        assert not fl.takes_wide(f32, "train_level", S)


@pytest.mark.parametrize("probes,fuse_ipe,twopass", [
    ("", False, False), ("fl_variant=twopass", False, True),
    ("fl_variant=twopass", True, False)])
def test_each_route_gets_its_own_packing(monkeypatch, probes, fuse_ipe,
                                         twopass):
    """``pack_train`` (what ``train.py`` packs once per step) gives both
    train kernels ``pack_train_level``'s layout (the two-pass kernel's
    bf16 route runs ``train_level``'s passes), and the level launches the
    kernel its route names."""
    cfg = Config(**dict(CONFIGS["narrow"], kernel_probes=probes,
                        fuse_ipe=fuse_ipe))
    assert ttrain.use_fused_level(cfg)
    params = params_of(cfg)
    assert fl.uses_twopass(cfg) == twopass
    packed = fl.pack_train(params, cfg, torch.bfloat16)
    assert (packed[0].numel(), packed[2].numel()) == fl.train_weight_sizes(
        cfg, "wg")
    ref = fl.pack_train_level(params, cfg, torch.bfloat16)
    assert all(torch.equal(a, r) for a, r in zip(packed, ref))
    # the kernel the level takes on this config
    called = []
    for name in ("train_level", "train_level_twopass"):
        monkeypatch.setattr(fl, name, lambda *a, _n=name, **k: called.append(_n))
    R, S = 2, cfg.num_samples
    means, covs, d, _, pixels, g_scale = level_inputs(cfg, R, 1)
    t_vals = torch.linspace(2, 6, S + 1).expand(R, S + 1).contiguous()
    from nerf_or_nothing_tpu_torch.models import mipnerf

    x_enc, means_covs = mipnerf.encode_samples(
        cfg, means.view(R, S, 3), covs.view(R, S, 3), in_kernel=True,
        dtype=torch.bfloat16)
    fl.fused_level_train(params, cfg, x_enc, d, t_vals, torch.ones(R, 3),
                         pixels, g_scale, True, means_covs=means_covs)
    assert called == ["train_level_twopass" if twopass else "train_level"]
