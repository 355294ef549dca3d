"""The render-level, train-level (one- and two-pass) and MLP forward /
backward CUDA kernels against their plain PyTorch versions, on a card, a
full-gradient train step on the card against the CPU, on a host of four
cards the tensor-parallel grids on NCCL against the plain step, and the
JAX package's 20,000-step quality run on the hard scene (``-k
quality_20k``, minutes; ``-k "not quality_20k"`` leaves it out).

The kernel has no CPU mode, so these tests skip on a host without CUDA.
The module imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; ``tests/conftest.py`` imports JAX, so on such a
machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py -q

Tolerances: the parity bands of ``nerf_or_nothing_tpu/utils/parity.py``
(f32 (1e-6, 1e-3), bf16 (2e-3, 3e-2)) as a normalized error < 1, kernel
and plain version in the same compute dtype.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu_torch.config import Config, tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops.ipe import integrated_pos_enc  # noqa: E402
from nerf_or_nothing_tpu_torch.ops.render import (  # noqa: E402
    interval_lengths,
)
from nerf_or_nothing_tpu_torch.utils.parity import (  # noqa: E402
    near_zero_rows,
    reference_products,
)

BANDS = {"float32": (1e-6, 1e-3), "bfloat16": (2e-3, 3e-2)}
SMALL = dict(num_samples=8, net_depth=3, net_width=32, net_width_condition=32,
             skip_layer=2, max_deg_point=4, use_pallas=True)


def normalized_err(a, b, atol, rtol):
    a, b = a.double().cpu(), b.double().cpu()
    band = atol + rtol * b.abs() + rtol * b.abs().max()
    return float(((a - b).abs() / band).max())


def level_inputs(R, S, seed, dev, fd=27, cov=0.02):
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    means = T(rng.normal(size=(R, S, 3)))
    covs = T(rng.uniform(0, cov, size=(R, S, 3)))
    dir_enc = T(rng.normal(size=(R, fd)) * 0.5)
    t_vals = T(np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1))
    dirs = T(rng.normal(size=(R, 3)))
    return means, covs, dir_enc, t_vals, dirs


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("width", ["small", "config"])
def test_kernel_matches_plain_on_cuda(width):
    """Both input modes and both compute dtypes, through
    ``fused_level_render`` (which must launch the kernel once)."""
    dev = cuda_device()
    for dtype in ("float32", "bfloat16"):
        for mode in ("mv", "t"):
            if width == "small":
                cfg, R = tiny_config(**dict(SMALL, compute_dtype=dtype)), 9
            else:
                cfg, R = Config(compute_dtype=dtype), 37
            S = cfg.num_samples
            params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg,
                                   device=dev)
            means, covs, dir_enc, t_vals, dirs = level_inputs(R, S, 1, dev)
            kw, x = {}, None
            if mode == "mv":
                kw = dict(means_covs=(means, covs))
            else:
                x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                                       cfg.max_deg_point, fast=True)
            before = fl.render_level.launches
            out = fl.fused_level_render(params, cfg, x, dir_enc, t_vals, dirs,
                                        True, **kw)
            torch.cuda.synchronize()
            assert fl.render_level.launches == before + 1
            dt = tmlp.compute_dtype(cfg)
            xs = ((means.reshape(-1, 3), covs.reshape(-1, 3)) if mode == "mv"
                  else x.reshape(R * S, -1).to(dt))
            ref = fl.render_level_plain(
                params, cfg, xs, dir_enc.to(dt), interval_lengths(t_vals, dirs),
                True, mode)
            atol, rtol = BANDS[dtype]
            for a, b in zip(out, ref):
                assert bool(torch.isfinite(a).all())
                assert normalized_err(a, b, atol, rtol) < 1.0, (dtype, mode)


def test_render_fn_packs_weights_once_per_params(monkeypatch):
    """``make_render_fn`` packs the kernel's weights (``pack_forward``:
    the bf16 slab stream or the f32 layout) once for all chunks of a view,
    and again only after the weights change in place."""
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image
    from nerf_or_nothing_tpu_torch.rays import Rays

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, randomized=False))
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, device=dev)
    calls = []
    pack = fl.pack_forward
    monkeypatch.setattr(fl, "pack_forward",
                        lambda *a: calls.append(1) or pack(*a))
    rng = np.random.default_rng(2)
    n = 40
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    rays = Rays(
        origins=np.zeros((n, 3), np.float32), directions=dirs,
        viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        radii=np.full((n, 1), 1e-3, np.float32),
        loss_mult=np.ones((n, 1), np.float32),
        near=np.full((n, 1), 2.0, np.float32),
        far=np.full((n, 1), 6.0, np.float32),
    )
    render_fn = make_render_fn(cfg)
    launches = fl.render_level.launches
    rgb, _, _ = render_image(render_fn, params, rays, n, 1, chunk=16,
                             device=dev)
    assert fl.render_level.launches == launches + 2 * 3  # 2 levels, 3 chunks
    assert len(calls) == 1
    render_image(render_fn, params, rays, n, 1, chunk=16, device=dev)
    assert len(calls) == 1
    with torch.no_grad():
        params[-1][1].add_(1.0)  # rgb head bias: every colour changes
    rgb2, _, _ = render_image(render_fn, params, rays, n, 1, chunk=16,
                              device=dev)
    assert len(calls) == 2
    assert not np.allclose(rgb, rgb2)


def train_inputs(R, S, seed, dev, fd=27, cov=0.02):
    """One level's inputs (``fd`` direction features, covariances up to
    ``cov``) plus pixels and a g_scale with zeros (masked rays) from
    numpy."""
    rng = np.random.default_rng(seed + 100)
    pixels = torch.from_numpy(rng.uniform(size=(R, 3)).astype(np.float32))
    mask = rng.uniform(0.5, 2.0, size=R).astype(np.float32)
    mask[::5] = 0.0
    g_scale = torch.from_numpy((0.1 * 2.0 * mask / mask.sum())[:, None])
    return (*level_inputs(R, S, seed, dev, fd, cov), pixels.to(dev),
            g_scale.to(dev))


def check_train(cfg, R, mode, white_bkgd, dev, seed=1, cov=0.02):
    """``fused_level_train`` on the card (one launch of the kernel the
    config selects) against ``level_train_plain`` (f32 on the wide route:
    with f64 products, ``reference_products``); covariances up to
    ``cov``."""
    S = cfg.num_samples
    kernel = (fl.train_level_twopass if mode == "t"
              and cfg.probe("fl_variant") == "twopass" else fl.train_level)
    params = tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, seed, dev, cfg.direction_features, cov)
    kw, x = {}, None
    if mode == "mv":
        kw = dict(means_covs=(means, covs))
    else:
        x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                               cfg.max_deg_point, fast=cfg.fast_ipe)
    before = (fl.train_level.launches, fl.train_level_twopass.launches)
    out = fl.fused_level_train(params, cfg, x, dir_enc, t_vals, dirs, pixels,
                               g_scale, white_bkgd, **kw)
    torch.cuda.synchronize()
    grown = tuple(a - b for a, b in zip(
        (fl.train_level.launches, fl.train_level_twopass.launches), before))
    assert grown == ((0, 1) if kernel is fl.train_level_twopass else (1, 0))
    dt = tmlp.compute_dtype(cfg)
    xs = ((means.reshape(-1, 3), covs.reshape(-1, 3)) if mode == "mv"
          else x.reshape(R * S, -1).to(dt))
    name = ("train_level" if kernel is fl.train_level
            else "train_level_twopass")
    with reference_products(cfg, name, S):
        ref = fl.level_train_plain(params, cfg, xs, dir_enc.to(dt),
                                   interval_lengths(t_vals, dirs), pixels,
                                   g_scale, white_bkgd, mode)
    atol, rtol = BANDS[cfg.compute_dtype]
    pairs = list(zip(out[:3], ref[:3])) + [
        (a, b) for (dw, db), (rw, rb) in zip(out[3], ref[3])
        for a, b in ((dw, rw), (db, rb))]
    for k, (a, b) in enumerate(pairs):
        assert a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        err = normalized_err(a, b, atol, rtol)
        assert err < 1.0, (cfg.compute_dtype, mode, S, k, err)
    return params, out


@pytest.mark.parametrize("width", ["small", "config"])
def test_train_kernel_matches_plain_on_cuda(width):
    """Both input modes, both compute dtypes, S = 64, 128 and 256 (and 8 at
    the narrow width), ragged ray counts, masked rays, through
    ``fused_level_train`` (which must launch the kernel once)."""
    dev = cuda_device()
    for dtype in ("float32", "bfloat16"):
        for mode in ("mv", "t"):
            for S in ((8, 64, 256) if width == "small" else (64, 128, 256)):
                if width == "small":
                    cfg = tiny_config(**dict(SMALL, compute_dtype=dtype,
                                             num_samples=S))
                    R = 13
                else:
                    cfg, R = Config(compute_dtype=dtype, num_samples=S), 21
                check_train(cfg, R, mode, S != 64, dev)


def test_train_kernel_dw_bit_equal_on_cuda():
    """No atomics: two launches on the same inputs give the same bits."""
    dev = cuda_device()
    cfg = Config()
    R, S = 96, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, 2, dev)
    x = integrated_pos_enc((means, covs), 0, cfg.max_deg_point, fast=True)
    a = fl.fused_level_train(params, cfg, x, dir_enc, t_vals, dirs, pixels,
                             g_scale, True)
    b = fl.fused_level_train(params, cfg, x, dir_enc, t_vals, dirs, pixels,
                             g_scale, True)
    for (wa, ba), (wb, bb) in zip(a[3], b[3]):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
    for ta, tb in zip(a[:3], b[:3]):
        assert torch.equal(ta, tb)


TRAIN_WG_CASES = [
    ("r777_masked_t", dict(), 777, "t"),
    ("r777_masked_mv", dict(fuse_ipe=True), 777, "mv"),
    ("s64_two_view_layers", dict(num_samples=64, net_depth_condition=2), 37,
     "mv"),
    ("s256", dict(num_samples=256), 19, "t"),
] + [(f"w{w}", dict(net_width=w, net_width_condition=min(w, 128),
                    num_samples=24), 21, "t") for w in range(32, 257, 32)]


@pytest.mark.parametrize("name,kw,R,mode", TRAIN_WG_CASES)
def test_train_kernel_wg_cases_on_cuda(name, kw, R, mode):
    """The bf16 train kernel's wgmma passes: a masked ragged batch in both
    modes, S=64 with two view layers, S=256, and every width 32-256 (the
    chain's products of every N, ragged last units)."""
    dev = cuda_device()
    check_train(Config(**kw), R, mode, True, dev)


def test_train_kernel_bit_equal_ragged_on_cuda():
    """No atomics in the wgmma passes either: a ragged masked batch in
    mode "mv" gives the same bits twice."""
    dev = cuda_device()
    cfg = Config(fuse_ipe=True)
    R, S = 777, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(4), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, 5, dev)
    a, b = (fl.fused_level_train(params, cfg, None, dir_enc, t_vals, dirs,
                                 pixels, g_scale, False,
                                 means_covs=(means, covs)) for _ in range(2))
    for (wa, ba), (wb, bb) in zip(a[3], b[3]):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
    for ta, tb in zip(a[:3], b[:3]):
        assert torch.equal(ta, tb)


@pytest.mark.parametrize("probes", ["", "fl_variant=twopass"])
def test_train_step_packs_its_route_once_on_cuda(monkeypatch, probes):
    """A train step packs once for both levels (``pack_train``), in
    ``pack_train_level``'s layouts, which both train kernels read."""
    from nerf_or_nothing_tpu_torch import train as ttrain
    from nerf_or_nothing_tpu_torch.rays import Rays

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, batch_size=40,
                             kernel_probes=probes))
    state = ttrain.init_train_state(cfg, dev)
    calls = []
    pack = fl.pack_train
    monkeypatch.setattr(fl, "pack_train",
                        lambda *a: calls.append(pack(*a)) or calls[-1])
    rng = np.random.default_rng(3)
    n = 40
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    rays = Rays(
        origins=np.zeros((n, 3), np.float32), directions=dirs,
        viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        radii=np.full((n, 1), 1e-3, np.float32),
        near=np.full((n, 1), 2.0, np.float32),
        far=np.full((n, 1), 6.0, np.float32),
        loss_mult=np.ones((n, 1), np.float32),
    )
    rays = Rays(*[torch.from_numpy(x).to(dev) for x in rays])
    pixels = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    before = (fl.train_level.launches, fl.train_level_twopass.launches)
    state, stats = ttrain.make_train_step(cfg)(state, rays, pixels.to(dev))
    assert np.isfinite(float(stats.loss))
    assert len(calls) == 1
    twopass = probes != ""
    grown = (fl.train_level.launches - before[0],
             fl.train_level_twopass.launches - before[1])
    assert grown == ((0, 2) if twopass else (2, 0))
    assert (calls[0][0].numel(), calls[0][2].numel()) == (
        fl.train_weight_sizes(cfg, "wg"))


@pytest.mark.parametrize("width", ["small", "config"])
def test_twopass_kernel_matches_plain_on_cuda(width):
    """The two-pass kernel (kernel_probes fl_variant=twopass, mode "t")
    through ``fused_level_train``: both compute dtypes, S = 8, 64 and 256
    at the narrow width (ragged R=13, masked rays), 128 at Config() width."""
    dev = cuda_device()
    for dtype in ("float32", "bfloat16"):
        for S in ((8, 64, 256) if width == "small" else (128,)):
            kw = dict(compute_dtype=dtype, num_samples=S,
                      kernel_probes="fl_variant=twopass")
            if width == "small":
                cfg, R = tiny_config(**dict(SMALL, **kw)), 13
            else:
                cfg, R = Config(**kw), 21
            check_train(cfg, R, "t", S != 64, dev)


def test_twopass_kernel_bit_equal_on_cuda():
    """No atomics: two launches at a narrow width and a ragged ray count
    give the same bits."""
    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, net_depth=5, num_samples=256,
                             kernel_probes="fl_variant=twopass"))
    R, S = 37, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, 3, dev)
    x = integrated_pos_enc((means, covs), 0, cfg.max_deg_point, fast=True)
    a, b = (fl.fused_level_train(params, cfg, x, dir_enc, t_vals, dirs,
                                 pixels, g_scale, True) for _ in range(2))
    for (wa, ba), (wb, bb) in zip(a[3], b[3]):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
    for ta, tb in zip(a[:3], b[:3]):
        assert torch.equal(ta, tb)


def test_train_step_then_render_repacks_on_cuda(monkeypatch):
    """A train step on the card (two train-kernel launches, which read
    ``pack_train_level``'s layouts) updates the weights in place;
    ``make_render_fn`` then packs the forward's layout again, once."""
    from nerf_or_nothing_tpu_torch import train as ttrain
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image
    from nerf_or_nothing_tpu_torch.rays import Rays

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, randomized=True,
                             batch_size=40))
    state = ttrain.init_train_state(cfg, dev)
    rng = np.random.default_rng(2)
    n = 40
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    rays = Rays(
        origins=np.zeros((n, 3), np.float32), directions=dirs,
        viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        radii=np.full((n, 1), 1e-3, np.float32),
        near=np.full((n, 1), 2.0, np.float32),
        far=np.full((n, 1), 6.0, np.float32),
        loss_mult=np.ones((n, 1), np.float32),
    )
    calls = []
    pack = fl.pack_forward
    monkeypatch.setattr(fl, "pack_forward",
                        lambda *a: calls.append(1) or pack(*a))
    render_fn = make_render_fn(cfg)
    rgb, _, _ = render_image(render_fn, state.params, rays, n, 1, chunk=16,
                             device=dev)
    assert len(calls) == 1
    launches = fl.train_level.launches
    trays = Rays(*[torch.from_numpy(x).to(dev) for x in rays])
    pixels = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    state, stats = ttrain.make_train_step(cfg)(state, trays, pixels.to(dev))
    assert fl.train_level.launches == launches + 2
    assert np.isfinite(float(stats.loss))
    calls.clear()
    rgb2, _, _ = render_image(render_fn, state.params, rays, n, 1, chunk=16,
                              device=dev)
    assert len(calls) == 1
    assert not np.allclose(rgb, rgb2)


def mlp_inputs(cfg, params, R, seed, dev, cov=0.02):
    """The MLP kernels' inputs as a train level makes them: IPE features
    [R*S, F] and view PE [R, Fd] in the compute dtype and, with 3 rgb / 1
    density heads, the head cotangents of the composite backward of the
    plain forward (others: random, from numpy). Random cotangents on
    random features at full width put the f32 comparison at the mercy of
    single ReLU masks that the two f32 forwards round to opposite sides of
    zero."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    S = cfg.num_samples
    dt = tmlp.compute_dtype(cfg)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, seed, dev, cfg.direction_features, cov)
    x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                           cfg.max_deg_point, fast=cfg.fast_ipe)
    x, d = x.reshape(R * S, -1).to(dt), dir_enc.to(dt)
    if (cfg.num_rgb_channels, cfg.num_density_channels) == (3, 1):
        raw_rgb, raw_den = fm.mlp_fwd_plain(params, cfg, x, d, S)
        g_rgb, g_den = fl._composite_backward(
            cfg, raw_rgb, raw_den[:, 0], interval_lengths(t_vals, dirs),
            pixels, g_scale, True)[3:]
        return x, d, g_rgb.contiguous(), g_den[:, None].contiguous()
    rng = np.random.default_rng(seed)
    g = [torch.from_numpy(rng.normal(size=(R * S, c)).astype(np.float32)
                          * 1e-3).to(dev)
         for c in (cfg.num_rgb_channels, cfg.num_density_channels)]
    return x, d, g[0], g[1]


MLP_CASES = [
    ("small", dict(SMALL), 13),
    ("small_heads_4_2", dict(SMALL, num_rgb_channels=4,
                             num_density_channels=2, net_depth=5), 7),
    ("config", dict(), 21),
]


@pytest.mark.parametrize("name,kw,R", MLP_CASES)
def test_mlp_kernels_match_plain_on_cuda(name, kw, R):
    """mlp_fwd and mlp_bwd (input_grads both ways) against their plain
    versions, both dtypes, S = 8 and 64 at the narrow widths."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    for dtype in ("float32", "bfloat16"):
        for S in ((8, 64) if name != "config" else (128,)):
            cfg = Config(**dict(kw, compute_dtype=dtype, num_samples=S))
            params = tmlp.init_mlp(torch.Generator().manual_seed(1), cfg,
                                   device=dev)
            x, d, g_rgb, g_den = mlp_inputs(cfg, params, R, 3, dev)
            atol, rtol = BANDS[dtype]
            launches = (fm.mlp_fwd.launches, fm.mlp_bwd.launches)
            out = fm.mlp_fwd(params, cfg, x, d)
            ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
            for a, b in zip(out, ref):
                assert bool(torch.isfinite(a).all())
                assert normalized_err(a, b, atol, rtol) < 1.0, (name, dtype)
            for input_grads in (False, True):
                got = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads)
                exp = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                                       input_grads)
                torch.cuda.synchronize()
                pairs = [(a, b) for wa, wb in zip(got[0], exp[0])
                         for a, b in zip(wa, wb)]
                if input_grads:
                    pairs += [(got[1].float(), exp[1].float()),
                              (got[2], exp[2])]
                for k, (a, b) in enumerate(pairs):
                    assert a.shape == b.shape
                    assert bool(torch.isfinite(a).all())
                    err = normalized_err(a, b, atol, rtol)
                    assert err < 1.0, (name, dtype, S, input_grads, k, err)
            assert (fm.mlp_fwd.launches, fm.mlp_bwd.launches) == (
                launches[0] + 1, launches[1] + 2)


F32_SHAPES = {
    "config": (dict(), 37),
    # rows of a block's rays (2 x 24) leave 16 of its 64-row tile empty
    "narrow_ragged": (dict(num_samples=24, net_depth=3, net_width=64,
                           net_width_condition=32, skip_layer=2,
                           max_deg_point=4), 13),
}


@pytest.mark.parametrize("shape", list(F32_SHAPES))
@pytest.mark.parametrize("route", ["render_level", "train_level",
                                   "train_level_twopass", "mlp_fwd",
                                   "mlp_bwd"])
def test_f32_routes_match_plain_and_repeat_on_cuda(route, shape):
    """Every f32 route (3xTF32 mma.sync) within the f32 band of its plain
    version at Config() width and a narrow ragged shape; the backward
    routes give the same bits over two launches (dW/db, and dX/dD with
    input_grads)."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    kw, R = F32_SHAPES[shape]
    if route == "train_level_twopass":
        kw = dict(kw, kernel_probes="fl_variant=twopass")
    cfg = Config(**dict(kw, compute_dtype="float32"))
    S = cfg.num_samples
    atol, rtol = BANDS["float32"]
    params = tmlp.init_mlp(torch.Generator().manual_seed(5), cfg, device=dev)
    if route == "render_level":
        means, covs, dir_enc, t_vals, dirs = level_inputs(R, S, 6, dev)
        for mode in ("mv", "t"):
            xs = ((means.reshape(-1, 3), covs.reshape(-1, 3)) if mode == "mv"
                  else integrated_pos_enc((means, covs), cfg.min_deg_point,
                                          cfg.max_deg_point, fast=True
                                          ).reshape(R * S, -1))
            delta = interval_lengths(t_vals, dirs)
            out = fl.render_level(params, cfg, xs, dir_enc, delta, True, mode)
            ref = fl.render_level_plain(params, cfg, xs, dir_enc, delta, True,
                                        mode)
            for a, b in zip(out, ref):
                assert bool(torch.isfinite(a).all())
                assert normalized_err(a, b, atol, rtol) < 1.0, mode
        return
    if route in ("train_level", "train_level_twopass"):
        for mode in (("t",) if route == "train_level_twopass" else
                     ("t", "mv")):
            _, out = check_train(cfg, R, mode, True, dev, seed=6)
            _, again = check_train(cfg, R, mode, True, dev, seed=6)
            for (wa, ba), (wb, bb) in zip(out[3], again[3]):
                assert torch.equal(wa, wb) and torch.equal(ba, bb), mode
        return
    x, d, g_rgb, g_den = mlp_inputs(cfg, params, R, 6, dev)
    if route == "mlp_fwd":
        out = fm.mlp_fwd(params, cfg, x, d)
        ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
        for a, b in zip(out, ref):
            assert normalized_err(a, b, atol, rtol) < 1.0
        return
    for input_grads in (False, True):
        got = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads)
        again = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads)
        exp = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                               input_grads)
        flat = [t for wb in got[0] for t in wb] + list(got[1:] if
                                                       input_grads else [])
        flat2 = [t for wb in again[0] for t in wb] + list(
            again[1:] if input_grads else [])
        ref = [t for wb in exp[0] for t in wb] + list(exp[1:] if
                                                      input_grads else [])
        for k, (a, b, c) in enumerate(zip(flat, flat2, ref)):
            assert torch.equal(a, b), (input_grads, k)
            assert normalized_err(a.float(), c.float(), atol, rtol) < 1.0, (
                input_grads, k)


@pytest.mark.parametrize("seed", range(8))
def test_f32_train_level_over_seeds_on_cuda(seed):
    """The f32 train level at Config() width, S=64, 21 rays, against its
    plain version for several seeds: a ReLU mask that the kernel's and
    cuBLAS's pre-activations put on opposite sides of zero moves dW past
    the f32 band, so the kernel's f32 sums must be as exact as the plain
    version's (the tensor core truncates its own sums; the kernels add
    each k-step's partial sum round-to-nearest)."""
    dev = cuda_device()
    check_train(Config(compute_dtype="float32", num_samples=64), 21, "t",
                False, dev, seed=seed)


def test_mlp_bwd_bit_equal_on_cuda():
    """No atomics: two mlp_bwd launches give the same dW/db, dX and dD."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = Config()
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, device=dev)
    x, d, g_rgb, g_den = mlp_inputs(cfg, params, 96, 4, dev)
    a = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, True)
    b = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, True)
    for (wa, ba), (wb, bb) in zip(a[0], b[0]):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_full_grad_step_on_cuda_matches_cpu():
    """One train step at Config(fuse_level=False, stop_level_grad=False)
    (full width, 64 rays) on the card against the same step on the CPU:
    2 mlp_fwd and 2 mlp_bwd launches, no level kernel; loss, grad norm,
    every gradient and the updated params within the bf16 band."""
    from nerf_or_nothing_tpu_torch import train as ttrain
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.rays import Rays

    dev = cuda_device()
    cfg = Config(fuse_level=False, stop_level_grad=False, randomized=False,
                 batch_size=64)
    rng = np.random.default_rng(5)
    n = 64
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    rays = Rays(
        origins=o, directions=dirs,
        viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        radii=np.full((n, 1), 1e-3, np.float32),
        near=np.full((n, 1), 2.0, np.float32),
        far=np.full((n, 1), 6.0, np.float32),
        loss_mult=rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32),
    )
    pixels = rng.uniform(size=(n, 3)).astype(np.float32)
    out = []
    for device in (dev, torch.device("cpu")):
        before = (fm.mlp_fwd.launches, fm.mlp_bwd.launches,
                  fl.train_level.launches, fl.render_level.launches)
        state = ttrain.init_train_state(cfg, device)
        state, stats = ttrain.make_train_step(cfg)(
            state, Rays(*[torch.from_numpy(a).to(device) for a in rays]),
            torch.from_numpy(pixels).to(device))
        after = (fm.mlp_fwd.launches, fm.mlp_bwd.launches,
                 fl.train_level.launches, fl.render_level.launches)
        grown = tuple(b - a for a, b in zip(before, after))
        assert grown == ((2, 2, 0, 0) if device.type == "cuda"
                         else (0, 0, 0, 0)), grown
        out.append((state, stats))
    (gs, gst), (cs, cst) = out
    atol, rtol = BANDS["bfloat16"]
    for k in ("loss", "losses", "grad_norm"):
        a, b = getattr(gst, k).reshape(-1), getattr(cst, k).reshape(-1)
        assert normalized_err(a, b, atol, rtol) < 1.0, k
    for (wa, ba), (wb, bb) in zip(gs.params, cs.params):
        assert normalized_err(wa, wb, atol, rtol) < 1.0
        assert normalized_err(ba, bb, atol, rtol) < 1.0
    grads = []
    for device in (dev, torch.device("cpu")):
        params = tmlp.init_mlp(torch.Generator().manual_seed(cfg.seed), cfg,
                               device=device)
        grads.append(ttrain._autograd_value_and_grad(
            cfg, params, None,
            Rays(*[torch.from_numpy(a).to(device) for a in rays]),
            torch.from_numpy(pixels).to(device))[2])
    for i, ((ga, gb), (ca, cb)) in enumerate(zip(*grads)):
        assert normalized_err(ga, ca, atol, rtol) < 1.0, ("dW", i)
        assert normalized_err(gb, cb, atol, rtol) < 1.0, ("db", i)


WG_CASES = [
    # (name, config overrides, rays, render mode or None for mlp_fwd only)
    ("config_r2048_s128_mv", dict(), 2048, "mv"),
    ("config_r1000_s64_t", dict(num_samples=64), 1000, "t"),
    ("narrow_r37_s8_mv", dict(net_width=64, net_width_condition=32,
                              num_samples=8, net_depth=3, skip_layer=2,
                              max_deg_point=4), 37, "mv"),
    ("heads_4_2_r37_s24", dict(net_width=64, net_width_condition=32,
                               num_samples=24, net_depth=5, skip_layer=2,
                               max_deg_point=4, num_rgb_channels=4,
                               num_density_channels=2), 37, None),
    # S > 128: each ray over two rounds, the composite carried between them
    ("config_r37_s256_mv", dict(num_samples=256), 37, "mv"),
    # widths that are not whole 64-column slabs (N = 224, 192, 96, 32) and
    # S = 24, which fills 120 of a round's 128 rows
    ("w224_192_r77_s16_t", dict(net_width=224, net_width_condition=192,
                                num_samples=16), 77, "t"),
    ("w96_32_r50_s24_mv", dict(net_width=96, net_width_condition=32,
                               num_samples=24), 50, "mv"),
]


@pytest.mark.parametrize("name,kw,R,mode", WG_CASES)
def test_wg_forward_kernels_match_plain_on_cuda(name, kw, R, mode):
    """The bf16 wgmma forward (``csrc/forward_wg.cuh``) of ``render_level``
    and ``mlp_fwd`` on ``pack_forward``'s slab stream: at Config() width
    and on ragged shapes (rays that fill no whole 128-row round, S = 8 and
    64, 8-column heads cut to 4 and 2 channels), one launch each."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = Config(**kw)
    dt = tmlp.compute_dtype(cfg)
    assert dt == torch.bfloat16
    S = cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(2), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs = level_inputs(R, S, 4, dev)
    packed = fl.pack_forward(params, cfg, dt)
    assert packed[0].shape == (fl.packed_wg_size(cfg),)
    x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                           cfg.max_deg_point, fast=True).reshape(R * S, -1)
    x, d = x.to(dt), dir_enc.to(dt)
    atol, rtol = BANDS["bfloat16"]
    before = fm.mlp_fwd.launches
    out = fm.mlp_fwd(params, cfg, x, d, packed=packed)
    ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
    torch.cuda.synchronize()
    assert fm.mlp_fwd.launches == before + 1
    for a, b in zip(out, ref):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert normalized_err(a, b, atol, rtol) < 1.0, name
    if mode is None:
        return
    xs = (means.reshape(-1, 3), covs.reshape(-1, 3)) if mode == "mv" else x
    delta = interval_lengths(t_vals, dirs)
    before = fl.render_level.launches
    out = fl.render_level(params, cfg, xs, d, delta, True, mode,
                          packed=packed)
    ref = fl.render_level_plain(params, cfg, xs, d, delta, True, mode)
    torch.cuda.synchronize()
    assert fl.render_level.launches == before + 1
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        assert normalized_err(a, b, atol, rtol) < 1.0, name


def multicam_g_scale(R, seed):
    """A Multicam pyramid's per-ray loss weights (1, 4, 16 or 64), every
    seventh ray masked, as g_scale [R, 1]."""
    rng = np.random.default_rng(seed)
    mask = 4.0 ** rng.integers(0, 4, size=R)
    mask[::7] = 0.0
    return torch.from_numpy((2.0 * mask / mask.sum())[:, None]
                            .astype(np.float32))


@pytest.mark.parametrize("R", [1024, 777])
def test_twopass_wg_matches_plain_on_cuda(R):
    """The two-pass kernel's bf16 route (``train_level``'s wgmma passes)
    at Config() width with Multicam's loss weights: against
    ``level_train_plain``, bit-equal over two launches and to
    ``train_level`` on the same inputs, one two-pass launch each."""
    dev = cuda_device()
    cfg = Config(kernel_probes="fl_variant=twopass")
    S = cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(6), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, _ = train_inputs(R, S, 7, dev)
    g_scale = multicam_g_scale(R, 8).to(dev)
    dt = tmlp.compute_dtype(cfg)
    x = integrated_pos_enc((means, covs), 0, cfg.max_deg_point,
                           fast=True).reshape(R * S, -1).to(dt)
    d, delta = dir_enc.to(dt), interval_lengths(t_vals, dirs)
    packed = fl.pack_train(params, cfg, dt)
    before = fl.train_level_twopass.launches
    a, b = (fl.train_level_twopass(params, cfg, x, d, delta, pixels, g_scale,
                                   False, packed=packed) for _ in range(2))
    torch.cuda.synchronize()
    assert fl.train_level_twopass.launches == before + 2
    one = fl.train_level_cuda(params, cfg, x, d, delta, pixels, g_scale,
                              False, "t", packed=packed)
    ref = fl.level_train_plain(params, cfg, x, d, delta, pixels, g_scale,
                               False, "t")
    flat = lambda o: [*o[:3], *[t for wb in o[3] for t in wb]]  # noqa: E731
    atol, rtol = BANDS["bfloat16"]
    for k, (ta, tb, to, tr) in enumerate(zip(*map(flat, (a, b, one, ref)))):
        assert torch.equal(ta, tb) and torch.equal(ta, to), k
        assert bool(torch.isfinite(ta).all())
        assert normalized_err(ta, tr, atol, rtol) < 1.0, k


@pytest.mark.parametrize("input_grads", [True, False])
@pytest.mark.parametrize("heads", [(3, 1), (8, 8), (5, 2)],
                         ids=lambda h: f"{h[0]}_{h[1]}")
def test_mlp_bwd_wg_matches_plain_on_cuda(heads, input_grads):
    """``mlp_bwd``'s bf16 route (the wgmma forward, chain with dX, dW) at
    Config() width, ragged R=77, heads 3/1 (their own instantiation), 8/8
    (any width) and 5/2 (an odd parameter count: the dW GEMM's float2
    stores into the split partials misaligned before their rows were
    padded to even): every dW/db, dX and dD against ``mlp_bwd_plain``,
    bit-equal over two launches."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = Config(num_rgb_channels=heads[0], num_density_channels=heads[1])
    R = 77
    params = tmlp.init_mlp(torch.Generator().manual_seed(3), cfg, device=dev)
    x, d, g_rgb, g_den = mlp_inputs(cfg, params, R, 5, dev)
    packed = fm.pack_mlp_params(params, cfg, tmlp.compute_dtype(cfg))
    assert len(packed) == 3
    before = fm.mlp_bwd.launches
    a, b = (fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads,
                       packed=packed) for _ in range(2))
    torch.cuda.synchronize()
    assert fm.mlp_bwd.launches == before + 2
    ref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, cfg.num_samples,
                           input_grads)
    flat = lambda o: [t for wb in o[0] for t in wb] + [  # noqa: E731
        t for t in o[1:] if t is not None]
    got, again, exp = flat(a), flat(b), flat(ref)
    assert len(got) == len(exp) == 2 * len(params) + 2 * input_grads
    atol, rtol = BANDS["bfloat16"]
    for k, (ta, tb, tr) in enumerate(zip(got, again, exp)):
        assert torch.equal(ta, tb), k
        assert ta.shape == tr.shape and bool(torch.isfinite(ta).all())
        assert normalized_err(ta.float(), tr.float(), atol, rtol) < 1.0, k


def test_wg_backward_configs_raise_before_launch_on_cuda():
    """On CUDA tensors, x rows wider than 256 columns for ``mlp_bwd``'s
    dX, which the bf16 narrow passes refused, take the wide route and
    launch once; so do more biases than the chain's shared memory holds
    (102 layers, which every route once refused before any launch: the
    two-pass kernel launches once, in band of its plain version); 25 dW
    products, past one dW launch's job table, keep the narrow route in
    both dtypes, in band of the plain version."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = Config(max_deg_point=44)
    R, S = 2, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, device=dev)
    x = torch.zeros(R * S, cfg.location_features, dtype=torch.bfloat16,
                    device=dev)
    d = torch.zeros(R, 27, dtype=torch.bfloat16, device=dev)
    g_rgb = torch.zeros(R * S, 3, device=dev)
    g_den = torch.zeros(R * S, 1, device=dev)
    before = fm.mlp_bwd.launches
    assert fl.takes_wide(cfg, "mlp_bwd", S, True)
    d_params, dx, dd = fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den, True)
    torch.cuda.synchronize()
    assert fm.mlp_bwd.launches == before + 1
    assert bool(torch.isfinite(dx.float()).all())
    assert all(bool(torch.isfinite(t).all()) for wb in d_params for t in wb)
    deep = Config(net_depth=100, num_samples=16,
                  kernel_probes="fl_variant=twopass")
    assert fl.takes_wide(deep, "train_level_twopass", 16)
    check_train(deep, 3, "t", True, dev)
    for dtype in ("bfloat16", "float32"):
        deeper = Config(net_depth=20, compute_dtype=dtype)
        assert fl.dw_jobs(deeper) == 25
        assert not fl.takes_wide(deeper, "train_level", deeper.num_samples)
        check_train(deeper, 5, "t", True, dev)


# Configs past the C sources' former tables: 25 dW products (one dW
# launch takes 24) and 66 layers (the layer tables held 64).
DEEP_CASES = {
    "depth20_f32": dict(net_depth=20, compute_dtype="float32"),
    "layers66_f32": dict(net_depth=63, net_depth_condition=1, net_width=64,
                         net_width_condition=32, compute_dtype="float32"),
    "layers66_bf16": dict(net_depth=63, net_depth_condition=1, net_width=64,
                          net_width_condition=32),
}


@pytest.mark.parametrize("name", sorted(DEEP_CASES))
def test_deep_backward_kernels_match_plain_on_cuda(name):
    """``train_level``, ``train_level_twopass`` and ``mlp_bwd`` (with and
    without input_grads) at the deep configs against their plain versions
    in the dtype's band (f32: with f64 products; ``mlp_bwd``'s cotangents
    0 on ``near_zero_rows``' rows), each bit-equal over two launches; the
    two-pass kernel bit-equal to ``train_level`` where they run the same
    launches (bf16, and the wide route; the narrow f32 two-pass kernel
    sums db in another order)."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = Config(**dict(DEEP_CASES[name], num_samples=32))
    dtype, R, S = cfg.compute_dtype, 37, 32
    params = tmlp.init_mlp(torch.Generator().manual_seed(3), cfg, device=dev)
    x, d, g_rgb, g_den = mlp_inputs(cfg, params, R, 3, dev)
    _, _, _, t_vals, dirs, pixels, g_scale = train_inputs(R, S, 3, dev)
    delta = interval_lengths(t_vals, dirs)
    dt = tmlp.compute_dtype(cfg)
    packed = fl.pack_train(params, cfg, dt)
    before = (fl.train_level.launches, fl.train_level_twopass.launches)
    a, b = (fl.train_level_cuda(params, cfg, x, d, delta, pixels, g_scale,
                                True, "t", packed=packed) for _ in range(2))
    two, two_b = (fl.train_level_twopass(params, cfg, x, d, delta, pixels,
                                         g_scale, True, packed=packed)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert (fl.train_level.launches - before[0],
            fl.train_level_twopass.launches - before[1]) == (2, 2)
    same = dtype == "bfloat16" or fl.takes_wide(cfg, "train_level", S)
    for ta, tb, tt, tu in zip(*map(tensors, (a, b, two, two_b))):
        assert torch.equal(ta, tb) and torch.equal(tt, tu)
        assert torch.equal(ta, tt) or not same
    with reference_products(cfg):
        ref = fl.level_train_plain(params, cfg, x, d, delta, pixels, g_scale,
                                   True, "t")
    check_close(a, ref, dtype, f"{name} train_level")
    check_close(two, ref, dtype, f"{name} train_level_twopass")
    if dtype == "float32":
        near = near_zero_rows(params, cfg, x, d)
        assert 2 * int(near.sum()) <= R * S, int(near.sum())
        g_rgb, g_den = (torch.where(near[:, None], 0.0, g)
                        for g in (g_rgb, g_den))
    mpacked = fm.pack_mlp_params(params, cfg, dt)
    for input_grads in (True, False):
        ga, gb = (fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads,
                             packed=mpacked) for _ in range(2))
        with reference_products(cfg):
            gref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                                    input_grads)
        assert all(torch.equal(ta, tb)
                   for ta, tb in zip(tensors(ga), tensors(gb))), input_grads
        check_close(ga, gref, dtype, f"{name} mlp_bwd {input_grads}")


WIDE = dict(net_depth=8, skip_layer=4, net_width_condition=128)


def check_render(cfg, R, mode, white_bkgd, dev, seed=1, cov=0.02):
    """``fused_level_render`` on the card (one ``render_level`` launch)
    against ``render_level_plain`` (f32 on the wide route: with f64
    products)."""
    S = cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs = level_inputs(
        R, S, seed, dev, cfg.direction_features, cov)
    dt = tmlp.compute_dtype(cfg)
    if mode == "mv":
        xs, x, kw = (means.reshape(-1, 3), covs.reshape(-1, 3)), None, dict(
            means_covs=(means, covs))
    else:
        x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                               cfg.max_deg_point, fast=cfg.fast_ipe)
        xs, kw = x.reshape(R * S, -1).to(dt), {}
    before = fl.render_level.launches
    out = fl.fused_level_render(params, cfg, x, dir_enc, t_vals, dirs,
                                white_bkgd, **kw)
    torch.cuda.synchronize()
    assert fl.render_level.launches == before + 1
    with reference_products(cfg, "render_level", S):
        ref = fl.render_level_plain(params, cfg, xs, dir_enc.to(dt),
                                    interval_lengths(t_vals, dirs),
                                    white_bkgd, mode)
    atol, rtol = BANDS[cfg.compute_dtype]
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        assert normalized_err(a, b, atol, rtol) < 1.0, (cfg.net_width, mode)


@pytest.mark.parametrize("width", [288, 512, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wide_levels_match_plain_on_cuda(dtype, width):
    """The wide route (net_width 288-1024; bf16 on wgmma, f32 as 3xTF32
    mma.sync): ``train_level`` and ``render_level`` in both modes, S=128
    and S=64 with two view layers at net_width_condition 256, ragged
    masked rays, against the plain versions in the dtype's band (f32: the
    plain versions with f64 products)."""
    dev = cuda_device()
    for kw, R in ((dict(), 37), (dict(num_samples=64, net_depth_condition=2,
                                      net_width_condition=256), 21)):
        cfg = Config(**dict(WIDE, net_width=width, compute_dtype=dtype,
                            **kw))
        assert fl.uses_wide(cfg)
        for mode in ("mv", "t"):
            check_train(cfg, R, mode, mode == "mv", dev)
            check_render(cfg, R, mode, mode == "t", dev)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wide_train_level_dw_bit_equal_on_cuda(dtype):
    """No atomics on the wide route: two launches at net_width 1024 give
    the same bits, in bf16 and f32."""
    dev = cuda_device()
    cfg = Config(net_width=1024, compute_dtype=dtype)
    R, S = 200, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, 2, dev)
    a, b = (fl.fused_level_train(params, cfg, None, dir_enc, t_vals, dirs,
                                 pixels, g_scale, True,
                                 means_covs=(means, covs)) for _ in range(2))
    for (wa, ba), (wb, bb) in zip(a[3], b[3]):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
    for ta, tb in zip(a[:3], b[:3]):
        assert torch.equal(ta, tb)


@pytest.mark.parametrize("dtype,width", [("bfloat16", 1024),
                                         ("float32", 288)])
def test_wide_graph_steps_equal_eager_steps_on_cuda(dtype, width):
    """At Config(net_width=1024) in bf16 and Config(net_width=288) in f32:
    six multi-step steps (two calls of three) against six eager steps
    from the same state on the same batches, bit-equal, two
    ``train_level`` launches a step."""
    from nerf_or_nothing_tpu_torch import train as ttrain
    from nerf_or_nothing_tpu_torch.kernels import launch_counts

    dev = cuda_device()
    cfg = Config(net_width=width, compute_dtype=dtype, batch_size=256,
                 lr_delay_steps=0)
    batches = host_batches(6, 256, 12)
    eager = ttrain.init_train_state(cfg, dev)
    step_fn = ttrain.make_train_step(cfg)
    for rays, pixels in batches:
        eager, last = step_fn(eager, *ttrain.batch_to_device(dev, rays,
                                                              pixels))
    graph = ttrain.init_train_state(cfg, dev)
    multi = ttrain.make_multi_step(cfg)
    before = launch_counts()
    graph, _ = multi(graph, batches[:3])
    graph, stats = multi(graph, batches[3:])
    grown = {k: v - before[k] for k, v in launch_counts().items()}
    steps = 6 + ttrain.WARMUP_STEPS
    assert grown == {k: 2 * steps if k == "train_level" else 0
                     for k in grown}
    assert graph.step == eager.step == 6
    for name in ("loss", "losses", "grad_norm", "psnr"):
        assert torch.equal(getattr(stats, name), getattr(last, name)), name
    for tree_a, tree_b in ((graph.params, eager.params),
                           (graph.mu, eager.mu), (graph.nu, eager.nu)):
        for (wa, ba), (wb, bb) in zip(tree_a, tree_b):
            assert torch.equal(wa, wb) and torch.equal(ba, bb)


def test_wide_route_packs_once_on_cuda(monkeypatch):
    """At net_width 512 a train step packs once for both levels
    (``pack_train``) and a view's render function once for all chunks
    (``pack_forward``): the wide route reads the narrow route's slab
    streams."""
    from nerf_or_nothing_tpu_torch import train as ttrain
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, net_width=512, net_width_condition=128,
                             num_levels=2, batch_size=40, randomized=False))
    assert fl.uses_wide(cfg)
    state = ttrain.init_train_state(cfg, dev)
    train_calls, fwd_calls = [], []
    pack, pack_fwd = fl.pack_train, fl.pack_forward
    monkeypatch.setattr(fl, "pack_train",
                        lambda *a: train_calls.append(pack(*a))
                        or train_calls[-1])
    monkeypatch.setattr(fl, "pack_forward",
                        lambda *a: fwd_calls.append(1) or pack_fwd(*a))
    (rays, pixels), = host_batches(1, 40, 5)
    before = (fl.train_level.launches, fl.render_level.launches)
    state, stats = ttrain.make_train_step(cfg)(
        state, *ttrain.batch_to_device(dev, rays, pixels))
    assert np.isfinite(float(stats.loss))
    assert len(train_calls) == 1
    assert (train_calls[0][0].numel(), train_calls[0][2].numel()) == (
        fl.train_weight_sizes(cfg, "wg"))
    render_fn = make_render_fn(cfg)
    render_image(render_fn, state.params, rays, 40, 1, chunk=16, device=dev)
    assert len(fwd_calls) == 1
    assert (fl.train_level.launches - before[0],
            fl.render_level.launches - before[1]) == (2, 6)


def tensors(out):
    """Every tensor in nested tuples and lists (None left out)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in (out or ()) for t in tensors(o)]


def test_wide_unported_routes_raise_before_launch_on_cuda():
    """The widths the wide route refused while it had a ceiling are taken
    now: on CUDA tensors every route at net_width_condition 288 and at
    net_width 1056, in bf16 and f32, launches its kernel once and gives
    finite outputs of the config's shapes (held to the plain versions
    there by ``-k any_width``); every route at 288, 512 and 1024 in bf16
    and f32 passes every config check (``test_wide_levels_match_plain_on_
    cuda``, ``test_wide_mlp_kernels_match_plain_on_cuda`` and
    ``test_wide_twopass_equals_train_level_on_cuda`` launch them)."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.kernels import launch_counts

    dev = cuda_device()
    R = 2
    for width in (288, 512, 1024):
        for dtype in ("bfloat16", "float32"):
            cfg = Config(**dict(SMALL, net_width=width, compute_dtype=dtype))
            assert fl.uses_wide(cfg)
            fl.check_kernel_config(cfg)
            fl.check_kernel_config(cfg, any_heads=True)
            for kernel in fl.KERNELS:
                for input_grads in (True, False):
                    assert fl.takes_wide(cfg, kernel, cfg.num_samples,
                                         input_grads)
    routes = ("train_level", "render_level", "train_level_twopass",
              "mlp_fwd", "mlp_bwd")
    for kw in (dict(net_width=512, net_width_condition=288),
               dict(net_width=1056),
               dict(net_width=512, net_width_condition=288,
                    compute_dtype="float32"),
               dict(net_width=1056, compute_dtype="float32")):
        cfg = Config(**dict(SMALL, **kw))
        S = cfg.num_samples
        params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg,
                               device=dev)
        dt = tmlp.compute_dtype(cfg)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(R * S, cfg.location_features, generator=g,
                        device=dev).to(dt)
        d = torch.randn(R, 27, generator=g, device=dev).to(dt)
        delta = torch.ones(R, S, device=dev)
        pixels = torch.zeros(R, 3, device=dev)
        g_scale = torch.ones(R, 1, device=dev)
        g_rgb = torch.randn(R * S, 3, generator=g, device=dev) * 1e-3
        g_den = torch.randn(R * S, 1, generator=g, device=dev) * 1e-3
        calls = {
            "train_level": lambda: fl.train_level_cuda(
                params, cfg, x, d, delta, pixels, g_scale, True, "t"),
            "render_level": lambda: fl.render_level_cuda(
                params, cfg, x, d, delta, True, "t"),
            "train_level_twopass": lambda: fl.train_level_twopass_cuda(
                params, cfg, x, d, delta, pixels, g_scale, True),
            "mlp_fwd": lambda: fm.mlp_fwd_cuda(params, cfg, x, d),
            "mlp_bwd": lambda: fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb,
                                               g_den, True),
        }
        for name in routes:
            before = launch_counts()
            out = calls[name]()
            torch.cuda.synchronize()
            grown = {k: v - before[k] for k, v in launch_counts().items()}
            assert grown == {k: int(k == name) for k in grown}, (kw, name)
            flat = tensors(out)
            assert flat and all(bool(torch.isfinite(t.float()).all())
                                for t in flat), (kw, name)
        dims = tmlp.layer_dims(cfg)
        assert [tuple(dw.shape) for dw, _ in calls["train_level"]()[3]] == dims


def exact_forward_inputs(cfg, R, seed, dev):
    """An MLP whose forward every f32 computation takes exactly, and so
    with the same ReLU masks: weights in {-1, 0, 1} (three nonzeros a
    column), zero biases, features and directions integers in [-2, 2], so
    every pre-activation is an integer below 2^22 (at most 3^(depth + 2)
    times 2), exact in the kernels' 3xTF32 sums (each operand's high and
    low TF32 parts hold it), in f32 and in f64. Returns (params, x [R*S,
    F], d [R, Fd], random head cotangents g_rgb, g_den) on ``dev``."""
    rng = np.random.default_rng(seed)
    params = []
    for fan_in, fan_out in tmlp.layer_dims(cfg):
        w = np.zeros((fan_in, fan_out), np.float32)
        for j in range(fan_out):
            w[rng.choice(fan_in, 3, replace=False), j] = rng.choice(
                [-1.0, 1.0], 3)
        params.append((torch.from_numpy(w).to(dev),
                       torch.zeros(fan_out, device=dev)))
    S = cfg.num_samples
    ints = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(-2, 3, size=shape).astype(np.float32)).to(dev)
    g = [torch.from_numpy(rng.normal(size=(R * S, c)).astype(np.float32)
                          * 1e-3).to(dev)
         for c in (cfg.num_rgb_channels, cfg.num_density_channels)]
    return (params, ints(R * S, cfg.location_features),
            ints(R, cfg.direction_features), g[0], g[1])


@pytest.mark.parametrize("width", [288, 512, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wide_mlp_kernels_match_plain_on_cuda(dtype, width):
    """The wide route of the MLP kernels (net_width 288-1024, bf16 and
    f32): ``mlp_fwd`` (heads 3 / 1 at R=300, S=128 and 4 / 2 ragged at
    R=37) and ``mlp_bwd`` with and without input_grads (3 / 1 with the
    composite's cotangents, 5 / 2 random) against ``mlp_fwd_plain`` /
    ``mlp_bwd_plain``: heads, every dW / db, dX and dD in the dtype's band,
    ``mlp_bwd`` bit-equal over two launches, one launch counted a call.
    f32 against the plain versions with f64 products; its random
    cotangents (4 / 2, 5 / 2) go through ``exact_forward_inputs``' MLP:
    on the random MLP every f32 computation, the kernel's, the f32 plain
    version's and the one with f64 products alike, puts some ReLU masks
    on the other side of zero from the others, and with cotangents spread
    over every row one such mask moves a column sum past the f32 band."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    atol, rtol = BANDS[dtype]
    flat = lambda o: [t for wb in o[0] for t in wb] + [  # noqa: E731
        t for t in o[1:] if t is not None]
    for heads, R in (((3, 1), 300), ((4, 2), 37), ((5, 2), 37)):
        cfg = Config(**dict(WIDE, net_width=width, num_rgb_channels=heads[0],
                            num_density_channels=heads[1],
                            compute_dtype=dtype))
        assert fl.uses_wide(cfg)
        S = cfg.num_samples
        params = tmlp.init_mlp(torch.Generator().manual_seed(width + R),
                               cfg, device=dev)
        x, d, g_rgb, g_den = mlp_inputs(cfg, params, R, width % 11, dev)
        packed = fm.pack_mlp_params(params, cfg, tmlp.compute_dtype(cfg))
        before = fm.mlp_fwd.launches
        raw = fm.mlp_fwd(params, cfg, x, d, packed=packed)
        torch.cuda.synchronize()
        assert fm.mlp_fwd.launches == before + 1
        with reference_products(cfg):
            raw_ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
        for a, b in zip(raw, raw_ref):
            assert bool(torch.isfinite(a).all()) and a.shape == b.shape
            assert normalized_err(a, b, atol, rtol) < 1.0, (width, heads)
        if dtype == "float32" and heads != (3, 1):  # see the docstring
            params, x, d, g_rgb, g_den = exact_forward_inputs(
                cfg, R, width % 11, dev)
            packed = fm.pack_mlp_params(params, cfg, tmlp.compute_dtype(cfg))
        for input_grads in ((True, False) if heads != (4, 2) else (True,)):
            before = fm.mlp_bwd.launches
            a, b = (fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads,
                               packed=packed) for _ in range(2))
            torch.cuda.synchronize()
            assert fm.mlp_bwd.launches == before + 2
            with reference_products(cfg):
                ref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                                       input_grads)
            got, again, exp = flat(a), flat(b), flat(ref)
            assert len(got) == len(exp) == 2 * len(params) + 2 * input_grads
            for k, (ta, tb, tr) in enumerate(zip(got, again, exp)):
                assert torch.equal(ta, tb), (width, heads, input_grads, k)
                assert ta.shape == tr.shape and bool(torch.isfinite(ta).all())
                assert normalized_err(ta.float(), tr.float(), atol,
                                      rtol) < 1.0, (width, heads, k)


@pytest.mark.parametrize("width", [288, 512, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wide_twopass_equals_train_level_on_cuda(dtype, width):
    """The two-pass kernel at net_width 288-1024 (bf16 and f32) runs
    ``train_level``'s wide route in its two phases: bit-equal to
    ``train_level`` on the same inputs and over two launches, in the
    dtype's band of ``level_train_plain`` (f32: with f64 products), with
    Multicam's loss weights."""
    dev = cuda_device()
    cfg = Config(**dict(WIDE, net_width=width, compute_dtype=dtype,
                        kernel_probes="fl_variant=twopass"))
    R, S = 200, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(width), cfg,
                           device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, _ = train_inputs(R, S, 9, dev)
    g_scale = multicam_g_scale(R, 10).to(dev)
    dt = tmlp.compute_dtype(cfg)
    x = integrated_pos_enc((means, covs), 0, cfg.max_deg_point,
                           fast=True).reshape(R * S, -1).to(dt)
    d, delta = dir_enc.to(dt), interval_lengths(t_vals, dirs)
    packed = fl.pack_train(params, cfg, dt)
    before = fl.train_level_twopass.launches
    a, b = (fl.train_level_twopass(params, cfg, x, d, delta, pixels, g_scale,
                                   True, packed=packed) for _ in range(2))
    torch.cuda.synchronize()
    assert fl.train_level_twopass.launches == before + 2
    one = fl.train_level_cuda(params, cfg, x, d, delta, pixels, g_scale,
                              True, "t", packed=packed)
    with reference_products(cfg):
        ref = fl.level_train_plain(params, cfg, x, d, delta, pixels, g_scale,
                                   True, "t")
    flat = lambda o: [*o[:3], *[t for wb in o[3] for t in wb]]  # noqa: E731
    atol, rtol = BANDS[dtype]
    for k, (ta, tb, to, tr) in enumerate(zip(*map(flat, (a, b, one, ref)))):
        assert torch.equal(ta, tb) and torch.equal(ta, to), k
        assert bool(torch.isfinite(ta).all())
        assert normalized_err(ta, tr, atol, rtol) < 1.0, k


ANY_WIDTHS = [(512, 320), (1056, 288), (2048, 1056)]
ANY_IDS = [f"{w}_{wc}" for w, wc in ANY_WIDTHS]


def any_width_cfg(widths, dtype, **kw):
    """``WIDE`` at net_width / net_width_condition ``widths`` (the wide
    route with no ceiling: above 1024, above 256, a partial last slab)."""
    return Config(**dict(WIDE, net_width=widths[0],
                         net_width_condition=widths[1], compute_dtype=dtype,
                         **kw))


def any_width_inputs(cfg, R, seed, dev):
    """(params, x [R*S, F], d [R, Fd], g_rgb, g_den) of the any_width card
    tests. bf16: a random MLP, IPE features and the composite's
    cotangents (``mlp_inputs``). f32: ``exact_forward_inputs``' MLP, on
    which every f32 computation takes the same ReLU masks, so that every
    dW / db is held; a random MLP in f32 is held by
    ``test_any_width_f32_random_mlp_matches_plain_on_cuda``."""
    if cfg.compute_dtype == "float32":
        return exact_forward_inputs(cfg, R, seed, dev)
    params = tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg,
                           device=dev)
    return (params, *mlp_inputs(cfg, params, R, seed, dev))


def check_close(got, ref, dtype, what):
    """Every tensor of ``got`` finite, of ``ref``'s shape and in the
    dtype's band of it."""
    atol, rtol = BANDS[dtype]
    got, ref = tensors(got), tensors(ref)
    assert len(got) == len(ref), what
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), (what, k)
        err = normalized_err(a.float(), b.float(), atol, rtol)
        assert err < 1.0, (what, k, err)


@pytest.mark.parametrize("widths", ANY_WIDTHS, ids=ANY_IDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_any_width_levels_match_plain_on_cuda(dtype, widths):
    """``train_level`` and ``render_level`` at net_width 512 / 320,
    1056 / 288 and 2048 / 1056 against the plain versions in the dtype's
    band (f32: with f64 products), ragged masked rays: in mode "t" on
    ``any_width_inputs``, and in bf16 also in mode "mv" (the IPE in the
    kernel; f32 mode "mv" is
    ``test_any_width_f32_random_mlp_matches_plain_on_cuda``'s and
    chip_smoke.py's any_width phase's)."""
    dev = cuda_device()
    cfg = any_width_cfg(widths, dtype)
    assert fl.uses_wide(cfg) and fl.kernel_cfg(cfg) is cfg
    R, S = 37, cfg.num_samples
    params, x, d, _, _ = any_width_inputs(cfg, R, 5, dev)
    dt = tmlp.compute_dtype(cfg)
    x, d = x.to(dt), d.to(dt)
    _, _, _, t_vals, dirs, pixels, g_scale = train_inputs(R, S, 5, dev)
    delta = interval_lengths(t_vals, dirs)
    before = (fl.train_level.launches, fl.render_level.launches)
    out = fl.train_level_cuda(params, cfg, x, d, delta, pixels, g_scale,
                              True, "t")
    comp = fl.render_level_cuda(params, cfg, x, d, delta, False, "t")
    torch.cuda.synchronize()
    assert (fl.train_level.launches - before[0],
            fl.render_level.launches - before[1]) == (1, 1)
    with reference_products(cfg):
        ref = fl.level_train_plain(params, cfg, x, d, delta, pixels,
                                   g_scale, True, "t")
        comp_ref = fl.render_level_plain(params, cfg, x, d, delta, False, "t")
    check_close(out, ref, dtype, "train_level")
    check_close(comp, comp_ref, dtype, "render_level")
    if dtype == "bfloat16":
        check_train(cfg, R, "mv", True, dev)
        check_render(cfg, R, "mv", False, dev)


@pytest.mark.parametrize("widths", ANY_WIDTHS, ids=ANY_IDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_any_width_mlp_kernels_match_plain_on_cuda(dtype, widths):
    """``mlp_fwd`` and ``mlp_bwd`` (with and without input_grads) at the
    same widths on ``any_width_inputs`` against ``mlp_fwd_plain`` /
    ``mlp_bwd_plain``: heads, every dW / db, dX and dD in the dtype's band
    (f32: with f64 products), ``mlp_bwd`` bit-equal over two launches."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = any_width_cfg(widths, dtype)
    R, S = 64, cfg.num_samples
    params, x, d, g_rgb, g_den = any_width_inputs(cfg, R, 3, dev)
    dt = tmlp.compute_dtype(cfg)
    x, d = x.to(dt), d.to(dt)
    packed = fm.pack_mlp_params(params, cfg, dt)
    raw = fm.mlp_fwd(params, cfg, x, d, packed=packed)
    with reference_products(cfg):
        raw_ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
    check_close(raw, raw_ref, dtype, "mlp_fwd")
    for input_grads in (True, False):
        a, b = (fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads,
                           packed=packed) for _ in range(2))
        with reference_products(cfg):
            ref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                                   input_grads)
        assert all(torch.equal(ta, tb)
                   for ta, tb in zip(tensors(a), tensors(b))), input_grads
        check_close(a, ref, dtype, f"mlp_bwd input_grads={input_grads}")


@pytest.mark.parametrize("widths", ANY_WIDTHS, ids=ANY_IDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_any_width_twopass_equals_train_level_on_cuda(dtype, widths):
    """The two-pass kernel at the same widths on ``any_width_inputs``:
    bit-equal to ``train_level`` on the same inputs and over two
    launches, in the dtype's band of ``level_train_plain`` (f32: with f64
    products), with Multicam's loss weights."""
    dev = cuda_device()
    cfg = any_width_cfg(widths, dtype, kernel_probes="fl_variant=twopass")
    R, S = 64, cfg.num_samples
    params, x, d, _, _ = any_width_inputs(cfg, R, 9, dev)
    dt = tmlp.compute_dtype(cfg)
    x, d = x.to(dt), d.to(dt)
    _, _, _, t_vals, dirs, pixels, _ = train_inputs(R, S, 9, dev)
    g_scale = multicam_g_scale(R, 10).to(dev)
    delta = interval_lengths(t_vals, dirs)
    packed = fl.pack_train(params, cfg, dt)
    a, b = (fl.train_level_twopass(params, cfg, x, d, delta, pixels, g_scale,
                                   True, packed=packed) for _ in range(2))
    one = fl.train_level_cuda(params, cfg, x, d, delta, pixels, g_scale,
                              True, "t", packed=packed)
    with reference_products(cfg):
        ref = fl.level_train_plain(params, cfg, x, d, delta, pixels, g_scale,
                                   True, "t")
    for ta, tb, to in zip(tensors(a), tensors(b), tensors(one)):
        assert torch.equal(ta, tb) and torch.equal(ta, to)
    check_close(a, ref, dtype, "train_level_twopass")


@pytest.mark.parametrize("widths", ANY_WIDTHS, ids=ANY_IDS)
def test_any_width_f32_random_mlp_matches_plain_on_cuda(widths):
    """f32 at the same widths on a random MLP (``init_mlp``) and IPE
    features, against the plain versions with f64 products in the f32
    band, ragged masked rays. A mask flipped at a pre-activation near
    zero moves the forward by about that pre-activation, so
    ``train_level``'s forward outputs (modes "t" and "mv"),
    ``render_level`` (mode "mv") and ``mlp_fwd`` are held as they are;
    it moves a dW column sum by its row's whole term (on these inputs in
    mode "mv" at 512 / 320 the kernel on an H100 was 1.53 bands from the
    f64-product version in the first view layer's dW), so the backward,
    the wide route's
    f32 passes that ``train_level`` and ``mlp_bwd`` share, is held
    through ``mlp_bwd`` with input_grads on the composite's cotangents
    with the rows of ``near_zero_rows`` set to 0 (at most half the
    rows)."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = any_width_cfg(widths, "float32")
    R, S = 37, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(1), cfg,
                           device=dev)
    means, covs, d, t_vals, dirs, pixels, g_scale = train_inputs(R, S, 1,
                                                                 dev)
    x, _, g_rgb, g_den = mlp_inputs(cfg, params, R, 1, dev)
    delta = interval_lengths(t_vals, dirs)
    mv = (means.reshape(-1, 3), covs.reshape(-1, 3))
    for mode, xs in (("t", x), ("mv", mv)):
        out = fl.train_level_cuda(params, cfg, xs, d, delta, pixels, g_scale,
                                  True, mode)
        with reference_products(cfg):
            ref = fl.level_train_plain(params, cfg, xs, d, delta, pixels,
                                       g_scale, True, mode)
        check_close(out[:3], ref[:3], "float32", f"train_level {mode}")
    comp = fl.render_level_cuda(params, cfg, mv, d, delta, False, "mv")
    raw = fm.mlp_fwd(params, cfg, x, d)
    near = near_zero_rows(params, cfg, x, d)
    assert 2 * int(near.sum()) <= R * S, int(near.sum())
    g_rgb, g_den = (torch.where(near[:, None], 0.0, g) for g in (g_rgb, g_den))
    grads = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, True)
    with reference_products(cfg):
        comp_ref = fl.render_level_plain(params, cfg, mv, d, delta, False,
                                         "mv")
        raw_ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
        grads_ref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S, True)
    check_close(comp, comp_ref, "float32", "render_level")
    check_close(raw, raw_ref, "float32", "mlp_fwd")
    check_close(grads, grads_ref, "float32", "mlp_bwd input_grads=True")


def host_batches(n_batches, R, seed):
    """Seeded numpy ray batches (non-uniform loss_mult) and pixels."""
    from nerf_or_nothing_tpu_torch.rays import Rays

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        o = (rng.normal(size=(R, 3)) * 0.3).astype(np.float32)
        dirs = rng.normal(size=(R, 3)).astype(np.float32)
        rays = Rays(
            origins=o, directions=dirs,
            viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
            radii=np.full((R, 1), 1e-3, np.float32),
            near=np.full((R, 1), 2.0, np.float32),
            far=np.full((R, 1), 6.0, np.float32),
            loss_mult=rng.uniform(0.5, 2.0, (R, 1)).astype(np.float32),
        )
        out.append((rays, rng.uniform(size=(R, 3)).astype(np.float32)))
    return out


GRAPH_ROUTES = {
    "train_level": {},
    "train_level_twopass": {"kernel_probes": "fl_variant=twopass"},
    "mlp_fwd_bwd": {"fuse_level": False, "stop_level_grad": False},
}


@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_graph_steps_equal_eager_steps_on_cuda(route):
    """Six multi-step steps (two calls of three: one capture, six replays)
    against six eager steps from the same state on the same batches, at a
    narrow bf16 config with randomized sampling: params, moments, step and
    the last stats bit-equal, and the route's kernels counted once a
    level a step (the warm-up's steps included)."""
    from nerf_or_nothing_tpu_torch import train as ttrain
    from nerf_or_nothing_tpu_torch.kernels import launch_counts

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, batch_size=48,
                             compute_dtype="bfloat16", randomized=True,
                             lr_delay_steps=0, **GRAPH_ROUTES[route]))
    batches = host_batches(6, 48, 11)
    eager = ttrain.init_train_state(cfg, dev)
    step_fn = ttrain.make_train_step(cfg)
    for rays, pixels in batches:
        eager, last = step_fn(eager, *ttrain.batch_to_device(dev, rays,
                                                              pixels))
    graph = ttrain.init_train_state(cfg, dev)
    multi = ttrain.make_multi_step(cfg)
    before = launch_counts()
    graph, _ = multi(graph, batches[:3])
    graph, stats = multi(graph, batches[3:])
    grown = {k: v - before[k] for k, v in launch_counts().items()}
    assert len(multi.captured) == 1
    steps = 6 + ttrain.WARMUP_STEPS
    kernels = ("mlp_fwd", "mlp_bwd") if route == "mlp_fwd_bwd" else (route,)
    assert grown == {k: 2 * steps if k in kernels else 0 for k in grown}
    assert graph.step == eager.step == 6
    for name in ("loss", "losses", "weight_l2", "psnr", "grad_norm",
                 "grad_abs_max", "grad_norm_clipped"):
        assert torch.equal(getattr(stats, name), getattr(last, name)), name
    for tree_a, tree_b in ((graph.params, eager.params),
                           (graph.mu, eager.mu), (graph.nu, eager.nu)):
        for (wa, ba), (wb, bb) in zip(tree_a, tree_b):
            assert torch.equal(wa, wb) and torch.equal(ba, bb)


def test_graph_recaptures_for_a_new_shape_or_state_on_cuda():
    """A new batch size captures a second graph; a state whose tensors and
    generator are not the captured ones (a restore) replaces both graphs
    by a new capture, whose steps equal eager steps on a copy of it."""
    from nerf_or_nothing_tpu_torch import train as ttrain

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, batch_size=48,
                             compute_dtype="bfloat16", randomized=True,
                             lr_delay_steps=0))
    multi = ttrain.make_multi_step(cfg)
    state = ttrain.init_train_state(cfg, dev)
    state, _ = multi(state, host_batches(2, 48, 14))
    first = multi.captured[(48, (3, 3, 3, 1, 1, 1, 1, 3))]
    state, _ = multi(state, host_batches(2, 32, 15))
    assert len(multi.captured) == 2

    def copy():
        return ttrain.TrainState(
            state.step, *[[(w.clone(), b.clone()) for w, b in tree]
                          for tree in (state.params, state.mu, state.nu)],
            torch.Generator(device=dev))

    restored, eager = copy(), copy()
    batches = host_batches(3, 48, 16)
    restored, stats = multi(restored, batches)
    assert len(multi.captured) == 1
    assert next(iter(multi.captured.values())) is not first
    step_fn = ttrain.make_train_step(cfg)
    for rays, pixels in batches:
        eager, last = step_fn(eager, *ttrain.batch_to_device(dev, rays,
                                                              pixels))
    assert restored.step == eager.step == state.step + 3
    assert torch.equal(stats.loss, last.loss)
    for a, b in zip(ttrain.state_tensors(restored),
                    ttrain.state_tensors(eager)):
        assert torch.equal(a, b)


def test_render_after_graph_replays_sees_new_params_on_cuda():
    """``make_render_fn``'s packed-weight cache, keyed on ``_version``,
    repacks after graph replays (which the multi-step makes visible by
    bumping every version): the same render function then renders what a
    fresh one renders, not the weights it packed before."""
    from nerf_or_nothing_tpu_torch import train as ttrain
    from nerf_or_nothing_tpu_torch.eval import make_render_fn
    from nerf_or_nothing_tpu_torch.rays import Rays

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, batch_size=48,
                             compute_dtype="bfloat16", lr_delay_steps=0,
                             lr_init=1e-2, lr_final=1e-2))
    batches = host_batches(4, 48, 12)
    state = ttrain.init_train_state(cfg, dev)
    render_fn = make_render_fn(cfg)
    rays = Rays(*[torch.from_numpy(x).to(dev) for x in batches[0][0]])
    first = render_fn(state.params, rays)[0].clone()
    key = [(id(t), t._version) for wb in state.params for t in wb]
    state, _ = ttrain.make_multi_step(cfg)(state, batches)
    assert all(k[1] < t._version for k, t in
               zip(key, [t for wb in state.params for t in wb]))
    again = render_fn(state.params, rays)[0]
    fresh = make_render_fn(cfg)(state.params, rays)[0]
    assert torch.equal(again, fresh)
    assert not torch.equal(again, first)


def test_graph_debug_nans_raises_and_keeps_state_on_cuda():
    """With ``debug_nans`` the captured step is two graphs with the finite
    check between them: a NaN pixel in the second batch raises after the
    first step was applied, and the state stays as that step left it."""
    from nerf_or_nothing_tpu_torch import train as ttrain

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, batch_size=48,
                             compute_dtype="bfloat16", randomized=True,
                             lr_delay_steps=0, debug_nans=True))
    batches = host_batches(3, 48, 13)
    batches[1][1][5, 2] = np.nan
    ref = ttrain.init_train_state(cfg, dev)
    ref, _ = ttrain.make_train_step(cfg)(
        ref, *ttrain.batch_to_device(dev, *batches[0]))
    state = ttrain.init_train_state(cfg, dev)
    with pytest.raises(FloatingPointError, match="nan"):
        ttrain.make_multi_step(cfg)(state, batches)
    assert state.step == ref.step == 1
    for tree_a, tree_b in ((state.params, ref.params), (state.mu, ref.mu),
                           (state.nu, ref.nu)):
        for (wa, ba), (wb, bb) in zip(tree_a, tree_b):
            assert torch.equal(wa, wb) and torch.equal(ba, bb)
    assert torch.equal(state.generator.get_state(), ref.generator.get_state())


def test_level_parity_errors_on_cuda():
    """``utils.parity.level_parity_errors``: the train kernel against the
    autograd oracle, bf16 and f32, within each band."""
    from nerf_or_nothing_tpu_torch.utils import parity

    cuda_device()
    for dtype in ("bfloat16", "float32"):
        worst, errs = parity.level_parity_errors(dtype, device="cuda")
        assert worst < 1.0, (dtype, errs)


# One rank on NCCL in its own process: the three train routes' sharded
# steps (all-reduces and all) against the unsharded ones, eager, and the
# sharded multi-step (graph replays with the all-reduces captured) against
# the eager sharded steps. Prints OK per route.
NCCL_WORLD1 = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[2])
from test_torch_kernel_cuda import GRAPH_ROUTES, SMALL, host_batches
from nerf_or_nothing_tpu_torch import train as ttrain
from nerf_or_nothing_tpu_torch.config import tiny_config
from nerf_or_nothing_tpu_torch.kernels import launch_counts
from nerf_or_nothing_tpu_torch.parallel import mesh

mesh.initialize("file://" + sys.argv[1], 1, 0, "cuda")
assert torch.distributed.get_backend() == "nccl"
m = mesh.create_mesh(1, device="cuda")
dev = m.device
batches = host_batches(6, 48, 11)
todev = [ttrain.batch_to_device(dev, r, p) for r, p in batches]


def same(a, b, sa, sb):
    return a.step == b.step and all(
        torch.equal(x, y) for x, y in zip(ttrain.state_tensors(a),
                                          ttrain.state_tensors(b))) and all(
        torch.equal(getattr(sa, k), getattr(sb, k))
        for k in ("loss", "losses", "psnr", "grad_norm", "grad_abs_max"))


for route, kw in GRAPH_ROUTES.items():
    cfg = tiny_config(**dict(SMALL, num_levels=2, batch_size=48,
                             compute_dtype="bfloat16", randomized=True,
                             lr_delay_steps=0, **kw))
    plain, sharded = ttrain.make_train_step(cfg), \
        mesh.make_sharded_train_step(cfg, m)
    a = ttrain.init_train_state(cfg, dev)
    b = mesh.replicate_state(ttrain.init_train_state(cfg, dev))
    for bt in todev:
        a, la = plain(a, *bt)
        b, lb = sharded(b, *bt)
    assert same(a, b, la, lb), f"{route}: sharded eager != unsharded"
    multi = mesh.make_sharded_multi_step(cfg, m)
    g = ttrain.init_train_state(cfg, dev)
    before = launch_counts()
    g, _ = multi(g, batches[:3])
    g, lg = multi(g, batches[3:])
    grown = sum(launch_counts()[k] - before[k] for k in before)
    assert len(multi.captured) == 1
    per_step = 4 if route == "mlp_fwd_bwd" else 2
    assert grown == per_step * (6 + ttrain.WARMUP_STEPS), grown
    assert same(g, b, lg, lb), f"{route}: sharded graph != sharded eager"
    print("OK", route, flush=True)
torch.distributed.destroy_process_group()
"""


def test_world_of_one_on_nccl_is_the_unsharded_step_on_cuda(tmp_path):
    """In a NCCL group of one rank (a child process, so that no group
    outlives the test) the sharded step of each train route is bit-equal
    to the unsharded step over six steps, and the sharded multi-step (one
    capture with the all-reduces inside, six replays) to the sharded eager
    steps."""
    from nerf_or_nothing_tpu_torch.kernels import build

    cuda_device()
    build.build_all(build.SOURCES)  # the child loads what this built
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", NCCL_WORLD1, str(tmp_path / "store"), here],
        cwd=os.path.dirname(here), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split().count("OK") == len(GRAPH_ROUTES), proc.stdout


def test_tensor_parallel_grids_on_four_cards(tmp_path):
    """Tensor parallelism across four cards (NCCL, one rank a card) at
    ``Config()``: ``run train --mesh-shape=2,2`` for 4 steps against ``run
    train --use-pallas=false`` in one process, their checkpoints in the
    bf16 band; 2 x 2 and 1 x 4 grids of child processes against the plain
    step (``chip_smoke.grid_check``: the bf16 band, each block bit-equal
    down its 'model' column, the rest on every rank). One card holds one
    NCCL rank, so ``chip_smoke.py``'s tensor phase checks a 1 x 1 NCCL grid
    and a 2 x 2 gloo grid there."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one rank a card")
    dev = cuda_device()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke
    from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    scene = str(tmp_path / "scene")
    write_scene(scene, n_train=4, n_test=1, size=400)
    latest = {}
    for name, extra in (("grid", "--mesh-shape=2,2"),
                        ("plain", "--use-pallas=false")):
        ckpt = str(tmp_path / f"ckpt_{name}")
        assert run.main(["train", f"--data-dir={scene}", "--max-steps=4",
                         "--print-every=2", "--test-render-interval=0",
                         f"--checkpoint-dir={ckpt}", extra,
                         "--device=cuda"]) == 0, name
        latest[name] = ckpt_lib.latest_checkpoint(ckpt)
    with np.load(latest["grid"]) as g, np.load(latest["plain"]) as p:
        names = [k for k in p.files if k.split("/")[0] in ("params", "mu",
                                                           "nu")]
        errs, _ = smoke.check_pairs("run train --mesh-shape=2,2", [
            (k, torch.from_numpy(g[k]), torch.from_numpy(p[k]))
            for k in names], "bfloat16")
    assert max(errs.values()) < 1.0, errs

    cfg = run.parse_flags([f"--data-dir={scene}", "--randomized=true"])
    batches = smoke.loader_batches(scene, cfg, smoke.TP_GLOO_STEPS)
    smoke.save_batches(str(tmp_path), batches)
    for dp, mp in ((2, 2), (1, 4)):
        smoke.grid_children(dp, mp, "nccl", scene, str(tmp_path))
        res = smoke.grid_check(cfg, batches, str(tmp_path), dp, mp, dev)
        print(json.dumps(res), flush=True)


def test_quality_20k_on_cuda(tmp_path):
    """The JAX package's full quality run on the card
    (``benchmarks/bench_quality.py --full --size 256 --steps 20000``): the
    hard scene, 24 train and 3 test views at 256x256, ``Config()``'s
    widths at batch 1024 with the harness's schedule, 20,000 steps of
    ``train.make_multi_step`` (graph replays through ``train_level``),
    then held-out view 0 through ``render_level``
    (``chip_smoke.quality_run``). Held against the recorded JAX run
    (``benchmarks/artifacts/quality_curve_hard_full.json``, read here):
    held-out view 0 within 1.5 dB of its PSNR, and the mean train PSNR over
    steps 19,001-20,000 within 1.5 dB of the mean of its points at
    19,000-20,000. Takes minutes: select it with ``-k quality_20k``."""
    dev = cuda_device()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke

    steps = smoke.QUALITY_MAX_STEPS
    res = smoke.quality_run(dev, steps, str(tmp_path))
    jax = smoke.jax_quality_curve()
    window = [p for e, p in res["psnr_by_call"] if steps - 1000 < e <= steps]
    mean = sum(window) / len(window)
    jax_mean = smoke.window_mean(jax["curve"], steps - 1000, steps)
    print(json.dumps({
        "quality_20k": {k: v for k, v in res.items() if k != "psnr_by_call"},
        "window_mean_psnr": mean, "jax_window_mean_psnr": jax_mean,
        "device": smoke.nvidia_smi_line()}), flush=True)
    assert res["finite"]
    assert res["heldout"]["psnr"] >= (jax["heldout"][0]["psnr"]
                                      - smoke.QUALITY_MARGIN_DB), res["heldout"]
    assert mean >= jax_mean - smoke.QUALITY_MARGIN_DB, (mean, jax_mean)


# Widths that are not multiples of 32, and net_width_condition above
# net_width: the kernels run them zero-padded (``fused_level.kernel_cfg``).
PADDED_ROWS = {
    "16_8": dict(net_width=16, net_width_condition=8, net_depth=2),
    "32_16": dict(net_width=32, net_width_condition=16, net_depth=3),
    "48_16": dict(net_width=48, net_width_condition=16, net_depth=8,
                  net_depth_condition=2),
    "96_48": dict(net_width=96, net_width_condition=48, net_depth=4),
    "32_64": dict(net_width=32, net_width_condition=64, net_depth=8),
    "400_200": dict(net_width=400, net_width_condition=200, net_depth=8),
    "260_128": dict(net_width=260, net_width_condition=128, net_depth=8),
}
PADDED_CASES = [(r, dt) for r in sorted(PADDED_ROWS)
                for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("row,dtype", PADDED_CASES)
def test_padded_widths_match_plain_on_cuda(row, dtype):
    """Each of the five kernels at a width that is not a multiple of 32
    (or net_width_condition above net_width), R=37 x S=64, random biases,
    against its plain version at the real config in the dtype's band (f32
    on the wide route: with f64 products):
    ``render_level`` (mode "mv"), ``train_level`` (modes "t" and "mv"),
    ``train_level_twopass``, ``mlp_fwd`` and ``mlp_bwd`` with input_grads.
    The backward kernels are bit-equal over two launches, and a launch at
    the kernel config on the embedded weights gives padded dW/db entries of
    exactly 0 and, once they are dropped, the real launch's grads bit for
    bit. Launch counts exact."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.kernels import launch_counts

    dev = cuda_device()
    cfg = Config(**dict(PADDED_ROWS[row], num_samples=64,
                        compute_dtype=dtype))
    kc = fl.kernel_cfg(cfg)
    assert kc is not cfg
    R, S = 37, cfg.num_samples
    g = torch.Generator().manual_seed(len(row))
    params = [(w, (torch.randn(b.shape, generator=g) * 0.1).to(dev))
              for w, b in tmlp.init_mlp(g, cfg, device=dev)]
    ep = fl.embed_params(params, cfg)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, 5, dev)
    dt = tmlp.compute_dtype(cfg)
    mv = (means.reshape(-1, 3), covs.reshape(-1, 3))
    x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                           cfg.max_deg_point, fast=True).reshape(R * S, -1)
    x, d = x.to(dt), dir_enc.to(dt)
    delta = interval_lengths(t_vals, dirs)
    atol, rtol = BANDS[dtype]
    pad = torch.ones(tmlp.num_params(kc), dtype=torch.bool, device=dev)
    pad[fl._unembed_index(cfg, dev)] = False

    def flat(d_params):
        return torch.cat([w.reshape(-1) for w, _ in d_params]
                         + [b for _, b in d_params])

    def plain(fn, *args):
        with reference_products(cfg):
            return fn(*args)

    def in_band(got, ref, what):
        assert len(got) == len(ref), what
        for k, (a, b) in enumerate(zip(got, ref)):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            err = normalized_err(a.float(), b.float(), atol, rtol)
            assert err < 1.0, (what, k, err)

    before = launch_counts()
    out = fl.render_level_cuda(params, cfg, mv, d, delta, True, "mv")
    in_band(out, plain(fl.render_level_plain, params, cfg, mv, d, delta,
                       True, "mv"), "render_level")
    for mode, xs in (("t", x), ("mv", mv)):
        out = fl.train_level_cuda(params, cfg, xs, d, delta, pixels, g_scale,
                                  True, mode)
        ref = plain(fl.level_train_plain, params, cfg, xs, d, delta, pixels,
                    g_scale, True, mode)
        in_band([*out[:3], flat(out[3])], [*ref[:3], flat(ref[3])],
                f"train_level {mode}")
    for name, fn in (
            ("train_level", lambda p, c: fl.train_level_cuda(
                p, c, x, d, delta, pixels, g_scale, True, "t")),
            ("train_level_twopass", lambda p, c: fl.train_level_twopass_cuda(
                p, c, x, d, delta, pixels, g_scale, True))):
        a, b, padded = fn(params, cfg), fn(params, cfg), fn(ep, kc)
        assert all(torch.equal(ta, tb) for ta, tb in zip(
            [*a[:3], flat(a[3])], [*b[:3], flat(b[3])])), name
        pf = flat(padded[3])
        assert not pf[pad].any(), name
        assert torch.equal(fl.unembed_grads(pf, cfg), flat(a[3])), name
        assert all(torch.equal(ta, tp) for ta, tp in zip(a[:3], padded[:3]))
    twopass_ref = plain(fl.level_train_plain, params, cfg, x, d, delta,
                        pixels, g_scale, True, "t")
    in_band([*a[:3], flat(a[3])], [*twopass_ref[:3], flat(twopass_ref[3])],
            "train_level_twopass")
    x, d, g_rgb, g_den = mlp_inputs(cfg, params, R, 6, dev)
    in_band(fm.mlp_fwd_cuda(params, cfg, x, d),
            plain(fm.mlp_fwd_plain, params, cfg, x, d, S), "mlp_fwd")
    a, b = (fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den, True)
            for _ in range(2))
    padded = fm.mlp_bwd_cuda(ep, kc, x, d, g_rgb, g_den, True)
    ref = plain(fm.mlp_bwd_plain, params, cfg, x, d, g_rgb, g_den, S, True)
    in_band([flat(a[0]), *a[1:]], [flat(ref[0]), *ref[1:]], "mlp_bwd")
    assert all(torch.equal(ta, tb) for ta, tb in zip(
        [flat(a[0]), *a[1:]], [flat(b[0]), *b[1:]]))
    pf = flat(padded[0])
    assert not pf[pad].any()
    assert torch.equal(fl.unembed_grads(pf, cfg), flat(a[0]))
    assert all(torch.equal(ta, tp) for ta, tp in zip(a[1:], padded[1:]))
    torch.cuda.synchronize()
    grown = {k: v - before[k] for k, v in launch_counts().items()}
    assert grown == {"render_level": 1, "train_level": 5,
                     "train_level_twopass": 3, "mlp_fwd": 1, "mlp_bwd": 3}


# ---------------------------------------------------------------------------
# Heads of any channel count and location features past the narrow routes'
# shared memory (tests/test_torch_any_heads.py, tests/test_torch_any_
# features.py hold the plain versions against the JAX package)
# ---------------------------------------------------------------------------

ANY_HEADS = [(9, 1), (1, 9), (16, 16), (17, 33), (3, 64)]
HEAD_WIDTHS = {"narrow": (64, 32), "wide": (288, 64)}


@pytest.mark.parametrize("width", sorted(HEAD_WIDTHS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_any_heads_mlp_kernels_match_plain_on_cuda(dtype, width):
    """``mlp_fwd`` and ``mlp_bwd`` (with and without input_grads) at head
    pairs (9, 1), (1, 9), (16, 16), (17, 33) and (3, 64), at 64 / 32 (the
    narrow route: the bf16 forward's N=8 product a group of 8 channels)
    and 288 / 64 (the wide route: a head launch a group), against
    ``mlp_fwd_plain`` / ``mlp_bwd_plain`` in the dtype's band (f32 on the
    wide route: with f64 products, ``any_width_inputs``' exact MLP), one
    launch a call, ``mlp_bwd`` bit-equal over two launches."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    W, Wc = HEAD_WIDTHS[width]
    for heads in ANY_HEADS:
        cfg = Config(net_width=W, net_width_condition=Wc, compute_dtype=dtype,
                     num_rgb_channels=heads[0], num_density_channels=heads[1])
        R, S = 48, cfg.num_samples
        for kernel, ig in (("mlp_fwd", False), ("mlp_bwd", False),
                           ("mlp_bwd", True)):
            assert fl.takes_wide(cfg, kernel, S, ig) == (width == "wide")
        params, x, d, g_rgb, g_den = any_width_inputs(cfg, R, sum(heads), dev)
        dt = tmlp.compute_dtype(cfg)
        x, d = x.to(dt), d.to(dt)
        before = (fm.mlp_fwd.launches, fm.mlp_bwd.launches)
        raw = fm.mlp_fwd(params, cfg, x, d)
        assert fm.mlp_fwd.launches == before[0] + 1
        assert [t.shape[1] for t in raw] == list(heads)
        with reference_products(cfg, "mlp_fwd", S):
            raw_ref = fm.mlp_fwd_plain(params, cfg, x, d, S)
        check_close(raw, raw_ref, dtype, f"mlp_fwd {heads}")
        for input_grads in (True, False):
            a, b = (fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads)
                    for _ in range(2))
            with reference_products(cfg, "mlp_bwd", S, input_grads):
                ref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                                       input_grads)
            assert all(torch.equal(ta, tb)
                       for ta, tb in zip(tensors(a), tensors(b))), heads
            check_close(a, ref, dtype, f"mlp_bwd {heads} {input_grads}")
        torch.cuda.synchronize()
        assert fm.mlp_bwd.launches == before[1] + 4


# Covariances of the model's samples (a cone of radius ~1e-3 at t = 2-6),
# which leave the frequencies up to ~2^9 undamped; larger ones damp every
# feature of min_deg_point 8 to ~0, and every pre-activation with it.
MODEL_COV = 2e-5
ANY_FEATURES = {"44": dict(max_deg_point=44), "56": dict(max_deg_point=56),
                "70": dict(max_deg_point=70), "100": dict(max_deg_point=100),
                "8_60": dict(min_deg_point=8, max_deg_point=60),
                "deg_view_32": dict(deg_view=32)}


@pytest.mark.parametrize("deg", sorted(ANY_FEATURES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_any_features_kernels_match_plain_on_cuda(dtype, deg):
    """All five kernels at Config() widths with ``max_deg_point`` 44, 56,
    70 and 100, frequencies 8 to 60, and ``deg_view`` 32 (195 direction
    features), exact transcendentals (the polynomials' features are NaN
    from degree ~36 in both packages), covariances of the model's scale
    (``MODEL_COV``): ``train_level`` and
    ``render_level`` in modes "mv" and "t", the two-pass kernel,
    ``mlp_fwd`` and ``mlp_bwd`` with and without input_grads on the route
    ``takes_wide`` picks, against the plain versions in the dtype's band
    (f32 on the wide route: with f64 products; f32 ``mlp_bwd`` with no
    cotangent on the rows of ``near_zero_rows``, whose ReLU masks two f32
    computations may take on opposite sides of zero); the backward
    kernels bit-equal over two launches."""
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm

    dev = cuda_device()
    cfg = Config(compute_dtype=dtype, fast_ipe=False, **ANY_FEATURES[deg])
    R, S = 21, cfg.num_samples
    kw = dict(cov=MODEL_COV)
    for mode in ("mv", "t"):
        params, a = check_train(cfg, R, mode, mode == "t", dev, **kw)
        _, b = check_train(cfg, R, mode, mode == "t", dev, **kw)
        assert all(torch.equal(ta, tb) for ta, tb in zip(tensors(a),
                                                         tensors(b)))
        check_render(cfg, R, mode, mode == "mv", dev, cov=MODEL_COV)
    two = cfg.replace(kernel_probes="fl_variant=twopass")
    _, a = check_train(two, R, "t", True, dev, seed=2, **kw)
    _, b = check_train(two, R, "t", True, dev, seed=2, **kw)
    assert all(torch.equal(ta, tb) for ta, tb in zip(tensors(a), tensors(b)))
    params = tmlp.init_mlp(torch.Generator().manual_seed(3), cfg, device=dev)
    x, d, g_rgb, g_den = mlp_inputs(cfg, params, R, 3, dev, cov=MODEL_COV)
    if dtype == "float32":
        keep = ~near_zero_rows(params, cfg, x, d)[:, None]
        g_rgb, g_den = g_rgb * keep, g_den * keep
    raw = fm.mlp_fwd(params, cfg, x, d)
    with reference_products(cfg, "mlp_fwd", S):
        check_close(raw, fm.mlp_fwd_plain(params, cfg, x, d, S), dtype,
                    "mlp_fwd")
    for input_grads in (True, False):
        a, b = (fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, input_grads)
                for _ in range(2))
        with reference_products(cfg, "mlp_bwd", S, input_grads):
            ref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                                   input_grads)
        assert all(torch.equal(ta, tb)
                   for ta, tb in zip(tensors(a), tensors(b))), input_grads
        check_close(a, ref, dtype, f"mlp_bwd input_grads={input_grads}")


# The layer GEMM of the wide bf16 route alone (kernels/wide_gemm.py):
# (name, kind, M, N, K0, K1, gemm_case options). M tails, N of 288, 1056
# and 2048 (and 64, below a column block), two-part A, K past whole
# slabs, every epilogue kind.
WIDE_GEMM_CASES = [
    ("fwd_288_tail", "fwd", 5077, 288, 288, 0, {}),
    ("fwd_1056_skip", "fwd", 3001, 1056, 1056, 96, {}),
    ("fwd_2048", "fwd", 1029, 2048, 2048, 0, {}),
    ("fwd_512_k96_x112", "fwd", 777, 512, 96, 112, {}),
    ("fwd_64", "fwd", 300, 64, 64, 16, {}),
    ("fwd_view_dc", "fwd", 4160, 256, 1024, 0, {"dc": True, "S": 64}),
    ("chain_1024_den", "chain", 2049, 1024, 1024, 0, {}),
    ("chain_288", "chain", 1000, 288, 288, 0, {"den": False}),
    ("chain_heads_1056", "chain_heads", 1500, 1056, 1056, 0, {"cd": 3}),
    ("dx_96_accum", "dx", 1999, 96, 1024, 0, {"ldo": 90, "accum": True}),
    ("dx_288", "dx", 777, 288, 512, 0, {"ldo": 270}),
]


@pytest.mark.parametrize("name,kind,M,N,K0,K1,kw", WIDE_GEMM_CASES,
                         ids=[c[0] for c in WIDE_GEMM_CASES])
def test_wide_gemm_matches_parent_and_plain_on_cuda(name, kind, M, N, K0, K1,
                                                    kw):
    """The redesigned layer GEMM (``csrc/wide_gemm.cuh``) bit-equal to the
    cp.async GEMM it replaced (``chip_smoke.gemm_sources``: that commit's
    headers beside ``csrc/wide_gemm.cu``) and over two launches, and in
    the bf16 band of ``wide_gemm_plain``."""
    from nerf_or_nothing_tpu_torch.kernels import wide_gemm as wg

    dev = cuda_device()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke

    parent = smoke.gemm_sources()
    if parent is None:
        pytest.skip("no copy of the parent GEMM and no git history")
    old = parent["wide_gemm"]
    c = wg.gemm_case(kind, M, N, K0, K1, seed=M, device=dev, **kw)
    a, b = wg.wide_gemm_cuda(c), wg.wide_gemm_cuda(c)
    parent = wg.wide_gemm_cuda(c, old)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, parent), name
    assert bool(torch.isfinite(a.float()).all())
    check_close(a, wg.wide_gemm_plain(c), "bfloat16", name)


# The layer GEMM of the wide f32 route alone (kernels/wide_gemm.py): (name,
# kind, M, N, K0, K1, gemm_case options). Each epilogue at N = 288 (two
# column blocks of 144), 1024 (eight of 128), 1056 and 2048 (blocks of
# 160, the last partial), M tails, two-part A, K past whole slabs, the
# first view layer's direction term, density terms of 1 and 3 channels.
WIDE_GEMM_F32_CASES = [
    ("fwd_288_tail", "fwd", 5077, 288, 288, 0, {}),
    ("fwd_1024_skip", "fwd", 2049, 1024, 1024, 96, {}),
    ("fwd_1056_dc", "fwd", 3001, 1056, 1056, 0, {"dc": True, "S": 64}),
    ("fwd_2048", "fwd", 1029, 2048, 2048, 0, {}),
    ("chain_288", "chain", 1000, 288, 288, 0, {"den": False}),
    ("chain_1024_den", "chain", 2049, 1024, 1024, 0, {"cd": 1}),
    ("chain_1056_cd3", "chain", 1500, 1056, 1056, 0, {"cd": 3}),
    ("chain_2048", "chain", 777, 2048, 2048, 0, {"cd": 1}),
    ("dx_288", "dx", 777, 288, 512, 0, {"ldo": 270}),
    ("dx_96_accum", "dx", 1999, 96, 1024, 0, {"ldo": 90, "accum": True}),
    ("dx_1056", "dx", 300, 1056, 2048, 0, {"ldo": 1050, "accum": True}),
    ("dx_2048", "dx", 300, 2048, 1024, 0, {"ldo": 2048}),
]


@pytest.mark.parametrize("name,kind,M,N,K0,K1,kw", WIDE_GEMM_F32_CASES,
                         ids=[c[0] for c in WIDE_GEMM_F32_CASES])
def test_wide_gemm_f32_matches_plain_on_cuda(name, kind, M, N, K0, K1, kw):
    """The f32 layer GEMM (``csrc/wide_f32.cuh``: 3xTF32 ``wgmma`` on the
    packer's hi / lo slabs) gives the same bits over two launches, lies in
    the f32 band of ``wide_gemm_f32_plain`` (f64 products), and, where the
    ``mma.sync`` GEMM it replaced can be built (``chip_smoke.
    f32_gemm_sources``: that commit's headers beside ``csrc/
    wide_gemm_f32.cu``), gives that GEMM's bits."""
    from nerf_or_nothing_tpu_torch.kernels import wide_gemm as wg

    dev = cuda_device()
    c = wg.gemm_case(kind, M, N, K0, K1, seed=M, device=dev,
                     dtype=torch.float32, **kw)
    a, b = wg.wide_gemm_f32_cuda(c), wg.wide_gemm_f32_cuda(c)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and bool(torch.isfinite(a).all()), name
    check_close(a, wg.wide_gemm_f32_plain(c), "float32", name)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke

    parent = smoke.f32_gemm_sources()
    if parent is not None:
        assert torch.equal(a, wg.wide_gemm_f32_cuda(c, parent["wide_gemm_f32"]))


# The dW GEMMs of the wide routes alone (kernels/wide_gemm.py): (name, M,
# Nn, K, lda, splits). W = 288 (a partial 128-column block), 1024 and
# 2048, a view layer's 128 columns, the features' x rows (a partial row
# block, lda = KX above M = LX), splits that end off a 64-row stage
# (5000 rows in 3: 1,696 a split), empty splits (100 rows in 32).
WIDE_DW_CASES = [
    ("w288", 288, 288, 9000, None, None),
    ("w1024", 1024, 1024, 1 << 15, None, None),
    ("w2048", 2048, 2048, 8192, None, None),
    ("view_128", 1024, 128, 4160, None, None),
    ("x90", 90, 1024, 5000, 96, 3),
    ("split_off_stage", 512, 256, 5000, None, 3),
    ("empty_splits", 128, 256, 100, None, 32),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,M,Nn,K,lda,splits", WIDE_DW_CASES,
                         ids=[c[0] for c in WIDE_DW_CASES])
def test_wide_dw_matches_parent_and_plain_on_cuda(name, M, Nn, K, lda,
                                                  splits, dtype):
    """The dW GEMMs (``csrc/wide_dw.cuh``: ``wide_dw_kernel<BN>``,
    ``wide_dw_f32_kernel``, both with db, the splits added into the output
    in order) give the same bits over two launches; dW the bits of the
    kernels before (``chip_smoke.dw_sources``: that commit's headers beside
    ``csrc/wide_dw.cu``, whose split partials ``_reduce`` sums in order, as
    ``reduce_kernel`` did), and f32 db too; db the bits of
    ``wide_db_plain``; both in the dtype's band of ``wide_dw_plain`` /
    ``wide_dw_f32_plain``."""
    from nerf_or_nothing_tpu_torch.kernels import wide_gemm as wg

    dev = cuda_device()
    f32 = dtype == "float32"
    c = wg.dw_case(M, Nn, K, lda=lda, splits=splits, seed=K + M, device=dev,
                   dtype=getattr(torch, dtype))
    run = wg.wide_dw_cuda
    a, b = tensors(run(c)), tensors(run(c))
    torch.cuda.synchronize()
    assert len(a) == 2 and all(torch.equal(x, y) for x, y in zip(a, b)), name
    db = wg.wide_db_plain(c)
    assert torch.equal(a[1], db), name
    ref = wg.wide_dw_f32_plain(c) if f32 else (wg.wide_dw_plain(c), db)
    check_close(a, ref, dtype, name)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke

    parent = smoke.dw_sources()
    if parent is not None:
        old = tensors(run(c, parent["wide_dw"]))
        assert len(old) == (2 if f32 else 1), name
        assert all(torch.equal(x, y) for x, y in zip(a, old)), name


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wide_dw_split_order_in_graphs_on_cuda(dtype):
    """The ordered add of the splits across launches and CUDA graph
    replays: a graph of two products' launches (W = 288, whose 3 x 3 tiles
    a split are fewer than the blocks, so splits of one tile run at once;
    and W = 1024 / 128, a view layer's) on shared split counters, replayed
    three times, gives the eager launches' bits each time, and those are
    the parent's summed partials (dW) and ``wide_db_plain`` (db)."""
    from nerf_or_nothing_tpu_torch.kernels import wide_gemm as wg

    dev = cuda_device()
    dt = getattr(torch, dtype)
    cases = [wg.dw_case(288, 288, 1 << 15, seed=1, device=dev, dtype=dt),
             wg.dw_case(1024, 128, 20000, seed=2, device=dev, dtype=dt)]
    flags = torch.zeros(max(wg.dw_flag_count(c["M"], c["Nn"]) for c in cases),
                        dtype=torch.int32, device=dev)
    eager = [wg.wide_dw_reduced(c, flags) for c in cases]
    torch.cuda.synchronize()
    for c, e in zip(cases, eager):
        n = c["M"] * c["Nn"]
        assert torch.equal(e[n:], wg.wide_db_plain(c))
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        wg.wide_dw_reduced(cases[0], flags)  # warm-up off the capture
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            outs = [wg.wide_dw_reduced(c, flags) for c in cases]
    torch.cuda.current_stream(dev).wait_stream(stream)
    for _ in range(3):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke

    parent = smoke.dw_sources()
    if parent is not None:
        for c, e in zip(cases, eager):
            n = c["M"] * c["Nn"]
            old = wg.wide_dw_cuda(c, parent["wide_dw"])
            assert torch.equal(e[:n].view(c["M"], c["Nn"]), old[0])
