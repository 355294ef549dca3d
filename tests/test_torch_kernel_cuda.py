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

BANDS = {"float32": (1e-6, 1e-3), "bfloat16": (2e-3, 3e-2)}
SMALL = dict(num_samples=8, net_depth=3, net_width=32, net_width_condition=32,
             skip_layer=2, max_deg_point=4, use_pallas=True)


def normalized_err(a, b, atol, rtol):
    a, b = a.double().cpu(), b.double().cpu()
    band = atol + rtol * b.abs() + rtol * b.abs().max()
    return float(((a - b).abs() / band).max())


def level_inputs(R, S, seed, dev):
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    means = T(rng.normal(size=(R, S, 3)))
    covs = T(rng.uniform(0, 0.02, size=(R, S, 3)))
    dir_enc = T(rng.normal(size=(R, 27)) * 0.5)
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


def train_inputs(R, S, seed, dev):
    """One level's inputs plus pixels and a g_scale with zeros (masked
    rays) from numpy."""
    rng = np.random.default_rng(seed + 100)
    pixels = torch.from_numpy(rng.uniform(size=(R, 3)).astype(np.float32))
    mask = rng.uniform(0.5, 2.0, size=R).astype(np.float32)
    mask[::5] = 0.0
    g_scale = torch.from_numpy((0.1 * 2.0 * mask / mask.sum())[:, None])
    return (*level_inputs(R, S, seed, dev), pixels.to(dev), g_scale.to(dev))


def check_train(cfg, R, mode, white_bkgd, dev, seed=1):
    """``fused_level_train`` on the card (one launch of the kernel the
    config selects) against ``level_train_plain``."""
    S = cfg.num_samples
    kernel = (fl.train_level_twopass if mode == "t"
              and cfg.probe("fl_variant") == "twopass" else fl.train_level)
    params = tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, seed, dev)
    kw, x = {}, None
    if mode == "mv":
        kw = dict(means_covs=(means, covs))
    else:
        x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                               cfg.max_deg_point, fast=True)
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
    ref = fl.level_train_plain(params, cfg, xs, dir_enc.to(dt),
                               interval_lengths(t_vals, dirs), pixels, g_scale,
                               white_bkgd, mode)
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


def mlp_inputs(cfg, params, R, seed, dev):
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
        R, S, seed, dev)
    x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                           cfg.max_deg_point, fast=True)
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
@pytest.mark.parametrize("heads", [(3, 1), (8, 8)],
                         ids=lambda h: f"{h[0]}_{h[1]}")
def test_mlp_bwd_wg_matches_plain_on_cuda(heads, input_grads):
    """``mlp_bwd``'s bf16 route (the wgmma forward, chain with dX, dW) at
    Config() width, ragged R=77, heads 3/1 (their own instantiation) and
    8/8 (any width): every dW/db, dX and dD against ``mlp_bwd_plain``,
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
    """On CUDA tensors too, configs the bf16 passes cannot take raise
    ValueError before any launch: x rows wider than 256 columns for
    ``mlp_bwd``'s dX, more biases than the chain's shared memory holds for
    the two-pass kernel."""
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
    before = (fm.mlp_bwd.launches, fl.train_level_twopass.launches)
    with pytest.raises(ValueError, match="mlp_bwd kernel"):
        fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den, True)
    deep = Config(net_depth=100)
    delta = torch.ones(R, S, device=dev)
    pixels, g_scale = torch.zeros(R, 3, device=dev), torch.ones(R, 1, device=dev)
    xd = torch.zeros(R * S, deep.location_features, dtype=torch.bfloat16,
                     device=dev)
    with pytest.raises(ValueError, match="g-chain"):
        fl.train_level_twopass_cuda(params, deep, xd, d, delta, pixels,
                                    g_scale, True)
    assert (fm.mlp_bwd.launches, fl.train_level_twopass.launches) == before


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
