"""The render-level and train-level CUDA kernels against their plain
PyTorch versions, on a card.

The kernel has no CPU mode, so these tests skip on a host without CUDA.
The module imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; ``tests/conftest.py`` imports JAX, so on such a
machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py -q

Tolerances: the parity bands of ``nerf_or_nothing_tpu/utils/parity.py``
(f32 (1e-6, 1e-3), bf16 (2e-3, 3e-2)) as a normalized error < 1, kernel
and plain version in the same compute dtype.
"""

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
    """``make_render_fn`` packs the kernel's weights once for all chunks of
    a view, and again only after the weights change in place."""
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image
    from nerf_or_nothing_tpu_torch.rays import Rays

    dev = cuda_device()
    cfg = tiny_config(**dict(SMALL, num_levels=2, randomized=False))
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, device=dev)
    calls = []
    pack = fl.pack_params
    monkeypatch.setattr(fl, "pack_params",
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
    S = cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(seed), cfg, device=dev)
    means, covs, dir_enc, t_vals, dirs, pixels, g_scale = train_inputs(
        R, S, seed, dev)
    kw, x = {}, None
    if mode == "mv":
        kw = dict(means_covs=(means, covs))
    else:
        x = integrated_pos_enc((means, covs), cfg.min_deg_point,
                               cfg.max_deg_point, fast=True)
    before = fl.train_level.launches
    out = fl.fused_level_train(params, cfg, x, dir_enc, t_vals, dirs, pixels,
                               g_scale, white_bkgd, **kw)
    torch.cuda.synchronize()
    assert fl.train_level.launches == before + 1
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


def test_train_step_then_render_repacks_on_cuda(monkeypatch):
    """A train step on the card (two train-kernel launches) updates the
    weights in place; ``make_render_fn`` then packs them again."""
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
    pack = fl.pack_params
    monkeypatch.setattr(fl, "pack_params",
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
