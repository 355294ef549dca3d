"""The render-level CUDA kernel against its plain PyTorch version, on a card.

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
