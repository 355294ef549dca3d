"""The port's render level (render_level_plain through fused_level_render
on the CPU) against the JAX ``fused_level_render`` (Pallas, interpret
mode) and the kernel's flat weight layout; the kernel itself is held
against the plain version on a card in ``test_torch_kernel_cuda.py``.

Tolerances: f32 rtol 1e-4 / atol 1e-5; bf16 within the bf16 parity band
(2e-3, 3e-2) of ``utils/parity.py`` as a normalized error < 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_render as j_render,
)
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.ops.ipe import integrated_pos_enc  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402

SMALL = dict(num_samples=8, net_depth=3, net_width=32, net_width_condition=32,
             skip_layer=2, max_deg_point=4, use_pallas=True)


def level_inputs(R, S, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(R, S, 3)).astype(np.float32)
    covs = rng.uniform(0, 0.02, size=(R, S, 3)).astype(np.float32)
    dir_enc = (rng.normal(size=(R, 27)) * 0.5).astype(np.float32)
    t_vals = np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    return means, covs, dir_enc, t_vals, dirs


def compare(port, ref, dtype):
    for a, b in zip(port, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        else:
            atol, rtol = PARITY_BANDS["bfloat16"]
            assert normalized_err(a, b, atol, rtol) < 1.0


def run_both(kw, mode, white_bkgd, R=5, seed=0):
    jc, tc = jtiny(**kw), tiny_config(**kw)
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    means, covs, dir_enc, t_vals, dirs = level_inputs(R, tc.num_samples, seed)
    J = jnp.asarray
    if mode == "mv":
        ref = j_render(jp, jc, None, J(dir_enc), J(t_vals), J(dirs),
                       white_bkgd, tile=16, means_covs=(J(means), J(covs)))
        port = fl.fused_level_render(
            tp, tc, None, torch.from_numpy(dir_enc), torch.from_numpy(t_vals),
            torch.from_numpy(dirs), white_bkgd,
            means_covs=(torch.from_numpy(means), torch.from_numpy(covs)))
    else:
        dt = jnp.bfloat16 if tc.compute_dtype == "bfloat16" else jnp.float32
        x = np.array(integrated_pos_enc((J(means), J(covs)), 0,
                                         tc.max_deg_point, fast=True,
                                         dtype=dt).astype(jnp.float32))
        ref = j_render(jp, jc, J(x).astype(dt), J(dir_enc), J(t_vals),
                       J(dirs), white_bkgd, tile=16)
        port = fl.fused_level_render(
            tp, tc, torch.from_numpy(x), torch.from_numpy(dir_enc),
            torch.from_numpy(t_vals), torch.from_numpy(dirs), white_bkgd)
    assert port[0].shape == (R, 3) and port[2].shape == (R, tc.num_samples)
    return port, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("white_bkgd", [True, False])
@pytest.mark.parametrize("mode", ["mv", "t"])
def test_render_level_matches_jax(mode, white_bkgd, dtype):
    """5 rays x 8 samples against 16-row JAX tiles: a ragged last tile."""
    port, ref = run_both(dict(SMALL, compute_dtype=dtype), mode, white_bkgd)
    compare(port, ref, dtype)


@pytest.mark.parametrize("fast_ipe", [True, False])
def test_render_level_deeper_model_matches_jax(fast_ipe):
    """Two skip layers, a two-layer view branch, 7 rays, exact and
    polynomial IPE."""
    kw = dict(SMALL, net_depth=5, net_depth_condition=2,
              compute_dtype="float32", fast_ipe=fast_ipe)
    port, ref = run_both(kw, "mv", True, R=7, seed=3)
    compare(port, ref, "float32")


def unpack_like_kernel(w_flat: np.ndarray, cfg, fragments: bool):
    """Read the flat weights with the kernel's offsets and fragment
    indexing (csrc/render_level.cu: render_level_launch and gemm)."""
    W, Wc, D, Dc = (cfg.net_width, cfg.net_width_condition, cfg.net_depth,
                    cfg.net_depth_condition)
    KX = fl.padded_location_features(cfg)
    off = 0

    def mat(K, N):
        nonlocal off
        k = np.arange(K)[:, None]
        n = np.arange(N)[None, :]
        if fragments:
            r = k % 16
            idx = ((((n // 8) * (K // 16) + k // 16) * 32
                    + (n % 8) * 4 + (r % 8) // 2) * 4 + (r // 8) * 2 + r % 2)
        else:
            idx = k * N + n
        m = w_flat[off + idx]
        off += K * N
        return m

    def vec(n, shape):
        nonlocal off
        v = w_flat[off:off + n].reshape(shape)
        off += n
        return v

    layers = []
    for i in range(D):
        K = (0 if i == 0 else W) + (KX if i == 0 or i % cfg.skip_layer == 0
                                    else 0)
        layers.append(mat(K, W))
    layers.append(vec(W, (W, 1)))
    top = mat(W, Wc)
    layers.append(np.concatenate([top, vec(cfg.direction_features * Wc,
                                           (cfg.direction_features, Wc))]))
    for _ in range(1, Dc):
        layers.append(mat(Wc, Wc))
    layers.append(vec(3 * Wc, (3, Wc)).T)
    assert off == w_flat.size
    return layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_params_matches_kernel_layout(dtype):
    """location_features 24 pads to 32 feature columns; the x rows of the
    skip layer and layer 0 sit after the h rows, zero-padded."""
    cfg = tiny_config(net_depth=5, skip_layer=2, net_width=64,
                      net_width_condition=32, net_depth_condition=2,
                      max_deg_point=4)
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    w_flat, b_flat = fl.pack_params(params, cfg, dtype)
    assert (w_flat.numel(), b_flat.numel()) == fl.packed_sizes(cfg)
    got = unpack_like_kernel(w_flat.float().numpy(), cfg,
                             fragments=dtype == torch.bfloat16)
    lx, kx, W = cfg.location_features, fl.padded_location_features(cfg), 64
    assert (lx, kx) == (24, 32)
    for i, ((w, _), g) in enumerate(zip(params, got)):
        w = w.to(dtype).float().numpy()
        if i == 0:
            exp = np.concatenate([w, np.zeros((kx - lx, W), np.float32)])
        elif i < cfg.net_depth and i % cfg.skip_layer == 0:
            exp = np.concatenate([w[:W], w[W:],
                                  np.zeros((kx - lx, W), np.float32)])
        else:
            exp = w
        np.testing.assert_array_equal(g, exp, err_msg=f"layer {i}")
    np.testing.assert_array_equal(
        b_flat.numpy(), np.concatenate([b.numpy() for _, b in params]))


def test_kernel_wrapper_checks_inputs():
    cfg = tiny_config(**SMALL)
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    R, S = 3, cfg.num_samples
    xs = (torch.zeros(R * S, 3), torch.zeros(R * S, 3))
    d = torch.zeros(R, 27, dtype=torch.bfloat16)
    delta = torch.zeros(R, S)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.render_level_cuda(params, cfg, xs, d, delta, True, "mv")
    # every width is taken (the wide route has no ceiling); heads the
    # level kernels do not composite are refused
    fl.check_kernel_config(cfg.replace(net_width=1056))
    fl.check_kernel_config(cfg.replace(net_width_condition=288))
    with pytest.raises(ValueError, match="not supported"):
        fl.check_kernel_config(cfg.replace(net_width=1056,
                                           num_rgb_channels=4))
    fl.check_kernel_config(tiny_config())

