"""The port's ops against the JAX package's, on the same numpy inputs.

Tolerance: f32 at rtol 1e-5 / atol 1e-6 unless stated beside a check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu import rays as jrays  # noqa: E402
from nerf_or_nothing_tpu.config import RayShape as JRayShape  # noqa: E402
from nerf_or_nothing_tpu.ops import fastmath as jfm  # noqa: E402
from nerf_or_nothing_tpu.ops import ipe as jipe  # noqa: E402
from nerf_or_nothing_tpu.ops import math_utils as jmu  # noqa: E402
from nerf_or_nothing_tpu.ops import perceptual as jperc  # noqa: E402
from nerf_or_nothing_tpu.ops import render as jrender  # noqa: E402
from nerf_or_nothing_tpu.ops import sampling as jsamp  # noqa: E402
from nerf_or_nothing_tpu_torch import rays as trays  # noqa: E402
from nerf_or_nothing_tpu_torch.config import RayShape  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import fastmath as tfm  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import ipe as tipe  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import math_utils as tmu  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import perceptual as tperc  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import render as trender  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import sampling as tsamp  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def ray_batch(R, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    radii = rng.uniform(1e-3, 1e-2, size=(R, 1)).astype(np.float32)
    near = np.full((R, 1), 2.0, np.float32)
    far = np.full((R, 1), 6.0, np.float32)
    return o, d, radii, near, far


# ---- rays ------------------------------------------------------------------


@pytest.mark.parametrize("w,h", [(7, 5), (2, 3), (16, 16)])
def test_generate_rays_byte_equal(w, h):
    rng = np.random.default_rng(w * h)
    c2w = rng.normal(size=(4, 4)).astype(np.float32)
    p2c = trays.pinhole_pix_to_cam(12.5, w, h)
    np.testing.assert_array_equal(p2c, jrays.pinhole_pix_to_cam(12.5, w, h))
    t = trays.generate_rays(p2c, c2w, w, h, 2.0, 6.0)
    j = jrays.generate_rays(p2c, c2w, w, h, 2.0, 6.0)
    for name, a, b in zip(trays.Rays._fields, t, j):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_ndc_conversion_matches():
    rng = np.random.default_rng(3)
    o = rng.normal(size=(4, 5, 3)).astype(np.float32)
    o[..., 2] -= 3.0
    d = rng.normal(size=(4, 5, 3)).astype(np.float32)
    d[..., 2] = -np.abs(d[..., 2]) - 0.5
    to, td = trays.convert_to_ndc(o, d, 20.0, 5, 4)
    jo, jd = jrays.convert_to_ndc(o, d, 20.0, 5, 4)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(trays.ndc_radii(to), jrays.ndc_radii(jo))


# ---- fastmath --------------------------------------------------------------


@pytest.mark.parametrize("name", ["fast_sin", "fast_cos", "fast_sincos"])
@pytest.mark.parametrize("lim", [10.0, 2e5])
def test_fast_trig_matches_jax(name, lim):
    # |x| <= 2e5 keeps the reduction quotient below 2^16 (ADVICE.md:4).
    x = np.random.default_rng(1).uniform(-lim, lim, 50000).astype(np.float32)
    t = getattr(tfm, name)(T(x))
    j = getattr(jfm, name)(jnp.asarray(x))
    if name == "fast_sincos":
        close(t[0], j[0])
        close(t[1], j[1])
    else:
        close(t, j)


def test_fast_exp_neg_matches_jax():
    x = np.concatenate([
        np.random.default_rng(2).uniform(0, 100, 50000),
        [0.0, 87.0, 88.0, 125.0 / 1.4426950408889634, 1e4],
    ]).astype(np.float32)
    close(tfm.fast_exp_neg(T(x)), jfm.fast_exp_neg(jnp.asarray(x)),
          rtol=RTOL, atol=0.0)


# ---- IPE -------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["cone", "cylinder"])
@pytest.mark.parametrize("diag", [True, False])
def test_cast_rays_matches(shape, diag):
    o, d, radii, _, _ = ray_batch(6)
    t = np.sort(np.random.default_rng(4).uniform(2, 6, (6, 9)), -1).astype(
        np.float32)
    tm, tc = tipe.cast_rays(T(t), T(o), T(d), T(radii), RayShape(shape), diag)
    jm, jc = jipe.cast_rays(jnp.asarray(t), jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(radii), JRayShape(shape), diag)
    close(tm, jm)
    close(tc, jc)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("diag", [True, False])
def test_integrated_pos_enc_matches(fast, diag):
    o, d, radii, _, _ = ray_batch(4, seed=5)
    t = np.sort(np.random.default_rng(5).uniform(2, 6, (4, 9)), -1).astype(
        np.float32)
    mc_t = tipe.cast_rays(T(t), T(o), T(d), T(radii), diag=diag)
    mc_j = jipe.cast_rays(jnp.asarray(t), jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(radii), diag=diag)
    feat_t = tipe.integrated_pos_enc(mc_t, 0, 16, diag=diag, fast=fast)
    feat_j = jipe.integrated_pos_enc(mc_j, 0, 16, diag=diag, fast=fast)
    assert tuple(feat_t.shape) == (4, 8, 96)
    close(feat_t, feat_j)
    bf_t = tipe.integrated_pos_enc(mc_t, 0, 16, diag=diag, fast=fast,
                                   dtype=torch.bfloat16)
    bf_j = jipe.integrated_pos_enc(mc_j, 0, 16, diag=diag, fast=fast,
                                   dtype=jnp.bfloat16)
    # bf16 outputs: one bf16 quantum (2^-8 relative) where the f32 values
    # straddle a rounding boundary.
    close(bf_t.float(), np.asarray(bf_j, np.float32), rtol=2 ** -8, atol=1e-6)


def test_pos_enc_matches():
    x = np.random.default_rng(6).normal(size=(5, 3)).astype(np.float32)
    close(tipe.pos_enc(T(x), 0, 4), jipe.pos_enc(jnp.asarray(x), 0, 4))


# ---- sampling --------------------------------------------------------------


@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("lin_disp", [False, True])
def test_sample_along_rays_matches(randomized, lin_disp):
    o, d, radii, near, far = ray_batch(6, seed=7)
    key = jax.random.PRNGKey(3)
    j_t, (j_m, j_c) = jsamp.sample_along_rays(
        key, *map(jnp.asarray, (o, d, radii)), 16, jnp.asarray(near),
        jnp.asarray(far), randomized, lin_disp, JRayShape.CONE)
    u = np.asarray(jax.random.uniform(key, (6, 17)))  # JAX's own draw
    t_t, (t_m, t_c) = tsamp.sample_along_rays(
        T(o), T(d), T(radii), 16, T(near), T(far), randomized, lin_disp,
        RayShape.CONE, u=T(u))
    close(t_t, j_t)
    close(t_m, j_m)
    close(t_c, j_c)


def _pdf_inputs(R=6, S=16, seed=8):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2, 6, (R, S + 1)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (R, S)).astype(np.float32)
    w[0, 3:9] = 0.0      # flat CDF stretch: tied entries
    w[1, :] = 0.0        # all-zero weights: padding path
    w[2, ::2] = 0.0      # alternating ties
    return bins, w


@pytest.mark.parametrize("randomized", [False, True])
def test_sorted_piecewise_constant_pdf_matches_with_ties(randomized):
    bins, w = _pdf_inputs()
    key = jax.random.PRNGKey(9)
    j = jsamp.sorted_piecewise_constant_pdf(
        key, jnp.asarray(bins), jnp.asarray(w), 33, randomized)
    u = np.asarray(jax.random.uniform(key, (6, 33)))
    t = tsamp.sorted_piecewise_constant_pdf(T(bins), T(w), 33, randomized,
                                            u=T(u))
    close(t, j)


def test_pdf_inversion_at_tied_cdf_values():
    """u equal to a tied CDF value picks the end of the flat stretch, as
    the masked max/min reduction does."""
    bins = np.array([[0.0, 1.0, 2.0, 3.0, 4.0]], np.float32)
    w = np.array([[0.5, 0.0, 0.0, 0.5]], np.float32)
    t = tsamp.sorted_piecewise_constant_pdf(T(bins), T(w), 5, False)
    j = jsamp.sorted_piecewise_constant_pdf(
        jax.random.PRNGKey(0), jnp.asarray(bins), jnp.asarray(w), 5, False)
    close(t, j)


@pytest.mark.parametrize("randomized", [False, True])
def test_resample_along_rays_matches(randomized):
    o, d, radii, _, _ = ray_batch(6, seed=10)
    bins, w = _pdf_inputs(seed=11)
    key = jax.random.PRNGKey(12)
    j_t, (j_m, j_c) = jsamp.resample_along_rays(
        key, *map(jnp.asarray, (o, d, radii, bins, w)), randomized,
        JRayShape.CONE, 0.01)
    u = np.asarray(jax.random.uniform(key, (6, 17)))
    t_t, (t_m, t_c) = tsamp.resample_along_rays(
        T(o), T(d), T(radii), T(bins), T(w), randomized, RayShape.CONE, 0.01,
        u=T(u))
    close(t_t, j_t)
    close(t_m, j_m)
    close(t_c, j_c)


# ---- compositing -----------------------------------------------------------


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_volumetric_rendering_matches(white_bkgd):
    rng = np.random.default_rng(13)
    R, S = 6, 16
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    dens = rng.uniform(0, 3, size=(R, S)).astype(np.float32)
    dens[0] = 0.0  # empty-space ray: acc 0, distance clamps to t_0
    t = np.sort(rng.uniform(2, 6, (R, S + 1)), -1).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    tr = trender.volumetric_rendering(T(rgb), T(dens), T(t), T(d), white_bkgd)
    jr = jrender.volumetric_rendering(*map(jnp.asarray, (rgb, dens, t, d)),
                                      white_bkgd)
    for a, b in zip(tr, jr):
        close(a, b)


# ---- metrics ---------------------------------------------------------------


def test_metric_math_matches():
    rng = np.random.default_rng(14)
    a = rng.uniform(size=(13, 17, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(
        np.float32)
    close(tmu.compute_ssim(T(a), T(b)), jmu.compute_ssim(a, b))
    close(tmu.compute_ssim(T(a), T(b), return_map=True),
          jmu.compute_ssim(a, b, return_map=True))
    close(tmu.mse_to_psnr(0.01), jmu.mse_to_psnr(0.01))
    close(tmu.psnr_to_mse(23.0), jmu.psnr_to_mse(23.0))
    close(tmu.compute_avg_error(23.0, 0.8, 0.3),
          jmu.compute_avg_error(23.0, 0.8, 0.3))
    x = np.linspace(-0.1, 1.1, 101).astype(np.float32)
    close(tmu.linear_to_srgb(T(x)), jmu.linear_to_srgb(x))
    close(tmu.srgb_to_linear(T(x)), jmu.srgb_to_linear(x))
    # f32 convolutions sum in another order: rtol 1e-5 of a sum of ~32^2
    # terms of O(1).
    close(tperc.perceptual_distance(T(a), T(b)),
          jperc.perceptual_distance(jnp.asarray(a), jnp.asarray(b)),
          rtol=1e-5, atol=1e-6)
    assert float(tperc.perceptual_distance(T(a), T(a))) == 0.0


def test_perceptual_filters_match():
    for ft, fj in zip(tperc._filters(), jperc._filters()):
        np.testing.assert_array_equal(ft, fj)


def test_glorot_uniform_range():
    g = torch.Generator().manual_seed(0)
    w = tmu.glorot_uniform(g, 96, 256, (96, 256))
    lim = np.sqrt(6.0 / (96 + 256))
    assert w.dtype == torch.float32 and tuple(w.shape) == (96, 256)
    assert float(w.abs().max()) <= lim
    assert abs(float(w.mean())) < 0.01 and float(w.std()) > 0.5 * lim
