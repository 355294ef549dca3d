"""Integrated positional encoding and cone/cylinder -> Gaussian ops.

Same math and feature layout as ``nerf_or_nothing_tpu/ops/ipe.py``:
``integrated_pos_enc`` emits, for each frequency, [sin (3), cos (3)]
interleaved, [..., S, 2*(max_deg-min_deg)*3]. ``cast_rays`` maps S+1
t-values to S Gaussians.
"""

from __future__ import annotations

import functools

import torch

from nerf_or_nothing_tpu_torch.config import RayShape
from nerf_or_nothing_tpu_torch.ops.fastmath import (
    fast_cos,
    fast_exp_neg,
    fast_sin,
)


def lift_gaussian(directions, t_mean, t_var, r_var, diag: bool = True):
    """Lift a 1D ray Gaussian to 3D world space.

    Args:
      directions: [..., 3] (unnormalized); t_mean/t_var/r_var: [..., S].
    Returns:
      mean [..., S, 3] and cov diagonal [..., S, 3] (or full [..., S, 3, 3]).
    """
    mean = directions[..., None, :] * t_mean[..., None]
    d_sq = torch.clamp(
        torch.sum(directions**2, dim=-1, keepdim=True), min=1e-10
    )
    if diag:
        d_outer_diag = directions**2
        null_outer_diag = 1.0 - d_outer_diag / d_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag

    d_outer = directions[..., :, None] * directions[..., None, :]
    eye = torch.eye(3, dtype=directions.dtype, device=directions.device)
    null_outer = eye - d_outer / d_sq[..., None]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(directions, t0, t1, base_radius,
                                diag: bool = True):
    """Stable mean/cov of a conical frustum section (mip-NeRF eq. 7)."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    mu2 = mu * mu
    hw2 = hw * hw
    denom = 3.0 * mu2 + hw2
    t_mean = mu + (2.0 * mu * hw2) / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * (hw2 * hw2 * (12.0 * mu2 - hw2)) / (
        denom * denom
    )
    r_var = base_radius**2 * (
        mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * (hw2 * hw2) / denom
    )
    return lift_gaussian(directions, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(directions, t0, t1, radius, diag: bool = True):
    """Mean/cov of a cylindrical ray section."""
    t_mean = (t0 + t1) / 2.0
    r_var = radius**2 / 4.0
    t_var = (t1 - t0) ** 2 / 12.0
    return lift_gaussian(directions, t_mean, t_var, r_var, diag)


def cast_rays(t_vals, origins, directions, radii,
              ray_shape: RayShape = RayShape.CONE, diag: bool = True):
    """t-interval boundaries [..., S+1] -> world-space sample Gaussians
    [..., S]."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == RayShape.CONE:
        mean, cov = conical_frustum_to_gaussian(directions, t0, t1, radii, diag)
    elif ray_shape == RayShape.CYLINDER:
        mean, cov = cylinder_to_gaussian(directions, t0, t1, radii, diag)
    else:
        raise ValueError(f"invalid ray shape {ray_shape}")
    mean = mean + origins[..., None, :]
    return mean, cov


@functools.lru_cache(maxsize=32)
def _scales_on(min_deg: int, max_deg: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                        dtype=dtype, device=device)


def _scales(min_deg: int, max_deg: int, like: torch.Tensor):
    """The frequencies 2^min_deg .. 2^(max_deg-1), made once per device: a
    host-to-device copy cannot be captured in a CUDA graph, so the train
    step's capture reads the tensor its warm-up made."""
    return _scales_on(min_deg, max_deg, like.dtype, like.device)


def integrated_pos_enc(means_covs, min_deg: int, max_deg: int,
                       diag: bool = True, dtype=None, fast: bool = False):
    """IPE of Gaussian samples, interleaved [sin3, cos3] per frequency.

    ``fast`` uses the polynomial transcendentals of ``ops/fastmath.py``.
    ``dtype`` rounds the features (bf16 for the kernel path).
    """
    mean, cov = means_covs
    if not diag:
        cov = torch.diagonal(cov, dim1=-2, dim2=-1)
    out_dt = dtype or mean.dtype
    scales = _scales(min_deg, max_deg, mean)
    y = mean[..., None, :] * scales[:, None]           # [..., F, 3]
    y_var = cov[..., None, :] * (scales[:, None] ** 2)
    if fast:
        damp = fast_exp_neg(0.5 * y_var)
        sin_y, cos_y = fast_sin(y), fast_cos(y)
    else:
        damp = torch.exp(-0.5 * y_var)
        sin_y, cos_y = torch.sin(y), torch.cos(y)
    feats = torch.cat([damp * sin_y, damp * cos_y], dim=-1).to(out_dt)
    return feats.reshape(*feats.shape[:-2], -1)


def pos_enc(x, min_deg: int, max_deg: int):
    """Classic positional encoding with identity:
    [x, sin(2^min x), cos(2^min x), ..., sin, cos], [..., 3 + 6F]."""
    scales = _scales(min_deg, max_deg, x)
    xb = x[..., None, :] * scales[:, None]
    feats = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    feats = feats.reshape(*x.shape[:-1], -1)
    return torch.cat([x, feats], dim=-1)
