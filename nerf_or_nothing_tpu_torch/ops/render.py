"""Volume rendering (alpha compositing) with its hand-derived backward.

Same semantics as ``nerf_or_nothing_tpu/ops/render.py``:
  alpha_i = 1 - exp(-sigma_i * (t_{i+1} - t_i) * ||d||)
  T_i = exp(-sum_{j<i} sigma_j delta_j),  w_i = alpha_i T_i
  rgb = sum_i w_i c_i (+ (1-acc) if white background)
  distance = clip(sum_i w_i mid_i / acc, t_0, t_S)
``composite`` is a ``torch.autograd.Function`` whose backward is
``_composite_bwd`` of the JAX package: the reverse recurrence telescoped
into a reversed cumulative sum, with the ``max(1 - alpha, 1e-10)`` guard;
``t_vals`` and ``dirs`` get no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderResult(NamedTuple):
    rgb: torch.Tensor        # [R, 3]
    distance: torch.Tensor   # [R]
    acc: torch.Tensor        # [R]
    weights: torch.Tensor    # [R, S]


def composite_weights(density, delta):
    """alpha / transmittance / weights from densities and interval lengths
    ``delta = (t_{i+1}-t_i)*||d||`` ([R, S] each)."""
    s = density * delta
    alpha = 1.0 - torch.exp(-s)
    trans = torch.exp(-torch.cumsum(s[..., :-1], dim=-1))
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans], dim=-1)
    return alpha, trans, alpha * trans


def interval_lengths(t_vals, dirs):
    """delta = (t_{i+1} - t_i) * ||d||, [R, S]."""
    d_norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return (t_vals[..., 1:] - t_vals[..., :-1]) * d_norm


def ray_distance(weights, acc, t_vals):
    """Expected termination distance, clipped to the ray's [t_0, t_S]; the
    safe divide leaves empty-space rays (acc == 0) at t_0."""
    mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    dist = torch.sum(weights * mids, dim=-1) / torch.clamp(acc, min=1e-10)
    return torch.minimum(torch.maximum(dist, t_vals[..., 0]), t_vals[..., -1])


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rgb, density, t_vals, dirs, white_bkgd: bool):
        delta = interval_lengths(t_vals, dirs)
        alpha, trans, weights = composite_weights(density, delta)
        comp_rgb = torch.einsum("...s,...sc->...c", weights, rgb)
        acc = torch.sum(weights, dim=-1)
        if white_bkgd:
            comp_rgb = comp_rgb + (1.0 - acc[..., None])
        ctx.white_bkgd = white_bkgd
        ctx.save_for_backward(rgb, delta, alpha, trans, weights)
        return comp_rgb, acc, weights

    @staticmethod
    def backward(ctx, g_rgb, g_acc, g_weights):
        """dL/dw_i = g_rgb . c_i (- sum(g_rgb) on white) + g_acc + g_w_i;
        dL/dc_i = g_rgb w_i;
        dL/dalpha_i = dL/dw_i T_i - (sum_{j>i} dL/dw_j w_j) / (1 - alpha_i);
        dL/dsigma_i = dL/dalpha_i (1 - alpha_i) delta_i."""
        rgb, delta, alpha, trans, weights = ctx.saved_tensors
        dl_dc = g_rgb[..., None, :] * weights[..., None]
        dl_dw = torch.einsum("...c,...sc->...s", g_rgb, rgb)
        if ctx.white_bkgd:
            dl_dw = dl_dw - torch.sum(g_rgb, dim=-1, keepdim=True)
        dl_dw = dl_dw + g_acc[..., None] + g_weights
        wdw = dl_dw * weights
        suffix = torch.flip(torch.cumsum(torch.flip(wdw, [-1]), -1), [-1]) - wdw
        one_minus_alpha = torch.clamp(1.0 - alpha, min=1e-10)
        dl_dalpha = dl_dw * trans - suffix / one_minus_alpha
        dl_dsigma = dl_dalpha * (1.0 - alpha) * delta
        return dl_dc, dl_dsigma, None, None, None


def composite(rgb, density, t_vals, dirs, white_bkgd: bool):
    """(comp_rgb [R,3], acc [R], weights [R,S]) from activated colours
    [R,S,3] and densities [R,S], differentiable in ``rgb`` and
    ``density`` through the hand-derived backward."""
    return _Composite.apply(rgb, density, t_vals, dirs, white_bkgd)


def volumetric_rendering(rgb, density, t_vals, dirs,
                         white_bkgd: bool) -> RenderResult:
    """Composite samples along each ray.

    Args:
      rgb: [R, S, 3] activated colours; density: [R, S] activated sigma;
      t_vals: [R, S+1]; dirs: [R, 3] (unnormalized; its norm scales delta).
    """
    comp_rgb, acc, weights = composite(rgb, density, t_vals, dirs, white_bkgd)
    distance = ray_distance(weights, acc, t_vals).detach()
    return RenderResult(comp_rgb, distance, acc, weights)
