"""The MipNeRF model: hierarchical sample -> encode -> MLP -> composite.

Same branch structure as ``nerf_or_nothing_tpu/models/mipnerf.py``:
level 0 samples stratified, later levels resample from the previous
level's weights (blurpool + PDF, stop-gradient); IPE over frustum
Gaussians; view PE of the viewdir; rgb = sigmoid(raw)*(1+2p) - p;
density = softplus(raw + density_bias); compositing.

Which kernel runs each level (on the card; the CPU runs each kernel's
plain version):

- inference with ``use_pallas`` and ``fuse_level`` (3 rgb / 1 density
  heads): one ``fused_level_render`` call, the ``render_level`` kernel;
- otherwise with ``use_pallas`` (``fuse_level=False``, the training step's
  autograd branch, which ``stop_level_grad=False`` selects, other head
  widths): ``fused_mlp_apply``, the ``mlp_fwd`` kernel forward and the
  ``mlp_bwd`` kernel in its backward, then the autograd ``composite``;
- ``use_pallas=False``: the plain ``apply_mlp`` and the autograd
  ``composite``.

The training step's fused branch (``train.use_fused_level``) does not come
here: it runs the ``train_level`` kernel per level.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.models import mlp as mlp_lib
from nerf_or_nothing_tpu_torch.ops import ipe, render, sampling
from nerf_or_nothing_tpu_torch.ops.math_utils import softplus
from nerf_or_nothing_tpu_torch.rays import Rays

def encode_dirs(cfg: Config, rays: Rays) -> torch.Tensor:
    """View-direction PE of viewdirs (or the raw direction)."""
    dir_to_encode = rays.viewdirs if cfg.use_viewdirs else rays.directions
    return ipe.pos_enc(dir_to_encode, 0, cfg.deg_view)


def sample_level(cfg: Config, rays: Rays, i_level: int, t_vals, weights,
                 randomized: bool, stop_grad: bool,
                 u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """Level ``i_level``'s sample Gaussians: stratified at level 0,
    blurpool + PDF resampling from the previous level's weights after.
    Returns (t_vals, (means, covs))."""
    if i_level == 0:
        return sampling.sample_along_rays(
            rays.origins, rays.directions, rays.radii, cfg.num_samples,
            rays.near, rays.far, randomized, cfg.lin_disp, cfg.ray_shape,
            diag=cfg.diag_covariance, u=u, generator=generator,
        )
    return sampling.resample_along_rays(
        rays.origins, rays.directions, rays.radii, t_vals, weights,
        randomized, cfg.ray_shape, cfg.resample_padding, stop_grad=stop_grad,
        diag=cfg.diag_covariance, u=u, generator=generator,
    )


def encode_samples(cfg: Config, means, covs, in_kernel: bool, dtype=None,
                   render: bool = False):
    """IPE features for the MLP. Returns (x_enc, means_covs), exactly one
    not None: with ``fuse_ipe`` (or ``fuse_ipe_render`` on the render path)
    and a diagonal covariance the kernel encodes (means, covs) itself.
    ``xt_ipe`` and ``pair_ipe`` are the JAX package's transposed layouts of
    these same features for its TPU kernel; here they take the
    interleaved [R, S, F] encode and the kernels' mode "t"."""
    if (in_kernel and cfg.diag_covariance
            and (cfg.fuse_ipe or (render and cfg.fuse_ipe_render))):
        return None, (means, covs)
    x_enc = ipe.integrated_pos_enc(
        (means, covs), cfg.min_deg_point, cfg.max_deg_point,
        diag=cfg.diag_covariance, dtype=dtype, fast=cfg.fast_ipe,
    )
    return x_enc, None


def level_weight(cfg: Config, i_level: int) -> float:
    """Loss weight of one level: coarse_loss_mult below the fine level."""
    return 1.0 if i_level == cfg.num_levels - 1 else cfg.coarse_loss_mult


def loss_normalizer(cfg: Config, loss_mult: torch.Tensor):
    """Multiscale-loss mask [R] and normalizer max(sum(mask), 1e-10) on one
    device."""
    mask = loss_mult[..., 0]
    if cfg.disable_multiscale_loss:
        mask = torch.ones_like(mask)
    return mask, torch.clamp(torch.sum(mask), min=1e-10)


def total_from_level_losses(cfg: Config, losses: torch.Tensor):
    """Total loss from stacked per-level MSEs: coarse_loss_mult times the
    coarse levels' sum, plus the fine level."""
    return cfg.coarse_loss_mult * torch.sum(losses[:-1]) + losses[-1]


def multiscale_loss(results: List[render.RenderResult], pixels: torch.Tensor,
                    loss_mult: torch.Tensor, cfg: Config):
    """Masked multiscale MSE: per level sum(mask * |rgb - pixel|^2) /
    sum(mask). Returns (total_loss, per_level_mses [levels])."""
    mask, denom = loss_normalizer(cfg, loss_mult)
    losses = torch.stack([
        torch.sum(mask * torch.sum((res.rgb - pixels) ** 2, dim=-1)) / denom
        for res in results
    ])
    return total_from_level_losses(cfg, losses), losses


def uses_fused_render(cfg: Config, mlp_apply=None,
                      inference: bool = False) -> bool:
    """Whether ``render_rays`` runs each level as one
    ``fused_level_render`` call."""
    return (mlp_apply is None and inference and cfg.use_pallas
            and cfg.fuse_level and cfg.num_rgb_channels == 3
            and cfg.num_density_channels == 1
            and (not cfg.fuse_ipe or cfg.diag_covariance))


def render_rays(
    params: mlp_lib.Params,
    cfg: Config,
    rays: Rays,
    randomized: bool,
    white_bkgd: bool,
    mlp_apply=None,
    inference: bool = False,
    generator: Optional[torch.Generator] = None,
    packed=None,
) -> List[render.RenderResult]:
    """Full hierarchical forward; one RenderResult per level.

    Args:
      rays: Rays of tensors, leaves [R, C], all on one device.
      mlp_apply: optional override of the MLP forward, signature
        (params, cfg, x, dir_enc) -> (raw_rgb, raw_density).
      inference: render-only call; with ``use_pallas`` and ``fuse_level``
        each level is one ``fused_level_render`` call.
      generator: source of a randomized render's draws.
      packed: the kernels' weights (``fused_level.pack_forward`` or
        ``fused_mlp.pack_mlp_params``), when the caller keeps them across
        calls; else packed here for CUDA, once for all levels and, on the
        fused-MLP route, for both directions.
    """
    dt = mlp_lib.compute_dtype(cfg)
    device = rays.origins.device
    fused_render = None
    fused_mlp = False
    if uses_fused_render(cfg, mlp_apply, inference):
        from nerf_or_nothing_tpu_torch.kernels.fused_level import (
            fused_level_render,
            pack_forward,
        )

        fused_render = fused_level_render
        if packed is None and device.type == "cuda":
            packed = pack_forward(params, cfg, dt)  # once for all levels
    elif mlp_apply is None and cfg.use_pallas:
        from nerf_or_nothing_tpu_torch.kernels.fused_mlp import (
            fused_mlp_apply,
            pack_mlp_params,
        )

        mlp_apply, fused_mlp = fused_mlp_apply, True
        if packed is None and device.type == "cuda":
            packed = pack_mlp_params(params, cfg, dt,
                                     backward=torch.is_grad_enabled())
    elif mlp_apply is None:
        def mlp_apply(p, c, x, d):
            return mlp_lib.apply_mlp(p, c, x, d, compute_dtype=dt)

    dir_enc = encode_dirs(cfg, rays)

    results: List[render.RenderResult] = []
    t_vals = None
    weights = None
    for i_level in range(cfg.num_levels):
        t_vals, (means, covs) = sample_level(
            cfg, rays, i_level, t_vals, weights, randomized,
            stop_grad=cfg.stop_level_grad, generator=generator,
        )

        if fused_render is not None:
            x_enc, means_covs = encode_samples(
                cfg, means, covs, in_kernel=True, dtype=dt, render=True
            )
            comp_rgb, acc, weights = fused_render(
                params, cfg, x_enc, dir_enc, t_vals, rays.directions,
                white_bkgd, means_covs=means_covs, packed=packed,
            )
            distance = render.ray_distance(weights, acc, t_vals)
            results.append(
                render.RenderResult(comp_rgb, distance, acc, weights)
            )
            continue
        x_enc, _ = encode_samples(cfg, means, covs, in_kernel=False,
                                  dtype=dt if fused_mlp else None)
        if fused_mlp:
            # dX / dD reach a parameter only through a later level's
            # resampling: only level > 0 without stop_level_grad needs them.
            raw_rgb, raw_density = mlp_apply(
                params, cfg, x_enc, dir_enc,
                input_grads=i_level > 0 and not cfg.stop_level_grad,
                packed=packed,
            )
        else:
            raw_rgb, raw_density = mlp_apply(params, cfg, x_enc, dir_enc)

        rgb = torch.sigmoid(raw_rgb)
        rgb = rgb * (1.0 + 2.0 * cfg.rgb_padding) - cfg.rgb_padding
        density = softplus(raw_density[..., 0] + cfg.density_bias)
        results.append(render.volumetric_rendering(
            rgb, density, t_vals, rays.directions, white_bkgd
        ))
        weights = results[-1].weights
    return results
