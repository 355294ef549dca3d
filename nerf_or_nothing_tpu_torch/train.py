"""Training: Adam, gradient clipping, the LR schedule and the train step.

Same contract as ``nerf_or_nothing_tpu/train.py`` on one device:

- ``adam_update``: m/v moving averages and the bias-corrected step with
  eps inside the square root, ``p -= lr * (m c1) / sqrt(v c2 + eps)``;
- ``clip_grads``: value clipping, then norm clipping over all tensors;
- ``make_train_step``: with ``use_fused_level`` (the default config) each
  level is one ``fused_level_train`` call (the train kernel on the card,
  its plain version on the CPU) and the per-level dW/db are summed;
  otherwise ``torch.autograd`` over ``render_rays`` + ``multiscale_loss``,
  whose levels (with ``use_pallas``) run the ``mlp_fwd`` kernel and, in
  the backward, ``mlp_bwd``, with the weights packed once per step;
- ``make_multi_step``: the same step K times, returning the last step's
  stats, as the JAX package's ``lax.scan`` multi-step does.

The parameters and the Adam moments are updated in place, through
``torch._foreach_*`` ops, which bump each tensor's version counter: a
cache keyed on the tensors' identity and ``_version`` (``eval.
make_render_fn``'s packed weights) sees every update. Random draws come
from the state's ``torch.Generator``, reseeded at every step from
(``cfg.seed``, step), so a resumed run draws what an uninterrupted one
draws.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.metrics import Stats
from nerf_or_nothing_tpu_torch.models import mipnerf
from nerf_or_nothing_tpu_torch.models import mlp as mlp_lib
from nerf_or_nothing_tpu_torch.ops.math_utils import (
    learning_rate_decay,
    mse_to_psnr,
)
from nerf_or_nothing_tpu_torch.rays import Rays


@dataclasses.dataclass
class TrainState:
    """step + params + Adam moments + the generator of the step's draws."""

    step: int
    params: mlp_lib.Params
    mu: mlp_lib.Params      # first moment (m)
    nu: mlp_lib.Params      # second moment (v)
    generator: torch.Generator


def step_seed(seed: int, step: int) -> int:
    """Seed of the generator at ``step``; a checkpoint stores (seed, step)."""
    return ((seed & 0xFFFFFFFF) << 31 | (step & 0x7FFFFFFF)) & (2**63 - 1)


def init_train_state(cfg: Config, device="cpu") -> TrainState:
    """Seeded Glorot weights (the same draw as ``run.load_params``), zero
    moments, and a generator on ``device``."""
    device = torch.device(device)
    params = mlp_lib.init_mlp(torch.Generator().manual_seed(cfg.seed), cfg,
                              device=device)
    zeros = lambda: [(torch.zeros_like(w), torch.zeros_like(b))  # noqa: E731
                     for w, b in params]
    gen = torch.Generator(device=device).manual_seed(step_seed(cfg.seed, 0))
    return TrainState(0, params, zeros(), zeros(), gen)


def _leaves(tree) -> List[torch.Tensor]:
    return [t for wb in tree for t in wb]


def adam_update(params, grads, mu, nu, lr: float, step: int, cfg: Config):
    """Adam in place: m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2;
    p -= lr * (m c1) * rsqrt(v c2 + eps), c = 1 / (1 - beta^t), the bias
    corrections and ``lr`` in f32 as the JAX package computes them."""
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    t = np.float32(step)
    c1 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t))
    c2 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t))
    p, g, m, v = _leaves(params), _leaves(grads), _leaves(mu), _leaves(nu)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1.0 - b2),
                                              g))
    denom = torch._foreach_mul(v, c2)
    torch._foreach_add_(denom, eps)
    torch._foreach_rsqrt_(denom)
    upd = torch._foreach_mul(m, c1)
    torch._foreach_mul_(upd, float(lr))
    torch._foreach_mul_(upd, denom)
    torch._foreach_sub_(p, upd)


def clip_grads(grads, cfg: Config):
    """Value clipping (``grad_max_val``), then norm clipping
    (``grad_max_norm``) over all tensors. Returns (grads, grad_norm,
    clipped_norm, grad_abs_max), the max taken after clipping."""
    if cfg.grad_max_val > 0:
        grads = [(torch.clamp(w, -cfg.grad_max_val, cfg.grad_max_val),
                  torch.clamp(b, -cfg.grad_max_val, cfg.grad_max_val))
                 for w, b in grads]
    flat = torch.cat([t.reshape(-1) for t in _leaves(grads)])
    grad_norm = torch.sqrt(torch.sum(flat * flat))
    grad_abs_max = torch.max(torch.abs(flat))
    if cfg.grad_max_norm > 0:
        mult = torch.clamp(cfg.grad_max_norm / (1e-10 + grad_norm), max=1.0)
        grads = [(w * mult, b * mult) for w, b in grads]
        grad_abs_max = grad_abs_max * mult
    clipped_norm = (torch.clamp(grad_norm, max=cfg.grad_max_norm)
                    if cfg.grad_max_norm > 0 else grad_norm)
    return grads, grad_norm, clipped_norm, grad_abs_max


def use_fused_level(cfg: Config) -> bool:
    """Whether the whole-level train kernel applies to this config."""
    return (
        cfg.use_pallas
        and cfg.fuse_level
        and cfg.stop_level_grad
        and (not cfg.fuse_ipe or cfg.diag_covariance)
        and cfg.num_rgb_channels == 3
        and cfg.num_density_channels == 1
    )


def _weight_l2(params) -> torch.Tensor:
    return sum(torch.sum(w ** 2) for w, _ in params)


@torch.no_grad()
def _fused_level_value_and_grad(cfg: Config, params, generator, rays: Rays,
                                pixels):
    """Loss and gradients from one ``fused_level_train`` call per level.

    Valid with ``stop_level_grad``: each level's loss gradient is then
    independent, so the total gradient is the sum of the levels' dW/db,
    each level's loss weight folded into its per-ray g_scale. The weights
    are packed once for both levels, in the layouts of the kernel the
    step launches (``pack_train``).

    Returns (loss, (level_losses, fine_rgb, weight_l2), grads).
    """
    from nerf_or_nothing_tpu_torch.kernels.fused_level import (
        fused_level_train,
        pack_train,
    )

    dt = mlp_lib.compute_dtype(cfg)
    packed = None
    if rays.origins.is_cuda:
        packed = pack_train(params, cfg, dt)
    dir_enc = mipnerf.encode_dirs(cfg, rays)
    mask, denom = mipnerf.loss_normalizer(cfg, rays.loss_mult)
    grads = None
    losses = []
    comp = t_vals = weights = None
    for i_level in range(cfg.num_levels):
        t_vals, (means, covs) = mipnerf.sample_level(
            cfg, rays, i_level, t_vals, weights, cfg.randomized,
            stop_grad=True, generator=generator,
        )
        x_enc, means_covs = mipnerf.encode_samples(
            cfg, means, covs, in_kernel=True, dtype=dt
        )
        g_scale = (
            mipnerf.level_weight(cfg, i_level) * 2.0 * mask / denom
        )[..., None]
        comp, _, weights, d_params = fused_level_train(
            params, cfg, x_enc, dir_enc, t_vals, rays.directions, pixels,
            g_scale, cfg.white_bkgd, means_covs=means_covs, packed=packed,
        )
        losses.append(
            torch.sum(mask * torch.sum((comp - pixels) ** 2, dim=-1)) / denom
        )
        if grads is None:
            grads = d_params
        else:
            torch._foreach_add_(_leaves(grads), _leaves(d_params))
    losses = torch.stack(losses)
    total = mipnerf.total_from_level_losses(cfg, losses)
    if cfg.weight_decay_mult > 0:
        wl2 = _weight_l2(params)
        total = total + cfg.weight_decay_mult * wl2
        grads = [(gw + 2.0 * cfg.weight_decay_mult * w, gb)
                 for (gw, gb), (w, _) in zip(grads, params)]
    else:
        wl2 = torch.zeros((), device=pixels.device)
    return total, (losses, comp, wl2), grads


def _autograd_value_and_grad(cfg: Config, params, generator, rays: Rays,
                             pixels, mlp_apply=None):
    """Loss and gradients by ``torch.autograd`` over ``render_rays`` +
    ``multiscale_loss`` (the JAX package's ``jax.value_and_grad`` branch).
    ``render_rays`` packs the kernels' weights once for both levels and
    both directions."""
    leaves = [t.detach().requires_grad_() for t in _leaves(params)]
    p = list(zip(leaves[0::2], leaves[1::2]))
    with torch.enable_grad():
        results = mipnerf.render_rays(
            p, cfg, rays, randomized=cfg.randomized,
            white_bkgd=cfg.white_bkgd, mlp_apply=mlp_apply,
            generator=generator,
        )
        total, level_losses = mipnerf.multiscale_loss(
            results, pixels, rays.loss_mult, cfg
        )
        if cfg.weight_decay_mult > 0:
            wl2 = _weight_l2(p)
            total = total + cfg.weight_decay_mult * wl2
        else:
            wl2 = torch.zeros((), device=pixels.device)
        flat = torch.autograd.grad(total, leaves)
    grads = list(zip(flat[0::2], flat[1::2]))
    return (total.detach(), (level_losses.detach(),
                             results[-1].rgb.detach(), wl2.detach()), grads)


def make_train_step(cfg: Config, mlp_apply=None):
    """fn(state, rays, pixels) -> (state, Stats), updating ``state`` in
    place. ``rays`` and ``pixels`` are tensors on the state's device."""

    def train_step(state: TrainState, rays: Rays, pixels: torch.Tensor):
        step = state.step + 1
        state.generator.manual_seed(step_seed(cfg.seed, step))
        lr = learning_rate_decay(
            step, cfg.lr_init, cfg.lr_final, cfg.max_steps,
            cfg.lr_delay_steps, cfg.lr_delay_mult,
        )
        if use_fused_level(cfg) and mlp_apply is None:
            loss, (level_losses, fine_rgb, wl2), grads = (
                _fused_level_value_and_grad(
                    cfg, state.params, state.generator, rays, pixels
                )
            )
        else:
            loss, (level_losses, fine_rgb, wl2), grads = (
                _autograd_value_and_grad(
                    cfg, state.params, state.generator, rays, pixels,
                    mlp_apply=mlp_apply,
                )
            )
        with torch.no_grad():
            grads, grad_norm, clipped_norm, grad_abs_max = clip_grads(
                grads, cfg)
            adam_update(state.params, grads, state.mu, state.nu, float(lr),
                        step, cfg)
            psnr = mse_to_psnr(torch.mean((fine_rgb - pixels) ** 2))
        state.step = step
        stats = Stats(
            loss=loss,
            losses=level_losses,
            weight_l2=wl2,
            psnr=psnr,
            psnrs=mse_to_psnr(level_losses),
            grad_norm=grad_norm,
            grad_abs_max=grad_abs_max,
            grad_norm_clipped=clipped_norm,
            learning_rate=lr,
        )
        return state, stats

    return train_step


def make_multi_step(cfg: Config, mlp_apply=None):
    """fn(state, batches) -> (state, Stats of the last step): the train
    step over a list of (rays, pixels) batches, in order."""
    step_fn = make_train_step(cfg, mlp_apply=mlp_apply)

    def multi_step(state: TrainState,
                   batches: List[Tuple[Rays, torch.Tensor]]):
        stats = None
        for rays, pixels in batches:
            state, stats = step_fn(state, rays, pixels)
        return state, stats

    return multi_step
