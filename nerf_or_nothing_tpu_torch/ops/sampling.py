"""Stratified and hierarchical (PDF) ray sampling.

Same semantics as ``nerf_or_nothing_tpu/ops/sampling.py``. Functions that
draw take an optional ``u``: the raw uniform draw in [0, 1) that the JAX
version makes with ``jax.random.uniform`` (shape [R, S+1] for stratified
jitter, [R, num_samples] for the PDF draw, which scales it by
``1/num_samples - 1e-7`` as the JAX ``maxval`` does). Without ``u`` they
draw from ``generator``.

The CDF inversion uses ``torch.searchsorted(cdf, u, right=True)`` and a
gather: the index of the largest ``cdf[i] <= u``, which is what the TPU
version's masked max/min reduction over the bin axis selects (``cdf`` and
``bins`` are non-decreasing, so the masked max over the prefix is its last
element and the masked min over the rest is its first).

With ``stop_grad=False`` the resampled t-values are differentiable in the
previous level's weights and t-values, and the gradients match JAX's
(``tests/test_torch_fused_mlp.py``): the gather sends each gradient to the
one element that the masked reduction selects (the reductions would split
it between ties, which strictly increasing ``bins`` and ``cdf`` do not
have). ``torch.clamp`` passes the whole gradient where a value equals a
bound, ``jnp.clip`` half; the interpolation weight meets its lower bound
only where u equals a ``cdf`` entry (the first non-randomized sample,
u = cdf[0] = 0), and there its gradient is 0 either way.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_or_nothing_tpu_torch.config import RayShape
from nerf_or_nothing_tpu_torch.ops.ipe import cast_rays


def _uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    gen_device = generator.device if generator is not None else like.device
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=gen_device)
    return u.to(like.device)


def sample_along_rays(origins, directions, radii, num_samples: int, near,
                      far, randomized: bool, lin_disp: bool,
                      ray_shape: RayShape, diag: bool = True,
                      u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Stratified sampling along each ray.

    Args:
      origins/directions: [R, 3]; radii/near/far: [R, 1];
      u: optional [R, S+1] uniforms in [0, 1) for the jitter.
    Returns:
      t_vals [R, S+1], (means [R, S, 3], covs [R, S, 3]).
    """
    num_rays = origins.shape[0]
    dtype = origins.dtype
    t = torch.linspace(0.0, 1.0, num_samples + 1, dtype=dtype,
                       device=origins.device)
    if lin_disp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        t_vals = near * (1.0 - t) + far * t  # [R, S+1]

    if randomized:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        shifted = torch.cat([t_vals[..., :1], mids], dim=-1)
        upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
        if u is None:
            u = _uniform((num_rays, num_samples + 1), origins, generator)
        t_vals = shifted + (upper - shifted) * u
    means, covs = cast_rays(t_vals, origins, directions, radii, ray_shape,
                            diag)
    return t_vals, (means, covs)


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int,
                                  randomized: bool,
                                  u: Optional[torch.Tensor] = None,
                                  generator: Optional[torch.Generator] = None):
    """Stratified inverse-CDF sampling.

    Args:
      bins: [R, B+1] sorted t boundaries; weights: [R, B] >= 0;
      u: optional [R, num_samples] raw uniforms in [0, 1).
    Returns:
      [R, num_samples] sorted samples.
    """
    dtype = bins.dtype
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat(
        [torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])],
        dim=-1,
    )  # [R, B+1]

    shape = (*cdf.shape[:-1], num_samples)
    if randomized:
        s = 1.0 / num_samples
        if u is None:
            u = _uniform(shape, cdf, generator)
        # jax.random.uniform(maxval=m) is the [0, 1) draw times m.
        u = u.to(dtype) * torch.tensor(s - 1e-7, dtype=dtype)
        u = torch.arange(num_samples, dtype=dtype, device=cdf.device) * s + u
        u = torch.clamp(u, max=1.0 - 1e-7)
    else:
        u = torch.linspace(0.0, 1.0 - 1e-7, num_samples, dtype=dtype,
                           device=cdf.device)
        u = u.expand(shape)
    u = u.contiguous()

    # Largest i with cdf[i] <= u, and the next entry.
    hi = torch.searchsorted(cdf.contiguous(), u, right=True)
    hi = hi.clamp(max=cdf.shape[-1] - 1)
    lo = (hi - 1).clamp(min=0)
    bins_g0 = torch.gather(bins, -1, lo)
    bins_g1 = torch.gather(bins, -1, hi)
    cdf_g0 = torch.gather(cdf, -1, lo)
    cdf_g1 = torch.gather(cdf, -1, hi)

    denom = cdf_g1 - cdf_g0
    t = torch.where(denom > 0, (u - cdf_g0) / denom, torch.zeros_like(u))
    t = torch.clamp(t, 0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(origins, directions, radii, t_vals, weights,
                        randomized: bool, ray_shape: RayShape,
                        resample_padding: float, stop_grad: bool = True,
                        diag: bool = True, u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Hierarchical resampling from coarse weights: blurpool (pad, 2-tap
    max, 2-tap average + padding), then an inverse-CDF draw of S+1 new t
    boundaries.

    Args:
      t_vals: [R, S+1]; weights: [R, S]; u: optional [R, S+1] uniforms.
    """
    w_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    w_max = torch.maximum(w_pad[..., :-1], w_pad[..., 1:])
    w_blur = 0.5 * (w_max[..., :-1] + w_max[..., 1:]) + resample_padding

    if stop_grad:
        w_blur = w_blur.detach()
        t_vals = t_vals.detach()

    new_t_vals = sorted_piecewise_constant_pdf(
        t_vals, w_blur, t_vals.shape[-1], randomized, u=u,
        generator=generator,
    )
    means, covs = cast_rays(new_t_vals, origins, directions, radii, ray_shape,
                            diag)
    return new_t_vals, (means, covs)
