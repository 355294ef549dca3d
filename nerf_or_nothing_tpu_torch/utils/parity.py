"""The numerics-parity oracle of the train level, the names of
``nerf_or_nothing_tpu/utils/parity.py``.

The oracle is the unfused level loss (the plain MLP, the activations, the
composite and the masked MSE, each as plain PyTorch ops) differentiated
by ``torch.autograd``; the function under test is ``fused_level_train``:
the ``train_level`` kernel on the card, its plain version on the CPU.
Errors are normalized to the band ``atol + rtol*|b| + rtol*max|b|``: a
value under 1 is within it.

``parity_inputs`` draws its arrays with numpy from the seed (the JAX
module draws with ``jax.random``), so a test can feed the same arrays to
both packages' oracles.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.device import resolve_device
from nerf_or_nothing_tpu_torch.models import mlp as mlp_lib
from nerf_or_nothing_tpu_torch.ops.math_utils import exact_f32, softplus
from nerf_or_nothing_tpu_torch.ops.render import (
    composite_weights,
    interval_lengths,
)

# The bands per compute dtype (those of the JAX package).
PARITY_BANDS = {"float32": (1e-6, 1e-3), "bfloat16": (2e-3, 3e-2)}


def oracle_level_loss(params, cfg: Config, x_enc, dir_enc, t_vals, dirs,
                      pixels, mask, level_weight, white_bkgd):
    """Unfused one-level train loss: MLP (f32) -> sigmoid / rgb padding +
    softplus / density bias -> composite -> masked MSE times the level's
    weight. Returns (loss, (comp, weights))."""
    raw_rgb, raw_den = mlp_lib.apply_mlp(params, cfg, x_enc, dir_enc)
    rgb = torch.sigmoid(raw_rgb)
    rgb = rgb * (1.0 + 2.0 * cfg.rgb_padding) - cfg.rgb_padding
    density = softplus(raw_den[..., 0] + cfg.density_bias)
    _, _, weights = composite_weights(density, interval_lengths(t_vals, dirs))
    comp = torch.sum(weights[..., None] * rgb, dim=-2)
    if white_bkgd:
        comp = comp + (1.0 - torch.sum(weights, dim=-1)[..., None])
    denom = torch.clamp(torch.sum(mask), min=1e-10)
    sq = torch.sum((comp - pixels) ** 2, dim=-1)
    return level_weight * torch.sum(mask * sq) / denom, (comp, weights)


def parity_inputs(dtype: str, num_samples: int = 128, num_rays: int = 32,
                  seed: int = 0):
    """Deterministic inputs at ``Config()`` width, as numpy f32 arrays:
    (cfg, params [(w [in, out], b [out]), ...], x_enc [R, S, F], dir_enc
    [R, Fd], t_vals [R, S+1] sorted in [2, 6], dirs [R, 3], pixels
    [R, 3]); Glorot-uniform weights and zero biases, as ``init_mlp``."""
    cfg = Config(compute_dtype=dtype, num_samples=num_samples)
    S, R = cfg.num_samples, num_rays
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params = []
    for fan_in, fan_out in mlp_lib.layer_dims(cfg):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        params.append((rng.uniform(-lim, lim, (fan_in, fan_out)).astype(f32),
                       np.zeros((fan_out,), f32)))
    x_enc = (rng.normal(size=(R, S, cfg.location_features)) * 0.5).astype(f32)
    dir_enc = (rng.normal(size=(R, cfg.direction_features)) * 0.5).astype(f32)
    t_vals = np.sort(rng.uniform(2.0, 6.0, (R, S + 1)), axis=-1).astype(f32)
    dirs = rng.normal(size=(R, 3)).astype(f32)
    pixels = rng.uniform(size=(R, 3)).astype(f32)
    return cfg, params, x_enc, dir_enc, t_vals, dirs, pixels


def normalized_err(a, b, atol: float, rtol: float) -> float:
    """max |a-b| / band with band = atol + rtol*|b| + rtol*max|b|, in f64.

    < 1.0 means within tolerance; the value is the fraction of the band
    consumed."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    band = atol + rtol * b.abs() + rtol * b.abs().max()
    return float(((a - b).abs() / band).max())


@contextlib.contextmanager
def f64_products():
    """Within the block, the plain versions (``fused_level``'s and
    ``fused_mlp``'s, whose layer products all go through
    ``fused_level.dense``) take every layer product in f64 from the same
    compute-dtype operands and round it to f32, every other rounding point
    as it is. Two f32 computations of a wide MLP (the kernel's 3xTF32 sums,
    the plain version's f32 ones) can put one ReLU mask on opposite sides
    of zero and then differ by about a band in a column sum, whichever of
    them is nearer the exact value: f32 on the wide route is held to this
    version (``reference_products``)."""
    from nerf_or_nothing_tpu_torch.kernels import fused_level

    def dense_f64(h, w, dt):
        return (h.to(dt).double() @ w.to(dt).double()).float()

    saved = fused_level.dense
    fused_level.dense = dense_f64
    try:
        yield
    finally:
        fused_level.dense = saved


def f64_reference(cfg: Config, kernel: Optional[str] = None, S: int = 0,
                  input_grads: bool = False) -> bool:
    """Whether ``cfg``'s kernels are held to the plain version with f64
    products (``f64_products``): f32 on the wide route, a kernel net_width
    above 256 or, with ``kernel`` (a launch of it at ``S`` samples a ray),
    wherever ``fused_level.takes_wide`` picks that route."""
    from nerf_or_nothing_tpu_torch.kernels import fused_level

    if cfg.compute_dtype != "float32":
        return False
    if kernel is None:
        return fused_level.uses_wide(cfg)
    return fused_level.takes_wide(cfg, kernel, S, input_grads)


def reference_products(cfg: Config, kernel: Optional[str] = None, S: int = 0,
                       input_grads: bool = False):
    """The context in which a plain version gives the reference of
    ``cfg``'s kernels (of a launch of ``kernel``, as ``f64_reference``):
    ``f64_products()`` where ``f64_reference``, else the plain version as
    it is."""
    return (f64_products() if f64_reference(cfg, kernel, S, input_grads)
            else contextlib.nullcontext())


def level_parity_errors(dtype: str, device="cuda", atol=None,
                        rtol=None) -> Tuple[float, dict]:
    """``fused_level_train`` against the autograd oracle on ``parity_inputs``
    (level weight 0.1, every ray unmasked, white background), on
    ``device``. Returns (worst normalized error, {tensor: error}) for comp,
    weights and each dW / db."""
    from nerf_or_nothing_tpu_torch.kernels.fused_level import (
        fused_level_train,
    )

    device = resolve_device(device)
    exact_f32(device)
    if atol is None or rtol is None:
        atol, rtol = PARITY_BANDS[dtype]
    cfg, params, *arrays = parity_inputs(dtype)
    x_enc, dir_enc, t_vals, dirs, pixels = [torch.from_numpy(a).to(device)
                                            for a in arrays]
    params = [(torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
              for w, b in params]
    mask = torch.ones((pixels.shape[0],), device=device)
    lw = 0.1
    gsc = (lw * 2.0 * mask / torch.clamp(torch.sum(mask), min=1e-10))[:, None]
    comp, _, wts, dp = fused_level_train(params, cfg, x_enc, dir_enc, t_vals,
                                         dirs, pixels, gsc, True)
    leaves = [t.clone().requires_grad_() for wb in params for t in wb]
    with torch.enable_grad():
        loss, (comp_o, wts_o) = oracle_level_loss(
            list(zip(leaves[0::2], leaves[1::2])), cfg, x_enc, dir_enc,
            t_vals, dirs, pixels, mask, lw, True)
        grads = torch.autograd.grad(loss, leaves)
    errs = {"comp": normalized_err(comp, comp_o, atol, rtol),
            "weights": normalized_err(wts, wts_o, atol, rtol)}
    for i, (dw, db) in enumerate(dp):
        errs[f"dw{i}"] = normalized_err(dw, grads[2 * i], atol, rtol)
        errs[f"db{i}"] = normalized_err(db, grads[2 * i + 1], atol, rtol)
    return max(errs.values()), errs


# A hidden pre-activation within this many times its layer's rms of zero
# in the f64 forward is a ReLU mask that an f32 computation may take on
# the other side of zero: several times the f32 rounding of a
# pre-activation at these widths
MASK_MARGIN = 3e-5


def near_zero_rows(params, cfg, x, d, margin=MASK_MARGIN):
    """The rows [R*S] of the MLP on x [R*S, F], d [R, Fd] with a hidden
    pre-activation of the f64 forward within ``margin`` times its layer's
    rms of zero."""
    D, nw, S = cfg.net_depth, cfg.net_width, cfg.num_samples
    x, d = x.double(), d.double()
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)

    def relu(z):
        near.logical_or_(
            (z.abs() < margin * z.pow(2).mean().sqrt()).any(dim=1))
        return torch.relu(z)

    h = x
    for i in range(D):
        w, b = (t.double() for t in params[i])
        skip = i % cfg.skip_layer == 0 and i > 0
        h = relu((h @ w[:nw] + x @ w[nw:] if skip else h @ w) + b)
    for j in range(cfg.net_depth_condition):
        w, b = (t.double() for t in params[D + 1 + j])
        z = (h @ w[:nw] + (d @ w[nw:]).repeat_interleave(S, 0) if j == 0
             else h @ w)
        h = relu(z + b)
    return near
