"""Deterministic random-feature perceptual distance (the LPIPS input slot).

Same metric as ``nerf_or_nothing_tpu/ops/perceptual.py``: three scales of
3x3 conv + ReLU with fixed He-scaled Gaussian filters drawn from
``np.random.default_rng(1905)``, channel unit-normalisation, squared
feature difference, spatial + channel mean, summed over scales, with 2x2
average pooling between scales (odd edges dropped; a scale with no pixels
left, below 4 pixels a side, gives NaN, as the mean over no pixels does
in JAX). Not the trained LPIPS metric: it is reported as ``lpips_proxy``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from nerf_or_nothing_tpu_torch.ops.math_utils import exact_f32

_WIDTHS = (16, 32, 32)
_SEED = 1905  # fixed forever; changing it changes the metric


@functools.lru_cache(maxsize=1)
def _filters():
    """The conv banks, HWIO float32 numpy arrays (same draws as JAX's)."""
    rng = np.random.default_rng(_SEED)
    banks = []
    c_in = 3
    for w in _WIDTHS:
        fan_in = 3 * 3 * c_in
        f = rng.standard_normal((3, 3, c_in, w)) * np.sqrt(2.0 / fan_in)
        banks.append(f.astype(np.float32))
        c_in = w
    return tuple(banks)


def _normalize_channels(feat, eps=1e-10):
    norm = torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True))
    return feat / torch.clamp(norm, min=eps)


def _avg_pool2(x):
    """2x2 average pooling, odd edges dropped; no pixels below 2."""
    if min(x.shape[-2:]) < 2:
        return x[..., : x.shape[-2] // 2, : x.shape[-1] // 2]
    return F.avg_pool2d(x, 2)


def perceptual_distance(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Distance of two [H, W, 3] images in [0, 1]; 0 for identical images."""
    exact_f32(img0.device)
    x0 = img0.float().permute(2, 0, 1)[None] * 2.0 - 1.0   # NCHW
    x1 = img1.float().permute(2, 0, 1)[None] * 2.0 - 1.0
    total = torch.zeros((), dtype=torch.float32, device=img0.device)
    for i, f in enumerate(_filters()):
        if i:
            x0, x1 = _avg_pool2(x0), _avg_pool2(x1)
        if min(x0.shape[-2:]) == 0:
            total = total + float("nan")
            continue
        k = torch.from_numpy(f).permute(3, 2, 0, 1).contiguous()  # OIHW
        k = k.to(img0.device)
        x0 = torch.relu(F.conv2d(x0, k, padding=1))
        x1 = torch.relu(F.conv2d(x1, k, padding=1))
        d = _normalize_channels(x0) - _normalize_channels(x1)
        total = total + torch.mean(torch.sum(d * d, dim=1))
    return total
