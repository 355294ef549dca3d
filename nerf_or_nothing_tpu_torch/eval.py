"""Evaluation: chunked full-image rendering + image metrics.

Same contract as ``nerf_or_nothing_tpu/eval.py`` on one device:
``render_image`` renders ``render_chunk_size`` rays at a time (the last
chunk padded by repeating its last ray, then cut), and the metrics are
PSNR, SSIM, the perceptual proxy and avg-error.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.device import resolve_device
from nerf_or_nothing_tpu_torch.models import mipnerf
from nerf_or_nothing_tpu_torch.models import mlp as mlp_lib
from nerf_or_nothing_tpu_torch.ops.math_utils import (
    compute_avg_error,
    compute_ssim,
    linear_to_srgb,
    mse_to_psnr,
)
from nerf_or_nothing_tpu_torch.rays import Rays


def to_display(cfg: Config, img: np.ndarray) -> np.ndarray:
    """Model/dataset colour -> display space (sRGB-encode with
    ``linear_color``, identity otherwise)."""
    if cfg.linear_color:
        return linear_to_srgb(torch.from_numpy(np.asarray(img))).numpy()
    return np.asarray(img)


def make_render_fn(cfg: Config, mlp_apply=None):
    """Deterministic forward returning the fine level's rgb/dist/acc.

    On the card the forward kernels' packed weights (``pack_forward``: the
    render-level kernel's, the same for the fused-MLP forward kernel) are
    kept between calls with the same weight tensors, unchanged in place, so
    the chunks of a view (and the views of a dataset) pack them once. The
    key is each tensor's identity and ``_version``: an in-place update
    bumps it, and so does the train multi-step after its CUDA-graph
    replays (which do not)."""
    kernels = mlp_apply is None and cfg.use_pallas
    kept = {}  # "key": tensor ids and versions, "tensors", "packed"

    def packed_for(params):
        tensors = [t for wb in params for t in wb]
        key = [(id(t), t._version) for t in tensors]
        if kept.get("key") != key:
            from nerf_or_nothing_tpu_torch.kernels.fused_level import (
                pack_forward,
            )

            # Holding the tensors keeps their ids from being reused.
            kept.update(key=key, tensors=tensors, packed=pack_forward(
                params, cfg, mlp_lib.compute_dtype(cfg)))
        return kept["packed"]

    @torch.no_grad()
    def render_fn(params, rays: Rays):
        packed = None
        if kernels and rays.origins.device.type == "cuda":
            packed = packed_for(params)
        results = mipnerf.render_rays(
            params, cfg, rays, randomized=False, white_bkgd=cfg.white_bkgd,
            mlp_apply=mlp_apply, inference=True, packed=packed,
        )
        fine = results[-1]
        return fine.rgb, fine.distance, fine.acc

    return render_fn


def render_image(render_fn, params, rays: Rays, height: int, width: int,
                 chunk: int = 8192, device="cuda"):
    """Render a full image in fixed-size chunks on ``device``.

    The image's rays go to the device in one copy and the chunks' results
    stay there until the end, so the host queues chunk k+1 while the
    device renders chunk k.

    Args:
      rays: flattened leaves [H*W, C] (numpy or tensors).
    Returns:
      rgb [H, W, 3], distance [H, W], acc [H, W] as numpy arrays.
    """
    device = resolve_device(device)
    rays = Rays(*[torch.as_tensor(np.asarray(x), dtype=torch.float32)
                  .to(device) for x in rays])
    n = rays.origins.shape[0]
    rgbs, dists, accs = [], [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        chunk_rays = [x[start:end] for x in rays]
        pad = chunk - (end - start)
        if pad:
            chunk_rays = [torch.cat([x, x[-1:].expand(pad, -1)])
                          for x in chunk_rays]
        rgb, dist, acc = render_fn(params, Rays(*chunk_rays))
        rgbs.append(rgb[: end - start])
        dists.append(dist[: end - start])
        accs.append(acc[: end - start])
    rgb = torch.cat(rgbs).reshape(height, width, 3).cpu().numpy()
    dist = torch.cat(dists).reshape(height, width).cpu().numpy()
    acc = torch.cat(accs).reshape(height, width).cpu().numpy()
    return rgb, dist, acc


def evaluate_image(pred: np.ndarray, gt: np.ndarray,
                   lpips: Optional[float] = None, device="cuda") -> dict:
    """PSNR / SSIM / avg-error for one rendered image vs ground truth, on
    ``device``. Without a real LPIPS value the deterministic perceptual
    proxy fills the slot, reported as ``lpips_proxy``."""
    device = resolve_device(device)
    pred = torch.as_tensor(np.clip(pred, 0.0, 1.0), dtype=torch.float32,
                           device=device)
    gt = torch.as_tensor(np.asarray(gt), dtype=torch.float32, device=device)
    mse = torch.mean((pred - gt) ** 2)
    psnr = float(mse_to_psnr(mse))
    ssim = float(compute_ssim(pred, gt, max_val=1.0))
    out = {"mse": float(mse), "psnr": psnr, "ssim": ssim}
    if lpips is not None:
        out["lpips"] = lpips
    else:
        from nerf_or_nothing_tpu_torch.ops.perceptual import (
            perceptual_distance,
        )

        lpips = float(perceptual_distance(pred, gt))
        out["lpips_proxy"] = lpips
    out["avg_error"] = float(compute_avg_error(psnr, ssim, lpips))
    return out


def evaluate_dataset(cfg: Config, params, dataset,
                     max_images: Optional[int] = None, mlp_apply=None,
                     device="cuda") -> dict:
    """Mean metrics over (a prefix of) a test dataset."""
    render_fn = make_render_fn(cfg, mlp_apply=mlp_apply)
    n = dataset.num_images if max_images is None else min(
        max_images, dataset.num_images
    )
    metrics = []
    for i in range(n):
        rays, gt = dataset.image_rays(i)
        h, w = dataset.image_dims(i)
        rgb, _, _ = render_image(
            render_fn, params, rays, h, w, cfg.render_chunk_size,
            device=device,
        )
        metrics.append(evaluate_image(
            to_display(cfg, rgb),
            to_display(cfg, np.asarray(gt).reshape(h, w, 3)),
            device=device,
        ))
    return {
        k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]
    }
