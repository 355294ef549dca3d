"""Eval / render entry points of the PyTorch/CUDA port.

CLI (same config flags as ``nerf_or_nothing_tpu.run``):
  python -m nerf_or_nothing_tpu_torch.run eval   --data-dir=... --checkpoint-dir=...
  python -m nerf_or_nothing_tpu_torch.run render --data-dir=... --out=...
Extra flags: --out=DIR, --max-images=N, --device=cuda|cpu (default cuda;
without a card the run raises unless --device=cpu is given).
``train`` is not ported yet and exits with 2.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
from nerf_or_nothing_tpu_torch.config import Config, parse_flags
from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
from nerf_or_nothing_tpu_torch.device import resolve_device
from nerf_or_nothing_tpu_torch.eval import (
    evaluate_dataset,
    make_render_fn,
    render_image,
    to_display,
)
from nerf_or_nothing_tpu_torch.models.mlp import Params, init_mlp


def load_params(cfg: Config, device) -> Params:
    """Seeded initial parameters, replaced by the newest checkpoint in
    ``cfg.checkpoint_dir`` when there is one."""
    gen = torch.Generator().manual_seed(cfg.seed)
    params = init_mlp(gen, cfg, device=device)
    if cfg.checkpoint_dir:
        params = ckpt_lib.maybe_restore_params(
            cfg.checkpoint_dir, cfg, params, device=device
        )
    return params


def evaluate(cfg: Config, max_images: Optional[int] = None,
             device="cuda") -> dict:
    device = resolve_device(device)
    params = load_params(cfg, device)
    with create_dataset("test", cfg.data_dir, cfg) as dataset:
        metrics = evaluate_dataset(cfg, params, dataset, max_images,
                                   device=device)
    print(json.dumps({"eval": metrics}), flush=True)
    return metrics


def render(cfg: Config, out_dir: str, max_images: Optional[int] = None,
           device="cuda"):
    """Render the test split to ``out_dir/render_XXX.png``."""
    from PIL import Image

    if cfg.render_path:
        raise NotImplementedError(
            "render_path (novel-view camera paths) is not ported yet"
        )
    device = resolve_device(device)
    params = load_params(cfg, device)
    with create_dataset("test", cfg.data_dir, cfg) as dataset:
        render_fn = make_render_fn(cfg)
        os.makedirs(out_dir, exist_ok=True)
        n = dataset.num_images if max_images is None else min(
            max_images, dataset.num_images
        )
        for i in range(n):
            rays = dataset.image_rays(i)[0]
            h, w = dataset.image_dims(i)
            rgb, _, _ = render_image(
                render_fn, params, rays, h, w, cfg.render_chunk_size,
                device=device,
            )
            rgb = to_display(cfg, rgb)
            img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(out_dir, f"render_{i:03d}.png")
            )
            print(f"wrote render_{i:03d}.png", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("train", "eval", "render"):
        print(__doc__)
        return 2
    command, rest = argv[0], argv[1:]
    if command == "train":
        print("train is not ported to the PyTorch package yet "
              "(ROADMAP queue A: the train slice)")
        return 2
    out = None
    max_images = None
    device = "cuda"
    filtered = []
    for a in rest:
        if a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--max-images="):
            max_images = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            filtered.append(a)
    cfg = parse_flags(filtered)
    if command == "eval":
        evaluate(cfg, max_images, device=device)
    else:
        render(cfg, out or "renders", max_images, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
