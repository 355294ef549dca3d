"""Blender synthetic dataset (NeRF ``transforms_{split}.json``).

Same loader as ``nerf_or_nothing_tpu/datasets/blender.py``: RGBA PNGs with
alpha composited onto white (``white_bkgd``) or black, focal from
``camera_angle_x``, near/far from the config, mip radii from adjacent
pixel directions.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_or_nothing_tpu_torch.datasets.base import Dataset
from nerf_or_nothing_tpu_torch.rays import (
    Rays,
    generate_rays,
    pinhole_pix_to_cam,
)


def _load_image(path: str, factor: int = 0) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if factor and factor > 1:
        img = img.resize(
            (img.width // factor, img.height // factor), Image.LANCZOS
        )
    return np.asarray(img, dtype=np.float32) / 255.0


class Blender(Dataset):
    def _load(self) -> None:
        split = "train" if self.split == "train" else "test"
        meta_path = os.path.join(self.data_dir, f"transforms_{split}.json")
        with open(meta_path) as f:
            meta = json.load(f)

        images = []
        cams = []
        for frame in meta["frames"]:
            fname = os.path.join(self.data_dir, frame["file_path"] + ".png")
            img = _load_image(fname, self.cfg.factor)
            if img.shape[-1] == 4:
                rgb, alpha = img[..., :3], img[..., 3:]
                if self.cfg.white_bkgd:
                    img = rgb * alpha + (1.0 - alpha)
                else:
                    img = rgb * alpha
            images.append(img.astype(np.float32))
            cams.append(np.asarray(frame["transform_matrix"], np.float32))

        self.images = np.stack(images)
        n, h, w = self.images.shape[:3]
        camera_angle_x = float(meta["camera_angle_x"])
        self.focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
        pix_to_cam = pinhole_pix_to_cam(self.focal, w, h)

        per_image = [
            generate_rays(pix_to_cam, c2w, w, h, self.cfg.near, self.cfg.far)
            for c2w in cams
        ]
        self.rays = Rays(*[
            np.stack([getattr(r, f) for r in per_image])
            for f in Rays._fields
        ])
