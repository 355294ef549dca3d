"""Multiscale Blender ("multicam") dataset: mip-NeRF's multiscale loss.

Same loader as ``nerf_or_nothing_tpu/datasets/multicam.py``:

- ``metadata.json`` with per-split dicts of ``file_path``, ``cam2world``,
  ``width``, ``height``, ``focal``, ``pix2cam``, ``lossmult`` and optional
  ``near`` / ``far``, one entry per (image, scale);
- without it, the 4-scale pyramid is made from a Blender scene's
  ``transforms_{split}.json`` by box-filter downsampling;
- rays are made per image with that image's intrinsics and flattened into
  one pool; ``loss_mult`` carries the area weight 4^scale, which the
  multiscale loss and the level kernels' per-ray ``g_scale`` take;
- ``image_rays`` / ``image_dims`` serve each image at its own resolution.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_or_nothing_tpu_torch.datasets.base import Dataset
from nerf_or_nothing_tpu_torch.datasets.blender import _load_image, orbit_pose
from nerf_or_nothing_tpu_torch.rays import (
    Rays,
    flatten_rays,
    generate_rays,
    pinhole_pix_to_cam,
)


class Multicam(Dataset):
    NUM_SCALES = 4

    def _load(self) -> None:
        meta_path = os.path.join(self.data_dir, "metadata.json")
        if os.path.exists(meta_path):
            self._load_metadata(meta_path)
        else:
            self._load_synthesized()

    def _load_metadata(self, meta_path: str) -> None:
        split = "train" if self.split == "train" else "test"
        with open(meta_path) as f:
            meta = json.load(f)[split]

        per_image_rays = []
        pixels = []
        for i in range(len(meta["file_path"])):
            img = _load_image(os.path.join(self.data_dir,
                                           meta["file_path"][i]))
            if img.shape[-1] == 4:
                rgb, a = img[..., :3], img[..., 3:]
                img = rgb * a + (1 - a) if self.cfg.white_bkgd else rgb * a
            w, h = int(meta["width"][i]), int(meta["height"][i])
            pix2cam = np.asarray(meta["pix2cam"][i], np.float32)
            c2w = np.asarray(meta["cam2world"][i], np.float32)
            r = generate_rays(
                pix2cam, c2w[:3], w, h,
                float(meta.get("near", [self.cfg.near] * (i + 1))[i]),
                float(meta.get("far", [self.cfg.far] * (i + 1))[i]),
            )
            lm = float(meta["lossmult"][i])
            per_image_rays.append(
                r._replace(loss_mult=np.full_like(r.radii, lm))
            )
            pixels.append(img.reshape(-1, 3))
        # Render-path intrinsics: the sharpest (widest) camera of the set.
        i0 = int(np.argmax(np.asarray(meta["width"], np.float64)))
        self._path_cam = (
            np.asarray(meta["pix2cam"][i0], np.float32),
            int(meta["height"][i0]), int(meta["width"][i0]),
        )
        self._pose_radius = float(np.mean([
            np.linalg.norm(np.asarray(c, np.float32)[:3, 3])
            for c in meta["cam2world"]
        ]))
        self._set_flat(per_image_rays, pixels)

    def _load_synthesized(self) -> None:
        split = "train" if self.split == "train" else "test"
        with open(os.path.join(self.data_dir,
                               f"transforms_{split}.json")) as f:
            meta = json.load(f)
        camera_angle_x = float(meta["camera_angle_x"])

        per_image_rays = []
        pixels = []
        for frame in meta["frames"]:
            fname = os.path.join(self.data_dir, frame["file_path"] + ".png")
            base = _load_image(fname)
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            for scale in range(self.NUM_SCALES):
                factor = 2**scale
                img = base if factor == 1 else _downsample(base, factor)
                if img.shape[-1] == 4:
                    rgb, a = img[..., :3], img[..., 3:]
                    img = ((rgb * a + (1 - a)) if self.cfg.white_bkgd
                           else rgb * a)
                h, w = img.shape[:2]
                focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
                r = generate_rays(
                    pinhole_pix_to_cam(focal, w, h), c2w[:3], w, h,
                    self.cfg.near, self.cfg.far,
                )
                # Area weight: a pixel at scale s covers 4^s base pixels.
                lm = float(4**scale)
                per_image_rays.append(
                    r._replace(loss_mult=np.full_like(r.radii, lm))
                )
                pixels.append(img.reshape(-1, 3))
        h0, w0 = per_image_rays[0].radii.shape[:2]
        focal0 = 0.5 * w0 / np.tan(0.5 * camera_angle_x)
        self._path_cam = (pinhole_pix_to_cam(focal0, w0, h0), h0, w0)
        self._pose_radius = float(np.mean([
            np.linalg.norm(
                np.asarray(f["transform_matrix"], np.float32)[:3, 3]
            )
            for f in meta["frames"]
        ]))
        self._set_flat(per_image_rays, pixels)

    def render_path_rays(self, n_frames: int = 40, phi_deg: float = -30.0):
        """The Blender orbit (``Blender.render_path_rays``) at the set's
        sharpest camera. Returns [(rays [H*W, C], (H, W)), ...]."""
        pix_to_cam, h, w = self._path_cam
        out = []
        for theta in np.linspace(-180.0, 180.0, n_frames, endpoint=False):
            c2w = orbit_pose(theta, phi_deg, self._pose_radius)
            r = generate_rays(
                pix_to_cam, c2w[:3], w, h, self.cfg.near, self.cfg.far
            )
            out.append((flatten_rays(r), (h, w)))
        return out

    def _linearize(self) -> None:
        super()._linearize()
        from nerf_or_nothing_tpu_torch.ops.math_utils import srgb_to_linear

        self._per_image_pixels = [
            np.asarray(srgb_to_linear(p).numpy(), np.float32)
            for p in self._per_image_pixels
        ]

    def _set_flat(self, per_image_rays, pixels) -> None:
        # Mixed resolutions: flatten each image's grid before stacking.
        flat = [flatten_rays(r) for r in per_image_rays]
        self.rays = Rays(*[
            np.concatenate([getattr(r, f) for r in flat])[None]
            for f in Rays._fields
        ])
        self.images = np.concatenate(pixels)[None, :, None, :]
        self._per_image_rays = per_image_rays
        self._per_image_pixels = pixels

    def _flatten(self) -> None:
        # images is already the flat pool [1, P, 1, 3]; rays [1, P, C].
        self.num_images = len(self._per_image_pixels)
        self.height, self.width = self.image_dims(0)
        self._set_pool(Rays(*[x[0] for x in self.rays]),
                       self.images.reshape(-1, 3))

    def image_rays(self, index: int):
        return (flatten_rays(self._per_image_rays[index]),
                self._per_image_pixels[index])

    def image_dims(self, index: int):
        """(height, width) of image ``index``: each scale has its own."""
        h, w = self._per_image_rays[index].radii.shape[:2]
        return h, w


def _downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Box-filter downsample (the multiscale preprocessing)."""
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    img = img[: h2 * factor, : w2 * factor]
    return img.reshape(h2, factor, w2, factor, -1).mean(axis=(1, 3))
