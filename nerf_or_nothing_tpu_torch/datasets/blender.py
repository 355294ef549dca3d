"""Blender synthetic dataset (NeRF ``transforms_{split}.json``).

Same loader as ``nerf_or_nothing_tpu/datasets/blender.py``: RGBA PNGs with
alpha composited onto white (``white_bkgd``) or black, focal from
``camera_angle_x``, near/far from the config, mip radii from adjacent
pixel directions, and the novel-view orbit of ``render_path_rays``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_or_nothing_tpu_torch.datasets.base import Dataset
from nerf_or_nothing_tpu_torch.rays import (
    Rays,
    flatten_rays,
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
        # Orbit radius of the render path: the cameras' mean distance.
        self._pose_radius = float(np.mean(
            [np.linalg.norm(c2w[:3, 3]) for c2w in cams]
        ))
        pix_to_cam = pinhole_pix_to_cam(self.focal, w, h)

        per_image = [
            generate_rays(pix_to_cam, c2w, w, h, self.cfg.near, self.cfg.far)
            for c2w in cams
        ]
        self.rays = Rays(*[
            np.stack([getattr(r, f) for r in per_image])
            for f in Rays._fields
        ])

    def render_path_rays(self, n_frames: int = 40, phi_deg: float = -30.0):
        """Ray grids along a novel-view orbit: cameras on a circle of the
        scene's pose radius at elevation ``phi_deg``, all looking at the
        origin. Returns [(rays [H*W, C], (H, W)), ...], the ``image_rays``
        contract."""
        h, w = self.images.shape[1:3]
        pix_to_cam = pinhole_pix_to_cam(self.focal, w, h)
        out = []
        for theta in np.linspace(-180.0, 180.0, n_frames, endpoint=False):
            c2w = orbit_pose(theta, phi_deg, self._pose_radius)
            r = generate_rays(
                pix_to_cam, c2w[:3], w, h, self.cfg.near, self.cfg.far
            )
            out.append((flatten_rays(r), (h, w)))
        return out


def orbit_pose(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world matrix on an origin-centred orbit (OpenGL
    convention, -z forward): start at distance ``radius`` on +z, pitch by
    ``phi`` about x, yaw by ``theta`` about the world up axis."""
    th = np.deg2rad(theta_deg)
    ph = np.deg2rad(phi_deg)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    rot_x = np.array(
        [[1, 0, 0, 0],
         [0, np.cos(ph), -np.sin(ph), 0],
         [0, np.sin(ph), np.cos(ph), 0],
         [0, 0, 0, 1]], np.float32,
    )
    rot_y = np.array(
        [[np.cos(th), 0, -np.sin(th), 0],
         [0, 1, 0, 0],
         [np.sin(th), 0, np.cos(th), 0],
         [0, 0, 0, 1]], np.float32,
    )
    # Blender scenes have z up: swap y/z and flip x so that the orbit
    # sweeps the azimuth around the scene's vertical axis.
    flip = np.array(
        [[-1, 0, 0, 0],
         [0, 0, 1, 0],
         [0, 1, 0, 0],
         [0, 0, 0, 1]], np.float32,
    )
    return flip @ rot_y @ rot_x @ c2w
