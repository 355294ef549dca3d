"""LLFF (forward-facing) dataset: poses_bounds + NDC rays.

Same loader as ``nerf_or_nothing_tpu/datasets/llff.py``: ``images/`` (or
``images_{factor}/``) and ``poses_bounds.npy`` (or the ``.csv`` export),
one 3x5 pose (with h, w, focal in the 5th column) and two depth bounds a
row; the axis swap ``(r0, r1) <- (r1, -r0)``; poses scaled by
``1 / (min(bounds) * 0.75)`` and recentred on the average pose; NDC rays
with origin-spacing radii and pre-NDC view directions, or, with
``spherify``, the spherified poses, plain rays and near/far from the
bounds; the spiral (or, spherified, circular) render path; every
``llff_hold``-th image held out as the test split.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_or_nothing_tpu_torch.datasets.base import Dataset
from nerf_or_nothing_tpu_torch.datasets.blender import _load_image
from nerf_or_nothing_tpu_torch.rays import (
    Rays,
    convert_to_ndc,
    flatten_rays,
    generate_rays,
    ndc_radii,
    pinhole_pix_to_cam,
)


def _normalize(x):
    return x / np.linalg.norm(x)


def _average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean camera pose [3, 4]."""
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, center], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """All poses [N, 4, 4] relative to the average pose."""
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _average_pose(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses = np.linalg.inv(c2w) @ poses
    poses_[:, :3, :4] = poses[:, :3, :4]
    return poses_


def spherify_poses(poses: np.ndarray, bounds: np.ndarray):
    """Spherify inward-facing captures: recentre on the point closest to
    all camera axes, scale to unit distance, and make a circular render
    path.

    Args:
      poses: [N, 4, 4]; bounds: [N, 2].
    Returns:
      (poses [N, 4, 4], render_poses [120, 3, 4], bounds).
    """
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.asarray([0, 0, 0, 1.0])[None, None],
                        (p.shape[0], 1, 1))], axis=1
        )

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -a_i @ rays_o
        # pinv: parallel camera axes make the normal matrix singular.
        return np.squeeze(
            -np.linalg.pinv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
            @ b_i.mean(0)
        )

    center = min_line_dist(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = (
        np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    )
    rad = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bounds = bounds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(max(rad**2 - zh**2, 1e-8))
    render_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.asarray(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh]
        )
        up = np.asarray([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        render_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    return p34_to_44(poses_reset[:, :3, :4]), np.stack(render_poses), bounds


def generate_spiral_path(
    poses: np.ndarray,
    bounds: np.ndarray,
    focal_scale: float = 1.0,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
) -> np.ndarray:
    """Spiral novel-view path [n_frames, 3, 4] for forward-facing scenes."""
    c2w = _average_pose(poses)
    up = _normalize(poses[:, :3, 1].sum(0))

    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    mean_dz = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    focal = mean_dz * focal_scale

    # Radii of the spiral: the 90th percentile of the camera offsets.
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames,
                             endpoint=False):
        t = (
            c2w[:3, :4]
            @ (np.asarray([np.cos(theta), -np.sin(theta),
                           -np.sin(theta * zrate), 1.0]) * np.append(rads, 1.0))
        )
        z = _normalize(t - c2w[:3, :4] @ np.asarray([0, 0, -focal, 1.0]))
        vec0 = _normalize(np.cross(up, z))
        vec1 = _normalize(np.cross(z, vec0))
        render_poses.append(np.stack([vec0, vec1, z, t], 1))
    return np.stack(render_poses)


def load_poses_bounds(data_dir: str):
    """poses [N, 3, 5] and bounds [N, 2] from poses_bounds.npy or .csv."""
    npy = os.path.join(data_dir, "poses_bounds.npy")
    csv = os.path.join(data_dir, "poses_bounds.csv")
    if os.path.exists(npy):
        arr = np.load(npy)
    elif os.path.exists(csv):
        arr = np.loadtxt(csv, delimiter=",")
    else:
        raise FileNotFoundError(f"no poses_bounds.[npy|csv] in {data_dir}")
    return arr[:, :-2].reshape([-1, 3, 5]), arr[:, -2:]


def _ndc_rays(pix_to_cam, c2w, focal: float, w: int, h: int) -> Rays:
    """One image's rays in NDC (near 0, far 1), with origin-spacing radii
    and the pre-NDC view directions."""
    r = generate_rays(pix_to_cam, c2w[:3], w, h, 0.0, 1.0)
    origins, directions = convert_to_ndc(r.origins, r.directions, focal, w, h)
    radii = ndc_radii(origins)
    ones = np.ones_like(radii)
    f32 = np.float32
    return Rays(
        origins.astype(f32), directions.astype(f32),
        np.asarray(r.viewdirs, f32), radii.astype(f32),
        (ones * 0.0).astype(f32), (ones * 1.0).astype(f32), ones.astype(f32),
    )


class LLFF(Dataset):
    def _load(self) -> None:
        cfg = self.cfg
        factor = cfg.factor if cfg.factor else 1
        img_dir = os.path.join(
            self.data_dir, f"images_{cfg.factor}" if cfg.factor else "images"
        )
        fnames = sorted(
            os.path.join(img_dir, f)
            for f in os.listdir(img_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        images = np.stack([_load_image(f)[..., :3] for f in fnames])

        poses_raw, bounds = load_poses_bounds(self.data_dir)
        if poses_raw.shape[0] != images.shape[0]:
            raise ValueError(
                f"{poses_raw.shape[0]} poses vs {images.shape[0]} images"
            )
        # poses_raw[:, :, 4] = (h, w, focal) at full resolution.
        self.focal = float(poses_raw[0, 2, 4]) / factor
        h, w = images.shape[1:3]

        poses = np.concatenate(
            [poses_raw[:, :, 1:2], -poses_raw[:, :, 0:1], poses_raw[:, :, 2:4]],
            axis=-1,
        )  # [N, 3, 4]
        scale = 1.0 / (bounds.min() * 0.75)
        poses[:, :3, 3] *= scale
        bounds = bounds * scale
        eye = np.tile(np.eye(4, dtype=np.float32)[None], (poses.shape[0], 1, 1))
        eye[:, :3, :4] = poses
        poses = recenter_poses(eye)

        self.render_poses = None
        if cfg.spherify:
            poses, self.render_poses, bounds = spherify_poses(poses, bounds)
        elif cfg.render_path:
            self.render_poses = generate_spiral_path(poses, bounds)

        indices = np.arange(images.shape[0])
        if cfg.llff_hold > 0:
            test_mask = indices % cfg.llff_hold == 0
        else:
            test_mask = np.zeros_like(indices, dtype=bool)
        sel = ~test_mask if self.split == "train" else test_mask
        images = images[sel]
        poses = poses[sel]

        pix_to_cam = pinhole_pix_to_cam(self.focal, w, h)
        if cfg.spherify:
            # No NDC for inward-facing captures; near/far from the bounds.
            near = float(bounds.min() * 0.9)
            far = float(bounds.max() * 1.0)
            per_image = [generate_rays(pix_to_cam, c2w[:3], w, h, near, far)
                         for c2w in poses]
        else:
            per_image = [_ndc_rays(pix_to_cam, c2w, self.focal, w, h)
                         for c2w in poses]
        self.images = images.astype(np.float32)
        self.rays = Rays(*[
            np.stack([getattr(r, f) for r in per_image])
            for f in Rays._fields
        ])

    def render_path_rays(self):
        """Flat ray grids and dims along the render path (spiral, or circle
        when spherified): [(rays [H*W, C], (H, W)), ...], the
        ``image_rays`` contract."""
        if self.render_poses is None:
            raise ValueError(
                "no render path: set spherify or render_path in the config"
            )
        h, w = self.images.shape[1:3]
        pix_to_cam = pinhole_pix_to_cam(self.focal, w, h)
        out = []
        for c2w in self.render_poses:
            if self.cfg.spherify:
                r = generate_rays(pix_to_cam, c2w[:3], w, h,
                                  float(self.rays.near.min()),
                                  float(self.rays.far.max()))
            else:
                r = _ndc_rays(pix_to_cam, c2w, self.focal, w, h)
            out.append((flatten_rays(r), (h, w)))
        return out
