"""Analytic synthetic scene generator (Blender-format output).

The BASELINE configs target Blender scenes (lego etc.) which cannot be
downloaded in an offline environment, so this module ray-traces analytic
scenes — exactly, so multi-view ground truth is consistent — and writes
them in the standard Blender-NeRF layout (``transforms_{split}.json`` +
RGBA PNGs). A NeRF that works must drive PSNR well above the ~11 dB floor
that random-noise fixtures allow.

Two scenes:
- ``simple``: four Lambertian spheres (the smoke-test scene).
- ``hard``: the quality-gate scene — procedurally TEXTURED surfaces
  (high-frequency checkers in spherical/planar coordinates), a ring of
  mutually SELF-OCCLUDING spheres around a central one, a checkered ground
  disk, and analytic CAST SHADOWS (secondary shadow rays) — far closer to
  NeRF-scene frequency content than flat-shaded spheres.

Also exposes ``render_rays_analytic`` so tests can compare a trained model
against ground truth along arbitrary rays.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

# Scene: unit-ish spheres inside the [near=2, far=6] shell around origin.
SPHERES = [
    # (center, radius, albedo rgb)
    (np.array([0.0, 0.0, 0.0]), 0.9, np.array([0.85, 0.15, 0.15])),
    (np.array([1.1, 0.8, -0.3]), 0.45, np.array([0.15, 0.65, 0.2])),
    (np.array([-1.0, 0.6, 0.4]), 0.5, np.array([0.2, 0.3, 0.85])),
    (np.array([0.2, -1.1, 0.5]), 0.4, np.array([0.9, 0.8, 0.2])),
]
LIGHT_DIR = np.array([0.5, 0.6, 0.62])
AMBIENT = 0.35

# The hard scene: central textured sphere + a ring of six small spheres
# (each occludes its neighbors and the center from grazing views) over a
# checkered ground disk. (center, radius, base albedo, checker frequency).
_RING = [
    (
        np.array([1.15 * np.cos(a), 1.15 * np.sin(a), -0.55]),
        0.32,
        np.array(c),
        10.0,
    )
    for a, c in zip(
        np.linspace(0.0, 2 * np.pi, 6, endpoint=False),
        [
            (0.9, 0.25, 0.2), (0.2, 0.7, 0.3), (0.25, 0.35, 0.9),
            (0.9, 0.8, 0.25), (0.8, 0.3, 0.8), (0.25, 0.8, 0.8),
        ],
    )
]
SPHERES_HARD = [
    (np.array([0.0, 0.0, 0.05]), 0.75, np.array([0.95, 0.55, 0.25]), 14.0),
    (np.array([0.45, 0.1, 0.85]), 0.28, np.array([0.3, 0.9, 0.5]), 8.0),
    *_RING,
]
GROUND_Z = -0.9
GROUND_R = 1.85
GROUND_CHECK = 3.2  # checker cells per unit length


def _sphere_hits(o, d, center, radius):
    """First-intersection t for each ray (inf where missed)."""
    oc = o - center
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - radius**2
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = -b - sq
    t = np.where((disc > 0) & (t > 1e-6), t, np.inf)
    return t


def _shadowed(p, light, spheres):
    """True where a shadow ray from p toward the light hits any sphere."""
    sh = np.zeros(p.shape[0], bool)
    d = np.broadcast_to(light, p.shape)
    for center, radius, _, _ in spheres:
        sh |= np.isfinite(_sphere_hits(p + 1e-4 * d, d, center, radius))
    return sh


def render_rays_analytic(
    origins: np.ndarray, directions: np.ndarray, scene: str = "simple"
) -> np.ndarray:
    """Exact ray-traced RGB for rays (white background, Lambertian).

    Args:
      origins/directions: [N, 3] (directions need not be normalized).
      scene: "simple" (flat-shaded spheres) or "hard" (textured,
        self-occluding, shadowed — the quality-gate scene).
    Returns:
      [N, 3] float32 in [0, 1].
    """
    o = np.asarray(origins, np.float64)
    d = np.asarray(directions, np.float64)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    n = o.shape[0]
    best_t = np.full(n, np.inf)
    rgb = np.ones((n, 3))
    light = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)

    if scene == "simple":
        for center, radius, albedo in SPHERES:
            t = _sphere_hits(o, d, center, radius)
            hit = t < best_t
            if not hit.any():
                continue
            p = o[hit] + t[hit, None] * d[hit]
            normal = (p - center) / radius
            lam = np.maximum(normal @ light, 0.0)
            shade = AMBIENT + (1.0 - AMBIENT) * lam
            rgb[hit] = albedo[None, :] * shade[:, None]
            best_t[hit] = t[hit]
        return rgb.astype(np.float32)

    assert scene == "hard", scene
    # Spheres: high-frequency checker texture in spherical coordinates.
    for center, radius, albedo, freq in SPHERES_HARD:
        t = _sphere_hits(o, d, center, radius)
        hit = t < best_t
        if not hit.any():
            continue
        p = o[hit] + t[hit, None] * d[hit]
        normal = (p - center) / radius
        theta = np.arctan2(normal[:, 1], normal[:, 0])
        phi = np.arccos(np.clip(normal[:, 2], -1.0, 1.0))
        checker = (
            np.floor(theta * freq / np.pi) + np.floor(phi * freq / np.pi)
        ) % 2
        tex = np.where(checker > 0.5, 1.0, 0.35)[:, None]
        lam = np.maximum(normal @ light, 0.0)
        lam = np.where(_shadowed(p, light, SPHERES_HARD), 0.0, lam)
        shade = AMBIENT + (1.0 - AMBIENT) * lam
        rgb[hit] = albedo[None, :] * tex * shade[:, None]
        best_t[hit] = t[hit]

    # Ground disk: planar checker + cast shadows from the spheres.
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (GROUND_Z - o[:, 2]) / d[:, 2]
    pg = o + tg[:, None] * d
    hit = (
        np.isfinite(tg) & (tg > 1e-6) & (tg < best_t)
        & (pg[:, 0] ** 2 + pg[:, 1] ** 2 < GROUND_R**2)
    )
    if hit.any():
        p = pg[hit]
        checker = (
            np.floor(p[:, 0] * GROUND_CHECK) + np.floor(p[:, 1] * GROUND_CHECK)
        ) % 2
        base = np.where(
            checker[:, None] > 0.5,
            np.array([[0.85, 0.85, 0.9]]),
            np.array([[0.25, 0.25, 0.3]]),
        )
        lam = light[2]  # ground normal is +z
        lam = np.where(_shadowed(p, light, SPHERES_HARD), 0.0, lam)
        shade = AMBIENT + (1.0 - AMBIENT) * lam
        rgb[hit] = base * shade[:, None]
        best_t[hit] = tg[hit]
    return rgb.astype(np.float32)


def _look_at(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world looking from ``eye`` at the origin, -z forward
    (OpenGL/Blender convention)."""
    forward = eye / np.linalg.norm(eye)        # camera -z points at origin
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, forward)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    true_up = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    return c2w


def camera_poses(n_views: int, distance: float = 4.0,
                 elevation: float = 0.45,
                 two_rings: bool = False) -> List[np.ndarray]:
    """Orbit poses; with ``two_rings`` views alternate between two
    elevations (better vertical coverage for held-out generalization)."""
    poses = []
    for i in range(n_views):
        theta = 2.0 * np.pi * i / n_views
        el = elevation
        if two_rings:
            el = elevation + (0.18 if i % 2 else -0.12)
        eye = distance * np.array([
            np.cos(theta) * np.cos(el),
            np.sin(theta) * np.cos(el),
            np.sin(el),
        ])
        poses.append(_look_at(eye))
    return poses


def write_scene(
    root: str,
    n_train: int = 12,
    n_test: int = 3,
    size: int = 64,
    camera_angle_x: float = 0.8,
    scene: str = "simple",
) -> str:
    """Write a Blender-format scene directory; returns ``root``."""
    from PIL import Image

    from nerf_or_nothing_tpu_torch.rays import generate_rays, pinhole_pix_to_cam

    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    pix_to_cam = pinhole_pix_to_cam(focal, size, size)

    def render_pose(c2w) -> np.ndarray:
        rays = generate_rays(pix_to_cam, c2w[:3], size, size, 2.0, 6.0)
        rgb = render_rays_analytic(
            np.asarray(rays.origins).reshape(-1, 3),
            np.asarray(rays.directions).reshape(-1, 3),
            scene=scene,
        )
        return rgb.reshape(size, size, 3)

    for split, n, offset in (("train", n_train, 0.0),
                             ("test", n_test, 0.33)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        poses = camera_poses(n, two_rings=(split == "train"))
        for i, c2w in enumerate(poses):
            # offset test azimuths so views differ from train
            if offset:
                theta = 2.0 * np.pi * (i + offset) / n
                eye = 4.0 * np.array([
                    np.cos(theta) * np.cos(0.45),
                    np.sin(theta) * np.cos(0.45),
                    np.sin(0.45),
                ])
                c2w = _look_at(eye)
            img = render_pose(c2w)
            rgba = np.concatenate(
                [img, np.ones_like(img[..., :1])], axis=-1
            )
            Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
                os.path.join(root, split, f"r_{i}.png")
            )
            frames.append({
                "file_path": f"{split}/r_{i}",
                "transform_matrix": c2w.tolist(),
            })
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(
                {"camera_angle_x": camera_angle_x, "frames": frames}, f
            )
    return root
