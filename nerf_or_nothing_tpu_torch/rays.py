"""Ray batch container and camera -> ray generation (numpy side).

Pinhole ray generator with the mip radius (2/sqrt(12) x adjacent-pixel
direction spacing) and the LLFF NDC conversion. Everything here is numpy:
rays are made on the host and moved to the device per render chunk
(``eval.render_image``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Rays(NamedTuple):
    """A batch of rays; every leaf has leading shape [..., num_rays].

    origins/directions/viewdirs [N,3], radii/near/far/loss_mult [N,1].
    Leaves are numpy arrays or torch tensors.
    """

    origins: object
    directions: object
    viewdirs: object
    radii: object
    near: object
    far: object
    loss_mult: object

    @property
    def num_rays(self) -> int:
        return self.origins.shape[-2]


def flatten_rays(r: Rays) -> Rays:
    """Collapse grid leaves [..., C] to a flat ray list [N, C]."""
    return Rays(*[
        np.asarray(x).reshape(-1, np.asarray(x).shape[-1]) for x in r
    ])


def generate_rays(
    pix_to_cam: np.ndarray,
    cam_to_world: np.ndarray,
    width: int,
    height: int,
    near: float,
    far: float,
) -> Rays:
    """Pinhole camera rays for one pose.

    Per-pixel camera-space direction ``((x - w/2 + 0.5)/f, -(y - h/2 +
    0.5)/f, -1)`` rotated into world space; mip radius is ``2/sqrt(12)``
    times the x-spacing between adjacent pixel directions.

    Returns:
      Rays with float32 numpy leaves shaped [height, width, C].
    """
    x, y = np.meshgrid(
        np.arange(width, dtype=np.float32),
        np.arange(height, dtype=np.float32),
        indexing="xy",
    )
    pix = np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)  # [H,W,3]
    cam_dirs = pix @ pix_to_cam.T
    rot = cam_to_world[:3, :3]
    directions = cam_dirs @ rot.T
    origins = np.broadcast_to(cam_to_world[:3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

    # The last column reuses its left neighbour's spacing (dx has W-1
    # columns, so that neighbour is dx[:, -1:]).
    dx = np.sqrt(np.sum((directions[:, :-1, :] - directions[:, 1:, :]) ** 2, -1))
    dx = np.concatenate([dx, dx[:, -1:]], axis=1)
    radii = (dx * 2.0 / np.sqrt(12.0))[..., None]

    ones = np.ones_like(radii)
    f32 = np.float32
    return Rays(
        origins=np.asarray(origins, f32),
        directions=np.asarray(directions, f32),
        viewdirs=np.asarray(viewdirs, f32),
        radii=np.asarray(radii, f32),
        near=np.asarray(ones * near, f32),
        far=np.asarray(ones * far, f32),
        loss_mult=np.asarray(ones, f32),
    )


def pinhole_pix_to_cam(focal: float, width: int, height: int) -> np.ndarray:
    """Inverse intrinsics for a centred pinhole camera.

    Maps (x+0.5, y+0.5, 1) to ((x - w/2 + 0.5)/f, -(y - h/2 + 0.5)/f, -1).
    """
    return np.array(
        [
            [1.0 / focal, 0, -0.5 * width / focal],
            [0, -1.0 / focal, 0.5 * height / focal],
            [0, 0, -1.0],
        ],
        dtype=np.float32,
    )


def convert_to_ndc(
    origins: np.ndarray,
    directions: np.ndarray,
    focal: float,
    width: int,
    height: int,
    near: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Shift rays to the z=-near plane and map to NDC (forward-facing
    scenes)."""
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    dx, dy, dz = np.moveaxis(directions, -1, 0)
    ox, oy, oz = np.moveaxis(origins, -1, 0)

    o0 = -((2 * focal) / width) * (ox / oz)
    o1 = -((2 * focal) / height) * (oy / oz)
    o2 = 1 + 2 * near / oz
    d0 = -((2 * focal) / width) * (dx / dz - ox / oz)
    d1 = -((2 * focal) / height) * (dy / dz - oy / oz)
    d2 = -2 * near / oz

    origins = np.stack([o0, o1, o2], -1)
    directions = np.stack([d0, d1, d2], -1)
    return origins, directions


def ndc_radii(origins: np.ndarray) -> np.ndarray:
    """Radii from origin-plane spacing in NDC: sqrt(dx^2 + dy^2)/sqrt(12),
    the last row/column reusing its neighbour's spacing.

    Args:
      origins: [H, W, 3] NDC-space origins for one image.
    """
    dx = np.sqrt(np.sum((origins[:, :-1, :] - origins[:, 1:, :]) ** 2, -1))
    dx = np.concatenate([dx, dx[:, -1:]], axis=1)
    dy = np.sqrt(np.sum((origins[:-1, :, :] - origins[1:, :, :]) ** 2, -1))
    dy = np.concatenate([dy, dy[-1:, :]], axis=0)
    return (np.sqrt(dx**2 + dy**2) / np.sqrt(12.0))[..., None]
