"""Dataset framework: load renderings -> generate rays -> per-image grids.

Same contract as ``nerf_or_nothing_tpu/datasets/base.py`` for the test
split: subclasses fill ``images`` [N,H,W,3] and ``rays`` (leaves
[N,H,W,C]) in ``_load``; ``image_rays`` serves one image's flat ray grid
and ground truth. Everything is numpy on the host. The train split's
random-pixel batches, its prefetch thread and per-rank striping come with
the train slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nerf_or_nothing_tpu_torch.config import Config, DatasetType
from nerf_or_nothing_tpu_torch.rays import Rays


class Dataset:
    """Base dataset: subclasses fill ``self.images`` [N,H,W,3] float32 in
    [0,1] and ``self.rays`` (Rays with leaves [N,H,W,C]) in ``_load``."""

    def __init__(self, split: str, data_dir: str, cfg: Config):
        self.split = split
        self.data_dir = data_dir
        self.cfg = cfg
        self.images: np.ndarray = None
        self.rays: Rays = None
        self._load()
        if cfg.linear_color:
            self._linearize()
        self.num_images, self.height, self.width = self.images.shape[:3]

    def _load(self) -> None:
        raise NotImplementedError

    def _linearize(self) -> None:
        """Linear radiance (Config.linear_color): decode the sRGB pixels."""
        from nerf_or_nothing_tpu_torch.ops.math_utils import srgb_to_linear

        self.images = np.asarray(
            srgb_to_linear(self.images).numpy(), np.float32
        )

    def close(self) -> None:
        """Nothing to release on the test split (the context-manager form
        matches the train split's, which owns a prefetch thread)."""

    def __enter__(self) -> "Dataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def image_rays(self, index: int) -> Tuple[Rays, np.ndarray]:
        """Full ray grid + ground truth for one image (test/eval split)."""
        rays = Rays(*[np.asarray(x[index]).reshape(-1, x.shape[-1])
                      for x in self.rays])
        return rays, self.images[index].reshape(-1, 3)

    def image_dims(self, index: int) -> Tuple[int, int]:
        """(height, width) of image ``index``."""
        return self.height, self.width


def create_dataset(split: str, data_dir: str, cfg: Config) -> Dataset:
    """Dataset factory. The render slice ports the Blender loader; LLFF,
    Multicam and the bin dump come with the datasets slice."""
    from nerf_or_nothing_tpu_torch.datasets import blender

    if cfg.dataset_loader != DatasetType.BLENDER:
        raise NotImplementedError(
            f"dataset loader {cfg.dataset_loader.value!r} is not ported yet "
            "(ROADMAP queue A, datasets)"
        )
    return blender.Blender(split, data_dir, cfg)
