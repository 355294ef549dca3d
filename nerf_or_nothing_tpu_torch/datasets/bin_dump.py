"""Binary ray-dump dataset: a file of 64-byte records.

Same format and loader as ``nerf_or_nothing_tpu/datasets/bin_dump.py``:
each record is 16 little-endian float32s, origin (3), direction (3),
viewdir (3), radius, near, far, loss_mult, pixel RGB (3). The file is
memory-mapped once and served as one 1 x N x 1 "image", so the test split
is the whole pool as one image. Train batches come from the native C++
loader (``datasets/native_loader.py``) when its library builds, else from
the base class's seeded numpy draw, which ``peek`` and the test split
always use. For ``shared`` ranks the native loader runs one worker, so
that its batches are a function of the file and the seed.
"""

from __future__ import annotations

import numpy as np

from nerf_or_nothing_tpu_torch.datasets.base import Dataset
from nerf_or_nothing_tpu_torch.rays import Rays

RECORD_FLOATS = 16  # 64 bytes

# Module-level switch so that tests can take the numpy path.
USE_NATIVE = True


class BinDataset(Dataset):
    def _load(self) -> None:
        data = np.memmap(self.data_dir, dtype="<f4", mode="r")
        if data.size % RECORD_FLOATS:
            raise ValueError(
                f"{self.data_dir}: size {data.size * 4} bytes is not a "
                f"multiple of the 64-byte record"
            )
        records = data.reshape(-1, RECORD_FLOATS)
        n = records.shape[0]

        def col(a, b):
            return np.asarray(records[:, a:b]).reshape(1, n, 1, b - a)

        self.images = col(13, 16)
        self.rays = Rays(origins=col(0, 3), directions=col(3, 6),
                         viewdirs=col(6, 9), radii=col(9, 10),
                         near=col(10, 11), far=col(11, 12),
                         loss_mult=col(12, 13))
        self._native = None
        if USE_NATIVE and self.split == "train":
            self._native = self._open_native()

    def _open_native(self):
        """The C++ prefetch-ring loader for train batches; None -> numpy."""
        from nerf_or_nothing_tpu_torch.datasets.native_loader import (
            NativeRayLoader,
            native_available,
        )

        if not native_available():
            return None
        try:
            index, count = self.stripe
            # Its workers race for the draws, so that which draw fills
            # which batch varies; ranks that share a batch need one worker.
            return NativeRayLoader(self.data_dir, self.cfg.batch_size,
                                   seed=self.cfg.seed, stripe_index=index,
                                   stripe_count=count,
                                   workers=1 if self.shared else 2)
        except (RuntimeError, OSError):
            return None

    def __next__(self):
        if self._native is not None:
            # The native ring prefetches on its own threads; the base
            # class's prefetch thread is not started.
            return next(self._native)
        return super().__next__()

    def close(self) -> None:
        super().close()
        native, self._native = getattr(self, "_native", None), None
        if native is not None:
            native.close()


def write_bin_dump(path: str, rays: Rays, pixels: np.ndarray) -> None:
    """Write rays and pixels as 64-byte records."""
    n = pixels.shape[0]
    rec = np.zeros((n, RECORD_FLOATS), dtype="<f4")
    rec[:, 0:3] = np.asarray(rays.origins).reshape(n, 3)
    rec[:, 3:6] = np.asarray(rays.directions).reshape(n, 3)
    rec[:, 6:9] = np.asarray(rays.viewdirs).reshape(n, 3)
    rec[:, 9] = np.asarray(rays.radii).reshape(n)
    rec[:, 10] = np.asarray(rays.near).reshape(n)
    rec[:, 11] = np.asarray(rays.far).reshape(n)
    rec[:, 12] = np.asarray(rays.loss_mult).reshape(n)
    rec[:, 13:16] = np.asarray(pixels).reshape(n, 3)
    rec.tofile(path)
