"""Dataset framework: load renderings -> generate rays -> batch iterator.

Same contract as ``nerf_or_nothing_tpu/datasets/base.py`` on one process:
subclasses fill ``images`` [N,H,W,3] and ``rays`` (leaves [N,H,W,C]) in
``_load``; the images flatten to a pixel pool, and ``next()`` serves
``batch_size`` pixels drawn with replacement from
``np.random.default_rng(seed + 17 * index + (0 if train else 1))``, so the
batches are byte-equal to the JAX package's. A process reads the stripe
``index::count`` of the pool, as each JAX process takes
``process_index::process_count``: by default (``process_stripe``) its rank
and the size of ``torch.distributed``'s default group (0 of 1 without
one), the launch flags' processes; with ``shared`` stripe 0 of 1, for
ranks that stand for the devices of one JAX process and each draw its
whole batch (``run train --mesh-shape``), which must then be a function
of the seed alone. A background thread prefetches batches into
a bounded queue; ``peek``, ``close`` and the context manager behave as
there. ``image_rays`` serves one image's flat ray grid and ground truth.
Everything is numpy on the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from nerf_or_nothing_tpu_torch.config import Config, DatasetType
from nerf_or_nothing_tpu_torch.rays import Rays


class Dataset:
    """Base dataset: subclasses fill ``self.images`` [N,H,W,3] float32 in
    [0,1] and ``self.rays`` (Rays with leaves [N,H,W,C]) in ``_load``."""

    def __init__(self, split: str, data_dir: str, cfg: Config,
                 shared: bool = False):
        self.split = split
        self.data_dir = data_dir
        self.cfg = cfg
        self.images: np.ndarray = None
        self.rays: Rays = None
        self.shared = shared
        self.stripe = (0, 1) if shared else process_stripe()
        self._load()
        if cfg.linear_color:
            self._linearize()
        self._flatten()
        index, _ = self.stripe
        self._rng = np.random.default_rng(
            cfg.seed + 17 * index + (0 if split == "train" else 1)
        )
        self._queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._thread: Optional[threading.Thread] = None
        self._peeked: Optional[Tuple[Rays, np.ndarray]] = None
        self._stop = threading.Event()

    def _load(self) -> None:
        raise NotImplementedError

    def _linearize(self) -> None:
        """Linear radiance (Config.linear_color): decode the sRGB pixels."""
        from nerf_or_nothing_tpu_torch.ops.math_utils import srgb_to_linear

        self.images = np.asarray(
            srgb_to_linear(self.images).numpy(), np.float32
        )

    def _flatten(self) -> None:
        """Flatten [N,H,W,...] to a pixel pool, this process's stripe."""
        n, h, w = self.images.shape[:3]
        self.num_images, self.height, self.width = n, h, w
        self._set_pool(Rays(*[np.asarray(x).reshape(n * h * w, -1)
                              for x in self.rays]),
                       self.images.reshape(n * h * w, 3))

    def _set_pool(self, flat_rays: Rays, flat_pixels: np.ndarray) -> None:
        index, count = self.stripe
        self._flat_rays = Rays(*[x[index::count] for x in flat_rays])
        self._flat_pixels = flat_pixels[index::count]
        self.pool_size = self._flat_pixels.shape[0]

    def _sample_batch(self) -> Tuple[Rays, np.ndarray]:
        idx = self._rng.integers(0, self.pool_size,
                                 size=(self.cfg.batch_size,))
        rays = Rays(*[x[idx] for x in self._flat_rays])
        return rays, self._flat_pixels[idx]

    def __iter__(self) -> Iterator[Tuple[Rays, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[Rays, np.ndarray]:
        """Next training batch, from the background prefetch thread."""
        if self._peeked is not None:
            batch, self._peeked = self._peeked, None
            return batch
        if self._thread is None:
            if self._stop.is_set():
                raise RuntimeError("dataset is closed")
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self._queue.get()

    def _worker(self) -> None:
        # Bounded puts, so that close() can always join the thread.
        while not self._stop.is_set():
            batch = self._sample_batch()
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def peek(self) -> Tuple[Rays, np.ndarray]:
        """The batch ``next()`` will return, without consuming it: before
        the worker starts, a draw with the generator's state restored;
        after, the next queued batch, kept for ``next()``."""
        if self._peeked is not None:
            return self._peeked
        if self._thread is None:
            rng_state = self._rng.bit_generator.state
            batch = self._sample_batch()
            self._rng.bit_generator.state = rng_state
            return batch
        self._peeked = self._queue.get()
        return self._peeked

    def close(self) -> None:
        """Stop the prefetch worker and join it (idempotent)."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self) -> "Dataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: modules may already be gone

    def image_rays(self, index: int) -> Tuple[Rays, np.ndarray]:
        """Full ray grid + ground truth for one image (test/eval split)."""
        rays = Rays(*[np.asarray(x[index]).reshape(-1, x.shape[-1])
                      for x in self.rays])
        return rays, self.images[index].reshape(-1, 3)

    def image_dims(self, index: int) -> Tuple[int, int]:
        """(height, width) of image ``index``."""
        return self.height, self.width


def process_stripe() -> Tuple[int, int]:
    """(index, count) of this process's stripe: its rank and the number of
    ranks of the default group (``parallel/mesh.py``), JAX's
    ``process_index`` and ``process_count``."""
    from nerf_or_nothing_tpu_torch.parallel import mesh

    return mesh.rank(), mesh.world_size()


def create_dataset(split: str, data_dir: str, cfg: Config,
                   shared: bool = False) -> Dataset:
    """The loader of ``cfg.dataset_loader``: this process's stripe of the
    pool (``process_stripe()``), or with ``shared`` the whole pool and
    batches that every rank sharing them draws alike."""
    from nerf_or_nothing_tpu_torch.datasets import (
        bin_dump,
        blender,
        llff,
        multicam,
    )

    loaders = {
        DatasetType.BLENDER: blender.Blender,
        DatasetType.LLFF: llff.LLFF,
        DatasetType.MULTICAM: multicam.Multicam,
        DatasetType.BIN: bin_dump.BinDataset,
    }
    return loaders[cfg.dataset_loader](split, data_dir, cfg, shared)
