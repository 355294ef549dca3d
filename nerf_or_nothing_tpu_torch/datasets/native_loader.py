"""ctypes binding to the native C++ ray-batch loader (``native/ray_loader.cpp``).

The loader mmaps a dump of 64-byte ray records (``datasets/bin_dump.py``)
and serves batches from a ring that worker threads prefetch, with its own
seeded generator. The port builds its own copy of the library from
``native/ray_loader.cpp`` with the flags of ``native/Makefile`` at first
use, into the gitignored ``nerf_or_nothing_tpu_torch/build/`` (named by a
hash of the source and flags, written under a temporary name and moved into
place), so it never writes into ``native/``. ``load_library`` returns None
when there is no C++ compiler or the build fails; ``BinDataset`` then
serves batches with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from nerf_or_nothing_tpu_torch.kernels.build import BUILD_DIR
from nerf_or_nothing_tpu_torch.rays import Rays

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ray_loader.cpp"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
LDFLAGS = ["-shared", "-pthread"]

_LIB: Dict[str, ctypes.CDLL] = {}


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS)
                       .encode())
    return BUILD_DIR / f"libnonray_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the loader unless it is built; None if that fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, str(SOURCE), "-o", tmp,
           *LDFLAGS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if it cannot be built."""
    if "lib" in _LIB:
        return _LIB["lib"]
    path = _build() if SOURCE.exists() else None
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.rayloader_open.restype = ctypes.c_void_p
    lib.rayloader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.rayloader_num_records.restype = ctypes.c_long
    lib.rayloader_num_records.argtypes = [ctypes.c_void_p]
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rayloader_next.restype = ctypes.c_int
    lib.rayloader_next.argtypes = [ctypes.c_void_p] + [fp] * 8
    lib.rayloader_close.restype = None
    lib.rayloader_close.argtypes = [ctypes.c_void_p]
    _LIB["lib"] = lib
    return lib


def native_available() -> bool:
    return load_library() is not None


_FIELDS = ("origins", "directions", "viewdirs", "radii", "near", "far",
           "loss_mult", "pixels")


class NativeRayLoader:
    """Iterator of (Rays, pixels) numpy batches from the C++ prefetch ring.
    With one worker the batches are a function of the file and the seed."""

    def __init__(self, path: str, batch_size: int, seed: int = 0,
                 stripe_index: int = 0, stripe_count: int = 1,
                 slots: int = 4, workers: int = 2):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable (build failed)")
        self._lib = lib
        self._batch = batch_size
        self._handle = lib.rayloader_open(
            path.encode(), batch_size, seed, stripe_index, stripe_count,
            slots, workers,
        )
        if not self._handle:
            raise FileNotFoundError(
                f"cannot open {path} (missing or not a 64-byte-record file)"
            )
        self.num_records = lib.rayloader_num_records(self._handle)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[Rays, np.ndarray]:
        n = self._batch
        bufs = {k: np.empty((n, 3 if k in ("origins", "directions",
                                           "viewdirs", "pixels") else 1),
                            np.float32) for k in _FIELDS}
        fp = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.rayloader_next(
            self._handle, *[bufs[k].ctypes.data_as(fp) for k in _FIELDS])
        if rc != n:
            raise RuntimeError(f"rayloader_next returned {rc}")
        pixels = bufs.pop("pixels")
        return Rays(**bufs), pixels

    def close(self):
        """Stop the worker threads and unmap the file (idempotent)."""
        if getattr(self, "_handle", None):
            self._lib.rayloader_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
