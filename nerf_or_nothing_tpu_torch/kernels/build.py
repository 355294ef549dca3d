"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on first use into a shared library with a plain C
interface, under ``nerf_or_nothing_tpu_torch/build/`` (listed in
``.gitignore``), named by a hash of the source, the shared headers in
``csrc/`` and the flags, so an edited source or header rebuilds and an
unchanged one loads at once. ``build_all`` starts one nvcc per source, all
at once; the first ``load`` of any kernel builds all of ``SOURCES`` that
way. Nothing here runs at import time: the CPU tests import every module
of the package on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

SOURCES = ("render_level", "train_level", "train_level_twopass", "mlp_fwd",
           "mlp_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}
# source path -> {"seconds": build time (0.0 when loaded from the cache),
#                 "log": nvcc/ptxas output}
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    """The nvcc of the CUDA toolkit that PyTorch found, else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_path(name: str, source: Optional[os.PathLike] = None) -> Path:
    """``source`` (another version of a kernel, for timing versions in
    turns), else ``csrc/<name>.cu``."""
    return Path(source).resolve() if source else CSRC_DIR / f"{name}.cu"


def library_path(name: str, source: Optional[os.PathLike] = None) -> Path:
    src = source_path(name, source)
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, source: Optional[os.PathLike] = None):
    """Start nvcc for one source; None when its library is already built."""
    src, out = source_path(name, source), library_path(name, source)
    if out.exists():
        BUILD_INFO.setdefault(str(src), {"seconds": 0.0, "log": "cached"})
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return src, out, tmp, proc, time.perf_counter()


def _finish(started) -> Optional[str]:
    """Wait for one nvcc; the error text if it failed."""
    if started is None:
        return None
    src, out, tmp, proc, t0 = started
    log, _ = proc.communicate()
    BUILD_INFO[str(src)] = {"seconds": time.perf_counter() - t0, "log": log}
    if proc.returncode != 0:
        os.unlink(tmp)
        return f"nvcc failed for {src.name} ({proc.returncode}):\n{log}"
    os.replace(tmp, out)
    return None


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile the sources ``csrc/<name>.cu`` that are not built yet, one
    nvcc process per source, all started together."""
    errors = [e for e in map(_finish, [_start(n) for n in names]) if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def build(name: str, source: Optional[os.PathLike] = None) -> Path:
    """Compile the source unless its library is already built."""
    error = _finish(_start(name, source))
    if error:
        raise RuntimeError(error)
    return library_path(name, source)


def load(name: str, source: Optional[os.PathLike] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of ``source``), built
    on first use, together with the other ``SOURCES`` that are not built
    yet."""
    key = str(source_path(name, source))
    lib = _LIBS.get(key)
    if lib is None:
        if source is None and name in SOURCES:
            build_all(SOURCES)
        lib = ctypes.CDLL(str(build(name, source)))
        _LIBS[key] = lib
    return lib
