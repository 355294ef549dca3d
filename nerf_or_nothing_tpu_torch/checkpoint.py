"""Checkpoint reading.

Reads the ``.npz`` snapshots that ``nerf_or_nothing_tpu/checkpoint.py``
writes (``checkpoint_<step:09d>.npz`` holding ``params/w{i}``,
``params/b{i}``, Adam ``mu/*`` and ``nu/*``, ``step`` and ``key``). The
render slice restores the parameters only; saving and the optimizer state
come with the train slice.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.models.mlp import Params, layer_dims

_CKPT_RE = re.compile(r"^checkpoint_(\d+)\.npz$")


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _CKPT_RE.match(f))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def restore_params(path: str, cfg: Config, device="cpu") -> Params:
    """The parameter list of a checkpoint, shape-checked against ``cfg``."""
    dims = layer_dims(cfg)
    params: Params = []
    with np.load(path) as data:
        i = 0
        while f"params/w{i}" in data:
            w, b = data[f"params/w{i}"], data[f"params/b{i}"]
            if i >= len(dims) or w.shape != dims[i] or b.shape != dims[i][1:]:
                want = dims[i] if i < len(dims) else None
                raise ValueError(
                    f"checkpoint shape mismatch at layer {i}: {w.shape} vs {want}"
                )
            params.append((
                torch.tensor(w, dtype=torch.float32, device=device),
                torch.tensor(b, dtype=torch.float32, device=device),
            ))
            i += 1
    if len(params) != len(dims):
        raise ValueError(
            f"checkpoint has {len(params)} layers, config needs {len(dims)}"
        )
    return params


def maybe_restore_params(ckpt_dir: str, cfg: Config, params: Params,
                         device="cpu") -> Params:
    """The newest checkpoint's parameters if one exists, else ``params``."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return params
    return restore_params(path, cfg, device=device)
