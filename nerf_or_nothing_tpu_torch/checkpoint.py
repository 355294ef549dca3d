"""Checkpoints: atomic ``.npz`` snapshots of the train state.

Same files as ``nerf_or_nothing_tpu/checkpoint.py``:
``checkpoint_<step:09d>.npz`` holding ``step`` (int32), ``key``,
``params/w{i}``, ``params/b{i}`` and the Adam moments ``mu/*``, ``nu/*``;
written to a temporary file and renamed, the newest 3 kept. A torch
generator has no threefry key, so the port writes ``key`` as
uint32[2] = (seed, step), which the JAX package reads as a raw key; on
restore the port reseeds its generator from (seed, step)
(``train.step_seed``), whatever ``key`` holds. In a data-parallel group
rank 0 alone writes (the state is the same on every rank); every rank
restores the same file, and ``run`` then broadcasts rank 0's state
(``parallel/mesh.replicate_state``). A tensor-parallel grid writes the
whole model, which every rank gathers first (``mesh.gather_state``), and
shards it again after a restore (``mesh.shard_state``).
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Optional

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.models.mlp import Params, layer_dims
from nerf_or_nothing_tpu_torch.parallel import mesh

_CKPT_RE = re.compile(r"^checkpoint_(\d+)\.npz$")


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _CKPT_RE.match(f))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def restore_params(path: str, cfg: Config, device="cpu") -> Params:
    """The parameter list of a checkpoint, shape-checked against ``cfg``."""
    with np.load(path) as data:
        return _params_from(data, cfg, device)


def _params_from(data, cfg: Config, device) -> Params:
    dims = layer_dims(cfg)
    params: Params = []
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


def state_arrays(state, seed: int) -> dict:
    """The checkpoint's arrays of a train state, by name (numpy)."""
    out = {
        "step": np.asarray(state.step, np.int32),
        "key": np.asarray([seed & 0xFFFFFFFF, state.step & 0xFFFFFFFF],
                          np.uint32),
    }
    for name, tree in (("params", state.params), ("mu", state.mu),
                       ("nu", state.nu)):
        for i, (w, b) in enumerate(tree):
            out[f"{name}/w{i}"] = w.detach().cpu().numpy()
            out[f"{name}/b{i}"] = b.detach().cpu().numpy()
    return out


def save_checkpoint(ckpt_dir: str, state, cfg: Config, keep: int = 3) -> str:
    """Atomic write of the whole train state; keeps the newest ``keep``.
    Writes on rank 0 only; elsewhere returns ``""``."""
    if mesh.rank() != 0:
        return ""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"checkpoint_{state.step:09d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **state_arrays(state, cfg.seed))
    os.replace(tmp, path)
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _CKPT_RE.match(f))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def restore_checkpoint(path: str, cfg: Config, device="cpu"):
    """The whole train state of a checkpoint (shape-checked against
    ``cfg``), on ``device``, with its generator reseeded for the step."""
    with np.load(path) as data:
        return state_from_arrays(data, cfg, device)


def state_from_arrays(data, cfg: Config, device="cpu"):
    """The train state of ``state_arrays``' names (a dict or an npz)."""
    from nerf_or_nothing_tpu_torch.train import TrainState, step_seed

    device = torch.device(device)
    params = _params_from(data, cfg, device)
    step = int(data["step"])
    moments = []
    for name in ("mu", "nu"):
        moments.append([
            (torch.tensor(data[f"{name}/w{i}"], dtype=torch.float32,
                          device=device),
             torch.tensor(data[f"{name}/b{i}"], dtype=torch.float32,
                          device=device))
            for i in range(len(params))
        ])
    for (w, b), (mw, mb) in zip(params * 2, moments[0] + moments[1]):
        if mw.shape != w.shape or mb.shape != b.shape:
            raise ValueError(f"checkpoint moment shape {tuple(mw.shape)} "
                             f"vs {tuple(w.shape)}")
    gen = torch.Generator(device=device).manual_seed(step_seed(cfg.seed, step))
    return TrainState(step, params, moments[0], moments[1], gen)


def maybe_restore(ckpt_dir: str, cfg: Config, template, device="cpu"):
    """The newest checkpoint's train state if one exists, else
    ``template``."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return template
    return restore_checkpoint(path, cfg, device=device)
