"""The mip-NeRF MLP: parameter list, init, and batched forward.

Same architecture and parameter layout as ``nerf_or_nothing_tpu/models/
mlp.py``: a list of (kernel [fan_in, fan_out], bias [fan_out]) f32 tensors
in layer order (trunk 0..D-1, density head, view 0..Dc-1, rgb head):

  trunk: net_depth layers of net_width, ReLU, the encoded position
         re-concatenated at every layer i with i % skip_layer == 0, i > 0;
  density head: 1 linear unit off the trunk;
  view branch: concat(trunk_out, encoded_dir) -> net_depth_condition
         layers of net_width_condition, ReLU -> 3 linear RGB units.

``apply_mlp`` rounds operands to the compute dtype and multiplies them in
f32 (bf16 products are exact in f32, so this is bf16 operands with f32
accumulation, as ``preferred_element_type=f32`` gives in JAX). A bf16
``torch.matmul`` would round its output to bf16 and is not used.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.ops.math_utils import glorot_uniform

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def layer_dims(cfg: Config) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) per layer in layer order."""
    loc = cfg.location_features
    dims: List[Tuple[int, int]] = [(loc, cfg.net_width)]
    for i in range(1, cfg.net_depth):
        fan_in = (
            cfg.net_width + loc if i % cfg.skip_layer == 0 else cfg.net_width
        )
        dims.append((fan_in, cfg.net_width))
    dims.append((cfg.net_width, cfg.num_density_channels))
    dims.append(
        (cfg.net_width + cfg.direction_features, cfg.net_width_condition)
    )
    for _ in range(1, cfg.net_depth_condition):
        dims.append((cfg.net_width_condition, cfg.net_width_condition))
    dims.append((cfg.net_width_condition, cfg.num_rgb_channels))
    return dims


def init_mlp(generator: torch.Generator, cfg: Config, device="cpu") -> Params:
    """Glorot-uniform weights, zero biases, drawn from ``generator``."""
    params: Params = []
    for fan_in, fan_out in layer_dims(cfg):
        w = glorot_uniform(generator, fan_in, fan_out, (fan_in, fan_out),
                           device=device)
        b = torch.zeros((fan_out,), dtype=torch.float32, device=device)
        params.append((w, b))
    return params


def num_params(cfg: Config) -> int:
    return sum(i * o + o for i, o in layer_dims(cfg))


def dense(h: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """h @ w with operands rounded to ``dt`` and an f32 product/sum."""
    return h.to(dt).float() @ w.to(dt).float()


def apply_mlp(params: Params, cfg: Config, x: torch.Tensor,
              dir_enc: torch.Tensor, compute_dtype=torch.float32):
    """Batched forward.

    Args:
      x: [..., S, location_features] IPE-encoded positions.
      dir_enc: [..., direction_features] PE-encoded direction, one per ray,
        broadcast over its samples.
    Returns:
      raw_rgb [..., S, 3], raw_density [..., S, 1] in f32.
    """
    dt = compute_dtype
    inputs = x.to(dt)
    h = inputs
    for i in range(cfg.net_depth):
        if i % cfg.skip_layer == 0 and i > 0:
            h = torch.cat([h, inputs], dim=-1)
        w, b = params[i]
        h = torch.relu(dense(h, w, dt) + b).to(dt)

    w, b = params[cfg.net_depth]
    raw_density = dense(h, w, dt) + b

    d = dir_enc[..., None, :].to(dt).expand(*h.shape[:-1], dir_enc.shape[-1])
    h = torch.cat([h, d], dim=-1)
    for i in range(cfg.net_depth_condition):
        w, b = params[cfg.net_depth + 1 + i]
        h = torch.relu(dense(h, w, dt) + b).to(dt)
    w, b = params[cfg.net_depth + 1 + cfg.net_depth_condition]
    raw_rgb = dense(h, w, dt) + b
    return raw_rgb.float(), raw_density.float()


# Flat import/export: all weight matrices (row-major, [out, in]) then all
# bias vectors, the layout of the JAX package's export_flat.


def export_flat(params: Params) -> np.ndarray:
    ws = [w.detach().cpu().numpy().T.reshape(-1) for w, _ in params]
    bs = [b.detach().cpu().numpy().reshape(-1) for _, b in params]
    return np.concatenate(ws + bs)


def import_flat(flat: np.ndarray, cfg: Config, device="cpu") -> Params:
    dims = layer_dims(cfg)
    flat = np.asarray(flat, np.float32)
    off = 0
    mats = []
    for fan_in, fan_out in dims:
        n = fan_in * fan_out
        mats.append(np.ascontiguousarray(
            flat[off : off + n].reshape(fan_out, fan_in).T
        ))
        off += n
    params: Params = []
    for (_, fan_out), w in zip(dims, mats):
        b = flat[off : off + fan_out]
        off += fan_out
        params.append((torch.from_numpy(w).to(device),
                       torch.from_numpy(b.copy()).to(device)))
    if off != flat.size:
        raise ValueError(f"flat vector has {flat.size} values, config "
                         f"needs {off}")
    return params


def params_from_jax(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                    device="cpu") -> Params:
    """Carry a JAX parameter list [(w [in, out], b [out]), ...] (as numpy
    arrays) across: same layout, f32 tensors on ``device``."""
    return [
        (torch.tensor(np.asarray(w, np.float32), device=device),
         torch.tensor(np.asarray(b, np.float32), device=device))
        for w, b in pairs
    ]


def layer_sizes(cfg: Config) -> List[int]:
    """Flat per-tensor sizes, weights then biases."""
    dims = layer_dims(cfg)
    return [i * o for i, o in dims] + [o for _, o in dims]
