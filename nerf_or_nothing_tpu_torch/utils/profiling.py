"""Tracing, timing and roofline utilities of the port.

The names of ``nerf_or_nothing_tpu/utils/profiling.py``:

- ``trace()``: a context manager around ``torch.profiler`` (CPU and, on a
  card, CUDA activities) writing a Chrome trace into a directory;
- ``sync()`` and ``timed()``: completion of the card's work, and mean
  seconds per call (CUDA events on the card, the host clock on the CPU);
- ``CHIP_PEAKS`` / ``chip_peaks()``: published peak rates of the card;
- ``mlp_roofline()``: the JAX package's FLOPs / bytes model of the fused
  MLP, with its formula and keys.

Beside them, the counts the port's bounds use (``chip_smoke.py``,
``profile_train.py``): ``level_flops`` and its relatives count the view
layer's direction rows once per ray, as the kernels multiply them, where
``mlp_roofline`` charges them to every sample.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Tuple

import torch

from nerf_or_nothing_tpu_torch.models.mlp import layer_dims


def _cuda_tensors(tree):
    if torch.is_tensor(tree):
        return [tree] if tree.is_cuda else []
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _cuda_tensors(x)]
    if isinstance(tree, dict):
        return _cuda_tensors(list(tree.values()))
    return []


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace what runs inside the block with ``torch.profiler`` (CPU
    activity, and CUDA activity where a card is present) and write it to
    ``log_dir`` as a Chrome trace (``trace_<pid>_<ns>.json``), viewable in
    Perfetto or ``chrome://tracing``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def sync(tree=None) -> None:
    """Wait for the card: for the devices of the CUDA tensors in ``tree``,
    or, without one, for the current card when CUDA is initialised."""
    devices = {t.device for t in _cuda_tensors(tree)}
    if tree is None and torch.cuda.is_available() and (
            torch.cuda.is_initialized()):
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


def timed(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> float:
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls: CUDA
    events around the calls when they return CUDA tensors (or CUDA is in
    use), else the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync(out)
    cuda = bool(_cuda_tensors(out)) or (
        torch.cuda.is_available() and torch.cuda.is_initialized())
    if cuda:
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters


# Published dense peaks (NVIDIA H100 data sheets, SXM5 and PCIe): bf16
# tensor-core FLOP/s, f32 (non-tensor) FLOP/s, HBM bytes/s. Matched by
# name, the first key found in the card's name.
CHIP_PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100": (989e12, 67e12, 3.35e12),  # SXM
}


def device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def card_peaks(name: str):
    """(the ``CHIP_PEAKS`` key, (bf16 FLOP/s, f32 FLOP/s, bytes/s)) of a
    card by name; an H100 of no listed kind is taken for an SXM card."""
    for key, peaks in CHIP_PEAKS.items():
        if key in name:
            return key, peaks
    return "H100 (assumed SXM)", CHIP_PEAKS["H100"]


def chip_peaks(device=None) -> Tuple[float, float]:
    """(peak dense bf16 FLOP/s, memory bytes/s) of ``device`` (default:
    the card if there is one), as the JAX package's ``chip_peaks``; a
    device no entry names gets the same conservative (1e11, 1e10)."""
    kind = device_kind(device)
    for key, (bf16, _, bw) in CHIP_PEAKS.items():
        if key in kind:
            return bf16, bw
    return (1e11, 1e10)


def mlp_roofline(cfg, num_rows: int, backward: bool = True,
                 device=None) -> dict:
    """FLOPs / bytes / time lower bound for the fused MLP, the JAX
    package's model: num_rows = rays * samples (one level); every layer
    (the view layer's direction rows too) once per row, three times with
    the backward; bytes: inputs (IPE features + direction features) and
    rgb + sigma out per row, twice with the backward, and one pass over the
    parameters."""
    dims = layer_dims(cfg)
    matmul_flops = 2 * sum(i * o for i, o in dims) * num_rows
    total_flops = matmul_flops * (3 if backward else 1)
    param_bytes = sum(i * o + o for i, o in dims) * 4
    io_bytes = num_rows * (
        (cfg.location_features + cfg.direction_features) * 4
        + 4 * 4
    ) * (2 if backward else 1) + param_bytes
    peak_flops, peak_bw = chip_peaks(device)
    t_compute = total_flops / peak_flops
    t_memory = io_bytes / peak_bw
    return {
        "flops": total_flops,
        "bytes": io_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_roofline_s": max(t_compute, t_memory),
        "compute_bound": t_compute >= t_memory,
    }


def level_flops(cfg, R: int, S: int) -> int:
    """FLOPs of one level's MLP products over R rays of S samples: every
    layer once per sample, except the first view layer's direction rows,
    which both the TPU kernel and the port's multiply once per ray
    (d @ W_bot, broadcast over the ray's samples)."""
    per_sample = sum(i * o for i, o in layer_dims(cfg))
    per_ray = cfg.direction_features * cfg.net_width_condition
    return 2 * ((per_sample - per_ray) * R * S + per_ray * R)


def train_level_flops(cfg, R: int, S: int) -> int:
    """FLOPs one train level needs: the forward (``level_flops``), dW (the
    same count again) and the g-chain, which is the forward without layer
    0, the skip layers' x rows and the view layer's direction rows (there
    is no dX or dD)."""
    lx, W = cfg.location_features, cfg.net_width
    n_skip = sum(1 for i in range(1, cfg.net_depth) if i % cfg.skip_layer == 0)
    chain = (sum(i * o for i, o in layer_dims(cfg)) - lx * W * (1 + n_skip)
             - cfg.direction_features * cfg.net_width_condition)
    return 2 * level_flops(cfg, R, S) + 2 * chain * R * S


def mlp_fwd_flops(cfg, R: int, S: int) -> int:
    """FLOPs of one ``mlp_fwd`` launch: ``level_flops`` (the direction
    rows once per ray)."""
    return level_flops(cfg, R, S)


def dx_flops(cfg, R: int, S: int) -> int:
    """The chain into layer 0 and the skip layers' x rows (dX) and the
    direction rows' product (dD), which only ``input_grads`` needs."""
    n_x = 1 + sum(1 for i in range(1, cfg.net_depth) if i % cfg.skip_layer == 0)
    return 2 * (cfg.location_features * cfg.net_width * n_x * R * S
                + cfg.direction_features * cfg.net_width_condition * R)


def mlp_bwd_flops(cfg, R: int, S: int, input_grads: bool) -> int:
    """FLOPs of one ``mlp_bwd`` launch: the forward it recomputes, dW and
    the g-chain (``train_level_flops``, which counts the forward once), and
    with ``input_grads`` dX/dD."""
    return (train_level_flops(cfg, R, S)
            + (dx_flops(cfg, R, S) if input_grads else 0))


def full_grad_step_flops(cfg, R: int, S: int) -> int:
    """The work one train step at stop_level_grad=False needs: per level
    the forward, the g-chain and dW (no recompute), and dX/dD for every
    level but the first."""
    return (cfg.num_levels * train_level_flops(cfg, R, S)
            + (cfg.num_levels - 1) * dx_flops(cfg, R, S))
