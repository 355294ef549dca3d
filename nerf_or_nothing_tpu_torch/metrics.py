"""Training statistics and logging.

Same contract as ``nerf_or_nothing_tpu/metrics.py``: ``Stats`` holds the
per-step scalars (tensors, on the step's device), and ``MetricsLogger``
writes them as one CSV row (``train_stats.csv``, same columns), one stdout
line (same format) and, when ``torch.utils.tensorboard`` imports, as
TensorBoard scalars.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, NamedTuple, Optional

import numpy as np


class Stats(NamedTuple):
    """Per-step scalars."""

    loss: Any
    losses: Any             # per level
    weight_l2: Any
    psnr: Any
    psnrs: Any              # per level
    grad_norm: Any
    grad_abs_max: Any
    grad_norm_clipped: Any
    learning_rate: Any


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class MetricsLogger:
    """CSV + stdout + optional TensorBoard writer with rays/s throughput
    between logged steps (host clock)."""

    def __init__(self, log_dir: Optional[str] = None, batch_size: int = 0,
                 tensorboard: bool = True):
        self._csv_writer = None
        self._csv_file = None
        self._tb = None
        self._batch_size = batch_size
        self._last_time: Optional[float] = None
        self._last_step: int = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_file = open(
                os.path.join(log_dir, "train_stats.csv"), "a", newline=""
            )
            self._csv_writer = csv.writer(self._csv_file)
            if self._csv_file.tell() == 0:
                self._csv_writer.writerow(
                    ["step", "loss", "psnr", "grad_norm", "grad_abs_max",
                     "grad_norm_clipped", "weight_l2", "lr", "rays_per_sec"]
                )
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
                except Exception:
                    self._tb = None

    def log(self, step: int, stats: Stats, quiet: bool = False) -> dict:
        now = time.perf_counter()
        rays_per_sec = 0.0
        if self._last_time is not None and step > self._last_step:
            rays_per_sec = (
                (step - self._last_step) * self._batch_size
                / (now - self._last_time)
            )
        self._last_time = now
        self._last_step = step

        row = {
            "step": step,
            "loss": float(stats.loss),
            "psnr": float(stats.psnr),
            "grad_norm": float(stats.grad_norm),
            "grad_abs_max": float(stats.grad_abs_max),
            "grad_norm_clipped": float(stats.grad_norm_clipped),
            "weight_l2": float(stats.weight_l2),
            "lr": float(stats.learning_rate),
            "rays_per_sec": rays_per_sec,
        }
        losses = _host(stats.losses)
        if self._csv_writer is not None:
            self._csv_writer.writerow(list(row.values()))
            self._csv_file.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(f"train/{k}", v, step)
            for lvl, l in enumerate(losses):
                self._tb.add_scalar(f"train/loss_level{lvl}", float(l), step)
        if not quiet:
            per_level = "/".join(f"{l:.5f}" for l in losses)
            print(
                f"step {step:>7d}  loss {row['loss']:.5f} ({per_level})  "
                f"psnr {row['psnr']:.2f}  |g| {row['grad_norm']:.3f}  "
                f"lr {row['lr']:.2e}  {rays_per_sec:,.0f} rays/s",
                flush=True,
            )
        return row

    def close(self):
        if self._csv_file is not None:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
