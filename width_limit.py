#!/usr/bin/env python3
"""The memory of wide MLPs on the card, in bf16 and in f32: the
workspace each kernel asks for at ``Config(net_width=W)`` (depth 8,
net_width_condition 128) for W in ``WORKSPACE_WIDTHS``, from the kernels'
own workspace functions (``train_level``, the same as
``train_level_twopass``, and ``mlp_bwd`` at R=1024 x S=128, a level of a
train step, with the split partials' share: since the dW GEMMs add their
splits into the output, those of the small products only (the heads'
dW and db, the direction rows); ``render_level`` and
``mlp_fwd`` at R=16384, a render chunk), then the widest of these MLPs
whose train step fits: ``run train`` (batch 1024 x 128 samples a level)
for one step on a 48-px synthetic scene, with W searched in multiples of
256.

    python3 width_limit.py

Each attempt is a child process (``run.main(["train", ...])``), so that one
that runs out of device memory leaves nothing behind. An attempt passes when
the step ends and its loss is finite; it fails when the run raises
``torch.OutOfMemoryError`` (the workspace, the weights or the optimizer
state do not fit). Any other failure, or a non-finite loss, is a fault and
ends the script with exit code 1. W doubles from ``LO`` (which must
step) until an attempt fails (or reaches ``HI``), then the gap is halved
down to ``STEP``.
Prints one JSON line a workspace width and dtype, one an attempt (the
step's seconds, the run's peak ``torch.cuda.max_memory_allocated``, the
last lines of a failure's error) and one line a dtype with the largest W that stepped and the smallest that
ran out of memory (with the caching allocator's settings,
``PYTORCH_CUDA_ALLOC_CONF``, which the children inherit), the card's name
and power limit, and as the last line ``{"ok": true, ...}``. Needs one
CUDA card; exits 1 without one.
"""

from __future__ import annotations

import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time

CHILD = """
import json, sys, time
import torch
from nerf_or_nothing_tpu_torch import run
t0 = time.perf_counter()
rc = run.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                  "max_memory_allocated": torch.cuda.max_memory_allocated()}))
"""
DTYPES = ("bfloat16", "float32")
WORKSPACE_WIDTHS = (1024, 2048, 3072, 4096, 6144, 8192)
LO = 2048  # the first attempt
HI = 12288  # the widest attempt
STEP = 256  # the search's resolution
TIMEOUT_S = 900  # one attempt


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def attempt(scene: str, work: str, W: int, dtype: str) -> dict:
    """One ``run train`` step at net_width W in a child process: "steps",
    "out_of_memory" or "fault", with what the child reported."""
    log = os.path.join(work, f"w{W}_{dtype}")
    args = [f"--data-dir={scene}", f"--net-width={W}",
            f"--compute-dtype={dtype}", "--max-steps=1", "--print-every=1",
            "--save-every=1", "--test-render-interval=0", "--device=cuda",
            f"--checkpoint-dir={log}"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD, "train", *args],
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    res = {"net_width": W, "dtype": dtype,
           "wall_s": time.perf_counter() - t0}
    if proc.returncode == 0:
        res.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        with open(os.path.join(log, "train_stats.csv")) as f:
            res["loss"] = float(list(csv.DictReader(f))[-1]["loss"])
        res["result"] = "steps" if math.isfinite(res["loss"]) else "fault"
    else:
        tail = proc.stderr.strip().splitlines()[-3:]
        res["error"] = tail
        res["result"] = ("out_of_memory" if "OutOfMemoryError" in proc.stderr
                         else "fault")
    for name in os.listdir(log) if os.path.isdir(log) else ():
        if name.endswith(".npz"):
            os.unlink(os.path.join(log, name))  # GBs of weights a width
    emit({"attempt": res})
    return res


def workspace_sizes() -> None:
    """One line a width of ``WORKSPACE_WIDTHS`` and dtype: the bytes each
    kernel's workspace function asks for (see the module's docstring)."""
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import num_params

    _, train_ws, _ = fl._train_library("train_level")
    bwd_lib, _ = fm._bwd_library()
    _, render_ws = fl._wide_render_library()
    _, fwd_ws = fm._wide_fwd_library()
    R, S, R_render = 1024, 128, 16384
    for W in WORKSPACE_WIDTHS:
        for dtype in DTYPES:
            cfg = Config(net_width=W, compute_dtype=dtype)
            code = 1 if dtype == "bfloat16" else 0
            D, Wc, Dc = (cfg.net_depth, cfg.net_width_condition,
                         cfg.net_depth_condition)
            kx = fl.padded_location_features(cfg)
            n_out, splits = num_params(cfg), fl.train_splits(R * S)
            emit({"workspace": f"net_width={W}", "dtype": dtype, "R": R,
                  "S": S, "n_params": n_out,
                  "train_level_bytes": train_ws(code, R, S, D, W, Wc, Dc, kx,
                                                splits, n_out,
                                                cfg.direction_features),
                  "mlp_bwd_bytes": bwd_lib.mlp_bwd_workspace(
                      code, R, S, D, W, Wc, Dc, kx, splits, n_out,
                      cfg.num_rgb_channels + cfg.num_density_channels,
                      cfg.direction_features, cfg.num_density_channels),
                  "split_partials_bytes": splits * 4 * (
                      W * cfg.num_density_channels
                      + cfg.direction_features * Wc
                      + Wc * cfg.num_rgb_channels
                      + cfg.num_rgb_channels + cfg.num_density_channels),
                  "render_R": R_render,
                  "render_level_bytes": render_ws(code, R_render, S, W, Wc,
                                                  kx),
                  "mlp_fwd_bytes": fwd_ws(code, R_render, S, W, Wc, kx)})


def search(scene: str, work: str, dtype: str) -> dict:
    """The largest W (a multiple of ``STEP``) that steps, from ``LO``
    (which must step) up to ``HI``."""
    def ok(W):
        res = attempt(scene, work, W, dtype)
        if res["result"] == "fault":
            raise SystemExit(f"width_limit: a fault at net_width {W} "
                             f"({dtype}): {res}")
        return res["result"] == "steps"

    if not ok(LO):
        raise SystemExit(f"width_limit: net_width {LO} ({dtype}) does not "
                         "step")
    good, bad = LO, None
    while bad is None and good < HI:
        W = min(HI, 2 * good)
        if ok(W):
            good = W
        else:
            bad = W
    while bad is not None and bad - good > STEP:
        W = (good + bad) // 2 // STEP * STEP
        if ok(W):
            good = W
        else:
            bad = W
    return {"dtype": dtype, "largest_stepping": good,
            "smallest_out_of_memory": bad,
            "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("width_limit: no CUDA device", file=sys.stderr)
        return 1
    if argv:
        raise SystemExit(f"width_limit: takes no arguments, got {argv}")
    from nerf_or_nothing_tpu_torch.kernels import build
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    build.build_all(build.SOURCES)
    workspace_sizes()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    work = tempfile.mkdtemp(prefix="width_limit_")
    scene = write_scene(os.path.join(work, "scene"), n_train=2, n_test=1,
                        size=48)
    for dtype in DTYPES:
        emit(search(scene, work, dtype))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
