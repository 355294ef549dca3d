#!/usr/bin/env python3
"""Where the train step's time goes on one card: a torch.profiler trace of
a few train steps at Config() (1024 rays, 128 + 128 samples, bf16) on a
synthetic 400x400 Blender scene, through ``train.make_train_step``.

    python3 profile_train.py

Prints one JSON line: the steps' wall time (host clock, each step
synchronised; also without the profiler), the device time summed over all
kernels and copies and its share of the wall time (the rest is the device
idle), the device time of each of the train kernel's launches by name, the
rest of the device time, and, timed alone with CUDA events (median of 7),
the weight packing of one step (``pack_train_params``), the gradient
clipping plus Adam update of one step, and one ``train_level`` call.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

TRAIN_KERNELS = ("train_fwd_kernel", "train_chain_kernel", "dw_gemm",
                 "small_tn_kernel", "reduce_kernel")


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import level_inputs, median_ms, nvidia_smi_line, train_inputs
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype
    from nerf_or_nothing_tpu_torch.rays import Rays
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    scene = tempfile.mkdtemp(prefix="profile_train_")
    write_scene(scene, n_train=2, n_test=1, size=400)
    cfg = Config(data_dir=scene)
    device = torch.device("cuda")
    state = train_lib.init_train_state(cfg, device)
    step_fn = train_lib.make_train_step(cfg)
    with create_dataset("train", scene, cfg) as ds:
        batches = [next(ds) for _ in range(10)]
    batches = [(Rays(*[torch.from_numpy(np.asarray(x)).to(device) for x in r]),
                torch.from_numpy(np.asarray(p)).to(device)) for r, p in batches]

    def steps(bs):
        nonlocal state
        t0 = time.perf_counter()
        for rays, pixels in bs:
            state, _ = step_fn(state, rays, pixels)
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    steps(batches[:3])  # warm-up: builds the kernels, allocator, handles
    plain_wall = steps(batches[3:6])
    n = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = steps(batches[6:6 + n])

    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("aten::")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_s = sum(r[1] for r in rows) / 1e6
    by_kernel = {k: sum(r[1] for r in rows if k in r[0]) / 1e6 / n
                 for k in TRAIN_KERNELS}
    kernel_s = sum(by_kernel.values())

    # Parts timed alone with CUDA events.
    dt = compute_dtype(cfg)
    pack_ms = median_ms(lambda: fl.pack_train_params(state.params, cfg, dt))
    grads = [(torch.randn_like(w) * 1e-3, torch.randn_like(b) * 1e-3)
             for w, b in state.params]
    mu = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in state.params]
    nu = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in state.params]
    params = [(w.clone(), b.clone()) for w, b in state.params]

    def adam():
        g, *_ = train_lib.clip_grads(grads, cfg)
        train_lib.adam_update(params, g, mu, nu, 1e-4, 10, cfg)

    adam_ms = median_ms(adam)
    xs, d, delta = level_inputs(cfg, cfg.batch_size, "t", 1, device)
    pixels, g_scale = train_inputs(cfg, cfg.batch_size, 2, device)
    packed = fl.pack_train_params(state.params, cfg, dt)
    level_ms = median_ms(lambda: fl.train_level_cuda(
        state.params, cfg, xs, d, delta, pixels, g_scale, True, "t",
        packed=packed))
    print(json.dumps({
        "config": "Config()", "batch_size": cfg.batch_size, "steps": n,
        "step_wall_s": wall / n, "step_wall_s_unprofiled": plain_wall / 3,
        "device_busy_s_per_step": device_s / n,
        "device_busy_share": device_s / wall,
        "device_idle_share": 1.0 - device_s / wall,
        "train_kernels_s_per_step": kernel_s,
        "by_kernel_s_per_step": by_kernel,
        "other_device_s_per_step": device_s / n - kernel_s,
        "alone_ms": {"pack_train_params": pack_ms, "clip_and_adam": adam_ms,
                     "train_level_call": level_ms},
        "top": [{"name": nm[:80], "device_ms": us / 1e3 / n, "count": c}
                for nm, us, c in rows[:15]],
        "card": nvidia_smi_line(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
