#!/usr/bin/env python3
"""Where the render path's time goes on one card: a torch.profiler trace of
one 400x400 view at Config() through ``eval.render_image``.

    python3 profile_render.py

Prints one JSON line: the view's wall time (host clock, synchronised;
also without the profiler), the device time summed over all kernels and
copies, its share of the wall time and the rest (the device idle share),
the render kernel's device time in all and per launch (bf16: the wgmma
forward of ``csrc/forward_wg.cuh``), and the top device events with their
counts.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi_line
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    size = 400
    scene = tempfile.mkdtemp(prefix="profile_render_")
    write_scene(scene, n_train=1, n_test=1, size=size)
    cfg = Config(data_dir=scene)
    device = torch.device("cuda")
    params = init_mlp(torch.Generator().manual_seed(0), cfg, device=device)
    with create_dataset("test", scene, cfg) as ds:
        rays, _ = ds.image_rays(0)
    render_fn = make_render_fn(cfg)

    def view():
        render_image(render_fn, params, rays, size, size,
                     cfg.render_chunk_size, device=device)
        torch.cuda.synchronize()

    view()  # warm-up: builds the kernel, allocator, cuBLAS handles
    t0 = time.perf_counter()
    view()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        wall = time.perf_counter() - t0

    # Device-side events only (kernels, copies): the aten ops that launch
    # them report the same time again, so they are left out by name.
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
    kernel_s = sum(r[1] for r in rows if "render_level" in r[0]) / 1e6
    kernel_n = sum(r[2] for r in rows if "render_level" in r[0])
    print(json.dumps({
        "view": [size, size], "config": "Config()",
        "wall_s": wall, "wall_s_unprofiled": plain_wall,
        "device_busy_s": device_s,
        "device_busy_share": device_s / wall,
        "device_idle_share": 1.0 - device_s / wall,
        "render_level_s": kernel_s,
        "render_level_launches": kernel_n,
        "render_level_ms_per_launch": kernel_s * 1e3 / max(kernel_n, 1),
        "other_device_s": device_s - kernel_s,
        "top": [{"name": n[:80], "device_ms": us / 1e3, "count": c}
                for n, us, c in rows[:15]],
        "card": nvidia_smi_line(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
