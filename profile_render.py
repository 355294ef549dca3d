#!/usr/bin/env python3
"""Where the render path's time goes on one card: a torch.profiler trace of
one 400x400 view at Config() through ``eval.render_image``, with the
model flags given.

    python3 profile_render.py
    python3 profile_render.py --net-width=1024   # the wide route

Prints one JSON line: the view's wall time (host clock, synchronised;
also without the profiler), the device time summed over all kernels and
copies, its share of the wall time and the rest (the device idle share),
the render kernel's device time in all and per wrapper call (bf16: the
wgmma forward of ``csrc/forward_wg.cuh``; at net_width 288 and up the
launches of ``csrc/wide_forward.cuh``), the top device events with
their counts, and for each helper kernel of the wide route's launches
(the features, direction terms, heads and composite:
``profile_train.helper_model`` at the rays a launch takes) its launches,
its time a launch and its bound.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

# Device kernels of one render_level call: the narrow kernels' names hold
# "render_level"; the wide route's are its own (bf16, then f32's).
RENDER_KERNELS = ("render_level", "wide_features_kernel", "wide_dir_kernel",
                  "wide_gemm_kernel", "wide_head_kernel",
                  "wide_composite_kernel", "wide_gemm_f32_kernel",
                  "wide_head_f32_kernel")


def main(argv) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi_line
    from nerf_or_nothing_tpu_torch.config import Config, parse_flags
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    size = 400
    scene = tempfile.mkdtemp(prefix="profile_render_")
    write_scene(scene, n_train=1, n_test=1, size=size)
    cfg = parse_flags(argv, Config(data_dir=scene))
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
    calls = fl.render_level.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        wall = time.perf_counter() - t0
    calls = fl.render_level.launches - calls

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
    mine = [r for r in rows if any(k in r[0] for k in RENDER_KERNELS)]
    kernel_s = sum(r[1] for r in mine) / 1e6
    helpers = {}
    from profile_train import helper_model
    from nerf_or_nothing_tpu_torch.utils.profiling import card_peaks

    _, peaks = card_peaks(torch.cuda.get_device_name(0))
    kc = fl.kernel_cfg(cfg)
    rays = size * size * cfg.num_levels
    for k in ("wide_features_kernel", "wide_dir_kernel", "wide_head_kernel",
              "wide_composite_kernel", "wide_head_f32_kernel"):
        hit = [r for r in rows if f"namespace)::{k}" in r[0]]
        n = sum(r[2] for r in hit)
        if not n:
            continue
        per = -(-rays // (n // 2 if "head" in k else n))  # rays a launch
        m = helper_model(kc, per, cfg.num_samples, 1, 0,
                         fl.padded_location_features(cfg))[k]
        helpers[k] = {"launches": n, "rays_per_launch": per,
                      "ms_per_launch": sum(r[1] for r in hit) / 1e3 / n,
                      "bytes": m["bytes"],
                      "bound_ms": max(m["bytes"] / peaks[2],
                                      m["flops"] / peaks[1]) * 1e3}
    print(json.dumps({
        "view": [size, size], "config": "Config()", "flags": argv,
        "wall_s": wall, "wall_s_unprofiled": plain_wall,
        "device_busy_s": device_s,
        "device_busy_share": device_s / wall,
        "device_idle_share": 1.0 - device_s / wall,
        "render_level_s": kernel_s,
        "render_level_launches": calls,
        "device_launches": sum(r[2] for r in mine),
        "render_level_ms_per_launch": kernel_s * 1e3 / max(calls, 1),
        "other_device_s": device_s - kernel_s,
        "top": [{"name": n[:80], "device_ms": us / 1e3, "count": c}
                for n, us, c in rows[:15]],
        "helpers": helpers,
        "card": nvidia_smi_line(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
