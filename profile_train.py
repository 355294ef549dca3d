#!/usr/bin/env python3
"""Where the train step's time goes on one card: a torch.profiler trace of
a few train steps on a synthetic 400x400 Blender scene, through
``train.make_train_step``, at Config() (1024 rays, 128 + 128 samples, bf16)
with the model flags given.

    python3 profile_train.py
    python3 profile_train.py --fuse-level=false --stop-level-grad=false
    python3 profile_train.py --dataset-loader=multicam \
        --kernel-probes=fl_variant=twopass
    python3 profile_train.py --steps-per-call=8

With ``--steps-per-call=K`` (K > 1) the same is measured for K steps a
call through ``train.make_multi_step``, each step a replay of one
captured CUDA graph, beside K eager steps with one synchronisation at the
end (the ``graph`` and ``eager_unsynced`` entries): wall time a step,
device busy time a step and the device idle share.

Prints one JSON line: the steps' wall time (host clock, each step
synchronised; also without the profiler), the device time summed over all
kernels and copies and its share of the wall time (the rest is the device
idle), the device time of the hand-written kernels' launches by name per
step and per launch of the wrapper (``train_level`` and
``train_level_twopass`` in bf16: 7 launches, the wgmma forward, the
composite, the wgmma g-chain, the per-ray sums, the dW GEMM, the small
products and the reduction; every kernel at net_width 288 and up (e.g.
``--net-width=1024``, in f32 with ``--compute-dtype=float32``): the wide
route's launches, a GEMM a layer product; ``mlp_bwd`` in bf16: 6, with
input_grads 7,
the wgmma forward keeping its activations, the g-chain (with dX), the
per-ray sums, dD, the dW GEMM, the small products and the reduction;
``mlp_fwd``: 1), the rest of the device time, the device
time of the autograd backward nodes (inclusive of their kernels; the
fused MLP's node holds the ``mlp_bwd`` launches, the others are the eager
backward of the composite, IPE, cast_rays and resampling), and, timed
alone with CUDA events (median of 7), the weight packing of one step, the
gradient clipping plus Adam update of one step, and one call of each
kernel wrapper the step uses; and for each helper kernel of the step's
launches (``helper_model``: the composite, the per-ray sums, the heads,
the small products and the split reductions, ...) its launches a step,
its time a launch, its bound (the bytes it must move, each input read
once and each output written once, over the card's memory rate, or its
FLOPs over the f32 rate, the larger: its sums are f32 in both dtypes)
and, where one PyTorch
call computes the same function, that call's time (CUDA events, median
of 7, on seeded tensors of the same shapes).
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

TRAIN_WG = ("train_fwd_wg_kernel", "train_composite_kernel",
            "chain_wg_kernel", "g_ray_kernel", "dw_wg_kernel",
            "small_tn_kernel", "reduce_kernel")
# the wide route's (net_width 288 and up) own launches beside the shared ones;
# mlp_fwd and mlp_bwd share their names there, so in one step their
# per-launch split is the one timed alone ("alone")
WIDE_FWD = ("wide_features_kernel", "wide_dir_kernel", "wide_gemm_kernel",
            "wide_head_kernel")
# (wide_db_kernel: the bf16 db before the dW GEMM took it, none since)
WIDE_TRAIN = WIDE_FWD + ("wide_rgb_chain_kernel", "wide_db_kernel",
                         "wide_dw_kernel", "small_sum_kernel")
# the f32 wide route's (csrc/wide_f32.cuh): its layer GEMM and small
# kernels (the features and direction kernels are WIDE_FWD's, instantiated
# in f32), dW and db on csrc/wide_dw.cuh's f32 GEMM
WIDE_F32_FWD = ("wide_gemm_f32_kernel", "wide_head_f32_kernel")
WIDE_F32_TRAIN = WIDE_F32_FWD + ("wide_rgb_chain_f32_kernel",
                                 "g_ray_f32_kernel", "wide_dw_f32_kernel")
KERNELS = {
    "train_level": TRAIN_WG + WIDE_TRAIN + WIDE_F32_TRAIN,
    "train_level_twopass": TRAIN_WG + WIDE_TRAIN + WIDE_F32_TRAIN,
    "mlp_bwd": ("mlp_act_wg_kernel", "chain_wg_kernel", "g_ray_kernel",
                "mlp_dd_kernel", "dw_wg_kernel", "small_tn_kernel",
                "reduce_kernel") + WIDE_TRAIN + WIDE_F32_TRAIN
    + ("wide_dd_f32_kernel",),
    "mlp_fwd": (("mlp_fwd_wg_kernel", "mlp_fwd_kernel")  # bf16, f32
                + WIDE_FWD + WIDE_F32_FWD),
}
BACKWARD_NODE = "autograd::engine::evaluate_function: "


def helper_model(cfg, R: int, S: int, splits: int, n_out: int,
                 kx: int) -> dict:
    """The helper kernels of one level's launches at ``cfg`` (its kernel
    widths), R rays x S samples and ``splits`` row splits: by kernel name,
    the bytes a launch must move (each input read once, each output
    written once), its FLOPs, and the shapes of the one PyTorch call that
    computes the same function (``library``: (kind, shapes)) or None.
    ``wide_head_kernel`` is the level's two head launches' mean."""
    N = R * S
    W, Wc = cfg.net_width, cfg.net_width_condition
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    Fd, LX = cfg.direction_features, cfg.location_features
    Cr, Cd = cfg.num_rgb_channels, cfg.num_density_channels
    es = 2 if cfg.compute_dtype == "bfloat16" else 4
    n_small = W * Cd + Fd * Wc + Wc * Cr + Cr + Cd
    wide = {
        "train_composite_kernel": (N * 16 + N * 4 + R * 16 + R * 16
                                   + N * (4 + 4 * Cr + 4 * Cd), 0, None),
        "wide_composite_kernel": (N * 16 + N * 4 + R * 16 + N * 4, 0, None),
        "g_ray_kernel": (N * Wc * es + R * Wc * 4, N * Wc,
                         ("ray_sum", (R, S, Wc))),
        "wide_rgb_chain_kernel": (N * Cr * 4 + 2 * N * Wc * es + Cr * Wc * es,
                                  2 * N * Wc * Cr, None),
        "wide_head_kernel": ((N * (W + Wc) * es + 2 * N * 16) // 2,
                             N * (W * Cd + Wc * Cr), None),
        "wide_features_kernel": (N * LX * es + N * kx * es, 0, None),
        "wide_dir_kernel": (R * Fd * es + Fd * Wc * es + Wc * 4 + R * Wc * 4,
                            2 * R * Fd * Wc, None),
        "small_tn_kernel": (N * (W + Wc) * es + N * (Cr + Cd) * 4
                            + R * Fd * es + R * Wc * 4
                            + splits * n_small * 4,
                            2 * (N * W * Cd + R * Fd * Wc + N * Wc * Cr),
                            None),
        "small_sum_kernel": ((splits + 1) * n_small * 4, splits * n_small,
                             ("split_sum", (splits, n_small))),
        "reduce_kernel": ((splits + 1) * n_out * 4, splits * n_out,
                          ("split_sum", (splits, n_out))),
        "wide_db_kernel": (N * (D * W + Dc * Wc) * es + N * (Cr + Cd) * 4
                           + min(256, -(-N // 2048)) * (D * W + Dc * Wc
                                                        + Cr + Cd) * 4,
                           N * (D * W + Dc * Wc + Cr + Cd),
                           ("column_sum", (N, D * W + Dc * Wc))),
        "mlp_dd_kernel": (R * Wc * 4 + Fd * Wc * es + R * Fd * 4,
                          2 * R * Wc * Fd, ("matmul_dd", (R, Wc, Fd))),
    }
    wide["g_ray_f32_kernel"] = wide["g_ray_kernel"]
    wide["wide_rgb_chain_f32_kernel"] = wide["wide_rgb_chain_kernel"]
    wide["wide_head_f32_kernel"] = wide["wide_head_kernel"]
    wide["wide_dd_f32_kernel"] = wide["mlp_dd_kernel"]
    return {k: {"bytes": b, "flops": f, "library": lib}
            for k, (b, f, lib) in wide.items()}


def library_ms(lib, dtype, device, median_ms) -> float:
    """The time of the one PyTorch call of ``helper_model``'s ``library``
    on seeded tensors (CUDA events, median of 7)."""
    import torch

    kind, shape = lib
    gen = torch.Generator(device=device).manual_seed(0)
    if kind == "ray_sum":  # g [R, S, Wc] summed per ray in f32
        g = torch.randn(shape, generator=gen, device=device).to(dtype)
        return median_ms(lambda: g.sum(1, dtype=torch.float32))
    if kind == "split_sum":  # [splits, n] f32 partials summed
        part = torch.randn(shape, generator=gen, device=device)
        return median_ms(lambda: part.sum(0))
    if kind == "column_sum":  # masked g [N, n] column sums in f32
        g = torch.randn(shape, generator=gen, device=device).to(dtype)
        return median_ms(lambda: g.sum(0, dtype=torch.float32))
    R, Wc, Fd = shape  # dD = g_ray [R, Wc] @ W_dir^T [Wc, Fd]
    g = torch.randn((R, Wc), generator=gen, device=device)
    w = torch.randn((Wc, Fd), generator=gen, device=device)
    return median_ms(lambda: torch.matmul(g, w))


def main(argv) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (
        level_inputs,
        median_ms,
        mlp_case_inputs,
        nvidia_smi_line,
        train_inputs,
    )
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.config import Config, parse_flags
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype
    from nerf_or_nothing_tpu_torch.rays import Rays
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    scene = tempfile.mkdtemp(prefix="profile_train_")
    write_scene(scene, n_train=2, n_test=1, size=400)
    cfg = parse_flags(argv, Config(data_dir=scene))
    fused = train_lib.use_fused_level(cfg)
    twopass = fused and fl.uses_twopass(cfg)
    wrappers = (("train_level_twopass" if twopass else "train_level",)
                if fused else ("mlp_fwd", "mlp_bwd"))
    module = {"train_level": fl, "train_level_twopass": fl, "mlp_fwd": fm,
              "mlp_bwd": fm}
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

    multi_fn = train_lib.make_multi_step(cfg)

    def eager_chunk(host_batches):
        nonlocal state
        for rays, pixels in host_batches:
            state, _ = step_fn(state, *train_lib.batch_to_device(
                device, rays, pixels))

    def graph_chunk(host_batches):
        nonlocal state
        state, _ = multi_fn(state, host_batches)

    def chunk_profile(run_chunk, k):
        """Chunk 0 warms up (the graph: its capture), chunk 1 is timed
        alone, chunk 2 under the profiler."""
        run_chunk(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_chunk(1)
        torch.cuda.synchronize()
        plain = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as chunk_prof:
            t0 = time.perf_counter()
            run_chunk(2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(device_us(ev) for ev in chunk_prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.key.startswith("aten::")) / 1e6
        return {"step_wall_s_unprofiled": plain / k, "step_wall_s": wall / k,
                "device_busy_s_per_step": busy / k,
                "device_idle_share": 1.0 - busy / wall}

    steps(batches[:3])  # warm-up: builds the kernels, allocator, handles
    plain_wall = steps(batches[3:6])
    n = 4
    counts = {w: getattr(module[w], w).launches for w in wrappers}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = steps(batches[6:6 + n])
    calls = {w: (getattr(module[w], w).launches - counts[w]) / n
             for w in wrappers}

    def device_us(ev, inclusive=False):
        name = "device_time_total" if inclusive else "self_device_time_total"
        us = getattr(ev, name, None)
        if us is None:
            us = ev.cuda_time_total if inclusive else ev.self_cuda_time_total
        return us

    rows, backward = [], []
    for ev in prof.key_averages():
        if ev.key.startswith(BACKWARD_NODE) and device_us(ev, True) > 0:
            backward.append((ev.key[len(BACKWARD_NODE):],
                             device_us(ev, True), ev.count))
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("aten::")):
            continue
        if device_us(ev) > 0:
            rows.append((ev.key, device_us(ev), ev.count))
    rows.sort(key=lambda r: -r[1])
    backward.sort(key=lambda r: -r[1])
    device_s = sum(r[1] for r in rows) / 1e6
    names = [k for w in wrappers for k in KERNELS[w]]
    # the port's kernels by name in their anonymous namespace (PyTorch's
    # own reduce_kernel templates are not ours)
    def ours(k, key):
        return f"namespace)::{k}" in key

    by_kernel = {k: sum(r[1] for r in rows if ours(k, r[0])) / 1e6 / n
                 for k in names}
    by_kernel_launches = {k: sum(r[2] for r in rows if ours(k, r[0])) / n
                          for k in names}
    kernel_s = sum(by_kernel.values())
    per_call = {w: sum(by_kernel[k] for k in KERNELS[w]) / calls[w] * 1e3
                for w in wrappers}

    multi = None
    if cfg.steps_per_call > 1:
        k = cfg.steps_per_call
        with create_dataset("train", scene, cfg) as ds:
            host = [next(ds) for _ in range(3 * k)]
        multi = {"steps_per_call": k,
                 "eager_unsynced": chunk_profile(
                     lambda i: eager_chunk(host[i * k:(i + 1) * k]), k),
                 "graph": chunk_profile(
                     lambda i: graph_chunk(host[i * k:(i + 1) * k]), k)}

    # Parts timed alone with CUDA events.
    dt = compute_dtype(cfg)
    alone = {}
    if fused:
        alone["pack_train"] = median_ms(
            lambda: fl.pack_train(state.params, cfg, dt))
    else:
        alone["pack_mlp_params"] = median_ms(
            lambda: fm.pack_mlp_params(state.params, cfg, dt))
    grads = [(torch.randn_like(w) * 1e-3, torch.randn_like(b) * 1e-3)
             for w, b in state.params]
    mu = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in state.params]
    nu = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in state.params]
    params = [(w.clone(), b.clone()) for w, b in state.params]

    _, host = train_lib.adam_scalars(cfg, 10)
    scalars = torch.from_numpy(host).to(device)

    def adam():
        g, *_ = train_lib.clip_grads(grads, cfg)
        train_lib.adam_update(params, g, mu, nu, scalars[0], scalars[1],
                              scalars[2], cfg)

    alone["clip_and_adam"] = median_ms(adam)
    R = cfg.batch_size
    if fused:
        xs, d, delta = level_inputs(cfg, R, "t", 1, device)
        pixels, g_scale = train_inputs(cfg, R, 2, device)
        packed = fl.pack_train_level(state.params, cfg, dt)
        if twopass:
            alone["train_level_twopass_call"] = median_ms(
                lambda: fl.train_level_twopass_cuda(
                    state.params, cfg, xs, d, delta, pixels, g_scale, True,
                    packed=packed))
        alone["train_level_call"] = median_ms(lambda: fl.train_level_cuda(
            state.params, cfg, xs, d, delta, pixels, g_scale, True, "t",
            packed=packed))
    else:
        p, x, d, g_rgb, g_den = mlp_case_inputs(cfg, R, 1, device)
        packed = fm.pack_mlp_params(p, cfg, dt)
        alone["mlp_fwd_call"] = median_ms(
            lambda: fm.mlp_fwd_cuda(p, cfg, x, d, packed=packed))
        for ig in (False, True):
            alone[f"mlp_bwd_call_input_grads_{ig}"] = median_ms(
                lambda: fm.mlp_bwd_cuda(p, cfg, x, d, g_rgb, g_den, ig,
                                        packed=packed))
    # The helper kernels: a launch's time beside its bound and library call.
    from nerf_or_nothing_tpu_torch.models.mlp import num_params
    from nerf_or_nothing_tpu_torch.utils.profiling import card_peaks

    kc = fl.kernel_cfg(cfg)
    _, peaks = card_peaks(torch.cuda.get_device_name(0))
    peak = peaks[1]  # the helpers' sums are f32 FMA in both dtypes
    S = cfg.num_samples
    model = helper_model(kc, R, S, fl.train_splits(R * S), num_params(kc),
                         fl.padded_location_features(cfg))
    helpers = {}
    for k, m in model.items():
        launches = by_kernel_launches.get(k, 0.0)
        if not launches:
            continue
        b_ms = max(m["bytes"] / peaks[2] * 1e3, m["flops"] / peak * 1e3)
        helpers[k] = {
            "launches_per_step": launches,
            "ms_per_launch": by_kernel[k] * 1e3 / launches,
            "bytes": m["bytes"], "flops": m["flops"], "bound_ms": b_ms,
            "bound_by": ("bytes" if m["bytes"] / peaks[2]
                         >= m["flops"] / peak else "operations"),
            "library_ms": (library_ms(m["library"], dt, device, median_ms)
                           if m["library"] else None)}
    print(json.dumps({
        "config": "Config()", "flags": argv, "fused_level": fused,
        "batch_size": cfg.batch_size, "steps": n,
        "step_wall_s": wall / n, "step_wall_s_unprofiled": plain_wall / 3,
        "device_busy_s_per_step": device_s / n,
        "device_busy_share": device_s / wall,
        "device_idle_share": 1.0 - device_s / wall,
        "kernels_s_per_step": kernel_s,
        "by_kernel_s_per_step": by_kernel,
        "by_kernel_launches_per_step": by_kernel_launches,
        "helpers": helpers,
        "launches_per_step": calls, "ms_per_launch": per_call,
        "other_device_s_per_step": device_s / n - kernel_s,
        "backward_nodes_ms_per_step": {
            nm[:60]: us / 1e3 / n for nm, us, _ in backward[:12]},
        "eager_backward_ms_per_step": sum(
            us for nm, us, _ in backward if "_FusedMLP" not in nm) / 1e3 / n,
        "alone_ms": alone,
        "top": [{"name": nm[:80], "device_ms": us / 1e3 / n, "count": c}
                for nm, us, c in rows[:15]],
        "multi_step": multi,
        "card": nvidia_smi_line(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
