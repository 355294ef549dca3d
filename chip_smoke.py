#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  env      torch / CUDA / nvcc versions, the card, whether triton imports;
  build    nvcc builds csrc/render_level.cu, csrc/train_level.cu,
           csrc/train_level_twopass.cu, csrc/mlp_fwd.cu and csrc/mlp_bwd.cu,
           and the mma.sync versions of all five at commit 815018d
           (mma_sources), one process each, started together (ptxas
           register/spill lines);
  kernel   the render kernel against its plain PyTorch version (render_level_plain)
           at Config() width: bf16 and f32, R=16384 x S=128 in mode "mv",
           R=1000 x S=64 in mode "t" without white background, and a narrow
           config with S=8; errors as a fraction of the band
           atol + rtol*|ref| + rtol*max|ref|; kernel and plain times by CUDA
           events (median of 7 launches after warm-up) beside the bound;
  turns    the mma.sync and wgmma versions of every kernel on the same
           inputs, timed in turns with the SM clock and power draw beside
           each time (turns_phase);
  main     a synthetic 400x400 Blender scene and a seeded checkpoint at
           Config(), then the port's ``run.main(["eval", ...])`` and
           ``run.main(["render", ...])`` on the card; the kernel's launch
           counter must rise by 2 (levels) per 16384-ray chunk; render rays/s
           beside the bound; the rendered path checked against the plain
           path on the CPU on a small slice of rays;
  train_kernel  the train kernel (train_level_cuda) against level_train_plain:
           Config() width R=1024 x S=128 mode "t" in bf16 and f32 and mode
           "mv" in bf16, R=1000 x S=64 with two view layers and R=37 x
           S=256 at a narrow width in both dtypes, and a masked ragged batch
           (R=777, some g_scale 0);
           normalized errors of comp, acc, weights and every dW/db; times by
           CUDA events (median of 7 after warm-up) beside the bound
           (train_level_flops); two launches must give bit-equal dW;
  train    a synthetic 400x400 Blender scene (4 train views, 1 test view),
           ``run.main(["train", ...])`` at Config() for 40 steps with
           logging, checkpoints and a test render inside the run; the train
           kernel's launch counter must rise by exactly 2 per step; the loss
           is finite, the final checkpoint exists and ``run.main(["eval",
           ...])`` restores it on the card; steady-state train rays/s
           (batch_size / median host-clock step, each step synchronised)
           beside the bound; one step on the card against the same step on
           the CPU (randomized=false, 256 rays);
  mlp_kernel  the MLP kernels against their plain versions: mlp_fwd at
           Config() width, mode "t" features, R=16384 x S=128 in bf16 and
           f32 and R=1024 x S=128 in bf16, and a narrow ragged config with
           4 rgb / 2 density heads; mlp_bwd at R=1024 x S=128 in bf16 with
           input_grads False and True and in f32, and narrow R=37 x S=256,
           with head cotangents from the composite backward of the plain
           forward (the train level's); normalized errors of the heads,
           every dW/db, dX and dD; times by CUDA events beside the bound
           (mlp_fwd_flops, mlp_bwd_flops); two launches must give bit-equal
           dW/db, dX and dD;
  train_full_grad  the train phase at Config(fuse_level=False,
           stop_level_grad=False) for 20 steps: launch counters must rise
           by exactly 2 mlp_fwd + 2 mlp_bwd per step plus 2 mlp_fwd per
           16384-ray chunk of the test render, and 0 train_level /
           render_level; ``run eval`` at the same flags (2 mlp_fwd per
           chunk); train rays/s beside the bound of the work a step needs
           (full_grad_step_flops); one step on the card against the CPU,
           every gradient included;
  twopass_kernel  the two-pass train kernel (train_level_twopass_cuda,
           mode "t") against level_train_plain: Config() width R=1024 x
           S=128 in bf16 and f32, a masked ragged batch (R=777, every
           seventh g_scale 0, the others weighted by Multicam's 1/4/16/64),
           and R=37 x S=256 at depth 5 with skips at 2 and 4, in both
           dtypes; two launches bit-equal; train_level_cuda on the same
           inputs, its error against the two-pass kernel and both times
           beside the shared bound;
  multicam the train phase on the Blender scene's 4-scale Multicam pyramid
           (loss_mult 1/4/16/64) with kernel_probes fl_variant=twopass for
           20 steps: exactly 2 train_level_twopass launches per step and no
           train_level; ``run eval --max-images=4`` (the four scales of the
           test view: 2 render_level launches per 16384-ray chunk of each);
           ``run render --render-path --max-images=2`` (the orbit at
           400x400); train rays/s; one step on a Multicam batch against
           the CPU;
  llff     a forward-facing LLFF layout (9 views at 400x400, written by
           write_llff_scene from the synthetic renderer): the train phase at
           --white-bkgd=false for 10 steps (train_level, NDC rays), ``run
           render --render-path --max-images=2`` (the spiral) and ``run
           eval --spherify=true``;
  bin      the Blender scene's train rays as a 64-byte-record dump, the
           train phase with --dataset-loader=bin --test-render-interval=0
           for 10 steps: the native C++ loader (built from
           native/ray_loader.cpp into nerf_or_nothing_tpu_torch/build/) must
           serve every batch.
  graph    the multi-step as replays of one captured CUDA graph of the
           train step (train.make_multi_step): 8 graph steps against 8
           eager steps from one state on the same loader batches at
           Config(), Multicam with fl_variant=twopass and the slice config,
           params, moments, step and stats bit-equal, exact launch counts
           (the capture's warm-up steps included), the graph's memory pool;
           ``run train --steps-per-call=8`` for 40 steps (test renders at
           20 and 40) with exact launch counts, its logged lines and final
           checkpoint bit-equal to the train phase's --steps-per-call=1 run
           and its last test render equal to a fresh render_fn's; train
           rays/s of eager and graph steps in turns (eager, graph, graph,
           eager; 16 steps a turn, host clock, SM clock and power draw
           after each) at the three configs; ``run train --profile-dir``
           (its trace holds the train passes of steps 11-20),
           check_numerics on a NaN pixel (raises, state unchanged) and
           utils.parity.level_parity_errors in bf16 and f32 on the card.
  mesh     data parallelism (parallel/mesh.py) in child processes, after
           the kernels are built: (1) one rank on NCCL (world size 1): the
           sharded step at Config() bit-equal to make_train_step over 8
           loader batches (params, mu, nu, step, stats; 2 train_level
           launches a step), the sharded multi-step (8 replays of one
           captured graph, its all-reduces inside) bit-equal to 8 eager
           sharded steps, train rays/s of unsharded and sharded eager and
           graph steps in turns (host clock, SM clock and power draw after
           each), and one 2.19 MB all-reduce by CUDA events; (2) two ranks
           on the one card over gloo (NCCL takes one rank a card): 4 eager
           sharded steps of 512 rays each on 1024-ray loader batches at
           Config(), the slice config and Multicam with the two-pass probe
           (randomized=false), exact launch counts on each rank, params
           bit-equal across the ranks and within the bf16 band of the
           single-process steps on the whole batches; render_image of the
           400x400 test view over the two ranks against one process.
  tensor   tensor parallelism (mesh.make_tensor_parallel_train_step, the
           plain MLP as in JAX) in child processes: (1) a 1 x 1 grid on
           NCCL at Config(): 8 tensor-parallel steps on loader batches
           bit-equal to make_train_step(use_pallas=False) (params, mu, nu,
           step, stats; no kernel launched), train rays/s of the two in
           turns (plain, tensor, tensor, plain; SM clock and power draw
           after each), one 256-column all-gather at the trunk's shape by
           CUDA events, and ``run train --mesh-shape=1,1`` for 4 steps
           with a checkpoint and a test render (its render_level launches
           exact); (2) a 2 x 2 grid of four gloo ranks on the one card
           (NCCL takes one rank a card): 2 randomized steps of 1024-ray
           loader batches at Config() widths, the gathered state and the
           stats within the bf16 band of the single-process plain step,
           each block bit-equal down its 'model' column, the replicated
           heads, gathered state and stats bit-equal on all four ranks.
  recovery ``run.main(["train", ...])`` at Config() in child processes,
           each in its own session, on a bin dump of one ray of the scene
           repeated (every batch the same: a resumed loader starts its
           stream again), --steps-per-call=8 --save-every=8
           --max-steps=40: an uninterrupted run; a second one SIGKILLed
           with its whole session once its step-16 checkpoint exists (it
           writes each checkpoint 0.25 s late, so that the kill lands in
           the next chunk's replays), no process of it left, every
           checkpoint left loaded as a whole state, the .tmp leftovers
           reported; the same command again, which must resume from the
           newest checkpoint (step >= 16) and end at step 40 bit-equal to
           the first run (params, mu, nu, step); train_level launches of
           each run exact (2 a step, the capture's warm-up steps
           included: a restart from N runs steps N+1..40 only);
  quality  the JAX package's quality run (benchmarks/bench_quality.py
           --full): the hard scene, 24 train and 3 test views at 256x256
           written on the host (timed), Config() widths at batch 1024 with
           its schedule (lr 1e-3 to 1e-4 over 20,000 steps, 100 delay
           steps), 3,000 steps of train.make_multi_step (8 a call, graph
           replays); the train PSNR every 250 steps (the mean of the
           calls' last-step values) beside the recorded JAX curve
           (benchmarks/artifacts/quality_curve_hard_full.json), held-out
           view 0 through eval.render_image and eval.evaluate_image, train
           rays/s. Gates: the mean over steps 2,251-3,000 within 1.5 dB
           of the JAX curve's points at 2,250-3,000, held-out PSNR >= 17 dB
           (the JAX harness's numerics-regression line), every loss and
           the final state finite, launches exact.
The train phases share one 400x400 scene.
Then the ``kernels`` line (each kernel's launches: its path's, plus the
mesh phase's in the world-1 child's sharded steps and rank 0 of the
pair, the tensor phase's ``run train --mesh-shape=1,1``, the recovery
phase's two runs that end and the quality phase's), the card's
name and power limit, and as the last
line {"ok": true, "device": {...}}. Any failure raises: non-zero exit and
no ``ok`` line. Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

from nerf_or_nothing_tpu_torch.kernels import counted, launch_counts
from nerf_or_nothing_tpu_torch.utils.profiling import (
    card_peaks,
    full_grad_step_flops,
    level_flops,
    mlp_bwd_flops,
    mlp_fwd_flops,
    train_level_flops,
)
from nerf_or_nothing_tpu_torch.utils.parity import PARITY_BANDS as BANDS

TPU_KERNEL = "nerf_or_nothing_tpu/kernels/fused_level.py:652"  # _render_kernel
TPU_TRAIN_KERNEL = "nerf_or_nothing_tpu/kernels/fused_level.py:374"  # _level_kernel
TPU_MLP_FWD = "nerf_or_nothing_tpu/kernels/fused_mlp.py:239"  # _fwd_kernel
TPU_MLP_BWD = "nerf_or_nothing_tpu/kernels/fused_mlp.py:673"  # _bwd_kernel
# _level_kernel_twopass
TPU_TWOPASS_KERNEL = "nerf_or_nothing_tpu/kernels/fused_level.py:500"
# The forward kernels before wgmma (mma.sync), timed in turns with the
# wgmma ones: their commit, and where their copies are written (gitignored)
MMA_COMMIT = "815018d"
MMA_DIR = ".local_runs/mma_sync"
MMA_HEADERS = ("level_common.cuh", "level_backward.cuh")
TRAIN_STEPS = 40
FULL_GRAD_STEPS = 20
FULL_GRAD_ARGS = ("--fuse-level=false", "--stop-level-grad=false")
MULTICAM_STEPS = 20
MULTICAM_ARGS = ("--dataset-loader=multicam",
                 "--kernel-probes=fl_variant=twopass")
LOADER_STEPS = 10  # the LLFF and bin-dump phases
GRAPH_K = 8  # steps a multi-step call in the graph phase
TURN_STEPS = 16  # steps a turn of the graph phase's rays/s
GRAPH_CASES = (("Config()", ()), ("multicam_twopass", MULTICAM_ARGS),
               ("slice", FULL_GRAD_ARGS))
# Device kernels of train_level's bf16 passes that a trace must show
TRAIN_WG_KERNELS = ("train_fwd_wg_kernel", "chain_wg_kernel", "dw_wg_kernel")
TIMED_BATCHES = 13  # steps of the rays/s measurement, the first 3 warm-up
MESH_STEPS = 4  # eager sharded steps of each case of the gloo pair
MESH_CASES = (("Config()", ()), ("slice", FULL_GRAD_ARGS),
              ("multicam_twopass", MULTICAM_ARGS))
MESH_WAIT_S = 300  # each child of the mesh phase must end within this
ALLREDUCE_REPS = 20
TP_STEPS = 8  # 1 x 1 grid: tensor-parallel steps against plain ones
TP_RUN_STEPS = 4  # run train --mesh-shape=1,1, a test render at the end
TP_GLOO_STEPS = 2  # steps of the 2 x 2 gloo grid (cut these first)
RECOVERY_STEPS = 40  # run train of the recovery phase, killed and not
RECOVERY_KILL_AT = 16  # kill once this step's checkpoint exists
RECOVERY_PACE_S = 0.25  # the killed run writes each checkpoint this late
QUALITY_STEPS = 3000  # train steps of the quality phase
QUALITY_SCENE = dict(n_train=24, n_test=3, size=256, scene="hard")
QUALITY_MAX_STEPS = 20000  # the JAX run's schedule (bench_quality.py)
QUALITY_ARTIFACT = "benchmarks/artifacts/quality_curve_hard_full.json"
QUALITY_MARGIN_DB = 1.5  # the train curve's gate under the JAX curve's
QUALITY_HELDOUT_DB = 17.0  # bench_quality.py's numerics-regression line
def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def clock_power() -> str:
    """The card's SM clock and power draw now, as ``nvidia-smi
    --query-gpu=clocks.sm,power.draw`` gives them (a card held at its power
    limit runs at a lower clock under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def normalized_err(a, b, atol: float, rtol: float) -> float:
    a, b = a.double(), b.double()
    band = atol + rtol * b.abs() + rtol * b.abs().max()
    return float(((a - b).abs() / band).max())


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def level_inputs(cfg, R: int, mode: str, seed: int, device):
    """Kernel inputs of one level made the way the render path makes
    them: seeded rays around the origin, stratified samples, frustum
    Gaussians, view PE."""
    import torch

    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype
    from nerf_or_nothing_tpu_torch.ops import ipe, sampling
    from nerf_or_nothing_tpu_torch.ops.render import interval_lengths

    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(R, generator=g) * 2 * math.pi
    origins = torch.stack([4 * torch.cos(theta), 4 * torch.sin(theta),
                           torch.full((R,), 1.5)], -1)
    dirs = -origins + torch.randn(R, 3, generator=g) * 0.8
    viewdirs = dirs / dirs.norm(dim=-1, keepdim=True)
    radii = torch.full((R, 1), 1.2e-3)
    near, far = torch.full((R, 1), 2.0), torch.full((R, 1), 6.0)
    t_vals, (means, covs) = sampling.sample_along_rays(
        origins, dirs, radii, cfg.num_samples, near, far, True,
        cfg.lin_disp, cfg.ray_shape, u=torch.rand(R, cfg.num_samples + 1,
                                                  generator=g),
    )
    dt = compute_dtype(cfg)
    S = cfg.num_samples
    if mode == "mv":
        xs = (means.reshape(R * S, 3).contiguous().to(device),
              covs.reshape(R * S, 3).contiguous().to(device))
    else:
        x = ipe.integrated_pos_enc((means, covs), cfg.min_deg_point,
                                   cfg.max_deg_point, fast=cfg.fast_ipe)
        xs = x.reshape(R * S, -1).to(dt).contiguous().to(device)
    d = ipe.pos_enc(viewdirs, 0, cfg.deg_view).to(dt).contiguous().to(device)
    delta = interval_lengths(t_vals, dirs).float().contiguous().to(device)
    return xs, d, delta


def bound_ms(cfg, R: int, S: int, mode: str, peaks) -> tuple:
    """Least time for one launch: FLOPs of the MLP products over the peak
    of the compute type, bytes read and written over the memory rate."""
    from nerf_or_nothing_tpu_torch.models.mlp import layer_dims

    bf16_peak, f32_peak, bw = peaks
    n = R * S
    flops = level_flops(cfg, R, S)
    esize = 2 if cfg.compute_dtype == "bfloat16" else 4
    x_bytes = n * 6 * 4 if mode == "mv" else n * cfg.location_features * esize
    w_bytes = sum(i * o for i, o in layer_dims(cfg)) * esize
    b_bytes = sum(o for _, o in layer_dims(cfg)) * 4
    in_bytes = (x_bytes + R * cfg.direction_features * esize + R * S * 4
                + w_bytes + b_bytes)
    out_bytes = R * 3 * 4 + R * 4 + R * S * 4
    peak = bf16_peak if cfg.compute_dtype == "bfloat16" else f32_peak
    t_ops = flops / peak * 1e3
    t_bytes = (in_bytes + out_bytes) / bw * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, in_bytes + out_bytes)


def train_bound_ms(cfg, R: int, S: int, mode: str, peaks) -> tuple:
    """Least time for one train level: its FLOPs over the compute type's
    peak, or the bytes it must move (inputs once, outputs once) over the
    memory rate, whichever is larger."""
    from nerf_or_nothing_tpu_torch.models.mlp import num_params

    bf16_peak, f32_peak, bw = peaks
    _, _, _, nbytes = bound_ms(cfg, R, S, mode, peaks)
    nbytes += R * 3 * 4 + R * 4 + num_params(cfg) * 4  # pixels, g_scale, dW/db
    flops = train_level_flops(cfg, R, S)
    peak = bf16_peak if cfg.compute_dtype == "bfloat16" else f32_peak
    t_ops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


def mlp_bound_ms(cfg, R: int, S: int, flops: int, in_bytes: int,
                 out_bytes: int, peaks) -> tuple:
    """The larger of the FLOPs over the compute type's peak and the bytes
    (inputs read once, outputs written once) over the memory rate."""
    bf16_peak, f32_peak, bw = peaks
    peak = bf16_peak if cfg.compute_dtype == "bfloat16" else f32_peak
    t_ops, t_bytes = flops / peak * 1e3, (in_bytes + out_bytes) / bw * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, in_bytes + out_bytes)


def mlp_bytes(cfg, R: int, S: int):
    """Bytes of the MLP kernels' inputs x, d, weights and biases."""
    from nerf_or_nothing_tpu_torch.models.mlp import layer_dims

    esize = 2 if cfg.compute_dtype == "bfloat16" else 4
    dims = layer_dims(cfg)
    return (R * S * cfg.location_features * esize
            + R * cfg.direction_features * esize
            + sum(i * o for i, o in dims) * esize + sum(o for _, o in dims) * 4)


def mlp_case_inputs(cfg, R: int, seed: int, device):
    """Features, directions and, for the backward, the head cotangents the
    train level would give: the composite backward of the plain forward
    (pixels and g_scale of ``train_inputs``, white background)."""
    import torch

    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp

    params = init_mlp(torch.Generator().manual_seed(seed), cfg, device=device)
    x, d, delta = level_inputs(cfg, R, "t", seed + 1, device)
    S = cfg.num_samples
    g_rgb = g_den = None
    if cfg.num_rgb_channels == 3 and cfg.num_density_channels == 1:
        pixels, g_scale = train_inputs(cfg, R, seed + 2, device)
        raw_rgb, raw_den = fm.mlp_fwd_plain(params, cfg, x, d, S)
        g_rgb, g_den = fl._composite_backward(
            cfg, raw_rgb, raw_den[:, 0], delta, pixels, g_scale, True)[3:]
        g_den = g_den[:, None].contiguous()
    return params, x, d, g_rgb, g_den


def check_pairs(name, pairs, dtype):
    """Normalized errors and the max abs error of (kernel, plain) pairs."""
    import torch

    atol, rtol = BANDS[dtype]
    errs, max_abs = {}, 0.0
    for key, a, b in pairs:
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite kernel output {key}")
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {key} shape {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        errs[key] = normalized_err(a.float(), b.float(), atol, rtol)
        max_abs = max(max_abs, float((a.float() - b.float()).abs().max()))
    return errs, max_abs


def mlp_fwd_case(name, cfg, R, peaks, device, seed=0):
    import torch

    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype

    S = cfg.num_samples
    params, x, d, _, _ = mlp_case_inputs(cfg, R, seed, device)
    packed = fm.pack_mlp_params(params, cfg, compute_dtype(cfg), backward=False)

    def kernel():
        return fm.mlp_fwd_cuda(params, cfg, x, d, packed=packed)

    def plain():
        return fm.mlp_fwd_plain(params, cfg, x, d, S)

    out_k = kernel()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    errs, max_abs = check_pairs(name, [("raw_rgb", out_k[0], out_p[0]),
                                       ("raw_den", out_k[1], out_p[1])],
                                cfg.compute_dtype)
    ms = median_ms(kernel)
    plain_ms = median_ms(plain, reps=5, warmup=1)
    out_bytes = R * S * (cfg.num_rgb_channels + cfg.num_density_channels) * 4
    b_ms, b_by, flops, nbytes = mlp_bound_ms(
        cfg, R, S, mlp_fwd_flops(cfg, R, S), mlp_bytes(cfg, R, S), out_bytes,
        peaks)
    res = {
        "phase": "mlp_kernel", "kernel": "mlp_fwd", "case": name,
        "dtype": cfg.compute_dtype, "R": R, "S": S,
        "heads": [cfg.num_rgb_channels, cfg.num_density_channels],
        "band": list(BANDS[cfg.compute_dtype]), "normalized_err": errs,
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "flop": flops, "bytes": nbytes,
        "bound_share": b_ms / ms,
    }
    emit(res)
    if not max(errs.values()) < 1.0:
        raise AssertionError(f"{name}: mlp_fwd disagrees with plain: {errs}")
    return res


def mlp_bwd_case(name, cfg, R, input_grads, peaks, device, seed=0,
                 bit_check=False):
    import torch

    from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype, num_params

    S = cfg.num_samples
    params, x, d, g_rgb, g_den = mlp_case_inputs(cfg, R, seed, device)
    packed = fm.pack_mlp_params(params, cfg, compute_dtype(cfg))

    def kernel():
        return fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den, input_grads,
                               packed=packed)

    def plain():
        return fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S,
                                input_grads)

    out_k = kernel()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    pairs = []
    for i, ((dw, db), (rw, rb)) in enumerate(zip(out_k[0], out_p[0])):
        pairs += [(f"dW{i}", dw, rw), (f"db{i}", db, rb)]
    if input_grads:
        pairs += [("dX", out_k[1], out_p[1]), ("dD", out_k[2], out_p[2])]
    errs, max_abs = check_pairs(name, pairs, cfg.compute_dtype)
    bit_equal = None
    if bit_check:
        again = kernel()
        flat = lambda o: [t for wb in o[0] for t in wb] + [  # noqa: E731
            t for t in o[1:] if t is not None]
        bit_equal = all(torch.equal(a, b)
                        for a, b in zip(flat(out_k), flat(again)))
    ms = median_ms(kernel)
    plain_ms = median_ms(plain, reps=5, warmup=1)
    esize = 2 if cfg.compute_dtype == "bfloat16" else 4
    in_bytes = mlp_bytes(cfg, R, S) + R * S * 4 * (
        cfg.num_rgb_channels + cfg.num_density_channels)
    out_bytes = num_params(cfg) * 4 + (
        R * S * cfg.location_features * esize
        + R * cfg.direction_features * 4 if input_grads else 0)
    b_ms, b_by, flops, nbytes = mlp_bound_ms(
        cfg, R, S, mlp_bwd_flops(cfg, R, S, input_grads), in_bytes, out_bytes,
        peaks)
    res = {
        "phase": "mlp_kernel", "kernel": "mlp_bwd", "case": name,
        "dtype": cfg.compute_dtype, "R": R, "S": S,
        "input_grads": input_grads, "band": list(BANDS[cfg.compute_dtype]),
        "worst": max(errs, key=errs.get), "normalized_err": errs,
        "max_abs_err": max_abs, "bit_equal": bit_equal, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "flop": flops, "bytes": nbytes, "bound_share": b_ms / ms,
    }
    emit(res)
    if not max(errs.values()) < 1.0:
        raise AssertionError(f"{name}: mlp_bwd disagrees with plain, "
                             f"normalized error {max(errs.values())} "
                             f"({res['worst']})")
    if bit_check and not bit_equal:
        raise AssertionError(f"{name}: two mlp_bwd launches differ")
    return res


def kernel_case(name, cfg, R, mode, white_bkgd, peaks, device, seed=0):
    import torch

    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype, init_mlp

    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, cfg, device=device)
    xs, d, delta = level_inputs(cfg, R, mode, seed + 1, device)
    packed = fl.pack_forward(params, cfg, compute_dtype(cfg))

    def kernel():
        return fl.render_level_cuda(params, cfg, xs, d, delta, white_bkgd,
                                    mode, packed=packed)

    def plain():
        return fl.render_level_plain(params, cfg, xs, d, delta, white_bkgd,
                                     mode)

    out_k = kernel()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    atol, rtol = BANDS[cfg.compute_dtype]
    errs = {}
    max_abs = 0.0
    for key, a, b in zip(("comp", "acc", "weights"), out_k, out_p):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite kernel output {key}")
        errs[key] = normalized_err(a, b, atol, rtol)
        max_abs = max(max_abs, float((a - b).abs().max()))
    ms = median_ms(kernel)
    plain_ms = median_ms(plain, reps=5, warmup=1)
    b_ms, b_by, flops, nbytes = bound_ms(cfg, R, cfg.num_samples, mode, peaks)
    res = {
        "phase": "kernel", "case": name, "dtype": cfg.compute_dtype,
        "mode": mode, "R": R, "S": cfg.num_samples, "white_bkgd": white_bkgd,
        "band": [atol, rtol], "normalized_err": errs, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "flop": flops, "bytes": nbytes, "bound_share": b_ms / ms,
    }
    emit(res)
    worst = max(errs.values())
    if not worst < 1.0:
        raise AssertionError(f"{name}: kernel disagrees with plain, "
                             f"normalized error {worst}")
    return res


def mma_sources():
    """The ``mma.sync`` versions of every kernel (commit ``MMA_COMMIT``),
    by kernel name: the copies in ``MMA_DIR``, else written there from git
    (``git show MMA_COMMIT:...``) with the headers they include, which a
    quoted include finds beside them before ``csrc/`` (the checkout's
    headers no longer hold their bf16 ``mma.sync`` passes); None where
    neither exists (a checkout without history and without the copies)."""
    root = os.path.dirname(os.path.abspath(__file__))
    files = {f"{name}_mma.cu": f"{name}.cu" for name in KERNELS}
    files.update({h: h for h in MMA_HEADERS})
    for dst, src in files.items():
        path = os.path.join(root, MMA_DIR, dst)
        if not os.path.exists(path):
            got = subprocess.run(
                ["git", "show",
                 f"{MMA_COMMIT}:nerf_or_nothing_tpu_torch/csrc/{src}"],
                cwd=root, capture_output=True, text=True)
            if got.returncode != 0:
                return None
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(got.stdout)
    return {name: os.path.join(root, MMA_DIR, f"{name}_mma.cu")
            for name in KERNELS}


def matmul_ms(cfg, R: int, device) -> float:
    """The MLP's layer products at ``cfg`` over R rays as ``torch.matmul``
    calls on random bf16 operands (the view layer's direction rows once
    per ray), median by CUDA events: a yardstick of the products alone,
    which the port never calls."""
    import torch

    from nerf_or_nothing_tpu_torch.models.mlp import layer_dims

    g = torch.Generator(device=device).manual_seed(0)
    N, W, D = R * cfg.num_samples, cfg.net_width, cfg.net_depth
    pairs = []
    for k, (fan_in, fan_out) in enumerate(layer_dims(cfg)):
        rows = [(N, fan_in)]
        if k == D + 1:  # first view layer: h rows per sample, d rows per ray
            rows = [(N, W), (R, fan_in - W)]
        for n, kin in rows:
            pairs.append((torch.randn(n, kin, generator=g, device=device,
                                      dtype=torch.bfloat16),
                          torch.randn(kin, fan_out, generator=g,
                                      device=device, dtype=torch.bfloat16)))

    def run():
        for a, w in pairs:
            torch.matmul(a, w)

    return median_ms(run)


def turns_phase(device):
    """The ``mma.sync`` kernels (``mma_sources``) and the ``wgmma`` ones on
    the same inputs, timed in turns (mma, wgmma, wgmma, mma;
    ``compare_kernels.in_turns``, the SM clock and power draw beside each
    time): render_level bf16 R=16384 x S=128 mode "mv", mlp_fwd bf16
    R=16384 and R=1024 x S=128, train_level and train_level_twopass bf16
    R=1024 x S=128 mode "t" and R=777 with Multicam's loss weights,
    mlp_bwd bf16 R=1024 x S=128 with and without input_grads. First the
    same layer products as ``torch.matmul`` calls at those shapes, a
    yardstick only. Both versions must agree with the plain version (the
    backward kernels: and give bit-equal outputs over two launches); which
    is faster is recorded, not required."""
    import compare_kernels as ck
    from nerf_or_nothing_tpu_torch.kernels import build

    old = mma_sources()
    if old is None:
        emit({"phase": "turns", "skipped": "no copy of the mma.sync sources "
              f"in {MMA_DIR} and no git history to write one"})
        return None
    from nerf_or_nothing_tpu_torch.config import Config

    for R in (16384, 1024):
        emit({"phase": "turns", "yardstick": "torch.matmul of the layer "
              "products", "R": R, "S": Config().num_samples,
              "ms": matmul_ms(Config(), R, device)})
    out = []
    for kernel, k in (("render_level", 0), ("mlp_fwd", 0), ("mlp_fwd", 1),
                      ("train_level", 0), ("train_level", 1),
                      ("train_level_twopass", 0), ("train_level_twopass", 1),
                      ("mlp_bwd", 0), ("mlp_bwd", 1)):
        sources = {"mma": old[kernel], "wgmma": build.source_path(kernel)}
        res = ck.in_turns(kernel, sources, ck.cases(kernel)[k], device)
        mma_ms = (res["mma_ms_0"] + res["mma_ms_3"]) / 2
        wgmma_ms = (res["wgmma_ms_1"] + res["wgmma_ms_2"]) / 2
        res.update({"phase": "turns", "mma_ms": mma_ms, "wgmma_ms": wgmma_ms,
                    "speedup": mma_ms / wgmma_ms,
                    "wgmma_not_slower": wgmma_ms <= mma_ms})
        emit(res)
        for name in sources:
            if not res[f"{name}_err"] < 1.0:
                raise AssertionError(f"turns: {kernel} {name} disagrees with "
                                     f"plain: {res[f'{name}_err']}")
            if res.get(f"{name}_bit_equal") is False:
                raise AssertionError(f"turns: two {kernel} {name} launches "
                                     "gave different outputs")
        out.append(res)
    return out


def train_inputs(cfg, R: int, seed: int, device, multicam: bool = False):
    """Pixels and a g_scale (level weight 1, every seventh ray masked; the
    others weighted 0.5-1.5, or with ``multicam`` by a Multicam pyramid's
    loss_mult, 1, 4, 16 or 64)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pixels = torch.rand(R, 3, generator=g)
    if multicam:
        mask = 4.0 ** torch.randint(0, 4, (R,), generator=g).float()
    else:
        mask = torch.rand(R, generator=g) + 0.5
    mask[::7] = 0.0
    g_scale = (2.0 * mask / mask.sum())[:, None]
    return pixels.to(device), g_scale.to(device)


def train_kernel_case(name, cfg, R, mode, white_bkgd, peaks, device, seed=0,
                      bit_check=False, twopass=False, multicam=False):
    """One train kernel (``train_level_cuda``, or with ``twopass``
    ``train_level_twopass_cuda``, mode "t") against ``level_train_plain``;
    with ``twopass`` also ``train_level_cuda`` on the same inputs, its
    error against the two-pass kernel and its time."""
    import torch

    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl
    from nerf_or_nothing_tpu_torch.models.mlp import compute_dtype, init_mlp

    params = init_mlp(torch.Generator().manual_seed(seed), cfg, device=device)
    xs, d, delta = level_inputs(cfg, R, mode, seed + 1, device)
    pixels, g_scale = train_inputs(cfg, R, seed + 2, device, multicam)
    packed = fl.pack_train_level(params, cfg, compute_dtype(cfg))

    def one_pass():
        return fl.train_level_cuda(params, cfg, xs, d, delta, pixels, g_scale,
                                   white_bkgd, mode, packed=packed)

    def two_pass():
        return fl.train_level_twopass_cuda(params, cfg, xs, d, delta, pixels,
                                           g_scale, white_bkgd, packed=packed)

    kernel = two_pass if twopass else one_pass
    kname = "train_level_twopass" if twopass else "train_level"

    def plain():
        return fl.level_train_plain(params, cfg, xs, d, delta, pixels,
                                    g_scale, white_bkgd, mode)

    def level_pairs(out_a, out_b):
        pairs = [("comp", out_a[0], out_b[0]), ("acc", out_a[1], out_b[1]),
                 ("weights", out_a[2], out_b[2])]
        for i, ((dw, db), (rw, rb)) in enumerate(zip(out_a[3], out_b[3])):
            pairs += [(f"dW{i}", dw, rw), (f"db{i}", db, rb)]
        return pairs

    out_k = kernel()
    torch.cuda.synchronize()
    out_p = plain()
    torch.cuda.synchronize()
    atol, rtol = BANDS[cfg.compute_dtype]
    errs, max_abs = check_pairs(name, level_pairs(out_k, out_p),
                                cfg.compute_dtype)
    bit_equal = None
    if bit_check:
        again = kernel()
        bit_equal = all(torch.equal(a, b) for (a, _), (b, _) in
                        zip(out_k[3], again[3])) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(out_k[3], again[3]))
    ms = median_ms(kernel)
    plain_ms = median_ms(plain, reps=5, warmup=1)
    b_ms, b_by, flops, nbytes = train_bound_ms(cfg, R, cfg.num_samples, mode,
                                               peaks)
    one_pass_vs = one_pass_ms = turns = None
    if twopass:
        one_pass_vs, _ = check_pairs(name, level_pairs(one_pass(), out_k),
                                     cfg.compute_dtype)
        # In turns: two-pass (above), one-pass, one-pass, two-pass.
        turns = {"train_level": [median_ms(one_pass), median_ms(one_pass)],
                 "train_level_twopass": [ms, median_ms(two_pass)]}
        one_pass_ms = sum(turns["train_level"]) / 2
        ms = sum(turns["train_level_twopass"]) / 2
    res = {
        "phase": "twopass_kernel" if twopass else "train_kernel",
        "kernel": kname, "case": name, "dtype": cfg.compute_dtype,
        "mode": mode, "R": R, "S": cfg.num_samples, "white_bkgd": white_bkgd,
        "band": [atol, rtol], "worst": max(errs, key=errs.get),
        "normalized_err": errs, "max_abs_err": max_abs,
        "dw_bit_equal": bit_equal, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "flop": flops, "bytes": nbytes,
        "bound_share": b_ms / ms, "train_level_ms": one_pass_ms,
        "ms_in_turns": turns, "train_level_vs_twopass": one_pass_vs,
    }
    emit(res)
    worst = max(errs.values())
    if not worst < 1.0:
        raise AssertionError(f"{name}: {kname} disagrees with "
                             f"plain, normalized error {worst} "
                             f"({res['worst']})")
    if bit_check and not bit_equal:
        raise AssertionError(f"{name}: two launches gave different dW")
    return res


KERNELS = ("render_level", "train_level", "train_level_twopass", "mlp_fwd",
           "mlp_bwd")


def reset_launch_counts():
    for fn in counted().values():
        fn.launches = 0


def check_launches(what, got, expected):
    if got != expected:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{expected}")


def render_launches(cfg, dims):
    """Kernel launches of ``render_image`` over images of ``dims``: each
    level one launch per ``render_chunk_size`` rays (the render level, or
    the MLP forward off the fused level)."""
    n = cfg.num_levels * sum(math.ceil(h * w / cfg.render_chunk_size)
                             for h, w in dims)
    out = dict.fromkeys(KERNELS, 0)
    out["render_level" if cfg.fuse_level else "mlp_fwd"] = n
    return out


def step_launches(cfg, steps: int):
    """Kernel launches of ``steps`` train steps: per level one train level
    (the two-pass kernel with its probe in mode "t"), or the MLP forward and
    backward off the fused level."""
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.kernels import fused_level as fl

    out = dict.fromkeys(KERNELS, 0)
    n = cfg.num_levels * steps
    if train_lib.use_fused_level(cfg):
        twopass = fl.uses_twopass(cfg)
        out["train_level_twopass" if twopass else "train_level"] = n
    else:
        out["mlp_fwd"] = out["mlp_bwd"] = n
    return out


def added(a, b):
    return {k: a[k] + b[k] for k in KERNELS}


def run_main(what, argv, expected):
    """``run.main(argv)`` on the card with exact launch counts; seconds."""
    import torch

    from nerf_or_nothing_tpu_torch import run

    reset_launch_counts()
    t0 = time.perf_counter()
    rc = run.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{what}: run.main returned {rc}")
    check_launches(what, launch_counts(), expected)
    return seconds


def test_dims(data, cfg, n=None):
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset

    with create_dataset("test", data, cfg) as ds:
        k = ds.num_images if n is None else min(n, ds.num_images)
        return [ds.image_dims(i) for i in range(k)]


def train_path(peaks, device, data: str, steps: int, model_args=(),
               phase: str = "train", eval_args=(), path_frames: int = 0,
               setup_s: float = 0.0, extra=None):
    """``run train`` on the card at Config() with ``model_args`` on
    ``data``, exact launch counts of every kernel (its test render of test
    view 0 included, unless ``--test-render-interval=0``), the logged
    losses and the final checkpoint; ``run eval`` of the checkpoint with
    ``eval_args`` (skipped when None) and ``run render --render-path`` of
    ``path_frames`` frames at the train images' size, each with exact
    launch counts; train rays/s from the loader's batches; one step and
    its gradients against the CPU on one of them. Returns the launch counts
    of the train run and the emitted record."""
    import csv

    import numpy as np
    import torch

    from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp
    from nerf_or_nothing_tpu_torch.rays import Rays

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    args = [f"--data-dir={data}", f"--checkpoint-dir={ckpt}",
            f"--max-steps={steps}", "--print-every=10", "--save-every=20",
            f"--test-render-interval={steps}", *model_args,
            f"--device={device.type}"]
    cfg = run.parse_flags([a for a in args if not a.startswith("--device")])
    fused = train_lib.use_fused_level(cfg)
    expected = step_launches(cfg, steps)
    if cfg.test_render_interval > 0:
        expected = added(expected, render_launches(cfg, test_dims(data, cfg,
                                                                  1)))
    train_s = run_main(f"{phase}: run train ({steps} steps)",
                       ["train", *args], expected)
    launches = launch_counts()
    with open(os.path.join(ckpt, "train_stats.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if [int(r["step"]) for r in rows] != list(range(10, steps + 1, 10)):
        raise AssertionError(f"unexpected log steps {[r['step'] for r in rows]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    latest = ckpt_lib.latest_checkpoint(ckpt)
    if latest is None or not latest.endswith(f"checkpoint_{steps:09d}.npz"):
        raise AssertionError(f"final checkpoint missing: {latest}")
    state = ckpt_lib.restore_checkpoint(latest, cfg, device=device)
    restored = run.load_params(cfg, device)
    for (w, b), (rw, rb) in zip(state.params, restored):
        if not (torch.equal(w, rw) and torch.equal(b, rb)):
            raise AssertionError("run eval's restore differs from the checkpoint")
    record = {"phase": phase, "config": "Config()", "flags": list(model_args),
              "steps": steps, "setup_s": setup_s, "train_s": train_s,
              "launches": launches, "expected_launches": expected,
              "logged_losses": losses, "checkpoint": latest}
    if eval_args is not None:
        ecfg = run.parse_flags([*args[:-1], *[
            a for a in eval_args if not a.startswith("--max-images=")]])
        n = [int(a.split("=")[1]) for a in eval_args
             if a.startswith("--max-images=")]
        dims = test_dims(data, ecfg, n[0] if n else None)
        record["eval_images"] = dims
        record["eval_s"] = run_main(f"{phase}: run eval {list(eval_args)}",
                                    ["eval", *args, *eval_args],
                                    render_launches(ecfg, dims))
    if path_frames:  # at the size of test view 0
        img = test_dims(data, cfg, 1) * path_frames
        record["render_path_s"] = run_main(
            f"{phase}: run render --render-path",
            ["render", *args, "--render-path=true",
             f"--max-images={path_frames}",
             f"--out={os.path.join(ckpt, 'path')}"],
            render_launches(cfg, img))
        pngs = sorted(os.listdir(os.path.join(ckpt, "path")))
        if pngs != [f"render_{i:03d}.png" for i in range(path_frames)]:
            raise AssertionError(f"unexpected render-path frames {pngs}")

    # Steady-state train rays/s: the train step from the trained state on
    # the loader's batches, each step synchronised, host clock.
    step_fn = train_lib.make_train_step(cfg)
    with create_dataset("train", data, cfg) as ds:
        batches = []
        for _ in range(TIMED_BATCHES):
            rays, pixels = next(ds)
            batches.append((Rays(*[torch.from_numpy(np.asarray(x)).to(device)
                                   for x in rays]),
                            torch.from_numpy(np.asarray(pixels)).to(device)))
    times = []
    for i, (rays, pixels) in enumerate(batches):
        t0 = time.perf_counter()
        state, stats = step_fn(state, rays, pixels)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(time.perf_counter() - t0)
    if not math.isfinite(float(stats.loss)):
        raise AssertionError("non-finite loss in the timed steps")
    step_s = sorted(times)[len(times) // 2]
    rays_per_s = cfg.batch_size / step_s
    step_flops = (cfg.num_levels * train_level_flops(cfg, cfg.batch_size,
                                                     cfg.num_samples)
                  if fused else full_grad_step_flops(cfg, cfg.batch_size,
                                                     cfg.num_samples))
    bound_step_ms = step_flops / peaks[0] * 1e3
    bound_rays_per_s = cfg.batch_size / (bound_step_ms / 1e3)

    # One step, and the gradients of the same step, on the card against
    # the CPU.
    small = cfg.replace(randomized=False, batch_size=256)
    rays, pixels = batches[0]
    rays = Rays(*[x[:256] for x in rays])
    pixels = pixels[:256]
    value_and_grad = (train_lib._fused_level_value_and_grad if fused
                      else train_lib._autograd_value_and_grad)
    out, grads = [], []
    for dev in (device, torch.device("cpu")):
        dev_rays = Rays(*[x.to(dev) for x in rays])
        st = train_lib.init_train_state(small, dev)
        out.append(train_lib.make_train_step(small)(st, dev_rays,
                                                     pixels.to(dev)))
        params = init_mlp(torch.Generator().manual_seed(small.seed), small,
                          device=dev)
        grads.append(value_and_grad(small, params, None, dev_rays,
                                    pixels.to(dev))[2])
    atol, rtol = BANDS["bfloat16"]
    (gs, gst), (cs, cst) = out
    checks = {k: normalized_err(getattr(gst, k).cpu().reshape(-1),
                                getattr(cst, k).reshape(-1), atol, rtol)
              for k in ("loss", "losses", "grad_norm")}
    checks["params"] = max(
        normalized_err(a.cpu(), b, atol, rtol)
        for wa, wb in zip(gs.params, cs.params) for a, b in zip(wa, wb))
    checks["grads"] = {
        f"{kind}{i}": normalized_err(a.cpu(), b, atol, rtol)
        for i, (ga, gb) in enumerate(zip(*grads))
        for kind, a, b in (("dW", ga[0], gb[0]), ("db", ga[1], gb[1]))}
    worst = max([v for k, v in checks.items() if k != "grads"]
                + list(checks["grads"].values()))
    record.update({
        "step_s": times, "train_rays_per_s": rays_per_s,
        "bound_step_flop": step_flops, "bound_step_ms": bound_step_ms,
        "bound_rays_per_s": bound_rays_per_s,
        "bound_share": rays_per_s / bound_rays_per_s,
        "loss_mult": sorted({float(v) for v in
                             batches[0][0].loss_mult.reshape(-1).tolist()}),
        "step_vs_cpu": checks, **(extra or {}),
    })
    emit(record)
    if not worst < 1.0:
        raise AssertionError(f"train step on the card disagrees with the CPU: "
                             f"{checks}")
    return launches, record


def write_llff_scene(root: str, n_images: int = 9, size: int = 400,
                     camera_angle_x: float = 0.8) -> str:
    """A forward-facing LLFF layout (``images/`` + ``poses_bounds.npy``)
    of the synthetic scene: cameras 4 units out on a small patch of
    azimuths and elevations, all looking at the origin; bounds 2 and 6."""
    import numpy as np
    from PIL import Image

    from nerf_or_nothing_tpu_torch.rays import generate_rays, pinhole_pix_to_cam
    from nerf_or_nothing_tpu_torch.utils import synthetic

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    pix_to_cam = pinhole_pix_to_cam(focal, size, size)
    rows = []
    for i in range(n_images):
        theta = -0.5 * np.pi + 0.3 * (i / (n_images - 1) - 0.5)
        el = 0.35 + 0.05 * (i % 3 - 1)
        eye = 4.0 * np.array([np.cos(theta) * np.cos(el),
                              np.sin(theta) * np.cos(el), np.sin(el)])
        c2w = synthetic._look_at(eye)  # columns right, up, back, eye
        rays = generate_rays(pix_to_cam, c2w[:3], size, size, 2.0, 6.0)
        rgb = synthetic.render_rays_analytic(rays.origins.reshape(-1, 3),
                                             rays.directions.reshape(-1, 3))
        Image.fromarray((rgb.reshape(size, size, 3) * 255).astype(np.uint8)
                        ).save(os.path.join(root, "images", f"im_{i:03d}.png"))
        # LLFF pose columns: down, right, back, position, then (h, w, f).
        pose = np.stack([-c2w[:3, 1], c2w[:3, 0], c2w[:3, 2], c2w[:3, 3],
                         [size, size, focal]], axis=1)
        rows.append(np.concatenate([pose.ravel(), [2.0, 6.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return root


def write_checkpoint(ckpt_dir: str, params) -> str:
    """A checkpoint in the JAX package's npz layout (params only)."""
    import numpy as np

    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {"step": np.asarray(0, np.int32)}
    for i, (w, b) in enumerate(params):
        arrays[f"params/w{i}"] = w.cpu().numpy()
        arrays[f"params/b{i}"] = b.cpu().numpy()
    path = os.path.join(ckpt_dir, "checkpoint_000000000.npz")
    np.savez(path, **arrays)
    return path


def main_path(peaks, device, size: int = 400, base=None):
    import numpy as np
    import torch
    from PIL import Image

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image
    from nerf_or_nothing_tpu_torch.models.mlp import init_mlp
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    n_test = 2
    base = base or Config()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    scene = os.path.join(work, "scene")
    t0 = time.perf_counter()
    write_scene(scene, n_train=1, n_test=n_test, size=size)
    params_cpu = init_mlp(torch.Generator().manual_seed(0), base)
    write_checkpoint(os.path.join(work, "ckpt"), params_cpu)
    setup_s = time.perf_counter() - t0

    cfg = base.replace(data_dir=scene,
                       checkpoint_dir=os.path.join(work, "ckpt"))
    args = [f"--{f.name.replace('_', '-')}={getattr(cfg, f.name)}"
            for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(Config(), f.name)]
    args.append(f"--device={device.type}")
    out_dir = os.path.join(work, "renders")
    chunks = n_test * math.ceil(size * size / cfg.render_chunk_size)
    expected = 2 * cfg.num_levels * chunks  # eval + render

    reset_launch_counts()
    t0 = time.perf_counter()
    rc_eval = run.main(["eval", *args])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_render = run.main(["render", *args, f"--out={out_dir}"])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["render_level"]
    if rc_eval != 0 or rc_render != 0:
        raise AssertionError(f"run.main returned {rc_eval}, {rc_render}")
    check_launches("main: run eval + render", counts,
                   {**dict.fromkeys(KERNELS, 0), "render_level": expected})
    pngs = sorted(os.listdir(out_dir))
    if pngs != [f"render_{i:03d}.png" for i in range(n_test)]:
        raise AssertionError(f"unexpected renders {pngs}")
    for p in pngs:
        img = np.asarray(Image.open(os.path.join(out_dir, p)))
        if img.shape != (size, size, 3):
            raise AssertionError(f"{p} has shape {img.shape}")

    # Steady-state render rays/s of one test view through render_image.
    params = [(w.to(device), b.to(device)) for w, b in params_cpu]
    render_fn = make_render_fn(cfg)
    with create_dataset("test", scene, cfg) as ds:
        rays, _ = ds.image_rays(0)
    render_image(render_fn, params, rays, size, size,
                 cfg.render_chunk_size, device=device)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        rgb, _, acc = render_image(render_fn, params, rays, size, size,
                                   cfg.render_chunk_size, device=device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not (np.isfinite(rgb).all() and np.isfinite(acc).all()):
        raise AssertionError("non-finite render")
    sec = sorted(times)[1]
    rays_per_s = size * size / sec
    flop_per_ray = cfg.num_levels * level_flops(cfg, 1, cfg.num_samples)
    bound_rays_per_s = peaks[0] / flop_per_ray

    # The rendered path against the plain path on the CPU, small slice.
    checks = {}
    n_small = min(512, rays.origins.shape[0])
    small = type(rays)(*[x[:n_small] for x in rays])
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        fn = make_render_fn(c)
        gpu, _, gpu_acc = render_image(fn, params, small, n_small, 1,
                                       n_small, device=device)
        cpu, _, cpu_acc = render_image(fn, params_cpu, small, n_small, 1,
                                       n_small, device="cpu")
        atol, rtol = BANDS[dtype]
        checks[dtype] = {
            "rgb": normalized_err(torch.from_numpy(gpu), torch.from_numpy(cpu),
                                  atol, rtol),
            "acc": normalized_err(torch.from_numpy(gpu_acc),
                                  torch.from_numpy(cpu_acc), atol, rtol),
        }
    emit({
        "phase": "main", "config": "Config()", "image": [size, size],
        "test_images": n_test, "render_chunk_size": cfg.render_chunk_size,
        "setup_s": setup_s, "eval_s": eval_s, "render_s": render_s,
        "launches": launches, "expected_launches": expected,
        "render_rays_per_s": rays_per_s, "render_image_s": times,
        "bound_rays_per_s": bound_rays_per_s,
        "bound_share": rays_per_s / bound_rays_per_s,
        "path_vs_cpu_plain": checks,
    })
    for dtype, errs in checks.items():
        if not max(errs.values()) < 1.0:
            raise AssertionError(f"render path ({dtype}) disagrees with the "
                                 f"plain CPU path: {errs}")
    return launches


def bin_path(peaks, device, scene: str, work: str):
    """The Blender scene's train rays as a bin dump (``write_bin_dump``),
    then ``run train --dataset-loader=bin`` without test renders; the
    native C++ loader must serve every batch (the run's and the timed
    steps'). Returns the train run's launch counts."""
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.datasets import native_loader
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.datasets.bin_dump import write_bin_dump

    t0 = time.perf_counter()
    dump = os.path.join(work, "rays.bin")
    with create_dataset("train", scene, Config()) as ds:
        write_bin_dump(dump, ds._flat_rays, ds._flat_pixels)
        records = ds.pool_size
    setup_s = time.perf_counter() - t0
    served = []
    loader_next = native_loader.NativeRayLoader.__next__
    native_loader.NativeRayLoader.__next__ = (
        lambda self: served.append(1) or loader_next(self))
    try:
        launches, _ = train_path(
            peaks, device, dump, LOADER_STEPS,
            ("--dataset-loader=bin", "--test-render-interval=0"), "bin",
            eval_args=None, setup_s=setup_s,
            extra={"records": records,
                   "native_library": str(native_loader.library_path())})
    finally:
        native_loader.NativeRayLoader.__next__ = loader_next
    if len(served) != LOADER_STEPS + TIMED_BATCHES:
        raise AssertionError(f"bin: the native loader served {len(served)} "
                             f"batches, expected "
                             f"{LOADER_STEPS + TIMED_BATCHES}")
    return launches


def loader_batches(scene: str, cfg, n: int):
    """The first ``n`` train batches of the loader, as numpy arrays."""
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset

    with create_dataset("train", scene, cfg) as ds:
        return [next(ds) for _ in range(n)]


def state_pairs(a, b):
    """(name, a's tensor, b's tensor) over params, mu and nu."""
    return [(f"{tree}/{kind}{i}", x, y)
            for tree in ("params", "mu", "nu")
            for i, (wa, wb) in enumerate(zip(getattr(a, tree),
                                              getattr(b, tree)))
            for kind, x, y in (("w", wa[0], wb[0]), ("b", wa[1], wb[1]))]


def graph_equal_case(name, model_args, scene, device):
    """``GRAPH_K`` multi-step steps (one capture, ``GRAPH_K`` replays)
    against ``GRAPH_K`` eager steps from the same initial state on the same
    loader batches: params, mu, nu, step and the last stats must be
    bit-equal, with exact launch counts on both sides (the multi-step's:
    its warm-up steps and one count a replay)."""
    import torch

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib

    cfg = run.parse_flags([f"--data-dir={scene}", *model_args])
    batches = loader_batches(scene, cfg, GRAPH_K)
    eager = train_lib.init_train_state(cfg, device)
    step_fn = train_lib.make_train_step(cfg)
    reset_launch_counts()
    for rays, pixels in batches:
        eager, last = step_fn(eager, *train_lib.batch_to_device(
            device, rays, pixels))
    torch.cuda.synchronize()
    check_launches(f"graph {name}: eager steps", launch_counts(),
                   step_launches(cfg, GRAPH_K))
    graph = train_lib.init_train_state(cfg, device)
    multi = train_lib.make_multi_step(cfg)
    reset_launch_counts()
    graph, stats = multi(graph, batches)
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches(f"graph {name}: multi-step", launches, step_launches(
        cfg, GRAPH_K + train_lib.WARMUP_STEPS))
    captured = list(multi.captured.values())
    pairs = state_pairs(graph, eager) + [
        (f"stats/{k}", getattr(stats, k), getattr(last, k))
        for k in ("loss", "losses", "weight_l2", "psnr", "psnrs",
                  "grad_norm", "grad_abs_max", "grad_norm_clipped")]
    unequal = [k for k, a, b in pairs if not torch.equal(a, b)]
    errs, max_abs = check_pairs(name, pairs, "bfloat16")
    res = {
        "phase": "graph", "check": "graph_equals_eager", "case": name,
        "flags": list(model_args), "steps": GRAPH_K,
        "bit_equal": not unequal and graph.step == eager.step == GRAPH_K,
        "unequal": unequal, "worst_normalized_err_bf16_band":
        max(errs.values()), "max_abs_err": max_abs,
        "captures": len(captured), "graphs": len(captured[0].graphs),
        "pool_bytes": captured[0].pool_bytes,
        "launches_captured": captured[0].launches, "launches": launches,
        "loss": float(stats.loss),
    }
    emit(res)
    if not res["bit_equal"]:
        raise AssertionError(f"graph {name}: the graph steps differ from the "
                             f"eager steps in {unequal}")
    return res


def graph_train_run(device, scene: str, reference: dict):
    """``run train --steps-per-call=GRAPH_K`` for ``TRAIN_STEPS`` steps at
    Config() (logs every 10, checkpoints every 20, test renders at 20 and
    40): exact launch counts (one capture and its warm-up steps); the
    logged lines and the final checkpoint bit-equal to the
    ``--steps-per-call=1`` run of the train phase (``reference``); the test
    render at the last step equal to a render of the checkpoint's params
    through a fresh ``make_render_fn`` (the render function of the run
    packed its weights at step 20, so a stale cache would show)."""
    import csv

    import numpy as np

    from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.eval import make_render_fn

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    args = [f"--data-dir={scene}", f"--checkpoint-dir={ckpt}",
            f"--max-steps={TRAIN_STEPS}", "--print-every=10",
            "--save-every=20", "--test-render-interval=20",
            f"--steps-per-call={GRAPH_K}", f"--device={device.type}"]
    cfg = run.parse_flags(args[:-1])
    dims = test_dims(scene, cfg, 1)
    expected = added(
        step_launches(cfg, TRAIN_STEPS + train_lib.WARMUP_STEPS),
        render_launches(cfg, dims * (TRAIN_STEPS // 20)))
    renders = []
    render_image = run.render_image

    def grab(*a, **k):
        out = render_image(*a, **k)
        renders.append(out[0])
        return out

    run.render_image = grab
    try:
        train_s = run_main(f"graph: run train --steps-per-call={GRAPH_K}",
                           ["train", *args], expected)
    finally:
        run.render_image = render_image

    def rows(directory):
        with open(os.path.join(directory, "train_stats.csv")) as f:
            return [{k: v for k, v in r.items() if k != "rays_per_sec"}
                    for r in csv.DictReader(f)]

    ref_dir = os.path.dirname(reference["checkpoint"])
    logs_equal = rows(ckpt) == rows(ref_dir)
    latest = ckpt_lib.latest_checkpoint(ckpt)
    with np.load(latest) as a, np.load(reference["checkpoint"]) as b:
        differ = sorted(k for k in set(a.files) | set(b.files)
                        if k not in a.files or k not in b.files
                        or not np.array_equal(a[k], b[k]))
    state = ckpt_lib.restore_checkpoint(latest, cfg, device=device)
    with create_dataset("test", scene, cfg) as ds:
        trays, _ = ds.image_rays(0)
        (h, w), = dims
    fresh, _, _ = render_image(make_render_fn(cfg), state.params, trays, h, w,
                               cfg.render_chunk_size, device=device)
    res = {
        "phase": "graph", "check": "run_train_steps_per_call",
        "steps": TRAIN_STEPS, "steps_per_call": GRAPH_K, "train_s": train_s,
        "launches": expected, "logs_equal_steps_per_call_1": logs_equal,
        "checkpoint_differs_in": differ, "test_renders": len(renders),
        "render_equals_fresh": bool(np.array_equal(renders[-1], fresh)),
        "renders_differ": not np.array_equal(renders[0], renders[-1]),
    }
    emit(res)
    if not (logs_equal and not differ and res["render_equals_fresh"]
            and res["renders_differ"] and len(renders) == 2):
        raise AssertionError(f"graph: run train --steps-per-call={GRAPH_K} "
                             f"differs from --steps-per-call=1: {res}")
    return res


def graph_turns(name, model_args, scene, device):
    """Train rays/s of eager steps and graph steps in turns (eager, graph,
    graph, eager), ``TURN_STEPS`` steps a turn on the loader's batches,
    synchronised at the end of the turn, host clock; the SM clock and
    power draw after each turn."""
    import torch

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib

    cfg = run.parse_flags([f"--data-dir={scene}", *model_args])
    batches = loader_batches(scene, cfg, TURN_STEPS)
    state = train_lib.init_train_state(cfg, device)
    step_fn = train_lib.make_train_step(cfg)
    multi = train_lib.make_multi_step(cfg)

    def eager():
        nonlocal state
        for rays, pixels in batches:
            state, stats = step_fn(state, *train_lib.batch_to_device(
                device, rays, pixels))
        return stats

    def graph():
        nonlocal state
        for i in range(0, TURN_STEPS, GRAPH_K):
            state, stats = multi(state, batches[i:i + GRAPH_K])
        return stats

    eager()
    graph()  # captures
    turns = []
    for kind, fn in (("eager", eager), ("graph", graph), ("graph", graph),
                     ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        turns.append({"kind": kind, "s": sec,
                      "rays_per_s": TURN_STEPS * cfg.batch_size / sec,
                      "sm_clock_power": clock_power()})
        if not math.isfinite(float(stats.loss)):
            raise AssertionError(f"graph turns {name}: non-finite loss")
    mean = {k: sum(t["rays_per_s"] for t in turns if t["kind"] == k) / 2
            for k in ("eager", "graph")}
    res = {"phase": "graph", "check": "rays_per_s_in_turns", "case": name,
           "flags": list(model_args), "steps_a_turn": TURN_STEPS,
           "steps_per_call": GRAPH_K, "turns": turns,
           "eager_rays_per_s": mean["eager"],
           "graph_rays_per_s": mean["graph"],
           "graph_over_eager": mean["graph"] / mean["eager"]}
    emit(res)
    return res


def graph_debug_checks(device, scene: str):
    """``run train --profile-dir``: its trace holds the ten traced steps'
    ``train_level`` passes (2 a step); ``--check-numerics`` on the card: a
    NaN pixel raises FloatingPointError naming nan and leaves the state,
    its step and its generator unchanged; ``utils.parity.
    level_parity_errors`` on the card in bf16 and f32, each under 1."""
    import numpy as np
    import torch

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.utils import parity

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    args = [f"--data-dir={scene}", "--max-steps=20", "--print-every=10",
            "--test-render-interval=0", f"--profile-dir={trace_dir}",
            f"--device={device.type}"]
    cfg = run.parse_flags(args[:-1])
    profile_s = run_main("graph: run train --profile-dir", ["train", *args],
                         step_launches(cfg, 20))
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    traced = {k: sum(k in n for n in kernels) for k in TRAIN_WG_KERNELS}

    cfg = cfg.replace(check_numerics=True)
    (rays, pixels), (bad_rays, bad) = loader_batches(scene, cfg, 2)
    state = train_lib.init_train_state(cfg, device)
    step_fn = train_lib.make_train_step(cfg)
    state, _ = step_fn(state, *train_lib.batch_to_device(device, rays,
                                                         pixels))
    before = [t.clone() for t in train_lib.state_tensors(state)]
    step, gen = state.step, state.generator.get_state()
    bad = np.array(bad)
    bad[7, 0] = np.nan
    try:
        step_fn(state, *train_lib.batch_to_device(device, bad_rays, bad))
        message = None
    except FloatingPointError as e:
        message = str(e)
    unchanged = (all(torch.equal(a, t) for a, t in
                     zip(before, train_lib.state_tensors(state)))
                 and state.step == step
                 and torch.equal(state.generator.get_state(), gen))
    parity_errs = {dt: parity.level_parity_errors(dt, device=device)
                   for dt in ("bfloat16", "float32")}
    res = {"phase": "graph", "check": "debug_flags", "profile_s": profile_s,
           "trace_files": files, "traced_kernel_launches": traced,
           "check_numerics_message": message,
           "check_numerics_state_unchanged": unchanged,
           "level_parity_worst": {dt: v[0] for dt, v in parity_errs.items()},
           "level_parity_errors": {dt: v[1] for dt, v in parity_errs.items()}}
    emit(res)
    if traced != dict.fromkeys(TRAIN_WG_KERNELS, 2 * 10):
        raise AssertionError(f"graph: the trace holds {traced} launches, "
                             "expected 20 of each")
    if message is None or "nan" not in message or not unchanged:
        raise AssertionError(f"graph: check_numerics {message!r}, state "
                             f"unchanged {unchanged}")
    if not all(v[0] < 1.0 for v in parity_errs.values()):
        raise AssertionError(f"graph: level parity {res['level_parity_worst']}")
    return res


def graph_phase(device, scene: str, reference: dict):
    """The multi-step as CUDA-graph replays of one captured step: bit-equal
    to eager steps on the three train routes, ``run train
    --steps-per-call`` against ``--steps-per-call=1``, rays/s in turns,
    and the debugging flags."""
    out = {"equal": [graph_equal_case(n, a, scene, device)
                     for n, a in GRAPH_CASES]}
    out["run"] = graph_train_run(device, scene, reference)
    out["turns"] = [graph_turns(n, a, scene, device) for n, a in GRAPH_CASES]
    out["debug"] = graph_debug_checks(device, scene)
    return out


def run_child(what: str, *args):
    """Start ``mesh_child(*args)`` in a new process (this file imported, no
    JAX); ``wait_children`` reads the JSON it writes to its last
    argument."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.mesh_child(*sys.argv[1:]))", *args],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, what, args[-1]


def wait_children(children) -> list:
    """Each started child's result; one that fails or outlives
    ``MESH_WAIT_S`` raises, and the others are killed."""
    out = []
    try:
        for proc, what, path in children:
            try:
                _, err = proc.communicate(timeout=MESH_WAIT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"mesh: {what} did not end within "
                                     f"{MESH_WAIT_S} s")
            if proc.returncode != 0:
                raise AssertionError(f"mesh: {what} exited with "
                                     f"{proc.returncode}:\n{err[-4000:]}")
            with open(path) as f:
                out.append(json.load(f))
    finally:
        for proc, _, _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def mesh_child(kind: str, *args) -> int:
    """Entry of the mesh and tensor phases' child processes: ``world1
    SCENE STORE OUT``, ``pair RANK SCENE WORK STORE OUT``, ``grid1x1 SCENE
    WORK STORE OUT``, ``grid RANK DP MP BACKEND SCENE WORK STORE OUT`` or
    (the recovery phase's) ``recovery DUMP CKPT DEVICE PACE_S OUT``."""
    res = {"world1": mesh_world1, "pair": mesh_pair,
           "grid1x1": tensor_one, "grid": tensor_rank,
           "recovery": recovery_run}[kind](*args)
    with open(args[-1], "w") as f:
        json.dump(res, f)
    return 0


STAT_NAMES = ("loss", "losses", "weight_l2", "psnr", "psnrs", "grad_norm",
              "grad_abs_max", "grad_norm_clipped")


def states_equal(a, b, sa, sb) -> list:
    """The names of the state tensors and stats that differ."""
    import torch

    pairs = state_pairs(a, b) + [
        (f"stats/{k}", getattr(sa, k), getattr(sb, k)) for k in STAT_NAMES]
    out = [k for k, x, y in pairs if not torch.equal(x, y)]
    return out + ([] if a.step == b.step else ["step"])


def mesh_world1(scene: str, store: str, out: str) -> dict:
    """One rank on NCCL: sharded against unsharded steps, eager and as
    graph replays, bit for bit; rays/s in turns; one all-reduce's time."""
    import torch
    import torch.distributed as dist

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.parallel import mesh

    mesh.initialize(f"file://{store}", 1, 0, "cuda")
    m = mesh.create_mesh(1, device="cuda")
    device = m.device
    cfg = run.parse_flags([f"--data-dir={scene}"])
    batches = loader_batches(scene, cfg, TURN_STEPS)
    todev = [train_lib.batch_to_device(device, *b) for b in batches]
    plain, sharded = (train_lib.make_train_step(cfg),
                      mesh.make_sharded_train_step(cfg, m))
    a = train_lib.init_train_state(cfg, device)
    for b in todev[:GRAPH_K]:
        a, last_a = plain(a, *b)
    b_state = mesh.replicate_state(train_lib.init_train_state(cfg, device))
    reset_launch_counts()
    for b in todev[:GRAPH_K]:
        b_state, last_b = sharded(b_state, *b)
    torch.cuda.synchronize()
    eager_launches = launch_counts()
    check_launches("mesh world1: sharded eager steps", eager_launches,
                   step_launches(cfg, GRAPH_K))
    multi = mesh.make_sharded_multi_step(cfg, m)
    g = train_lib.init_train_state(cfg, device)
    reset_launch_counts()
    g, last_g = multi(g, batches[:GRAPH_K])
    torch.cuda.synchronize()
    graph_launches = launch_counts()
    check_launches("mesh world1: sharded multi-step", graph_launches,
                   step_launches(cfg, GRAPH_K + train_lib.WARMUP_STEPS))
    captured = list(multi.captured.values())[0]
    res = {"device": str(device), "backend": dist.get_backend(),
           "world_size": m.world_size, "steps": GRAPH_K,
           "eager_unequal": states_equal(b_state, a, last_b, last_a),
           "graph_unequal": states_equal(g, b_state, last_g, last_b),
           "graph_pool_bytes": captured.pool_bytes,
           "launches_captured": captured.launches,
           "launches": added(eager_launches, graph_launches),
           "loss": float(last_g.loss)}

    states = {k: train_lib.init_train_state(cfg, device)
              for k in ("eager", "sharded_eager", "graph", "sharded_graph")}
    fns = {"eager": plain, "sharded_eager": sharded,
           "graph": train_lib.make_multi_step(cfg),
           "sharded_graph": mesh.make_sharded_multi_step(cfg, m)}

    def turn(kind):
        if kind.endswith("graph"):
            for i in range(0, TURN_STEPS, GRAPH_K):
                states[kind], stats = fns[kind](states[kind],
                                                batches[i:i + GRAPH_K])
        else:
            for bt in todev:
                states[kind], stats = fns[kind](states[kind], *bt)
        return stats

    for kind in states:
        turn(kind)  # warm-up and captures
    turns = []
    for kind in ("eager", "sharded_eager", "graph", "sharded_graph",
                 "sharded_graph", "graph", "sharded_eager", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = turn(kind)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not math.isfinite(float(stats.loss)):
            raise AssertionError(f"mesh world1 turns: {kind} non-finite loss")
        turns.append({"kind": kind, "s": sec,
                      "rays_per_s": TURN_STEPS * cfg.batch_size / sec,
                      "sm_clock_power": clock_power()})
    res["turns"] = turns
    res["rays_per_s"] = {k: sum(t["rays_per_s"] for t in turns
                                if t["kind"] == k) / 2 for k in states}

    flat = torch.randn(sum(t.numel() for t in
                           train_lib.state_tensors(a)[:len(a.params) * 2]),
                       device=device)
    times = []
    for i in range(ALLREDUCE_REPS + 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(flat)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    times.sort()
    res["allreduce"] = {"bytes": flat.numel() * 4,
                        "median_ms": times[len(times) // 2],
                        "min_ms": times[0], "reps": ALLREDUCE_REPS}
    dist.destroy_process_group()
    return res


def mesh_pair(rank: str, scene: str, work: str, store: str, out: str) -> dict:
    """Rank ``rank`` of two on the one card over gloo: ``MESH_STEPS``
    eager sharded steps of each ``MESH_CASES`` case on its half of the
    parent's batches, its state written for the parent; render_image of
    test view 0 over the two ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image
    from nerf_or_nothing_tpu_torch.parallel import mesh
    from nerf_or_nothing_tpu_torch.rays import Rays

    rank = int(rank)
    mesh.initialize(f"file://{store}", 2, rank, "cuda", backend="gloo")
    m = mesh.create_mesh(2, device="cuda")
    device = m.device
    res = {"rank": rank, "device": str(device), "backend": dist.get_backend(),
           "cases": {}}
    total = dict.fromkeys(KERNELS, 0)
    for i, (name, args) in enumerate(MESH_CASES):
        cfg = run.parse_flags([f"--data-dir={scene}", "--randomized=false",
                               *args])
        with np.load(os.path.join(work, f"batches_{i}.npz")) as f:
            batches = [(Rays(*[f[f"{k}/rays{j}"] for j in range(7)]),
                        f[f"{k}/pixels"]) for k in range(MESH_STEPS)]
        state = mesh.replicate_state(train_lib.init_train_state(cfg, device))
        step = mesh.make_sharded_train_step(cfg, m)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rays, pixels in batches:
            state, stats = step(state, *train_lib.batch_to_device(
                device, *mesh.shard_batch(m, rays, pixels)))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = launch_counts()
        check_launches(f"mesh pair {name} rank {rank}", launches,
                       step_launches(cfg, MESH_STEPS))
        total = added(total, launches)
        np.savez(os.path.join(work, f"state_{i}_r{rank}.npz"),
                 **{k: t.cpu().numpy() for k, t, _ in
                    state_pairs(state, state)})
        res["cases"][name] = {
            "rows": int(batches[0][1].shape[0]) // 2, "s": sec,
            "rays_per_s": MESH_STEPS * batches[0][1].shape[0] / sec,
            "launches": launches, "loss": float(stats.loss),
            "psnr": float(stats.psnr)}
    cfg = run.parse_flags([f"--data-dir={scene}"])
    params = run.load_params(cfg, device)
    with create_dataset("test", scene, cfg) as ds:
        trays, _ = ds.image_rays(0)
        h, w = ds.image_dims(0)
    reset_launch_counts()
    t0 = time.perf_counter()
    rgb, _, _ = render_image(make_render_fn(cfg), params, trays, h, w,
                             cfg.render_chunk_size, mesh=m)
    res["render_s"] = time.perf_counter() - t0
    launches = launch_counts()
    check_launches(f"mesh pair render rank {rank}", launches,
                   render_launches(cfg, [(h, w)]))
    res["launches"] = added(total, launches)
    np.save(os.path.join(work, f"render_r{rank}.npy"), rgb)
    dist.destroy_process_group()
    return res


def mesh_phase(device, scene: str) -> dict:
    """Data parallelism in child processes: one rank on NCCL, then two
    ranks on the one card over gloo held against this process's
    single-rank steps and render (see the module docstring). Returns the
    launches of the children's sharded paths (the world-1 child's and rank
    0 of the pair's)."""
    import numpy as np
    import torch

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.eval import make_render_fn, render_image

    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.perf_counter()
    one, = wait_children([run_child(
        "world-1 NCCL child", "world1", scene, os.path.join(work, "store1"),
        os.path.join(work, "world1.json"))])
    one["child_s"] = time.perf_counter() - t0
    emit({"phase": "mesh", "check": "world1_nccl", **one})
    if one["eager_unequal"] or one["graph_unequal"]:
        raise AssertionError(f"mesh world1: sharded differs from unsharded "
                             f"(eager {one['eager_unequal']}) or graph from "
                             f"eager ({one['graph_unequal']})")

    cfgs = []
    for i, (name, args) in enumerate(MESH_CASES):
        cfg = run.parse_flags([f"--data-dir={scene}", "--randomized=false",
                               *args])
        batches = loader_batches(scene, cfg, MESH_STEPS)
        np.savez(os.path.join(work, f"batches_{i}.npz"), **{
            f"{k}/{f}": x for k, (rays, pixels) in enumerate(batches)
            for f, x in [*[(f"rays{j}", r) for j, r in enumerate(rays)],
                         ("pixels", pixels)]})
        cfgs.append((name, cfg, batches))
    t0 = time.perf_counter()
    pair = wait_children([run_child(
        f"gloo rank {r}", "pair", str(r), scene, work,
        os.path.join(work, "store2"), os.path.join(work, f"pair{r}.json"))
        for r in range(2)])
    pair_s = time.perf_counter() - t0
    cases = {}
    for i, (name, cfg, batches) in enumerate(cfgs):
        ref = train_lib.init_train_state(cfg, device)
        step = train_lib.make_train_step(cfg)
        for rays, pixels in batches:
            ref, _ = step(ref, *train_lib.batch_to_device(device, rays,
                                                          pixels))
        ranks = [np.load(os.path.join(work, f"state_{i}_r{r}.npz"))
                 for r in range(2)]
        across = [k for k in ranks[0].files
                  if not np.array_equal(ranks[0][k], ranks[1][k])]
        errs, max_abs = check_pairs(f"mesh pair {name}", [
            (k, torch.from_numpy(ranks[0][k]), t.cpu())
            for k, t, _ in state_pairs(ref, ref)], "bfloat16")
        cases[name] = {"ranks_unequal": across,
                       "worst_normalized_err_bf16_band": max(errs.values()),
                       "max_abs_err": max_abs,
                       **{f"rank{r}": pair[r]["cases"][name]
                          for r in range(2)}}
    cfg = run.parse_flags([f"--data-dir={scene}"])
    with create_dataset("test", scene, cfg) as ds:
        trays, _ = ds.image_rays(0)
        h, w = ds.image_dims(0)
    want, _, _ = render_image(make_render_fn(cfg), run.load_params(
        cfg, device), trays, h, w, cfg.render_chunk_size, device=device)
    got = [np.load(os.path.join(work, f"render_r{r}.npy")) for r in range(2)]
    rerrs, rmax = check_pairs("mesh pair render", [
        ("rgb", torch.from_numpy(got[0]), torch.from_numpy(want))],
        "bfloat16")
    res = {"phase": "mesh", "check": "gloo_pair_one_card", "children_s":
           pair_s, "steps": MESH_STEPS, "cases": cases,
           "render": {"image": [h, w], "bit_equal": bool(
               np.array_equal(got[0], want)), "ranks_equal": bool(
               np.array_equal(got[0], got[1])),
               "normalized_err_bf16_band": rerrs["rgb"],
               "max_abs_err": rmax, "s": [p["render_s"] for p in pair]},
           "launches": [p["launches"] for p in pair]}
    emit(res)
    bad = {n: c for n, c in cases.items() if c["ranks_unequal"]
           or c["worst_normalized_err_bf16_band"] >= 1.0}
    if bad or rerrs["rgb"] >= 1.0 or not res["render"]["ranks_equal"]:
        raise AssertionError(f"mesh pair: {bad or res['render']}")
    return added(one["launches"], pair[0]["launches"])


def tensor_one(scene: str, work: str, store: str, out: str) -> dict:
    """A 1 x 1 grid on NCCL at Config(): ``TP_STEPS`` tensor-parallel steps
    bit-equal to the plain step (``use_pallas=False``), no kernel launched;
    train rays/s of the two in turns; one 256-column all-gather at the
    trunk's shape by CUDA events; ``run train --mesh-shape=1,1`` with a
    checkpoint and a test render (its launch counts)."""
    import csv

    import torch
    import torch.distributed as dist

    from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.parallel import mesh

    mesh.initialize(f"file://{store}", 1, 0, "cuda")
    grid = mesh.create_mesh_2d(1, 1, device="cuda")
    device = grid.device
    cfg = run.parse_flags([f"--data-dir={scene}"])
    batches = loader_batches(scene, cfg, TURN_STEPS)
    todev = [train_lib.batch_to_device(device, *b) for b in batches]
    fns = {"plain": train_lib.make_train_step(cfg.replace(use_pallas=False)),
           "tensor": mesh.make_tensor_parallel_train_step(cfg, grid)}
    states = {"plain": train_lib.init_train_state(cfg, device),
              "tensor": mesh.shard_state(train_lib.init_train_state(
                  cfg, device), grid, cfg)}
    last = {}
    reset_launch_counts()
    for kind in fns:
        for b in todev[:TP_STEPS]:
            states[kind], last[kind] = fns[kind](states[kind], *b)
    torch.cuda.synchronize()
    check_launches("tensor 1x1: plain and tensor-parallel steps",
                   launch_counts(), dict.fromkeys(KERNELS, 0))
    whole = mesh.gather_state(states["tensor"], grid, cfg)
    res = {"device": str(device), "backend": dist.get_backend(),
           "grid": [1, 1], "steps": TP_STEPS,
           "unequal": states_equal(whole, states["plain"], last["tensor"],
                                   last["plain"]),
           "loss": float(last["tensor"].loss)}

    turns = []
    for kind in ("plain", "tensor", "tensor", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in todev:
            states[kind], stats = fns[kind](states[kind], *b)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not math.isfinite(float(stats.loss)):
            raise AssertionError(f"tensor 1x1 turns: {kind} non-finite loss")
        turns.append({"kind": kind, "s": sec,
                      "rays_per_s": TURN_STEPS * cfg.batch_size / sec,
                      "sm_clock_power": clock_power()})
    res["turns"] = turns
    res["rays_per_s"] = {k: sum(t["rays_per_s"] for t in turns
                                if t["kind"] == k) / 2 for k in fns}

    y = torch.randn(cfg.batch_size * cfg.num_samples, cfg.net_width,
                    device=device)
    parts = [torch.empty_like(y)]
    times = []
    for i in range(ALLREDUCE_REPS + 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_gather(parts, y, group=grid.model_group)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    times.sort()
    res["allgather"] = {"shape": list(y.shape), "bytes": y.numel() * 4,
                        "median_ms": times[len(times) // 2],
                        "min_ms": times[0], "reps": ALLREDUCE_REPS}

    ckpt = os.path.join(work, "ckpt")
    args = [f"--data-dir={scene}", f"--checkpoint-dir={ckpt}",
            f"--max-steps={TP_RUN_STEPS}", "--print-every=1",
            f"--test-render-interval={TP_RUN_STEPS}", "--mesh-shape=1,1",
            "--device=cuda"]
    expected = render_launches(cfg, test_dims(scene, cfg, 1))
    res["run_train_s"] = run_main("tensor 1x1: run train --mesh-shape=1,1",
                                  ["train", *args], expected)
    res["launches"] = launch_counts()
    with open(os.path.join(ckpt, "train_stats.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    latest = ckpt_lib.latest_checkpoint(ckpt)
    if len(losses) != TP_RUN_STEPS or not all(map(math.isfinite, losses)) \
            or not latest.endswith(f"checkpoint_{TP_RUN_STEPS:09d}.npz"):
        raise AssertionError(f"tensor 1x1 run train: losses {losses}, "
                             f"checkpoint {latest}")
    res["run_losses"] = losses
    dist.destroy_process_group()
    return res


def tensor_rank(rank: str, dp: str, mp: str, backend: str, scene: str,
                work: str, store: str, out: str) -> dict:
    """Rank ``rank`` of a ``dp`` x ``mp`` grid (gloo: every rank on the
    one card; nccl: rank r on cuda:r): ``TP_GLOO_STEPS`` tensor-parallel
    steps at Config() on its row block of the parent's batches
    (randomized), no kernel launched; its blocks, the gathered state and
    the stats written for the parent."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.parallel import mesh
    from nerf_or_nothing_tpu_torch.rays import Rays

    rank, dp, mp = int(rank), int(dp), int(mp)
    mesh.initialize(f"file://{store}", dp * mp, rank, "cuda", backend=backend)
    grid = mesh.create_mesh_2d(dp, mp, device="cuda")
    device = grid.device
    cfg = run.parse_flags([f"--data-dir={scene}", "--randomized=true"])
    with np.load(os.path.join(work, "tp_batches.npz")) as f:
        batches = [train_lib.batch_to_device(device, *mesh.shard_batch(
            grid.batch_mesh, Rays(*[f[f"{k}/rays{j}"] for j in range(7)]),
            f[f"{k}/pixels"])) for k in range(len(f.files) // 8)]
    step = mesh.make_tensor_parallel_train_step(cfg, grid)
    state = mesh.shard_state(train_lib.init_train_state(cfg, device), grid,
                             cfg)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:TP_GLOO_STEPS]:
        state, stats = step(state, *b)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check_launches(f"tensor {dp}x{mp} rank {rank}", launch_counts(),
                   dict.fromkeys(KERNELS, 0))
    whole = mesh.gather_state(state, grid, cfg)
    arrays = {f"shard/{k}": t.cpu().numpy()
              for k, t, _ in state_pairs(state, state)}
    arrays.update({f"whole/{k}": t.cpu().numpy()
                   for k, t, _ in state_pairs(whole, whole)})
    arrays.update({f"stats/{k}": getattr(stats, k).cpu().numpy()
                   for k in STAT_NAMES})
    np.savez(os.path.join(work, f"tp_{dp}x{mp}_r{rank}.npz"), **arrays)
    res = {"rank": rank, "b": grid.b, "m": grid.m, "device": str(device),
           "backend": dist.get_backend(), "rows": int(b[1].shape[0]),
           "s": sec, "rays_per_s": TP_GLOO_STEPS * cfg.batch_size / sec,
           "loss": float(stats.loss)}
    dist.destroy_process_group()
    return res


def grid_children(dp: int, mp: int, backend: str, scene: str, work: str):
    """Start the ``dp`` x ``mp`` grid's ranks (``tensor_rank``) and wait
    for them: (their results, seconds)."""
    t0 = time.perf_counter()
    ranks = wait_children([run_child(
        f"{dp} x {mp} {backend} rank {r}", "grid", str(r), str(dp), str(mp),
        backend, scene, work, os.path.join(work, f"store_{dp}x{mp}"),
        os.path.join(work, f"tp_{dp}x{mp}_{r}.json"))
        for r in range(dp * mp)])
    return ranks, time.perf_counter() - t0


def grid_check(cfg, batches, work: str, dp: int, mp: int, device) -> dict:
    """The ranks' gathered state and stats after ``TP_GLOO_STEPS`` steps
    against the plain single-process step (``use_pallas=False``) on the
    whole batches, in the bf16 band; each block against the rank of row 0
    in its column, and the replicated layers, the gathered state and the
    stats against rank 0, bit for bit."""
    import numpy as np
    import torch

    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.parallel import mesh

    ref = train_lib.init_train_state(cfg, device)
    step = train_lib.make_train_step(cfg.replace(use_pallas=False))
    for rays, pixels in batches[:TP_GLOO_STEPS]:
        ref, ref_stats = step(ref, *train_lib.batch_to_device(device, rays,
                                                              pixels))
    got = [dict(np.load(os.path.join(work, f"tp_{dp}x{mp}_r{r}.npz")))
           for r in range(dp * mp)]
    sharded = mesh.layer_sharded(cfg, mp)
    errs, max_abs = check_pairs(f"tensor {dp}x{mp}", [
        (k, torch.from_numpy(got[0][f"whole/{k}"]), t.cpu())
        for k, t, _ in state_pairs(ref, ref)] + [
        (f"stats/{k}", torch.from_numpy(got[0][f"stats/{k}"]).reshape(-1),
         getattr(ref_stats, k).cpu().reshape(-1)) for k in STAT_NAMES],
        "bfloat16")
    unequal = []
    for r in range(dp * mp):
        for k in got[r]:
            layer = int(re.search(r"(\d+)$", k).group(1)) if (
                k.startswith("shard/")) else None
            other = got[r % mp] if layer is not None and sharded[layer] \
                else got[0]
            if not np.array_equal(got[r][k], other[k]):
                unequal.append(f"rank{r}/{k}")
    res = {"grid": [dp, mp], "steps": TP_GLOO_STEPS,
           "batch": cfg.batch_size, "randomized": cfg.randomized,
           "sharded_layers": sharded,
           "worst_normalized_err_bf16_band": max(errs.values()),
           "worst": max(errs, key=errs.get), "max_abs_err": max_abs,
           "ranks_unequal": unequal}
    if unequal or res["worst_normalized_err_bf16_band"] >= 1.0:
        emit({"phase": "tensor", **res})
        raise AssertionError(f"tensor {dp}x{mp}: {res}")
    return res


def save_batches(work: str, batches) -> None:
    import numpy as np

    np.savez(os.path.join(work, "tp_batches.npz"), **{
        f"{k}/{f}": x for k, (rays, pixels) in enumerate(batches)
        for f, x in [*[(f"rays{j}", r) for j, r in enumerate(rays)],
                     ("pixels", pixels)]})


def tensor_phase(device, scene: str) -> dict:
    """Tensor parallelism in child processes (see the module docstring):
    a 1 x 1 grid on NCCL, then a 2 x 2 grid of four gloo ranks on the one
    card held against this process's plain steps. Returns the launches of
    ``run train --mesh-shape=1,1``."""
    from nerf_or_nothing_tpu_torch import run

    work = tempfile.mkdtemp(prefix="chip_smoke_tensor_")
    t0 = time.perf_counter()
    one, = wait_children([run_child(
        "1 x 1 NCCL grid", "grid1x1", scene, work,
        os.path.join(work, "store1"), os.path.join(work, "grid1x1.json"))])
    one["child_s"] = time.perf_counter() - t0
    emit({"phase": "tensor", "check": "grid_1x1_nccl", **one})
    if one["unequal"]:
        raise AssertionError(f"tensor 1x1: differs from the plain step: "
                             f"{one['unequal']}")

    cfg = run.parse_flags([f"--data-dir={scene}", "--randomized=true"])
    batches = loader_batches(scene, cfg, TP_GLOO_STEPS)
    save_batches(work, batches)
    ranks, children_s = grid_children(2, 2, "gloo", scene, work)
    emit({"phase": "tensor", "check": "grid_2x2_gloo_one_card",
          "children_s": children_s, "ranks": ranks,
          **grid_check(cfg, batches, work, 2, 2, device)})
    return one["launches"]


def recovery_args(dump: str, ckpt: str, device: str):
    """``run train``'s arguments of the recovery phase: ``Config()``, every
    step a graph replay, a checkpoint and a log line every chunk."""
    return [f"--data-dir={dump}", "--dataset-loader=bin",
            f"--checkpoint-dir={ckpt}", f"--max-steps={RECOVERY_STEPS}",
            f"--steps-per-call={GRAPH_K}", f"--save-every={GRAPH_K}",
            f"--print-every={GRAPH_K}", "--test-render-interval=0",
            f"--device={device}"]


def recovery_run(dump: str, ckpt: str, device: str, pace_s: str,
                 out: str) -> dict:
    """A recovery child: ``run.main(["train", ...])`` with the launch
    counters from 0; with ``pace_s`` > 0 each checkpoint is written that
    many seconds late, so that a kill on the appearance of one lands in
    the next chunk's steps, and ``OUT.step`` holds the last step done."""
    import torch

    from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
    from nerf_or_nothing_tpu_torch import run

    save = ckpt_lib.save_checkpoint

    def paced(ckpt_dir, state, *a, **k):
        with open(f"{out}.step", "w") as f:
            f.write(str(state.step))
        time.sleep(float(pace_s))
        return save(ckpt_dir, state, *a, **k)

    if float(pace_s) > 0:
        ckpt_lib.save_checkpoint = paced
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = run.main(["train", *recovery_args(dump, ckpt, device)])
    if device == "cuda":
        torch.cuda.synchronize()
    return {"rc": rc, "train_s": time.perf_counter() - t0,
            "launches": launch_counts()}


def start_recovery(work: str, name: str, dump: str, device: str,
                   pace_s: float = 0.0):
    """A recovery child in its own session (``os.killpg`` ends it all);
    (process, its checkpoint directory, its result file)."""
    ckpt = os.path.join(work, name)
    out = os.path.join(work, f"{name}.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.mesh_child(*sys.argv[1:]))", "recovery", dump,
         ckpt, device, str(pace_s), out],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return proc, ckpt, out


def end_recovery(proc, what: str, out: str) -> tuple:
    """Wait for a recovery child (``MESH_WAIT_S``); its result, stdout and
    the process's own wall time from its start."""
    t0 = time.perf_counter()
    try:
        stdout, err = proc.communicate(timeout=MESH_WAIT_S)
    except subprocess.TimeoutExpired:
        kill_session(proc)
        raise AssertionError(f"recovery: {what} did not end within "
                             f"{MESH_WAIT_S} s")
    if proc.returncode != 0:
        raise AssertionError(f"recovery: {what} exited with "
                             f"{proc.returncode}:\n{err[-4000:]}")
    with open(out) as f:
        return json.load(f), stdout, time.perf_counter() - t0


def live_in_session(sid: int) -> list:
    """The pids of the live (not zombie) processes of session ``sid``."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(pid))
    return pids


def kill_session(proc) -> None:
    """SIGKILL a child's whole session and wait until nothing of it
    lives."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=60)
    deadline = time.time() + 60
    while live_in_session(proc.pid):
        if time.time() > deadline:
            raise AssertionError(f"recovery: processes "
                                 f"{live_in_session(proc.pid)} outlived the "
                                 "kill")
        time.sleep(0.1)


def recovery_dump(scene: str, path: str) -> None:
    """A bin dump of one ray of the scene (the centre of train view 0)
    repeated: every batch is the same, whatever the loader's stream."""
    import numpy as np

    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.datasets.bin_dump import write_bin_dump
    from nerf_or_nothing_tpu_torch.rays import Rays

    with create_dataset("train", scene, Config()) as ds:
        h, w = ds.image_dims(0)
        i = (h // 2) * w + w // 2
        rays = Rays(*[np.repeat(np.asarray(x)[i:i + 1], 8, 0)
                      for x in ds._flat_rays])
        pixels = np.repeat(np.asarray(ds._flat_pixels)[i:i + 1], 8, 0)
    write_bin_dump(path, rays, pixels)


def recovery_phase(device, scene: str) -> dict:
    """``run train`` at ``Config()`` as graph replays in child processes
    on the card: an uninterrupted run; a second one SIGKILLed (its whole
    session) once its step-16 checkpoint exists; the surviving
    checkpoints loaded; the same command again, which resumes and must end
    bit-equal to the first (params, mu, nu, step), each run's
    ``train_level`` launches exact (2 a step, its capture's warm-up steps
    included). Returns the launches of the two runs that end."""
    import numpy as np

    from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
    from nerf_or_nothing_tpu_torch import run
    from nerf_or_nothing_tpu_torch import train as train_lib

    work = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    dump = os.path.join(work, "one_ray.bin")
    recovery_dump(scene, dump)
    dev = device.type
    cfg = run.parse_flags([a for a in recovery_args(dump, work, dev)
                           if not a.startswith("--device=")])

    def expected(start):
        return step_launches(cfg, RECOVERY_STEPS - start
                             + train_lib.WARMUP_STEPS)

    proc, ref_dir, out = start_recovery(work, "reference", dump, dev)
    ref, _, ref_wall = end_recovery(proc, "the uninterrupted run", out)
    check_launches("recovery: uninterrupted run", ref["launches"],
                   expected(0))

    proc, ckpt, out = start_recovery(work, "faulted", dump, dev,
                                     RECOVERY_PACE_S)
    target = os.path.join(ckpt, f"checkpoint_{RECOVERY_KILL_AT:09d}.npz")
    t0 = time.perf_counter()
    try:
        while not os.path.exists(target):
            if proc.poll() is not None:
                raise AssertionError(f"recovery: the run to be killed ended "
                                     f"with {proc.returncode}:\n"
                                     f"{proc.stderr.read()[-4000:]}")
            if time.perf_counter() - t0 > MESH_WAIT_S:
                raise AssertionError("recovery: no step-16 checkpoint in "
                                     f"{MESH_WAIT_S} s")
            time.sleep(0.002)
        alive = proc.poll() is None
    finally:
        kill_session(proc)
    faulted_wall = time.perf_counter() - t0
    with open(f"{out}.step") as f:
        done = int(f.read())
    # Steps done when the kill came: the chunk after the newest checkpoint
    # was running (done == its step), or it had ended and its checkpoint
    # was waiting on the pace.
    killed_in = (f"steps {done + 1}-{done + GRAPH_K}"
                 if done == RECOVERY_KILL_AT
                 else f"the pause after step {done}")
    names = sorted(os.listdir(ckpt))
    steps = []
    for n in names:
        if ckpt_lib._CKPT_RE.match(n):
            state = ckpt_lib.restore_checkpoint(os.path.join(ckpt, n), cfg)
            if n != f"checkpoint_{state.step:09d}.npz":
                raise AssertionError(f"recovery: {n} holds step {state.step}")
            steps.append(state.step)
    leftovers = [n for n in names if n.endswith(".tmp")]
    if not alive or not steps or max(steps) >= RECOVERY_STEPS:
        raise AssertionError(f"recovery: the kill came too late (alive "
                             f"{alive}, checkpoints {steps})")

    proc, _, out = start_recovery(work, "faulted", dump, dev)
    restart, stdout, restart_wall = end_recovery(proc, "the restart", out)
    found = re.findall(r"resumed from step (\d+)", stdout)
    resumed = int(found[0]) if found else None
    want = ckpt_lib.latest_checkpoint(ref_dir)
    got = ckpt_lib.latest_checkpoint(ckpt)
    with np.load(want) as a, np.load(got) as b:
        differ = sorted(k for k in set(a.files) | set(b.files)
                        if k not in a.files or k not in b.files
                        or not np.array_equal(a[k], b[k]))
        end_step = int(b["step"])
    res = {
        "phase": "recovery", "config": "Config()", "steps": RECOVERY_STEPS,
        "steps_per_call": GRAPH_K, "save_every": GRAPH_K,
        "kill_on_checkpoint": RECOVERY_KILL_AT, "killed_in": killed_in,
        "checkpoints_after_kill": steps, "tmp_leftovers": leftovers,
        "resumed_from": resumed, "end_step": end_step,
        "bit_equal": not differ, "differ_in": differ,
        "train_level_launches": {
            "uninterrupted": ref["launches"]["train_level"],
            "restart": restart["launches"]["train_level"]},
        "wall_s": {"uninterrupted": ref_wall, "faulted": faulted_wall,
                   "restart": restart_wall},
        "run_main_s": {"uninterrupted": ref["train_s"],
                       "restart": restart["train_s"]},
    }
    emit(res)
    if resumed is None or resumed < RECOVERY_KILL_AT or resumed != max(steps):
        raise AssertionError(f"recovery: resumed from {resumed}, checkpoints "
                             f"{steps}")
    check_launches("recovery: restart", restart["launches"],
                   expected(resumed))
    if differ or end_step != RECOVERY_STEPS:
        raise AssertionError(f"recovery: the restarted run ends at step "
                             f"{end_step} and differs in {differ}")
    return added(ref["launches"], restart["launches"])


def quality_config(root: str):
    """The JAX package's quality harness's config at ``--full``
    (``benchmarks/bench_quality.py``): ``Config()``'s widths."""
    from nerf_or_nothing_tpu_torch.config import Config, DatasetType

    return Config(batch_size=1024, dataset_loader=DatasetType.BLENDER,
                  lr_delay_steps=100, lr_init=1e-3, lr_final=1e-4,
                  max_steps=QUALITY_MAX_STEPS, data_dir=root)


def jax_quality_curve() -> dict:
    """The JAX package's recorded run on the hard scene at ``--full``
    (train PSNR every 250 steps, held-out view 0); only its PSNR and SSIM
    values are read."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, QUALITY_ARTIFACT)) as f:
        return json.load(f)


def window_mean(curve, lo: int, hi: int) -> float:
    """The mean train PSNR of the curve's points at steps lo..hi."""
    vals = [p["train_psnr"] for p in curve if lo <= p["step"] <= hi]
    return sum(vals) / len(vals)


def quality_run(device, steps: int, work: str) -> dict:
    """The hard scene (24 train, 3 test views at 256x256) written on the
    host, then ``steps`` steps of ``train.make_multi_step`` at
    ``quality_config`` on the card, ``GRAPH_K`` a call; the curve as the
    mean of the calls' train PSNR (each the last step's) over each
    250-step window, beside the JAX curve; held-out view 0 through
    ``eval.render_image`` scored by ``eval.evaluate_image``; exact
    launches; train rays/s."""
    import torch

    from nerf_or_nothing_tpu_torch import train as train_lib
    from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
    from nerf_or_nothing_tpu_torch.eval import (
        evaluate_image,
        make_render_fn,
        render_image,
        to_display,
    )
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    root = os.path.join(work, "hard")
    t0 = time.perf_counter()
    write_scene(root, **QUALITY_SCENE)
    scene_s = time.perf_counter() - t0
    cfg = quality_config(root)
    state = train_lib.init_train_state(cfg, device)
    multi = train_lib.make_multi_step(cfg)
    ends, psnrs, losses = [], [], []
    reset_launch_counts()
    with create_dataset("train", root, cfg) as ds:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        while state.step < steps:
            k = min(GRAPH_K, steps - state.step)
            state, stats = multi(state, [next(ds) for _ in range(k)])
            ends.append(state.step)
            psnrs.append(stats.psnr)
            losses.append(stats.loss)
        torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0
    launches = launch_counts()
    psnrs = torch.stack(psnrs).cpu().tolist()
    losses = torch.stack(losses).cpu().tolist()
    finite = (all(math.isfinite(v) for v in losses) and all(
        bool(torch.isfinite(t).all()) for t in train_lib.state_tensors(state)))
    check_launches("quality: train", launches,
                   step_launches(cfg, steps + train_lib.WARMUP_STEPS))

    with create_dataset("test", root, cfg) as test_ds:
        rays, gt = test_ds.image_rays(0)
        h, w = test_ds.image_dims(0)
    reset_launch_counts()
    t0 = time.perf_counter()
    rgb, _, _ = render_image(make_render_fn(cfg), state.params, rays, h, w,
                             cfg.render_chunk_size, device=device)
    m = evaluate_image(to_display(cfg, rgb),
                       to_display(cfg, gt.reshape(h, w, 3)), device=device)
    render_s = time.perf_counter() - t0
    render = launch_counts()
    check_launches("quality: held-out render", render,
                   render_launches(cfg, [(h, w)]))

    jax = jax_quality_curve()
    curve = []
    for hi in range(250, steps + 1, 250):
        vals = [p for e, p in zip(ends, psnrs) if hi - 250 < e <= hi]
        jax_at = [p["train_psnr"] for p in jax["curve"] if p["step"] == hi]
        curve.append({"step": hi, "train_psnr": sum(vals) / len(vals),
                      "calls": len(vals),
                      "jax_train_psnr": jax_at[0] if jax_at else None})
    return {
        "steps": steps, "steps_per_call": GRAPH_K, "scene": QUALITY_SCENE,
        "scene_s": scene_s,
        "train_s": train_s, "train_rays_per_s":
        steps * cfg.batch_size / train_s, "render_s": render_s,
        "curve": curve, "psnr_by_call": list(zip(ends, psnrs)),
        "heldout": {"psnr": m["psnr"], "ssim": m["ssim"]},
        "jax_heldout": jax["heldout"][0], "finite": finite,
        "launches": added(launches, render),
    }


def quality_phase(device) -> dict:
    """``quality_run`` for ``QUALITY_STEPS`` steps and its gates: the
    window mean over steps 2,251-3,000 within 1.5 dB of the JAX curve's
    points at 2,250-3,000, the held-out view at least 17 dB (the JAX
    harness's numerics-regression line), every loss finite. Returns its
    launches."""
    res = quality_run(device, QUALITY_STEPS, tempfile.mkdtemp(
        prefix="chip_smoke_quality_"))
    lo = QUALITY_STEPS - 750
    window = [p for e, p in res["psnr_by_call"] if lo < e <= QUALITY_STEPS]
    mean = sum(window) / len(window)
    jax_mean = window_mean(jax_quality_curve()["curve"], lo, QUALITY_STEPS)
    gates = {"window_mean": mean >= jax_mean - QUALITY_MARGIN_DB,
             "heldout": res["heldout"]["psnr"] >= QUALITY_HELDOUT_DB,
             "finite": res["finite"]}
    emit({"phase": "quality", "window": [lo + 1, QUALITY_STEPS],
          "window_mean_psnr": mean, "jax_window_mean_psnr": jax_mean,
          "gates": gates, "device": nvidia_smi_line(),
          **{k: v for k, v in res.items() if k != "psnr_by_call"}})
    if not all(gates.values()):
        raise AssertionError(f"quality: gates failed {gates}")
    return res["launches"]


def ptxas_lines(log: str):
    """ptxas's register, spill and serialized-wgmma (C7511) lines of a
    build, each kernel's under its name."""
    out = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            out.append("kernel " + kernel_name(ln))
        elif "registers" in ln or "spill" in ln or "C7511" in ln:
            out.append(ln.strip())
    return out


def kernel_name(line: str) -> str:
    """The ``..._kernel`` name in a ptxas line's mangled symbol (the
    length-prefixed names after ``_ZN``), else the line."""
    sym = line.split("'")[1] if line.count("'") >= 2 else line
    i, names = sym.find("_ZN") + 3, []
    while 2 < i < len(sym):
        m = re.match(r"\d+", sym[i:])
        if m is None:
            i += 1
            continue
        i += len(m.group())
        names.append(sym[i:i + int(m.group())])
        i += int(m.group())
    return next((n for n in names if n.endswith("_kernel")), line.strip())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from nerf_or_nothing_tpu_torch.config import Config
    from nerf_or_nothing_tpu_torch.kernels import build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    peaks_name, peaks = card_peaks(name)
    emit({
        "phase": "env", "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1], "device": name,
        "nvidia_smi": smi, "triton": has_triton, "peaks_of": peaks_name,
        "peaks": {"bf16_flops": peaks[0], "f32_flops": peaks[1],
                  "bytes_per_s": peaks[2]},
    })
    t0 = time.perf_counter()
    sources = build.SOURCES
    old = mma_sources() or {}
    build.build_all(sources, list(old.items()))
    seconds = time.perf_counter() - t0
    for src in [build.source_path(n) for n in sources] + list(old.values()):
        info = build.BUILD_INFO[str(src)]
        emit({
            "phase": "build", "source": os.path.relpath(src),
            "seconds": seconds, "nvcc_seconds": info["seconds"],
            "ptxas": ptxas_lines(info["log"]),
        })

    base = Config()
    main_case = kernel_case("config_r16384_s128_mv", base, 16384, "mv", True,
                            peaks, device)
    kernel_case("config_r16384_s128_mv_f32",
                base.replace(compute_dtype="float32"), 16384, "mv", True,
                peaks, device)
    c64 = base.replace(num_samples=64)
    for dtype in ("bfloat16", "float32"):
        kernel_case(f"config_r1000_s64_t_{dtype}",
                    c64.replace(compute_dtype=dtype), 1000, "t", False,
                    peaks, device, seed=2)
    narrow = base.replace(num_samples=8, net_depth=3, net_width=64,
                          net_width_condition=32, skip_layer=2,
                          max_deg_point=4)
    for dtype in ("bfloat16", "float32"):
        kernel_case(f"narrow_r37_s8_mv_{dtype}",
                    narrow.replace(compute_dtype=dtype), 37, "mv", True,
                    peaks, device, seed=3)

    turns_phase(device)

    launches = main_path(peaks, device)

    train_case = train_kernel_case("config_r1024_s128_t", base, 1024, "t",
                                   True, peaks, device, bit_check=True)
    train_kernel_case("config_r1024_s128_t_f32",
                      base.replace(compute_dtype="float32"), 1024, "t", True,
                      peaks, device)
    train_kernel_case("config_r1024_s128_mv", base.replace(fuse_ipe=True),
                      1024, "mv", True, peaks, device, seed=4)
    train_kernel_case("config_r777_s128_t_masked", base, 777, "t", False,
                      peaks, device, seed=5, bit_check=True)
    tnarrow = base.replace(net_depth=3, net_width=64, net_width_condition=32,
                           skip_layer=2, max_deg_point=4)
    for dtype in ("bfloat16", "float32"):
        train_kernel_case(f"narrow_r1000_s64_t_dc2_{dtype}",
                          tnarrow.replace(num_samples=64, net_depth_condition=2,
                                          compute_dtype=dtype),
                          1000, "t", False, peaks, device, seed=6)
        train_kernel_case(f"narrow_r37_s256_mv_{dtype}",
                          tnarrow.replace(num_samples=256, compute_dtype=dtype),
                          37, "mv", True, peaks, device, seed=7)
    from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene

    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    scene = os.path.join(work, "scene")
    t0 = time.perf_counter()
    write_scene(scene, n_train=4, n_test=1, size=400)
    scene_s = time.perf_counter() - t0
    train_launches, train_record = train_path(peaks, device, scene,
                                              TRAIN_STEPS, setup_s=scene_s)

    mlp_fwd_main = mlp_fwd_case("config_r16384_s128", base, 16384, peaks,
                                device)
    mlp_fwd_case("config_r16384_s128_f32", base.replace(compute_dtype="float32"),
                 16384, peaks, device)
    mlp_fwd_case("config_r1024_s128", base, 1024, peaks, device, seed=1)
    heads = narrow.replace(num_rgb_channels=4, num_density_channels=2,
                           net_depth=5, num_samples=24)
    for dtype in ("bfloat16", "float32"):
        mlp_fwd_case(f"narrow_heads_4_2_r37_s24_{dtype}",
                     heads.replace(compute_dtype=dtype), 37, peaks, device,
                     seed=2)
    mlp_bwd_main = mlp_bwd_case("config_r1024_s128_dx", base, 1024, True,
                                peaks, device, bit_check=True)
    mlp_bwd_case("config_r1024_s128", base, 1024, False, peaks, device,
                 seed=3)
    mlp_bwd_case("config_r1024_s128_dx_f32",
                 base.replace(compute_dtype="float32"), 1024, True, peaks,
                 device, seed=4)
    for dtype in ("bfloat16", "float32"):
        mlp_bwd_case(f"narrow_r37_s256_dx_{dtype}",
                     tnarrow.replace(num_samples=256, compute_dtype=dtype),
                     37, True, peaks, device, seed=5, bit_check=True)
    full_launches, _ = train_path(peaks, device, scene, FULL_GRAD_STEPS,
                                  FULL_GRAD_ARGS, "train_full_grad")

    twopass_main = train_kernel_case("config_r1024_s128_t", base, 1024, "t",
                                     True, peaks, device, bit_check=True,
                                     twopass=True)
    train_kernel_case("config_r1024_s128_t_f32",
                      base.replace(compute_dtype="float32"), 1024, "t", True,
                      peaks, device, twopass=True)
    train_kernel_case("config_r777_s128_t_masked_multicam", base, 777, "t",
                      False, peaks, device, seed=5, bit_check=True,
                      twopass=True, multicam=True)
    deep = tnarrow.replace(net_depth=5, num_samples=256)
    for dtype in ("bfloat16", "float32"):
        train_kernel_case(f"narrow_d5_r37_s256_t_{dtype}",
                          deep.replace(compute_dtype=dtype), 37, "t", True,
                          peaks, device, seed=7, bit_check=True, twopass=True)
    multicam_launches, _ = train_path(
        peaks, device, scene, MULTICAM_STEPS, MULTICAM_ARGS, "multicam",
        eval_args=("--max-images=4",), path_frames=2)

    llff = os.path.join(work, "llff")
    t0 = time.perf_counter()
    write_llff_scene(llff)
    train_path(peaks, device, llff, LOADER_STEPS,
               ("--dataset-loader=llff", "--white-bkgd=false"), "llff",
               eval_args=("--spherify=true",), path_frames=2,
               setup_s=time.perf_counter() - t0)

    bin_path(peaks, device, scene, work)

    graph_phase(device, scene, train_record)

    mesh_launches = mesh_phase(device, scene)
    mesh_launches = added(mesh_launches, tensor_phase(device, scene))
    mesh_launches = added(mesh_launches, recovery_phase(device, scene))
    mesh_launches = added(mesh_launches, quality_phase(device))

    def entry(name, case, n, replaces):
        return {
            "name": name, "route": "cuda",
            "source": f"nerf_or_nothing_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": n + mesh_launches[name],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
        }

    emit({"kernels": [
        entry("render_level", main_case, launches, TPU_KERNEL),
        entry("train_level", train_case, train_launches["train_level"],
              TPU_TRAIN_KERNEL),
        entry("mlp_fwd", mlp_fwd_main, full_launches["mlp_fwd"], TPU_MLP_FWD),
        entry("mlp_bwd", mlp_bwd_main, full_launches["mlp_bwd"], TPU_MLP_BWD),
        entry("train_level_twopass", twopass_main,
              multicam_launches["train_level_twopass"], TPU_TWOPASS_KERNEL),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
