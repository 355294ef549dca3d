"""Train / eval / render entry points of the PyTorch/CUDA port.

CLI (same config flags as ``nerf_or_nothing_tpu.run``):
  python -m nerf_or_nothing_tpu_torch.run train  --data-dir=... --max-steps=...
  python -m nerf_or_nothing_tpu_torch.run eval   --data-dir=... --checkpoint-dir=...
  python -m nerf_or_nothing_tpu_torch.run render --data-dir=... --out=...
Loaders: --dataset-loader=blender|llff|multicam|bin (bin: --data-dir is
the dump file); --render-path renders the loader's novel-view path.
Extra flags: --out=DIR, --max-images=N, --device=cuda|cpu (default cuda;
without a card the run raises unless --device=cpu is given).
Train: --steps-per-call=K runs K steps a call (on the card, replays of one
captured CUDA graph of the step); --profile-dir=DIR writes a torch.profiler
trace of steps 11-20; --check-numerics / --debug-nans raise on a nan or an
inf in the loss or the gradients before the update is applied.

Data parallelism (parallel/mesh.py; NCCL between cards, gloo on the CPU):
  train --mesh-shape=N   N ranks, one process a device, started by this
      command (on the card cuda:0..N-1; with --device=cpu, N CPU
      processes); --mesh-shape=() with an unindexed cuda on a host with
      several cards takes them all. As in the JAX package's one process
      over N devices, the N ranks share --batch-size: each reads the whole
      pixel pool, draws the global batch from --seed and keeps its row
      block of batch_size / N rays, and a batch size that N does not
      divide raises.
  train --mesh-shape=DP,MP   tensor parallelism (JAX's
      make_tensor_parallel_train_step): DP x MP ranks started as above
      (or joined by the launch flags, exactly DP x MP of them), rank
      b * MP + m holds row block b of the global batch and column block m
      of every layer MP divides; the plain MLP (no kernels), one step a
      call. Checkpoints hold the whole model.
  --coordinator=HOST:PORT --num-processes=P --process-id=I (or the
      NERF_COORDINATOR, NERF_NUM_PROCESSES, NERF_PROCESS_ID variables):
      this process is rank I of P (one a card, or one on the CPU with
      --platform=cpu); start one command a rank. As in the JAX package's
      multi-host run, each process draws --batch-size rays a step from
      its stripe: the batch of a step is P x batch_size. eval and render
      started so split each image's chunks over the ranks.
  --platform=cpu (NERF_PLATFORM) means --device=cpu.
Rank 0 alone logs, checkpoints, runs the periodic test render, prints
eval's metrics and writes PNGs. A mesh_shape of three or more axes raises
ValueError.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
from nerf_or_nothing_tpu_torch.config import Config, parse_flags
from nerf_or_nothing_tpu_torch.datasets.base import create_dataset
from nerf_or_nothing_tpu_torch.device import resolve_device
from nerf_or_nothing_tpu_torch.eval import (
    evaluate_dataset,
    evaluate_image,
    make_render_fn,
    render_image,
    to_display,
)
from nerf_or_nothing_tpu_torch.metrics import MetricsLogger
from nerf_or_nothing_tpu_torch.models.mlp import Params, init_mlp
from nerf_or_nothing_tpu_torch.parallel import mesh as mesh_lib
from nerf_or_nothing_tpu_torch.train import (
    TrainState,
    batch_to_device,
    init_train_state,
)
from nerf_or_nothing_tpu_torch.utils import profiling


def load_params(cfg: Config, device) -> Params:
    """Seeded initial parameters, replaced by the newest checkpoint in
    ``cfg.checkpoint_dir`` when there is one."""
    gen = torch.Generator().manual_seed(cfg.seed)
    params = init_mlp(gen, cfg, device=device)
    if cfg.checkpoint_dir:
        params = ckpt_lib.maybe_restore_params(
            cfg.checkpoint_dir, cfg, params, device=device
        )
    return params


def _chunk_len(step: int, cfg: Config, spc: int) -> int:
    """Steps until the next loop boundary (log/save/test-render/gc/end),
    capped at ``spc``: a multi-step chunk never skips a side-effect step."""
    nxt = cfg.max_steps - step
    for interval in (cfg.print_every, cfg.save_every,
                     cfg.test_render_interval, cfg.gc_every):
        if interval > 0:
            nxt = min(nxt, (step // interval + 1) * interval - step)
    return max(1, min(spc, nxt))


def mesh_size(cfg: Config, device: torch.device) -> int:
    """The ranks ``train`` starts for ``cfg.mesh_shape`` in one command: N
    for (N,), DP x MP for (DP, MP); for () every card of the host with an
    unindexed ``cuda`` (the JAX package's all local devices), else 1. Three
    or more axes raise ValueError."""
    shape = tuple(cfg.mesh_shape)
    if len(shape) > 2:
        raise ValueError(f"mesh_shape must be 1-D or 2-D, got {shape}")
    if shape:
        return math.prod(shape)
    if device.type == "cuda" and device.index is None:
        return max(1, torch.cuda.device_count())
    return 1


def train(cfg: Config, log_dir: Optional[str] = None,
          device="cuda") -> TrainState:
    """The training loop of ``nerf_or_nothing_tpu.run.train``.

    In a process group (the launch flags) this process trains as one rank
    of it; otherwise ``mesh_size`` ranks, started by ``mesh.spawn`` when
    there are several, sharing each step's ``batch_size`` rays. Returns
    the final state (the whole model), rank 0's on the CPU when the ranks
    were spawned. The loop itself is ``train_rank``'s."""
    device = resolve_device(device)
    shape = tuple(cfg.mesh_shape)
    n = mesh_size(cfg, device)
    joined = mesh_lib.world_size()
    if joined > 1 and shape and n != joined:
        raise ValueError(f"mesh_shape {shape} in a group of {joined} "
                         "processes")
    dp = shape[0] if shape else n
    if (len(shape) == 2 or joined == 1) and cfg.batch_size % dp:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over "
                         f"{dp} ranks")
    if joined > 1 or n == 1:
        return train_rank(cfg, log_dir, device)
    if device.type == "cuda" and (device.index is not None
                                  or n > torch.cuda.device_count()):
        raise ValueError(f"--mesh-shape={','.join(map(str, shape or (n,)))} "
                         f"needs {n} cards and an unindexed cuda; this host "
                         f"has {torch.cuda.device_count()}, asked for "
                         f"{device}")
    arrays = mesh_lib.spawn(_train_spawned, n, device, cfg, log_dir,
                            device.type)
    return ckpt_lib.state_from_arrays(arrays, cfg)


def _train_spawned(cfg: Config, log_dir: Optional[str], device: str):
    """A spawned rank's ``train_rank`` (the ranks stand for the devices of
    one process and share its batch); its state as numpy arrays."""
    state = train_rank(cfg, log_dir, device, shared=True)
    return ckpt_lib.state_arrays(state, cfg.seed)


def train_rank(cfg: Config, log_dir: Optional[str] = None,
               device="cuda", shared: bool = False) -> TrainState:
    """The training loop on this rank's device (one device without a
    group): multi-step chunks cut at every side-effect step (with
    ``steps_per_call`` > 1 and no ``profile_dir``; on the card each step a
    replay of one captured CUDA graph, ``train.make_multi_step``), logging
    every ``print_every``, checkpoints every ``save_every`` and at the end,
    resume from the newest checkpoint, a held-out render of test view 0
    every ``test_render_interval`` (switched off with a message when the
    data has no test split) and ``gc_every``. ``profile_dir``: a
    ``torch.profiler`` trace of steps start+11 to start+20 written there.
    ``check_numerics`` checks the single steps, ``debug_nans`` every step
    (``train.make_train_step``).

    In a group every rank restores the same checkpoint and then takes
    rank 0's state (``mesh.replicate_state``) and trains with the
    gradients averaged over the ranks; rank 0 alone logs (rays/s of the
    whole group's batch), checkpoints and renders the test view. The
    launch flags' processes each draw a batch from their stripe of the
    pool (``shared`` False); ranks that share one process's batch
    (``shared``: spawned by ``train``) each read the whole pool, draw the
    global batch and keep their row block. A ``mesh_shape`` of two axes
    trains tensor-parallel (``mesh.make_tensor_parallel_train_step``, one
    step a call), its ranks sharing the batch over the ``'batch'`` axis;
    every rank then joins the gathers of the whole model for a checkpoint
    or a test render, and the final state is the whole model."""
    grid = None
    if len(tuple(cfg.mesh_shape)) == 2:
        grid = mesh_lib.create_mesh_2d(*cfg.mesh_shape, device=device)
        mesh, shared = grid.batch_mesh, True
    else:
        mesh = mesh_lib.create_mesh(device=device)
    device, lead = mesh.device, mesh_lib.rank() == 0
    dataset = create_dataset("train", cfg.data_dir, cfg, shared)
    state = init_train_state(cfg, device)
    if cfg.checkpoint_dir and cfg.resume:
        state = ckpt_lib.maybe_restore(cfg.checkpoint_dir, cfg, state,
                                       device=device)
        if state.step and lead:
            print(f"resumed from step {state.step}", flush=True)
    state = mesh_lib.replicate_state(state)
    spc = cfg.steps_per_call if (cfg.steps_per_call > 1 and grid is None
                                 and not cfg.profile_dir) else 1
    multi_fn = None
    if grid is None:
        step_fn = mesh_lib.make_sharded_train_step(cfg, mesh)
        if spc > 1:
            multi_fn = mesh_lib.make_sharded_multi_step(cfg, mesh)
    else:
        state = mesh_lib.shard_state(state, grid, cfg)
        step_fn = mesh_lib.make_tensor_parallel_train_step(cfg, grid)

    def rows(batch):
        return mesh_lib.shard_batch(mesh, *batch) if shared else batch

    def whole(state):
        return state if grid is None else mesh_lib.gather_state(state, grid,
                                                                cfg)

    logger = MetricsLogger(
        log_dir if lead else None,
        batch_size=cfg.batch_size * (1 if shared else mesh.world_size))
    test_ds = None
    render_fn = None
    start_step = step = state.step
    tracing = contextlib.ExitStack()
    try:
        while step < cfg.max_steps:
            k = _chunk_len(step, cfg, spc)
            if multi_fn is not None and (k > 1 or not cfg.check_numerics):
                # As in the JAX package a chunk of one step is the single
                # step when check_numerics is to check it.
                batches = [rows(next(dataset)) for _ in range(k)]
                state, stats = multi_fn(state, batches)
            else:
                if cfg.profile_dir and step + 1 == start_step + 11:
                    tracing.enter_context(profiling.trace(cfg.profile_dir))
                state, stats = step_fn(
                    state, *batch_to_device(device, *rows(next(dataset))))
                if cfg.profile_dir and state.step == start_step + 20:
                    tracing.close()
                    print(f"trace written to {cfg.profile_dir}", flush=True)
            step = state.step
            if step % cfg.print_every == 0 and lead:
                logger.log(step, stats)
            if cfg.checkpoint_dir and step % cfg.save_every == 0:
                ckpt_lib.save_checkpoint(cfg.checkpoint_dir, whole(state),
                                         cfg)
            # A grid's every rank joins the gather of the params, so every
            # rank opens the test split and finds out whether there is one.
            if (cfg.test_render_interval > 0
                    and step % cfg.test_render_interval == 0
                    and (lead or grid is not None)):
                try:
                    if test_ds is None:
                        test_ds = create_dataset("test", cfg.data_dir, cfg)
                        render_fn = make_render_fn(cfg)
                except OSError as e:  # no test split: say so once, stop
                    if lead:
                        print(f"test render disabled: {type(e).__name__}: "
                              f"{e}", flush=True)
                    cfg = cfg.replace(test_render_interval=0)
                else:
                    params = state.params if grid is None else (
                        mesh_lib.gather_params(state.params, grid, cfg))
                    if lead:
                        _test_render(cfg, render_fn, params, test_ds, step,
                                     device)
            if cfg.gc_every > 0 and step % cfg.gc_every == 0:
                gc.collect()
        # A run too short to reach the trace's last step stops it here.
        tracing.close()
        state = whole(state)
        if cfg.checkpoint_dir:
            ckpt_lib.save_checkpoint(cfg.checkpoint_dir, state, cfg)
        logger.close()
    finally:
        tracing.close()
        dataset.close()
        if test_ds is not None:
            test_ds.close()
    return state


def _test_render(cfg: Config, render_fn, params, test_ds, step: int,
                 device) -> None:
    """Render test view 0 on this device alone and print its metrics."""
    trays, tgt = test_ds.image_rays(0)
    th, tw = test_ds.image_dims(0)
    rgb, _, _ = render_image(render_fn, params, trays, th, tw,
                             cfg.render_chunk_size, device=device)
    m = evaluate_image(
        to_display(cfg, rgb),
        to_display(cfg, np.asarray(tgt).reshape(th, tw, 3)),
        device=device,
    )
    print(f"step {step:>7d}  test view 0: "
          f"psnr {m['psnr']:.2f} ssim {m['ssim']:.3f}", flush=True)


def _eval_mesh(device):
    """The group's mesh when this process is one of several ranks (the
    launch flags), else None: one device renders the whole image."""
    if mesh_lib.world_size() > 1:
        return mesh_lib.create_mesh(device=device)
    return None


def evaluate(cfg: Config, max_images: Optional[int] = None,
             device="cuda") -> dict:
    """Mean metrics over the test split, printed as one JSON line; in a
    group the ranks split each image and rank 0 prints and returns them
    (``{}`` elsewhere)."""
    mesh = _eval_mesh(device)
    device = mesh.device if mesh else resolve_device(device)
    params = load_params(cfg, device)
    with create_dataset("test", cfg.data_dir, cfg) as dataset:
        metrics = evaluate_dataset(cfg, params, dataset, max_images,
                                   device=device, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(json.dumps({"eval": metrics}), flush=True)
    return metrics


def render(cfg: Config, out_dir: str, max_images: Optional[int] = None,
           device="cuda"):
    """Render the test split, or with ``cfg.render_path`` the loader's
    novel-view camera path (Blender and Multicam orbit, LLFF spiral, or
    circle when spherified), to ``out_dir/render_XXX.png``; in a group the
    ranks split each image and rank 0 writes the PNGs."""
    from PIL import Image

    mesh = _eval_mesh(device)
    device = mesh.device if mesh else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    params = load_params(cfg, device)
    with create_dataset("test", cfg.data_dir, cfg) as dataset:
        render_fn = make_render_fn(cfg)
        os.makedirs(out_dir, exist_ok=True)
        if cfg.render_path and hasattr(dataset, "render_path_rays"):
            # [(flat rays, (h, w)), ...]: the image_rays contract.
            frames = dataset.render_path_rays()[:max_images]
        else:
            n = dataset.num_images if max_images is None else min(
                max_images, dataset.num_images
            )
            frames = ((dataset.image_rays(i)[0], dataset.image_dims(i))
                      for i in range(n))
        for i, (rays, (h, w)) in enumerate(frames):
            rgb, _, _ = render_image(
                render_fn, params, rays, h, w, cfg.render_chunk_size,
                device=device, mesh=mesh,
            )
            if not lead:
                continue
            rgb = to_display(cfg, rgb)
            img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(out_dir, f"render_{i:03d}.png")
            )
            print(f"wrote render_{i:03d}.png", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("train", "eval", "render"):
        print(__doc__)
        return 2
    command, rest = argv[0], argv[1:]
    out = None
    max_images = None
    device = "cuda"
    launch = {k: os.environ.get(f"NERF_{k.upper()}")
              for k in ("coordinator", "num_processes", "process_id",
                        "platform")}
    filtered = []
    for a in rest:
        key, _, value = a.partition("=")
        name = key[2:].replace("-", "_")
        if key == "--out":
            out = value
        elif key == "--max-images":
            max_images = int(value)
        elif key == "--device":
            device = value
        elif name in launch:
            launch[name] = value
        else:
            filtered.append(a)
    if launch["platform"]:
        device = _platform_device(launch["platform"])
    cfg = parse_flags(filtered)
    num = launch["num_processes"]
    pid = launch["process_id"]
    joined = torch.distributed.is_initialized()
    mesh_lib.initialize_multihost(
        launch["coordinator"], int(num) if num else None,
        int(pid) if pid else None, device)
    try:
        if command == "train":
            train(cfg, log_dir=cfg.checkpoint_dir or None, device=device)
        elif command == "eval":
            evaluate(cfg, max_images, device=device)
        else:
            render(cfg, out or "renders", max_images, device=device)
    finally:
        if not joined and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


def _platform_device(platform: str) -> str:
    """``--platform`` (JAX's platform names) as the port's device."""
    devices = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}
    if platform.lower() not in devices:
        raise ValueError(f"--platform={platform}: the port runs on "
                         f"{sorted(devices)}")
    return devices[platform.lower()]


if __name__ == "__main__":
    sys.exit(main())
