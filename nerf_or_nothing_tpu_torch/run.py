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
"""

from __future__ import annotations

import contextlib
import gc
import json
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
from nerf_or_nothing_tpu_torch.train import (
    TrainState,
    batch_to_device,
    init_train_state,
    make_multi_step,
    make_train_step,
)
from nerf_or_nothing_tpu_torch.utils import profiling

MULTI_DEVICE_ROADMAP = (
    "training on more than one device (mesh_shape, the per-level gradient "
    "all-reduce) is not ported yet: ROADMAP queue A item 3"
)


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


def _check_train_config(cfg: Config, device: torch.device) -> None:
    """Raise NotImplementedError for what the port cannot do yet: a mesh,
    or an unindexed CUDA device on a host with several cards (the JAX
    package would train on all of them; ``--device=cuda:0`` takes one)."""
    if tuple(cfg.mesh_shape) or (
            device.type == "cuda" and device.index is None
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(MULTI_DEVICE_ROADMAP)


def train(cfg: Config, log_dir: Optional[str] = None,
          device="cuda") -> TrainState:
    """The training loop of ``nerf_or_nothing_tpu.run.train`` on one
    device: multi-step chunks cut at every side-effect step (with
    ``steps_per_call`` > 1 and no ``profile_dir``; on the card each step a
    replay of one captured CUDA graph, ``train.make_multi_step``), logging
    every ``print_every``, checkpoints every ``save_every`` and at the end,
    resume from the newest checkpoint, a held-out render of test view 0
    every ``test_render_interval`` (switched off with a message when the
    data has no test split) and ``gc_every``. ``profile_dir``: a
    ``torch.profiler`` trace of steps start+11 to start+20 written there.
    ``check_numerics`` checks the single steps, ``debug_nans`` every step
    (``train.make_train_step``)."""
    device = resolve_device(device)
    _check_train_config(cfg, device)
    dataset = create_dataset("train", cfg.data_dir, cfg)
    state = init_train_state(cfg, device)
    if cfg.checkpoint_dir and cfg.resume:
        state = ckpt_lib.maybe_restore(cfg.checkpoint_dir, cfg, state,
                                       device=device)
        if state.step:
            print(f"resumed from step {state.step}", flush=True)
    step_fn = make_train_step(cfg)
    spc = cfg.steps_per_call if (cfg.steps_per_call > 1
                                 and not cfg.profile_dir) else 1
    multi_fn = make_multi_step(cfg) if spc > 1 else None
    logger = MetricsLogger(log_dir, batch_size=cfg.batch_size)
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
                batches = [next(dataset) for _ in range(k)]
                state, stats = multi_fn(state, batches)
            else:
                if cfg.profile_dir and step + 1 == start_step + 11:
                    tracing.enter_context(profiling.trace(cfg.profile_dir))
                state, stats = step_fn(
                    state, *batch_to_device(device, *next(dataset)))
                if cfg.profile_dir and state.step == start_step + 20:
                    tracing.close()
                    print(f"trace written to {cfg.profile_dir}", flush=True)
            step = state.step
            if step % cfg.print_every == 0:
                logger.log(step, stats)
            if cfg.checkpoint_dir and step % cfg.save_every == 0:
                ckpt_lib.save_checkpoint(cfg.checkpoint_dir, state, cfg)
            if (cfg.test_render_interval > 0
                    and step % cfg.test_render_interval == 0):
                try:
                    if test_ds is None:
                        test_ds = create_dataset("test", cfg.data_dir, cfg)
                        render_fn = make_render_fn(cfg)
                except OSError as e:  # no test split: say so once, stop
                    print(f"test render disabled: {type(e).__name__}: {e}",
                          flush=True)
                    cfg = cfg.replace(test_render_interval=0)
                else:
                    trays, tgt = test_ds.image_rays(0)
                    th, tw = test_ds.image_dims(0)
                    rgb, _, _ = render_image(
                        render_fn, state.params, trays, th, tw,
                        cfg.render_chunk_size, device=device,
                    )
                    m = evaluate_image(
                        to_display(cfg, rgb),
                        to_display(cfg, np.asarray(tgt).reshape(th, tw, 3)),
                        device=device,
                    )
                    print(f"step {step:>7d}  test view 0: "
                          f"psnr {m['psnr']:.2f} ssim {m['ssim']:.3f}",
                          flush=True)
            if cfg.gc_every > 0 and step % cfg.gc_every == 0:
                gc.collect()
        # A run too short to reach the trace's last step stops it here.
        tracing.close()
        if cfg.checkpoint_dir:
            ckpt_lib.save_checkpoint(cfg.checkpoint_dir, state, cfg)
        logger.close()
    finally:
        tracing.close()
        dataset.close()
        if test_ds is not None:
            test_ds.close()
    return state


def evaluate(cfg: Config, max_images: Optional[int] = None,
             device="cuda") -> dict:
    device = resolve_device(device)
    params = load_params(cfg, device)
    with create_dataset("test", cfg.data_dir, cfg) as dataset:
        metrics = evaluate_dataset(cfg, params, dataset, max_images,
                                   device=device)
    print(json.dumps({"eval": metrics}), flush=True)
    return metrics


def render(cfg: Config, out_dir: str, max_images: Optional[int] = None,
           device="cuda"):
    """Render the test split, or with ``cfg.render_path`` the loader's
    novel-view camera path (Blender and Multicam orbit, LLFF spiral, or
    circle when spherified), to ``out_dir/render_XXX.png``."""
    from PIL import Image

    device = resolve_device(device)
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
                device=device,
            )
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
    filtered = []
    for a in rest:
        if a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--max-images="):
            max_images = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            filtered.append(a)
    cfg = parse_flags(filtered)
    if command == "train":
        train(cfg, log_dir=cfg.checkpoint_dir or None, device=device)
    elif command == "eval":
        evaluate(cfg, max_images, device=device)
    else:
        render(cfg, out or "renders", max_images, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
