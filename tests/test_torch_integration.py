"""The quality gates of the JAX package's CPU suite, run on the port.

- ``test_short_training_reconstructs_scene``: the counterpart of
  ``tests/test_integration.py``: the port trains the analytic sphere scene
  (``utils/synthetic.write_scene``, 10 train and 2 test views at 48x48)
  for 600 steps at the same tiny config on the CPU, and must meet the
  same thresholds: train PSNR > 20 dB, held-out view 0 > 18 dB and SSIM
  > 0.6. The port's own seeded init; nothing is carried over from JAX.
- ``test_golden_losses``: the counterpart of ``tests/test_golden.py``:
  ``golden_setup``'s config and batch, JAX's initial params carried across
  with ``models/mlp.params_from_jax`` (the port's torch init draws other
  weights), five steps, and the five losses of
  ``tests/golden/train_losses.json`` within the JAX test's rtol 2e-4 /
  atol 2e-5. The golden file is only read.
"""

import json
import os

import numpy as np
import torch

torch.set_num_threads(2)

from test_golden import GOLDEN_PATH, golden_setup  # noqa: E402

from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import DatasetType  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets.base import (  # noqa: E402
    create_dataset,
)
from nerf_or_nothing_tpu_torch.eval import (  # noqa: E402
    evaluate_image,
    make_render_fn,
    render_image,
)
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402
from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene  # noqa: E402


def test_short_training_reconstructs_scene(tmp_path):
    scene = write_scene(str(tmp_path / "sphere_scene"), n_train=10,
                        n_test=2, size=48)
    cfg = tiny_config(
        batch_size=512, num_samples=48, num_levels=2,
        net_depth=4, net_width=96, net_width_condition=48,
        max_deg_point=8, deg_view=4,
        lr_init=5e-3, lr_final=5e-4, lr_delay_steps=0, max_steps=600,
        dataset_loader=DatasetType.BLENDER,
    )
    state = ttrain.init_train_state(cfg)
    step = ttrain.make_train_step(cfg)
    first_psnr = None
    with create_dataset("train", scene, cfg) as ds:
        for _ in range(600):
            state, stats = step(state, *ttrain.batch_to_device(
                "cpu", *next(ds)))
            if first_psnr is None:
                first_psnr = float(stats.psnr)
    train_psnr = float(stats.psnr)
    assert train_psnr > 20.0, (first_psnr, train_psnr)

    with create_dataset("test", scene, cfg) as test_ds:
        rays, gt = test_ds.image_rays(0)
        h, w = test_ds.image_dims(0)
    rgb, _, _ = render_image(make_render_fn(cfg), state.params, rays, h, w,
                             chunk=2048, device="cpu")
    m = evaluate_image(rgb, np.asarray(gt).reshape(h, w, 3), device="cpu")
    print(f"train psnr {first_psnr:.2f} -> {train_psnr:.2f} dB, held-out "
          f"{m['psnr']:.2f} dB / {m['ssim']:.4f}")
    assert m["psnr"] > 18.0, m
    assert m["ssim"] > 0.6, m


def test_golden_losses():
    jcfg, jrays, jpixels = golden_setup()
    init = jtrain.init_train_state(jcfg).params
    cfg = tiny_config(
        batch_size=32, num_samples=16, net_depth=3, net_width=32,
        net_width_condition=16, max_deg_point=6, num_levels=2,
        randomized=False, lr_delay_steps=0, seed=42,
        donate_params=False, use_pallas=False,
    )
    params = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                                   for w, b in init])
    zeros = lambda: [(torch.zeros_like(w), torch.zeros_like(b))  # noqa: E731
                     for w, b in params]
    state = ttrain.TrainState(0, params, zeros(), zeros(),
                              torch.Generator().manual_seed(
                                  ttrain.step_seed(cfg.seed, 0)))
    rays = Rays(*[torch.from_numpy(np.array(x)) for x in jrays])
    pixels = torch.from_numpy(np.array(jpixels))
    step = ttrain.make_train_step(cfg)
    losses = []
    for _ in range(5):
        state, stats = step(state, rays, pixels)
        losses.append(float(stats.loss))
    assert os.path.exists(GOLDEN_PATH), GOLDEN_PATH
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)["losses"]
    rel = np.abs(np.subtract(losses, golden)) / np.abs(golden)
    print(f"losses {losses}, worst relative error {rel.max():.3g}")
    np.testing.assert_allclose(losses, golden, rtol=2e-4, atol=2e-5)
