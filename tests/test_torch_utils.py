"""The port's ``utils/profiling.py`` and ``utils/parity.py`` against the JAX
package's modules of the same names, on the CPU.

- ``mlp_roofline``: FLOPs, bytes and times equal JAX's (both on the CPU
  fallback peaks) for three configs;
- ``chip_peaks`` / ``card_peaks``: the H100 entries by card name, the CPU
  fallback otherwise;
- the per-ray counts moved from ``chip_smoke.py``: the values the
  smoke test's bounds were computed from;
- ``oracle_level_loss`` and its autograd gradients against JAX's with
  ``jax.grad`` on the same numpy inputs (``parity_inputs``), in the f32
  band (1e-6, 1e-3) as a normalized error < 1;
- ``level_parity_errors`` on the CPU (the plain train level) under 1;
- ``trace`` and ``timed`` on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.utils import parity as jparity  # noqa: E402
from nerf_or_nothing_tpu.utils import profiling as jprofiling  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.utils import parity, profiling  # noqa: E402

ROOFLINE_CONFIGS = {
    "config": {},
    "narrow": dict(net_depth=3, net_width=64, net_width_condition=32,
                   skip_layer=2, max_deg_point=4, num_samples=8),
    "heads_4_2": dict(net_depth=5, num_rgb_channels=4,
                      num_density_channels=2, net_depth_condition=2),
}


@pytest.mark.parametrize("backward", [True, False])
@pytest.mark.parametrize("name", list(ROOFLINE_CONFIGS))
def test_mlp_roofline_matches_jax(name, backward):
    kw = ROOFLINE_CONFIGS[name]
    rows = 1024 * 128
    ours = profiling.mlp_roofline(Config(**kw), rows, backward, device="cpu")
    ref = jprofiling.mlp_roofline(JConfig(**kw), rows, backward)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k] == ref[k], k


@pytest.mark.parametrize("name,device,peaks", [
    ("NVIDIA H100 80GB HBM3", "cuda", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", "cuda:0", (756e12, 2.0e12)),
    ("NVIDIA A100-SXM4-80GB", "cuda", (1e11, 1e10)),
    (None, "cpu", (1e11, 1e10)),
])
def test_chip_peaks_by_card_name(monkeypatch, name, device, peaks):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert profiling.chip_peaks(device) == peaks
    if name is not None and "H100" in name:
        key, triple = profiling.card_peaks(name)
        assert key in name
        assert (triple[0], triple[2]) == peaks
    assert profiling.chip_peaks("cpu") == jprofiling.chip_peaks(
        jax.devices("cpu")[0])


def test_bound_counts_keep_their_values():
    """The counts behind the smoke test's bounds at Config(), R=1024,
    S=128 (the forward 141.9 GFLOP a level; a train step's bound 1.2266M
    rays/s at 989 TFLOP/s)."""
    c = Config()
    assert profiling.level_flops(c, 1024, 128) == 141908770816
    assert profiling.train_level_flops(c, 1024, 128) == 412834332672
    assert profiling.mlp_fwd_flops(c, 16384, 128) == 2270540333056
    assert profiling.dx_flops(c, 1024, 128) == 12891979776
    assert profiling.mlp_bwd_flops(c, 1024, 128, True) == 425726312448
    assert profiling.mlp_bwd_flops(c, 1024, 128, False) == 412834332672
    assert profiling.full_grad_step_flops(c, 1024, 128) == 838560645120
    bound = 1024 / (2 * profiling.train_level_flops(c, 1024, 128) / 989e12)
    assert round(bound / 1e2) == 12266


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_oracle_level_loss_and_grads_match_jax(white_bkgd):
    cfg, params, x_enc, dir_enc, t_vals, dirs, pixels = parity.parity_inputs(
        "float32", num_samples=16, num_rays=8, seed=3)
    mask = np.random.default_rng(4).uniform(0.0, 2.0, (8,)).astype(np.float32)
    mask[2] = 0.0
    arrays = (x_enc, dir_enc, t_vals, dirs, pixels, mask)
    jcfg = JConfig(compute_dtype="float32", num_samples=16)

    def joracle(p):
        return jparity.oracle_level_loss(p, jcfg, *map(jnp.asarray, arrays[:5]),
                                         jnp.asarray(mask), 0.1, white_bkgd)

    (jloss, (jcomp, jwts)), jgrads = jax.value_and_grad(joracle, has_aux=True)(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params])
    leaves = [torch.from_numpy(t).requires_grad_() for wb in params
              for t in wb]
    loss, (comp, wts) = parity.oracle_level_loss(
        list(zip(leaves[0::2], leaves[1::2])), cfg,
        *map(torch.from_numpy, arrays[:5]), torch.from_numpy(mask), 0.1,
        white_bkgd)
    grads = torch.autograd.grad(loss, leaves)
    atol, rtol = parity.PARITY_BANDS["float32"]
    pairs = [("loss", loss, jloss), ("comp", comp, jcomp),
             ("weights", wts, jwts)]
    pairs += [(f"grad{i}", g, jg) for i, (g, jg) in enumerate(
        zip(grads, [t for wb in jgrads for t in wb]))]
    for name, a, b in pairs:
        b = torch.from_numpy(np.array(b))
        assert a.shape == b.shape, name
        assert parity.normalized_err(a, b, atol, rtol) < 1.0, name


def test_parity_inputs_are_seeded_numpy():
    a = parity.parity_inputs("bfloat16", num_samples=8, num_rays=4, seed=1)
    b = parity.parity_inputs("bfloat16", num_samples=8, num_rays=4, seed=1)
    c = parity.parity_inputs("bfloat16", num_samples=8, num_rays=4, seed=2)
    assert a[0].compute_dtype == "bfloat16" and a[0].num_samples == 8
    assert a[2].shape == (4, 8, a[0].location_features)
    assert all(np.array_equal(x, y) for x, y in zip(a[2:], b[2:]))
    assert not np.array_equal(a[2], c[2])
    assert all(x.dtype == np.float32 for x in a[2:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_parity_errors_on_cpu(dtype):
    worst, errs = parity.level_parity_errors(dtype, device="cpu")
    assert worst == max(errs.values()) < 1.0
    assert {"comp", "weights", "dw0", "db10"} <= set(errs)


def test_trace_and_timed_on_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "t")):
        y = x @ x
    profiling.sync(y)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1
    with open(tmp_path / "t" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert 0.0 < profiling.timed(torch.matmul, x, x, iters=3, warmup=1) < 1.0
