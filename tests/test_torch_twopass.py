"""The two-pass train level (``kernel_probes`` ``fl_variant=twopass``) and
the port's probe handling against the JAX package on the CPU.

The port's plain version of ``_level_kernel_twopass`` is
``level_train_plain`` (the two passes split where the products run, not
where they round): here it is held, through ``fused_level_train`` with the
probe, against JAX's ``fused_level_train`` with the probe, which runs
``_level_kernel_twopass`` in interpret mode. Also: the routing (the probe
in mode "t" reaches ``train_level_twopass``, with ``fuse_ipe`` it stays
``train_level``), two train steps with the probe on a Multicam batch
against JAX's train step, the filler probes raising, and the TPU knobs
changing nothing.

Small config (``SMALL`` of ``tests/test_torch_train_level.py``). Tolerance:
the parity bands f32 (1e-6, 1e-3) and bf16 (2e-3, 3e-2) of
``nerf_or_nothing_tpu/utils/parity.py`` as a normalized error < 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_train_level import (  # noqa: E402
    SMALL,
    T,
    compare_level,
    level_case,
    run_level,
)

from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import (  # noqa: E402
    DatasetType,
    tiny_config,
)
from nerf_or_nothing_tpu_torch.datasets.base import (  # noqa: E402
    create_dataset,
)
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402
from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene  # noqa: E402

TWOPASS = "fl_variant=twopass"
# Multicam's area weights 4^scale, and a masked ray.
MULTICAM_MASK = [1.0, 4.0, 16.0, 64.0, 0.0, 16.0, 4.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_twopass_plain_matches_jax(white_bkgd, dtype):
    """6 rays x 8 samples against JAX's 16-row two-pass tiles."""
    kw = dict(SMALL, compute_dtype=dtype, kernel_probes=TWOPASS)
    port, ref = run_level(kw, "t", white_bkgd)
    compare_level(port, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twopass_plain_deeper_ragged_matches_jax(dtype):
    """Depth 5 with two skip layers, 7 rays (ragged 16-row tiles: the
    padding must add nothing to the scratch-accumulated dW)."""
    kw = dict(SMALL, net_depth=5, skip_layer=2, compute_dtype=dtype,
              kernel_probes=TWOPASS)
    port, ref = run_level(kw, "t", True, R=7, seed=3)
    compare_level(port, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_twopass_plain_multicam_g_scale_matches_jax(white_bkgd, dtype):
    """A non-uniform g_scale from Multicam's 1/4/16/64 loss weights, one
    ray masked."""
    kw = dict(SMALL, compute_dtype=dtype, kernel_probes=TWOPASS)
    port, ref = run_level(kw, "t", white_bkgd, R=7, seed=4,
                          mask=MULTICAM_MASK)
    compare_level(port, ref, dtype)


def _spy(monkeypatch, calls):
    for name in ("train_level", "train_level_twopass"):
        orig = getattr(fl, name)
        monkeypatch.setattr(
            fl, name,
            lambda *a, _n=name, _o=orig, **k: calls.append(_n) or _o(*a, **k))


@pytest.mark.parametrize("probes,mode,expected", [
    (TWOPASS, "t", "train_level_twopass"),
    (TWOPASS, "mv", "train_level"),
    ("", "t", "train_level"),
    ("fl_variant=other", "t", "train_level"),
])
def test_probe_routing_matches_jax(monkeypatch, probes, mode, expected):
    """The probe selects the two-pass kernel in mode "t" only, as JAX's
    ``fused_level_train`` does (with ``fuse_ipe`` JAX keeps
    ``_level_kernel``); the result matches JAX either way."""
    calls = []
    _spy(monkeypatch, calls)
    kw = dict(SMALL, compute_dtype="float32", kernel_probes=probes)
    port, ref = run_level(kw, mode, True, R=5, seed=6)
    assert calls == [expected]
    compare_level(port, ref, "float32")


def test_two_train_steps_with_probe_match_jax(tmp_path, monkeypatch):
    """Two steps at randomized=false with the probe on Multicam batches
    (loss_mult 1/4/16/64), against JAX's jitted train step with the same
    probe; loss, level losses, grad norm, params and moments. Every level
    goes through ``train_level_twopass``."""
    scene = str(tmp_path / "scene")
    write_scene(scene, n_train=1, n_test=1, size=16)
    kw = dict(batch_size=16, num_samples=8, num_levels=2, net_depth=3,
              net_width=32, net_width_condition=16, skip_layer=2,
              max_deg_point=4, randomized=False, donate_params=False,
              compute_dtype="float32", use_pallas=True, lr_delay_steps=0,
              lr_init=2e-3, lr_final=2e-3, kernel_probes=TWOPASS)
    jc, tc = jtiny(**kw), tiny_config(**kw)
    assert ttrain.use_fused_level(tc)
    jstate = jtrain.init_train_state(jc)
    params = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                                   for w, b in jstate.params])
    zeros = lambda: [(torch.zeros_like(w), torch.zeros_like(b))  # noqa: E731
                     for w, b in params]
    state = ttrain.TrainState(0, params, zeros(), zeros(),
                              torch.Generator().manual_seed(0))
    j_step, t_step = jtrain.make_jitted_train_step(jc), ttrain.make_train_step(tc)
    atol, rtol = PARITY_BANDS["float32"]

    def close(a, b, what):
        assert normalized_err(np.asarray(a), np.asarray(b), atol, rtol) < 1, what

    multicam = tc.replace(dataset_loader=DatasetType.MULTICAM)
    with create_dataset("train", scene, multicam) as ds:
        batches = [next(ds) for _ in range(2)]
    assert len(np.unique(np.concatenate([b[0].loss_mult for b in batches]))) > 1
    calls = []
    _spy(monkeypatch, calls)
    for k, (rays, pixels) in enumerate(batches):
        jstate, jstats = j_step(jstate, JRays(*map(jnp.asarray, rays)),
                                jnp.asarray(pixels))
        state, stats = t_step(state, Rays(*map(torch.from_numpy, rays)),
                              torch.from_numpy(pixels))
        for name in ("loss", "losses", "grad_norm", "psnr"):
            close(getattr(stats, name).numpy(), getattr(jstats, name),
                  f"step {k + 1} {name}")
    assert calls == ["train_level_twopass"] * 4
    for tree, jtree, name in ((state.params, jstate.params, "params"),
                              (state.mu, jstate.mu, "mu"),
                              (state.nu, jstate.nu, "nu")):
        for i, ((w, b), (jw, jb)) in enumerate(zip(tree, jtree)):
            close(w.numpy(), jw, f"{name} w{i}")
            close(b.numpy(), jb, f"{name} b{i}")


def _level_args(kw, R=4, seed=0):
    jc, tc, jp, tp, c = level_case(kw, R, seed)
    return tc, tp, (T(c["x"]), T(c["dir_enc"]), T(c["t_vals"]),
                    T(c["dirs"]), T(c["pixels"]), T(c["g_scale"]), True)


@pytest.mark.parametrize("probe", ["fl_variant=nobwd", "fl_variant=nocomp",
                                   "fm_bwd=nodw", "fm_bwd=nogchain",
                                   "fm_bwd=bf16acc"])
def test_filler_probes_raise(probe):
    """The probes with which the JAX kernels compute fillers (or bf16 dW)
    raise where the port's kernels would read them, naming ROADMAP."""
    tc, tp, args = _level_args(dict(SMALL, kernel_probes=probe))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl.fused_level_train(tp, tc, *args)
    if probe.startswith("fm_bwd"):
        x = args[0].reshape(-1, tc.location_features)
        g = torch.zeros(x.shape[0], 3), torch.zeros(x.shape[0], 1)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fm.mlp_bwd(tp, tc, x, args[1], *g, False)


def test_tpu_knobs_change_nothing():
    """Tile, interleave and schedule probes give the same bits as none."""
    knobs = ("fl_tile=512,fl_il=2,fr_tile=1024,fr_il=2,fm_acc=when,"
             "fl_comp=rows,fm_heads=t,fm_bwd=phased,fl_enc=sep")
    tc, tp, args = _level_args(dict(SMALL))
    ref = fl.fused_level_train(tp, tc, *args)
    out = fl.fused_level_train(tp, tc.replace(kernel_probes=knobs), *args)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    for (wa, ba), (wb, bb) in zip(out[3], ref[3]):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)


def test_twopass_wrapper_checks_inputs():
    """CPU tensors are refused before any launch; the dispatcher sends
    them to the plain version and counts nothing."""
    tc, tp, args = _level_args(dict(SMALL, net_width_condition=32))
    R, S = 4, tc.num_samples
    dt = tmlp.compute_dtype(tc)
    x = args[0].reshape(R * S, -1).to(dt)
    d = args[1].to(dt)
    delta = torch.zeros(R, S)
    pixels, gsc = args[4], args[5]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.train_level_twopass_cuda(tp, tc, x, d, delta, pixels, gsc, True)
    before = fl.train_level_twopass.launches
    out = fl.train_level_twopass(tp, tc, x, d, delta, pixels, gsc, True)
    assert fl.train_level_twopass.launches == before
    ref = fl.level_train_plain(tp, tc, x, d, delta, pixels, gsc, True, "t")
    for (wa, ba), (wb, bb) in zip(out[3], ref[3]):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
