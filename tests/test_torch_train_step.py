"""The train slice end to end on the CPU: two full train steps of the port
against JAX ``make_jitted_train_step`` (fused-level branch and autograd
branches), train batches byte-equal to the JAX dataset's, checkpoints in
both directions, ``run train`` (a checkpoint that ``run eval`` restores),
the device rule and the in-place updates that the render cache sees.

Tiny 2-level config: depth 3, width 32/16, skip at 2, S=8, 16 rays,
randomized=False, f32. Tolerance: the f32 parity band (1e-6, 1e-3) of
``nerf_or_nothing_tpu/utils/parity.py`` as a normalized error < 1.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu import checkpoint as jckpt  # noqa: E402
from nerf_or_nothing_tpu import run as jrun  # noqa: E402
from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.datasets.base import (  # noqa: E402
    create_dataset as j_dataset,
)
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import checkpoint as tckpt  # noqa: E402
from nerf_or_nothing_tpu_torch import run as trun  # noqa: E402
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets.base import (  # noqa: E402
    create_dataset,
)
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402
from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene  # noqa: E402

TINY = dict(batch_size=16, num_samples=8, num_levels=2, net_depth=3,
            net_width=32, net_width_condition=16, skip_layer=2,
            max_deg_point=4, randomized=False, donate_params=False,
            compute_dtype="float32", use_pallas=True, lr_delay_steps=0,
            lr_init=2e-3, lr_final=2e-3)
FLAGS = ["--num-samples=8", "--net-depth=3", "--net-width=32",
         "--net-width-condition=32", "--skip-layer=2", "--max-deg-point=4",
         "--batch-size=32", "--compute-dtype=float32",
         "--render-chunk-size=128", "--lr-delay-steps=0"]


def close(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    atol, rtol = PARITY_BANDS["float32"]
    err = normalized_err(a, b, atol, rtol)
    assert err < 1.0, (what, err)


def make_batch(R, seed):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(R, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((R, 1), np.float32)
    mult = rng.uniform(0.5, 2.0, size=(R, 1)).astype(np.float32)
    rays = Rays(o, d, vd, ones * 0.005, ones * 2.0, ones * 6.0, mult)
    return rays, rng.uniform(size=(R, 3)).astype(np.float32)


def port_state(jstate, cfg):
    params = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                                   for w, b in jstate.params])
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    moments = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    return ttrain.TrainState(0, params, zeros, moments,
                             torch.Generator().manual_seed(cfg.seed))


def branch_kw(branch, **extra):
    """``TINY`` with weight decay, ``extra``, and the flags of one branch of
    the train step: ``fused_level``, ``autograd`` (use_pallas=False),
    ``autograd_pallas_cfg`` (fuse_level=False) or ``full_grad``
    (stop_level_grad=False)."""
    kw = dict(TINY, weight_decay_mult=1e-4, **extra)
    if branch == "autograd":
        kw["use_pallas"] = False
    elif branch == "autograd_pallas_cfg":
        kw["fuse_level"] = False
    elif branch == "full_grad":
        kw["stop_level_grad"] = False
    return kw


def check_two_steps(kw, fused: bool):
    """Two train steps of the port against JAX's from JAX's initial state
    at ``kw``, ``fused`` whether the port takes the fused-level branch:
    the stats after each step, then params, mu and nu, in the f32 band."""
    jc, tc = jtiny(**kw), tiny_config(**kw)
    assert ttrain.use_fused_level(tc) == fused
    jstate = jtrain.init_train_state(jc)
    state = port_state(jstate, tc)
    j_step = jtrain.make_jitted_train_step(jc)
    t_step = ttrain.make_train_step(tc)
    for k in range(2):
        rays, pixels = make_batch(16, seed=k)
        jstate, jstats = j_step(jstate, JRays(*map(jnp.asarray, rays)),
                                jnp.asarray(pixels))
        state, stats = t_step(state, Rays(*map(torch.from_numpy, rays)),
                              torch.from_numpy(pixels))
        assert state.step == int(jstate.step) == k + 1
        for name in ("loss", "losses", "grad_norm", "grad_abs_max",
                     "weight_l2", "psnr", "learning_rate"):
            close(getattr(stats, name).numpy(), getattr(jstats, name),
                  f"step {k + 1} {name}")
    for tree, jtree, name in ((state.params, jstate.params, "params"),
                              (state.mu, jstate.mu, "mu"),
                              (state.nu, jstate.nu, "nu")):
        for i, ((w, b), (jw, jb)) in enumerate(zip(tree, jtree)):
            close(w.numpy(), jw, f"{name} w{i}")
            close(b.numpy(), jb, f"{name} b{i}")


@pytest.mark.parametrize("branch", ["fused_level", "autograd",
                                    "autograd_pallas_cfg", "full_grad"])
def test_two_train_steps_match_jax(branch):
    """Loss, per-level losses, grad norm, params, mu and nu after each of
    two steps (different batches, non-uniform loss_mult, weight decay).
    The fused-MLP branches run JAX's fused MLP kernels (interpret mode) and
    the port's fused_mlp_apply Function (plain versions on the CPU);
    ``full_grad`` (stop_level_grad=False) also takes the fine level's loss
    through dX, the IPE and resampling into the coarse level's weights."""
    check_two_steps(branch_kw(branch), branch == "fused_level")


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_unfused_render_rays_resamples_from_previous_level(white_bkgd):
    """The unfused levels (``use_pallas=False``) carry each level's weights
    to the next level's resampling, as the JAX package does: the fine level
    matches JAX's ``render_rays``."""
    from nerf_or_nothing_tpu.models import mipnerf as jmip
    from nerf_or_nothing_tpu_torch.models import mipnerf as tmip

    kw = dict(TINY, use_pallas=False)
    jc, tc = jtiny(**kw), tiny_config(**kw)
    jstate = jtrain.init_train_state(jc)
    params = port_state(jstate, tc).params
    rays, _ = make_batch(16, 2)
    import jax

    ref = jmip.render_rays(jstate.params, jc, jax.random.PRNGKey(0),
                           JRays(*map(jnp.asarray, rays)), False, white_bkgd)
    out = tmip.render_rays(params, tc, Rays(*map(torch.from_numpy, rays)),
                           False, white_bkgd)
    assert len(out) == len(ref) == 2
    for a, b in zip(out, ref):
        for name in ("rgb", "acc", "weights", "distance"):
            close(getattr(a, name).detach().numpy(), getattr(b, name), name)


def test_multi_step_equals_single_steps():
    tc = tiny_config(**TINY)
    init = ttrain.init_train_state(tc)
    a = ttrain.init_train_state(tc)
    batches = [(Rays(*map(torch.from_numpy, make_batch(16, k)[0])),
                torch.from_numpy(make_batch(16, k)[1])) for k in range(2)]
    step = ttrain.make_train_step(tc)
    for rays, pixels in batches:
        a, last = step(a, rays, pixels)
    b, stats = ttrain.make_multi_step(tc)(init, batches)
    assert a.step == b.step == 2
    assert float(stats.loss) == float(last.loss)
    for (wa, ba), (wb, bb) in zip(a.params, b.params):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)


def test_adam_step_bumps_every_version():
    """The packed-weight cache of ``make_render_fn`` is keyed on tensor
    identity and ``_version``: the in-place step must change every key."""
    tc = tiny_config(**TINY)
    state = ttrain.init_train_state(tc)
    key = [(id(t), t._version) for wb in state.params for t in wb]
    rays, pixels = make_batch(16, 0)
    state, _ = ttrain.make_train_step(tc)(
        state, Rays(*map(torch.from_numpy, rays)), torch.from_numpy(pixels))
    new = [(id(t), t._version) for wb in state.params for t in wb]
    assert all(a[0] == b[0] and a[1] < b[1] for a, b in zip(key, new))


def test_chunk_len_matches_jax():
    for kw in (dict(), dict(print_every=7, save_every=10),
               dict(test_render_interval=3, gc_every=0, max_steps=20)):
        jc, tc = jtiny(**kw), tiny_config(**kw)
        for step in (0, 1, 5, 6, 9, 17, 19):
            for spc in (1, 4, 100):
                assert trun._chunk_len(step, tc, spc) == \
                    jrun._chunk_len(step, jc, spc)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_scene") / "scene")
    write_scene(root, n_train=2, n_test=1, size=16)
    return root


def test_train_batches_byte_equal_to_jax(scene):
    cfg_kw = dict(batch_size=64, seed=3)
    tds = create_dataset("train", scene, tiny_config(**cfg_kw))
    jds = j_dataset("train", scene, jtiny(**cfg_kw))
    try:
        assert tds.pool_size == jds.pool_size == 2 * 16 * 16
        for k in range(3):
            if k == 1:
                tp, jp = tds.peek(), jds.peek()
                for a, b in zip(tp[0], jp[0]):
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
            (tr, tpx), (jr, jpx) = next(tds), next(jds)
            for a, b in zip(tr, jr):
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes(), k
            assert np.asarray(tpx).tobytes() == np.asarray(jpx).tobytes()
    finally:
        tds.close()
        jds.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(tds)


def test_jax_checkpoint_restores_into_port(tmp_path):
    jc = jtiny(**TINY)
    jstate = jtrain.init_train_state(jc)
    rays, pixels = make_batch(16, 0)
    jstate, _ = jtrain.make_jitted_train_step(jc)(
        jstate, JRays(*map(jnp.asarray, rays)), jnp.asarray(pixels))
    path = jckpt.save_checkpoint(str(tmp_path), jstate)
    state = tckpt.restore_checkpoint(path, tiny_config(**TINY))
    assert state.step == 1
    for tree, jtree in ((state.params, jstate.params), (state.mu, jstate.mu),
                        (state.nu, jstate.nu)):
        for (w, b), (jw, jb) in zip(tree, jtree):
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_port_checkpoint_restores_into_jax(tmp_path):
    tc, jc = tiny_config(**TINY, seed=5), jtiny(**TINY, seed=5)
    state = ttrain.init_train_state(tc)
    rays, pixels = make_batch(16, 1)
    state, _ = ttrain.make_train_step(tc)(
        state, Rays(*map(torch.from_numpy, rays)), torch.from_numpy(pixels))
    for k in range(5):  # newest 3 kept
        state.step = k + 1
        path = tckpt.save_checkpoint(str(tmp_path), state, tc)
    assert sorted(os.listdir(tmp_path)) == [
        f"checkpoint_{s:09d}.npz" for s in (3, 4, 5)]
    jstate = jckpt.restore_checkpoint(path, jtrain.init_train_state(jc))
    assert int(jstate.step) == 5
    assert np.asarray(jstate.key).tolist() == [5, 5]
    for tree, jtree in ((state.params, jstate.params), (state.mu, jstate.mu),
                        (state.nu, jstate.nu)):
        for (w, b), (jw, jb) in zip(tree, jtree):
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    # The JAX step runs from the port's checkpoint.
    jstate, jstats = jtrain.make_jitted_train_step(jc)(
        jstate, JRays(*map(jnp.asarray, rays)), jnp.asarray(pixels))
    assert np.isfinite(float(jstats.loss)) and int(jstate.step) == 6
    back = tckpt.restore_checkpoint(path, tc)
    assert back.step == 5
    assert back.generator.initial_seed() == ttrain.step_seed(5, 5)


def test_run_train_on_cpu_then_eval_restores(scene, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    flags = [f"--data-dir={scene}", f"--checkpoint-dir={ckpt}", *FLAGS,
             "--max-steps=5", "--print-every=2", "--save-every=4",
             "--test-render-interval=4", "--device=cpu"]
    assert trun.main(["train", *flags]) == 0
    out = capsys.readouterr().out
    assert "step       2  loss" in out and "step       4  loss" in out
    assert "test view 0: psnr" in out
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".npz")) == [
        "checkpoint_000000004.npz", "checkpoint_000000005.npz"]
    with open(os.path.join(ckpt, "train_stats.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].split(",") == ["step", "loss", "psnr", "grad_norm",
                                  "grad_abs_max", "grad_norm_clipped",
                                  "weight_l2", "lr", "rays_per_sec"]
    assert [r.split(",")[0] for r in rows[1:]] == ["2", "4"]
    cfg = trun.parse_flags([f for f in flags if f != "--device=cpu"])
    state = tckpt.restore_checkpoint(tckpt.latest_checkpoint(ckpt), cfg)
    assert state.step == 5
    restored = trun.load_params(cfg, "cpu")
    for (w, b), (rw, rb) in zip(state.params, restored):
        assert torch.equal(w, rw) and torch.equal(b, rb)
    init = tmlp.init_mlp(torch.Generator().manual_seed(cfg.seed), cfg)
    assert not torch.equal(init[0][0], state.params[0][0])
    assert trun.main(["eval", *flags]) == 0
    assert '{"eval"' in capsys.readouterr().out
    # Resume: two more steps with multi-step dispatch.
    more = [f if not f.startswith("--max-steps") else "--max-steps=7"
            for f in flags]
    assert trun.main(["train", *more, "--steps-per-call=3"]) == 0
    assert "resumed from step 5" in capsys.readouterr().out
    assert tckpt.restore_checkpoint(tckpt.latest_checkpoint(ckpt),
                                    cfg).step == 7


def test_run_train_needs_a_card_unless_cpu_is_asked(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    flags = [f"--data-dir={scene}", *FLAGS, "--max-steps=1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["train", *flags])
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["train", *flags, "--mesh-shape=2,2"])
    with pytest.raises(ValueError, match="1-D or 2-D"):
        trun.main(["train", *flags, "--mesh-shape=2,1,1", "--device=cpu"])


def host_adam_update(params, grads, mu, nu, lr: float, step: int, cfg):
    """The Adam update as it was before the step's scalars moved to the
    device: lr, c1 and c2 as host floats."""
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    t = np.float32(step)
    c1 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t))
    c2 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t))
    leaves = lambda tree: [x for wb in tree for x in wb]  # noqa: E731
    p, g, m, v = leaves(params), leaves(grads), leaves(mu), leaves(nu)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1.0 - b2),
                                              g))
    denom = torch._foreach_mul(v, c2)
    torch._foreach_add_(denom, eps)
    torch._foreach_rsqrt_(denom)
    upd = torch._foreach_mul(m, c1)
    torch._foreach_mul_(upd, float(lr))
    torch._foreach_mul_(upd, denom)
    torch._foreach_sub_(p, upd)


@pytest.mark.parametrize("lr_delay_steps", [0, 2500])
def test_tensor_scalar_adam_equals_host_scalar_adam(lr_delay_steps):
    """``adam_update`` reading [lr, c1, c2] from a tensor (what a CUDA
    graph of the step replays) gives the bits of the host-scalar update,
    over five steps of the schedule."""
    tc = tiny_config(**dict(TINY, lr_delay_steps=lr_delay_steps,
                            lr_final=5e-5, max_steps=50))
    rng = np.random.default_rng(0)
    trees = [[(torch.from_numpy(rng.normal(size=(i, o)).astype(np.float32)
                                * scale),
               torch.from_numpy(rng.normal(size=(o,)).astype(np.float32)
                                * scale))
              for i, o in tmlp.layer_dims(tc)] for scale in (1.0, 0.0, 0.0)]
    for t in trees[2]:  # nu >= 0
        t[0].abs_(), t[1].abs_()
    a = [[(w.clone(), b.clone()) for w, b in tree] for tree in trees]
    b = [[(w.clone(), b.clone()) for w, b in tree] for tree in trees]
    for step in range(1, 6):
        g = [(torch.from_numpy(rng.normal(size=tuple(w.shape))
                               .astype(np.float32) * 0.1),
              torch.from_numpy(rng.normal(size=tuple(bb.shape))
                               .astype(np.float32) * 0.1))
             for w, bb in trees[0]]
        lr, host = ttrain.adam_scalars(tc, step)
        s = torch.from_numpy(host)
        ttrain.adam_update(a[0], g, a[1], a[2], s[0], s[1], s[2], tc)
        host_adam_update(b[0], g, b[1], b[2], float(lr), step, tc)
        for ta, tb in zip(a, b):
            for (wa, ba), (wb, bb) in zip(ta, tb):
                assert torch.equal(wa, wb) and torch.equal(ba, bb), step


def nan_batch(R, seed):
    rays, pixels = make_batch(R, seed)
    pixels = pixels.copy()
    pixels[3, 1] = np.nan
    return Rays(*map(torch.from_numpy, rays)), torch.from_numpy(pixels)


def snapshot(state):
    return ([t.clone() for t in ttrain.state_tensors(state)], state.step,
            state.generator.get_state())


def assert_unchanged(state, snap):
    tensors, step, gen = snap
    now = ttrain.state_tensors(state)
    assert len(now) == len(tensors)
    assert all(torch.equal(a, b) for a, b in zip(tensors, now))
    assert state.step == step
    assert torch.equal(state.generator.get_state(), gen)


@pytest.mark.parametrize("branch", ["fused_level", "autograd"])
@pytest.mark.parametrize("flag", ["check_numerics", "debug_nans"])
def test_check_numerics_raises_on_nan_and_keeps_state(flag, branch):
    """A NaN pixel raises FloatingPointError naming nan (JAX's checkify of
    the step, ``tests/test_model_train.py::test_check_numerics_traps_nan``)
    after one clean step, and the state, its step and its generator stay
    as the clean step left them; a clean batch then trains on."""
    kw = dict(TINY, randomized=True, **{flag: True})
    if branch == "autograd":
        kw["stop_level_grad"] = False
    tc = tiny_config(**kw)
    state = ttrain.init_train_state(tc)
    step = ttrain.make_train_step(tc)
    rays, pixels = make_batch(16, 0)
    state, _ = step(state, Rays(*map(torch.from_numpy, rays)),
                    torch.from_numpy(pixels))
    snap = snapshot(state)
    with pytest.raises(FloatingPointError, match="nan"):
        step(state, *nan_batch(16, 1))
    assert_unchanged(state, snap)
    state, stats = step(state, Rays(*map(torch.from_numpy, rays)),
                        torch.from_numpy(pixels))
    assert state.step == 2 and np.isfinite(float(stats.loss))


@pytest.mark.parametrize("flag", ["check_numerics", "debug_nans"])
def test_multi_step_checks_only_with_debug_nans(flag):
    """As in the JAX package, ``check_numerics`` leaves the multi-step
    unchecked and ``debug_nans`` checks each of its steps: the NaN batch
    (second of three) raises with the first step applied."""
    tc = tiny_config(**dict(TINY, **{flag: True}))
    state = ttrain.init_train_state(tc)
    batches = [(Rays(*map(torch.from_numpy, make_batch(16, 0)[0])),
                torch.from_numpy(make_batch(16, 0)[1])),
               nan_batch(16, 1),
               (Rays(*map(torch.from_numpy, make_batch(16, 2)[0])),
                torch.from_numpy(make_batch(16, 2)[1]))]
    multi = ttrain.make_multi_step(tc)
    if flag == "check_numerics":
        state, stats = multi(state, batches)
        assert state.step == 3 and not np.isfinite(float(stats.loss))
        return
    ref = ttrain.init_train_state(tc)
    ref, _ = ttrain.make_train_step(tc)(ref, *batches[0])
    snap = snapshot(ref)
    with pytest.raises(FloatingPointError, match="nan"):
        multi(state, batches)
    assert_unchanged(state, snap)


def test_multi_step_takes_host_batches():
    """The multi-step takes the loader's numpy batches as they come: the
    same states and stats as single steps on tensors."""
    tc = tiny_config(**TINY)
    a = ttrain.init_train_state(tc)
    b = ttrain.init_train_state(tc)
    batches = [make_batch(16, k) for k in range(3)]
    step = ttrain.make_train_step(tc)
    for rays, pixels in batches:
        a, last = step(a, Rays(*map(torch.from_numpy, rays)),
                       torch.from_numpy(pixels))
    b, stats = ttrain.make_multi_step(tc)(b, batches)
    assert a.step == b.step == 3
    for name in ("loss", "losses", "psnr", "grad_norm"):
        assert torch.equal(getattr(stats, name), getattr(last, name)), name
    for tree_a, tree_b in ((a.params, b.params), (a.mu, b.mu), (a.nu, b.nu)):
        for (wa, ba), (wb, bb) in zip(tree_a, tree_b):
            assert torch.equal(wa, wb) and torch.equal(ba, bb)


def test_run_train_profile_dir_writes_a_trace(scene, tmp_path, capsys):
    """``--profile-dir`` traces steps 11-20 with torch.profiler (JAX
    ``tests/test_run_cli.py``'s profile test): a 14-step run stops the
    trace at its end and writes one Chrome trace holding the steps' ops."""
    import json

    prof = str(tmp_path / "trace")
    flags = [f"--data-dir={scene}", *FLAGS, "--max-steps=14",
             "--print-every=100", "--test-render-interval=0",
             f"--profile-dir={prof}", "--steps-per-call=4", "--device=cpu"]
    assert trun.main(["train", *flags]) == 0
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(os.path.join(prof, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert "trace written to" not in capsys.readouterr().out


def test_run_train_check_numerics_flags_run_on_cpu(scene, tmp_path):
    """``--check-numerics`` and ``--debug-nans`` train on clean data as
    without them, to the same checkpoint."""
    out = {}
    for name, extra in (("plain", []), ("checked", [
            "--check-numerics=true", "--debug-nans=true"])):
        ckpt = str(tmp_path / name)
        flags = [f"--data-dir={scene}", *FLAGS, "--max-steps=3",
                 f"--checkpoint-dir={ckpt}", "--test-render-interval=0",
                 "--device=cpu", *extra]
        assert trun.main(["train", *flags]) == 0
        cfg = trun.parse_flags([f for f in flags if f != "--device=cpu"])
        out[name] = tckpt.restore_checkpoint(tckpt.latest_checkpoint(ckpt),
                                             cfg)
    for (w, b), (cw, cb) in zip(out["plain"].params, out["checked"].params):
        assert torch.equal(w, cw) and torch.equal(b, cb)
