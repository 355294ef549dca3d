"""Tensor parallelism of the port (``parallel/mesh.py``: ``create_mesh_2d``,
``make_tensor_parallel_train_step``) on the CPU over gloo, against the
port's single-process step and JAX's ``make_tensor_parallel_train_step`` on
a grid of as many virtual CPU devices.

The ranks are CPU processes started with ``subprocess.Popen`` (``WORKER``,
which imports the port only), joined by a ``file://`` store; every wait has
its own time limit. One module-scoped run of the worker on a 1 x 1, a
2 x 2 and a 1 x 4 grid (nine processes at once) serves the step cases;
``run train --mesh-shape=2,2`` runs the CLI with a checkpoint and a
resume.

Shapes: ``tests/test_distributed.py``'s tensor-parallel config (batch 32,
16 samples, depth 2, width 32/16, max_deg_point 4, two levels, f32) with
``grad_max_norm`` and ``weight_decay_mult`` on, so that the global norm and
the weight L2 cross the shards; two steps on two batches. At mp 2 and 4
the trunk and the view layer are sharded, the density (1) and rgb (3)
heads replicated. Tolerance: ``rtol=1e-4, atol=1e-6``, as
``tests/test_torch_mesh.py`` (JAX's own test holds its grid to 2e-4).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_mesh import (  # noqa: E402
    MAIN,
    TRAIN_FLAGS,
    finish,
    free_port,
    make_batch,
    port_env,
    results,
    scenes,  # noqa: F401  (the module fixture of the scenes)
    start,
)

from nerf_or_nothing_tpu import checkpoint as jckpt  # noqa: E402
from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import parse_flags as jparse  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.parallel import mesh as jmesh  # noqa: E402
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu_torch import checkpoint as tckpt  # noqa: E402
from nerf_or_nothing_tpu_torch import run as trun  # noqa: E402
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config, parse_flags  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets import bin_dump as tbin  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets import (  # noqa: E402
    native_loader as tnative,
)
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.parallel import mesh  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402

KW = dict(batch_size=32, num_samples=16, net_depth=2, net_width=32,
          net_width_condition=16, max_deg_point=4, num_levels=2,
          compute_dtype="float32", use_pallas=False, donate_params=False,
          lr_delay_steps=0, lr_init=2e-3, lr_final=2e-3, grad_max_norm=0.05,
          weight_decay_mult=0.01)
GRIDS = ((1, 1), (2, 2), (1, 4))
STEPS = 2
RTOL, ATOL = 1e-4, 1e-6
TREES = ("params", "mu", "nu")
STATS = ("loss", "losses", "weight_l2", "psnr", "psnrs", "grad_norm",
         "grad_abs_max", "grad_norm_clipped")

# One rank of a DP x MP grid: two tensor-parallel steps on its rows of two
# global batches, randomized false and true; its blocks, the gathered
# model and the stats; on a 1 x 1 grid the single-process step in the same
# process, bit for bit; with check_numerics a NaN pixel on the last rank.
WORKER = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from nerf_or_nothing_tpu_torch import train as ttrain
from nerf_or_nothing_tpu_torch.config import tiny_config
from nerf_or_nothing_tpu_torch.models import mlp as tmlp
from nerf_or_nothing_tpu_torch.parallel import mesh
from nerf_or_nothing_tpu_torch.rays import Rays

rank, dp, mp = (int(os.environ[k]) for k in ("RANK", "DP", "MP"))
out = os.environ["OUT"]
mesh.initialize(os.environ["INIT"], dp * mp, rank, "cpu")
grid = mesh.create_mesh_2d(dp, mp, device="cpu")
kw = json.loads(os.environ["KW"])
data = np.load(os.path.join(os.path.dirname(out), "inputs.npz"))
batches = [(Rays(*[data[f"b{k}/rays{i}"] for i in range(7)]),
            data[f"b{k}/pixels"]) for k in range(int(os.environ["STEPS"]))]
init = [(data[f"w{i}"], data[f"b{i}"])
        for i in range(len([k for k in data.files if k[0] == "w"]))]
arrays, flags = {}, {"b": grid.b, "m": grid.m}
STATS = ("loss", "losses", "weight_l2", "psnr", "psnrs", "grad_norm",
         "grad_abs_max", "grad_norm_clipped")


def fresh():
    p = tmlp.params_from_jax(init)
    z = lambda: [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in p]
    return ttrain.TrainState(0, p, z(), z(), torch.Generator())


def tensors(r, p):
    return Rays(*map(torch.from_numpy, r)), torch.from_numpy(np.array(p))


def keep(name, state):
    for tree in ("params", "mu", "nu"):
        for i, (w, b) in enumerate(getattr(state, tree)):
            arrays[f"{name}/{tree}/w{i}"] = w.numpy().copy()
            arrays[f"{name}/{tree}/b{i}"] = b.numpy().copy()


def same(a, b, sa, sb):
    return all(torch.equal(x, y) for x, y in zip(
        ttrain.state_tensors(a), ttrain.state_tensors(b))) and all(
        torch.equal(getattr(sa, k), getattr(sb, k)) for k in STATS)


for randomized in (False, True):
    cfg = tiny_config(**dict(kw, randomized=randomized))
    step = mesh.make_tensor_parallel_train_step(cfg, grid)
    state = mesh.shard_state(fresh(), grid, cfg)
    for k, batch in enumerate(batches):
        state, stats = step(state, *tensors(
            *mesh.shard_batch(grid.batch_mesh, *batch)))
        for s in STATS:
            arrays[f"{randomized}/{k}/{s}"] = getattr(stats, s).numpy().copy()
    keep(f"{randomized}/shard", state)
    whole = mesh.gather_state(state, grid, cfg)
    keep(f"{randomized}/whole", whole)
    if dp * mp == 1:
        plain = ttrain.make_train_step(cfg)
        other = fresh()
        for batch in batches:
            other, last = plain(other, *tensors(*batch))
        flags[f"{randomized}/single_equal"] = same(other, whole, last, stats)

cfg = tiny_config(**kw, check_numerics=True)
step = mesh.make_tensor_parallel_train_step(cfg, grid)
state = mesh.shard_state(fresh(), grid, cfg)
rays, pixels = tensors(*mesh.shard_batch(grid.batch_mesh, *batches[0]))
bad = pixels.clone()
if rank == dp * mp - 1:
    bad[3, 1] = float("nan")
try:
    step(state, rays, bad)
    flags["nan/raised"] = None
except FloatingPointError as e:
    flags["nan/raised"] = str(e)
state, stats = step(state, rays, pixels)  # every rank goes on in step
flags["nan/after"] = [state.step, float(stats.loss)]

np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(flags, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker on every grid of ``GRIDS``, all at once: per grid, each
    rank's arrays and flags."""
    root = tmp_path_factory.mktemp("torch_tp")
    init = jtrain.init_train_state(jtiny(**KW)).params
    arrays = {}
    batches = [make_batch(KW["batch_size"], seed=k) for k in range(STEPS)]
    for k, (rays, pixels) in enumerate(batches):
        arrays.update({f"b{k}/rays{i}": x for i, x in enumerate(rays)})
        arrays[f"b{k}/pixels"] = pixels
    for i, (w, b) in enumerate(init):
        arrays[f"w{i}"], arrays[f"b{i}"] = np.asarray(w), np.asarray(b)
    np.savez(root / "inputs.npz", **arrays)
    procs = []
    for dp, mp in GRIDS:
        for rank in range(dp * mp):
            procs.append(start([sys.executable, "-c", WORKER], port_env(
                RANK=str(rank), DP=str(dp), MP=str(mp), KW=json.dumps(KW),
                STEPS=str(STEPS), INIT=f"file://{root}/store_{dp}x{mp}",
                OUT=str(root / f"g{dp}x{mp}_r{rank}"))))
    finish(procs, "tensor-parallel workers")
    out = {}
    for dp, mp in GRIDS:
        ranks = []
        for rank in range(dp * mp):
            base = root / f"g{dp}x{mp}_r{rank}"
            with np.load(f"{base}.npz") as f:
                arrays = dict(f)
            with open(f"{base}.json") as f:
                ranks.append((arrays, json.load(f)))
        out[(dp, mp)] = ranks
    return {"grids": out, "init": init, "batches": batches}


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def port_state(init):
    p = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                              for w, b in init])
    z = lambda: [(torch.zeros_like(w), torch.zeros_like(b))  # noqa: E731
                 for w, b in p]
    return ttrain.TrainState(0, p, z(), z(), torch.Generator())


def held(arrays, randomized, state, stats):
    """A rank's gathered model and last stats against a state and its
    stats."""
    for tree in TREES:
        for i, (w, b) in enumerate(getattr(state, tree)):
            for k, t in (("w", w), ("b", b)):
                name = f"{randomized}/whole/{tree}/{k}{i}"
                close(arrays[name], t, name)
    for s in STATS:
        close(arrays[f"{randomized}/{STEPS - 1}/{s}"], getattr(stats, s), s)


def test_layer_sharded_follows_jax_rule():
    """A layer is split over 'model' when mp divides its fan-out: at
    Config() and mp 2 or 4 the 8 trunk layers and the 128-wide view layer,
    not the density (1) and rgb (3) heads; at mp 3 the rgb head alone; at
    mp 1 all."""
    cfg = Config()
    for mp in (2, 4):
        assert mesh.layer_sharded(cfg, mp) == [True] * 8 + [False, True,
                                                             False]
    assert mesh.layer_sharded(cfg, 3) == [False] * 10 + [True]
    assert all(mesh.layer_sharded(cfg, 1))


def test_shard_and_gather_params_round_trip():
    """``shard_params`` takes the contiguous column block m of each sharded
    layer (``w`` and ``b``) and the replicated layers whole; without a
    group, a 1 x 1 grid gathers them back as they are."""
    cfg = tiny_config(**KW)
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    for m in range(4):
        grid = mesh.Mesh2D(0, m, 1, 4, torch.device("cpu"), None, None)
        for (w, b), (sw, sb), sharded in zip(
                params, mesh.shard_params(params, grid, cfg),
                mesh.layer_sharded(cfg, 4)):
            k = w.shape[1] // 4 if sharded else w.shape[1]
            cols = slice(m * k, (m + 1) * k) if sharded else slice(None)
            assert sw.is_contiguous()
            assert torch.equal(sw, w[:, cols]) and torch.equal(sb, b[cols])
    one = mesh.create_mesh_2d(1, 1, device="cpu")
    assert (one.b, one.m, one.batch_group, one.model_group) == (0, 0, None,
                                                                None)
    shards = mesh.shard_params(params, one, cfg)
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(
        mesh.gather_params(shards, one, cfg), params))
    with pytest.raises(ValueError, match="2 x 2 grid"):
        mesh.create_mesh_2d(2, 2, device="cpu")


@pytest.mark.parametrize("randomized", [False, True])
def test_one_by_one_grid_is_the_single_process_step(runs, randomized):
    """On a 1 x 1 grid (gloo, a group of one) two tensor-parallel steps are
    bit-equal to ``make_train_step`` at ``use_pallas=False``: params, mu,
    nu and every stat."""
    arrays, flags = runs["grids"][(1, 1)][0]
    assert flags[f"{randomized}/single_equal"]


@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_grid_matches_single_process_step(runs, grid, randomized):
    """Every rank's gathered params, mu and nu and its stats after two
    steps against the port's single-process step on the global batches:
    column-parallel gradients are the unsharded ones (not scaled by mp,
    input gradients summed over 'model'), the norm and the weight L2 cross
    the shards, and with randomized=True every rank draws the
    single-process step's uniforms and keeps its rows."""
    cfg = tiny_config(**KW, randomized=randomized)
    state = port_state(runs["init"])
    step = ttrain.make_train_step(cfg)
    for rays, pixels in runs["batches"]:
        state, stats = step(state, Rays(*map(torch.from_numpy, rays)),
                            torch.from_numpy(pixels))
    assert float(stats.grad_norm) > KW["grad_max_norm"]  # clipping is on
    for arrays, _ in runs["grids"][grid]:
        held(arrays, randomized, state, stats)


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_grid_matches_jax_tensor_parallel_step(runs, grid):
    """The same gathered state against JAX's
    ``make_tensor_parallel_train_step`` on a grid of as many virtual CPU
    devices (randomized=False)."""
    jc = jtiny(**KW, randomized=False)
    jm = jmesh.create_mesh_2d(*grid)
    step, state_sh, batch_sh = jmesh.make_tensor_parallel_train_step(jc, jm)
    state = jax.tree.map(
        lambda x, s: jax.device_put(x, s), jtrain.init_train_state(jc),
        state_sh, is_leaf=lambda x: isinstance(x, (jax.Array, np.ndarray)))
    for rays, pixels in runs["batches"]:
        state, stats = step(state, JRays(*[jax.device_put(x, batch_sh)
                                           for x in rays]),
                            jax.device_put(pixels, batch_sh))
    for arrays, _ in runs["grids"][grid]:
        held(arrays, False, state, stats)


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_shards_equal_across_batch_ranks(runs, grid):
    """The ranks of one 'model' column hold bit-equal blocks; the
    replicated heads are bit-equal on every rank, and so are the stats.
    The heads (fan-out 1 and 3) keep their whole width."""
    dp, mp = grid
    cfg = tiny_config(**KW)
    sharded = mesh.layer_sharded(cfg, mp)
    ranks = runs["grids"][grid]
    for randomized in (False, True):
        for r, (arrays, flags) in enumerate(ranks):
            assert (flags["b"], flags["m"]) == divmod(r, mp)
            first = ranks[r % mp][0]  # row 0, the same column
            for i, ((fan_in, fan_out), s) in enumerate(zip(
                    tmlp.layer_dims(cfg), sharded)):
                for tree in TREES:
                    name = f"{randomized}/shard/{tree}/w{i}"
                    want = fan_out // mp if s else fan_out
                    assert arrays[name].shape == (fan_in, want), name
                    other = first if s else ranks[0][0]
                    np.testing.assert_array_equal(arrays[name], other[name])
            for k in [k for k in arrays if "/whole/" in k or k.split(
                    "/")[-1] in STATS]:
                np.testing.assert_array_equal(arrays[k], ranks[0][0][k], k)
    assert sharded == [True, True, False, True, False]


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_nan_on_one_rank_raises_on_every_rank(runs, grid):
    """A NaN pixel on the last rank under check_numerics: every rank
    raises FloatingPointError (the flags of the reduced values, and their
    min over 'model'), and all go on to the next step together."""
    afters = set()
    for arrays, flags in runs["grids"][grid]:
        assert flags["nan/raised"] and "nan" in flags["nan/raised"], flags
        afters.add(tuple(flags["nan/after"]))
    assert len(afters) == 1 and next(iter(afters))[0] == 1, afters


def test_run_train_mesh_shape_two_by_two_on_cpu(tmp_path):
    """``run train --mesh-shape=2,2 --device=cpu``: four spawned gloo ranks
    train 2 steps and checkpoint the whole model; a second run resumes to
    4 steps. The data is a bin dump of one ray repeated, so every batch is
    the same (a resumed loader starts its stream again, in both packages;
    JAX's recovery test feeds one batch too) and the resumed run must end
    where an uninterrupted 4-step single-process run ends, within the f32
    band. The checkpoints hold the unsharded arrays, which
    ``checkpoint.state_from_arrays`` and JAX's ``restore_checkpoint``
    read."""
    ckpt, ref = tmp_path / "ckpt", tmp_path / "ref"
    rays, pixels = make_batch(1, seed=3)
    dump = str(tmp_path / "rays.bin")
    tbin.write_bin_dump(dump, Rays(*[np.repeat(x, 8, 0) for x in rays]),
                        np.repeat(pixels, 8, 0))
    args = [f"--data-dir={dump}", "--dataset-loader=bin", *TRAIN_FLAGS,
            "--grad-max-norm=0.05", "--weight-decay-mult=0.01",
            "--lr-init=2e-3", "--lr-final=2e-3"]  # no decay over max_steps
    grid = [*args, "--mesh-shape=2,2", f"--checkpoint-dir={ckpt}"]
    out, = finish([start([sys.executable, "-c", MAIN,
                          " ".join(["train", *grid, "--max-steps=2"]),
                          " ".join(["train", *grid, "--max-steps=4"]),
                          " ".join(["train", *args, "--use-pallas=false",
                                    f"--checkpoint-dir={ref}",
                                    "--max-steps=4"])],
                         port_env())], "run train --mesh-shape=2,2")
    assert [r[:2] for r in results(out)] == [["0", "2"], ["0", "4"],
                                              ["0", "4"]], out
    assert out.count("resumed from step 2") == 1, out
    assert out.count("test view 0") == 4, out
    flags = [a for a in args if not a.startswith("--device")]
    cfg = parse_flags(flags)
    names = sorted(p.name for p in ckpt.glob("checkpoint_*.npz"))
    assert names == [f"checkpoint_00000000{s}.npz" for s in (2, 4)]
    with np.load(ckpt / names[-1]) as f:
        for i, dims in enumerate(tmlp.layer_dims(cfg)):
            for tree in TREES:
                assert f[f"{tree}/w{i}"].shape == dims
        state = tckpt.state_from_arrays(f, cfg)
    want = tckpt.restore_checkpoint(str(ref / names[-1]), cfg)
    assert state.step == want.step == 4
    for a, b in zip(ttrain.state_tensors(state), ttrain.state_tensors(want)):
        close(a, b, "state")
    jstate = jckpt.restore_checkpoint(
        str(ckpt / names[-1]), jtrain.init_train_state(jparse(flags)))
    assert int(jstate.step) == 4
    for (jw, jb), (w, b) in zip(jstate.params, state.params):
        np.testing.assert_array_equal(np.asarray(jw), w.numpy())
        np.testing.assert_array_equal(np.asarray(jb), b.numpy())


# ``run.main`` (its second argument) in a fresh process; the final state's
# arrays (rank 0's for spawned ranks) saved to the first.
SAVE = r"""
import sys
import numpy as np
from nerf_or_nothing_tpu_torch import checkpoint, run
train = run.train


def saved(cfg, *a, **k):
    state = train(cfg, *a, **k)
    np.savez(sys.argv[1], **checkpoint.state_arrays(state, cfg.seed))
    return state


run.train = saved
run.main(sys.argv[2].split())
"""


@pytest.mark.parametrize("shape", ["2", "2,2"])
def test_shared_batches_from_the_native_loader(tmp_path, monkeypatch, shape):
    """``run train --mesh-shape=2`` and ``2,2`` on a bin dump of 512
    distinct rays, through the native loader as ``run`` opens it: the ranks
    that share a batch must each draw it alike (several workers race for
    the draws, so that two ranks' batches would differ), and the run ends
    within the f32 band of one process trained on the one-worker loader's
    batches."""
    if not tnative.native_available():
        pytest.skip("no C++ toolchain to build native/ray_loader.cpp")
    rays, pixels = make_batch(512, seed=5)
    dump = str(tmp_path / "rays.bin")
    tbin.write_bin_dump(dump, rays, pixels)
    args = [f"--data-dir={dump}", "--dataset-loader=bin", *TRAIN_FLAGS,
            "--use-pallas=false", "--max-steps=4", "--print-every=4",
            "--test-render-interval=0", "--grad-max-norm=0.05",
            "--weight-decay-mult=0.01"]
    out = str(tmp_path / "state.npz")
    finish([start([sys.executable, "-c", SAVE, out,
                   " ".join(["train", *args, f"--mesh-shape={shape}"])],
                  port_env())], f"run train --mesh-shape={shape}")
    cls = tnative.NativeRayLoader
    monkeypatch.setattr(tnative, "NativeRayLoader",
                        lambda *a, **k: cls(*a, **{**k, "workers": 1}))
    cfg = parse_flags([a for a in args if not a.startswith("--device")])
    want = tckpt.state_arrays(trun.train(cfg, device="cpu"), cfg.seed)
    with np.load(out) as got:
        assert int(got["step"]) == int(want["step"]) == 4
        names = [k for k in want if k.split("/")[0] in TREES]
        assert len(names) == 6 * len(tmlp.layer_dims(cfg))
        for k in names:
            close(got[k], want[k], k)


def test_launch_flags_grid_equals_spawned_grid(scenes, tmp_path):  # noqa: F811
    """Four processes joined by the launch flags with ``--mesh-shape=2,2``
    take the spawned grid's path (each reads the whole pool and keeps its
    row block; every rank joins the test render's gather): all four end
    on the whole model that ``run train --mesh-shape=2,2`` ends on, bit
    for bit, and rank 0 alone logs and renders."""
    args = [f"--data-dir={scenes['blender']}", *TRAIN_FLAGS[:-1],
            "--mesh-shape=2,2", "--max-steps=2"]
    port = free_port()
    procs = [start([sys.executable, "-c", MAIN, " ".join([
        "train", *args, f"--coordinator=127.0.0.1:{port}",
        "--num-processes=4", f"--process-id={pid}", "--platform=cpu"])],
        port_env()) for pid in range(4)]
    procs.append(start([sys.executable, "-c", MAIN, " ".join(
        ["train", *args, "--device=cpu"])], port_env()))
    outs = finish(procs, "launch flags --mesh-shape=2,2")
    res = [results(o) for o in outs]
    assert [r[0][:2] for r in res] == [[str(p), "2"] for p in range(4)] + [
        ["0", "2"]], res
    assert len({r[0][2] for r in res}) == 1, res
    assert "test view 0" in outs[0] and "loss" in outs[0]
    assert not any("test view 0" in o or "loss" in o for o in outs[1:4])
