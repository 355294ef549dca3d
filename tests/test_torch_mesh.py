"""Data parallelism of the port (``parallel/mesh.py``) on the CPU over gloo,
against the port's single-process step and JAX's ``make_sharded_train_step``
on a mesh of as many virtual CPU devices.

The ranks are CPU processes started with ``subprocess.Popen`` (``WORKER``,
which imports the port only), joined by a ``file://`` store in the test's
temporary directory; every wait has its own time limit, so a hang fails
its test. One module-scoped run of the worker at 1, 2 and 4 ranks (all
seven processes at once) serves the step, multi-step, render and NaN
cases; ``run train --mesh-shape=2`` and the launch flags run the CLI.

Shapes: ``tiny_config`` at batch 64, 16 samples, depth 2, width 32/16,
two levels, f32, ``randomized=False``, with Multicam's ``loss_mult``
1/4/16/64 sorted so that the ranks' local sums differ. Tolerance:
``rtol=1e-4, atol=1e-6``, as ``tests/test_distributed.py``.
"""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_datasets import write_blender_scene  # noqa: E402

from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import parse_flags as jparse  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.datasets import bin_dump as jbin  # noqa: E402
from nerf_or_nothing_tpu.datasets import native_loader as jnative  # noqa: E402
from nerf_or_nothing_tpu.datasets.base import (  # noqa: E402
    create_dataset as j_dataset,
)
from nerf_or_nothing_tpu.parallel import mesh as jmesh  # noqa: E402
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu_torch import checkpoint as tckpt  # noqa: E402
from nerf_or_nothing_tpu_torch import eval as teval  # noqa: E402
from nerf_or_nothing_tpu_torch import run as trun  # noqa: E402
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import parse_flags  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets import bin_dump as tbin  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets import (  # noqa: E402
    native_loader as tnative,
)
from nerf_or_nothing_tpu_torch.datasets.base import (  # noqa: E402
    create_dataset,
)
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.parallel import mesh  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(batch_size=64, num_samples=16, net_depth=2, net_width=32,
          net_width_condition=16, max_deg_point=6, randomized=False,
          donate_params=False, num_levels=2, compute_dtype="float32",
          lr_delay_steps=0, lr_init=2e-3, lr_final=2e-3)
WORLDS = (1, 2, 4)
RTOL, ATOL = 1e-4, 1e-6
WAIT_S = 240  # each group of processes must end within this

# One rank: the sharded steps (fused level and autograd) on its rows of the
# global batch, the multi-step, randomized sampling on identical rows, the
# sharded render and a NaN pixel on the last rank under check_numerics.
WORKER = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from nerf_or_nothing_tpu_torch import eval as teval
from nerf_or_nothing_tpu_torch import train as ttrain
from nerf_or_nothing_tpu_torch.config import tiny_config
from nerf_or_nothing_tpu_torch.models import mlp as tmlp
from nerf_or_nothing_tpu_torch.parallel import mesh
from nerf_or_nothing_tpu_torch.rays import Rays

rank, world, out = int(os.environ["RANK"]), int(os.environ["WORLD"]), \
    os.environ["OUT"]
mesh.initialize(os.environ["INIT"], world, rank, "cpu")
m = mesh.create_mesh(world, device="cpu")
kw = json.loads(os.environ["KW"])
data = np.load(os.path.join(os.path.dirname(out), "inputs.npz"))
rays = Rays(*[data[f"rays{i}"] for i in range(7)])
pixels = data["pixels"]
init = [(data[f"w{i}"], data[f"b{i}"])
        for i in range(len([k for k in data.files if k[0] == "w"]))]
arrays, flags = {}, {}


def fresh():
    p = tmlp.params_from_jax(init)
    z = lambda: [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in p]
    return ttrain.TrainState(0, p, z(), z(), torch.Generator())


def tensors(r, p):
    return Rays(*map(torch.from_numpy, r)), torch.from_numpy(np.array(p))


def keep(name, state, stats):
    for tree in ("params", "mu"):
        for i, (w, b) in enumerate(getattr(state, tree)):
            arrays[f"{name}/{tree}/w{i}"] = w.numpy().copy()
            arrays[f"{name}/{tree}/b{i}"] = b.numpy().copy()
    for k in ("loss", "losses", "grad_norm", "psnr"):
        arrays[f"{name}/{k}"] = getattr(stats, k).numpy().copy()


def same(a, b, sa, sb):
    return all(torch.equal(x, y) for x, y in zip(
        ttrain.state_tensors(a), ttrain.state_tensors(b))) and all(
        torch.equal(getattr(sa, k), getattr(sb, k))
        for k in ("loss", "losses", "grad_norm", "psnr"))


local = tensors(*mesh.shard_batch(m, rays, pixels))
for name, extra in (("fused", dict(use_pallas=True)),
                    ("autograd", dict(use_pallas=False)),
                    ("random", dict(use_pallas=True, randomized=True))):
    cfg = tiny_config(**dict(kw, **extra))
    batch = local
    if name == "random":  # the same rows on every rank
        batch = tensors(Rays(*[x[:16] for x in rays]), pixels[:16])
    step = mesh.make_sharded_train_step(cfg, m)
    state = fresh()
    for k in range(3):
        state, stats = step(state, *batch)
        if k == 0:
            keep(f"{name}/1", state, stats)
    keep(f"{name}/3", state, stats)
    multi = mesh.make_sharded_multi_step(cfg, m)
    other, last = multi(fresh(), [batch] * 3)
    flags[f"{name}/multi_equal"] = same(other, state, last, stats)
    if world == 1:
        plain = ttrain.make_train_step(cfg)
        other = fresh()
        for k in range(3):
            other, last = plain(other, *batch)
        flags[f"{name}/world1_equal"] = same(other, state, last, stats)

cfg = tiny_config(**kw)
params = tmlp.params_from_jax(init)
render = Rays(*[data[f"render{i}"] for i in range(7)])
for k, v in zip(("rgb", "dist", "acc"), teval.render_image(
        teval.make_render_fn(cfg), params, render, 6, 10, chunk=16,
        device="cpu", mesh=m)):
    arrays[f"render/{k}"] = v

cfg = tiny_config(**kw, check_numerics=True)
step = mesh.make_sharded_train_step(cfg, m)
state = fresh()
state, _ = step(state, *local)
before = [t.clone() for t in ttrain.state_tensors(state)]
bad = local[1].clone()
if rank == world - 1:
    bad[3, 1] = float("nan")
try:
    step(state, local[0], bad)
    flags["nan/raised"] = None
except FloatingPointError as e:
    flags["nan/raised"] = str(e)
flags["nan/unchanged"] = state.step == 1 and all(
    torch.equal(a, b) for a, b in zip(before, ttrain.state_tensors(state)))
state, stats = step(state, *local)  # every rank goes on in step
flags["nan/after"] = [state.step, float(stats.loss)]

np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(flags, f)
"""


def make_batch(R, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((R, 1), np.float32)
    rays = Rays(np.zeros((R, 3), np.float32), d, vd, ones * 0.005,
                ones * 2.0, ones * 6.0, ones)
    return rays, rng.uniform(size=(R, 3)).astype(np.float32)


def global_batch():
    """64 rays with Multicam's loss_mult 1/4/16/64 in sorted blocks."""
    rays, pixels = make_batch(KW["batch_size"])
    lm = np.repeat(np.array([1.0, 4.0, 16.0, 64.0], np.float32),
                   KW["batch_size"] // 4).reshape(-1, 1)
    return rays._replace(loss_mult=lm), pixels


def start(argv, env=None, **kw):
    """A process in its own session, so that a timeout kills what it
    started too."""
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kw)


def finish(procs, what):
    """Wait for every process within ``WAIT_S``; kill the lot on a hang;
    each must exit 0. Returns their outputs."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, f"{what} failed:\n{out}\n{err}"
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{what}: no end within {WAIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker at 1, 2 and 4 ranks, all at once: per world, each
    rank's arrays and flags."""
    root = tmp_path_factory.mktemp("torch_mesh")
    rays, pixels = global_batch()
    render, _ = make_batch(60, seed=5)
    init = jtrain.init_train_state(jtiny(**KW)).params
    arrays = {f"rays{i}": x for i, x in enumerate(rays)}
    arrays.update({f"render{i}": x for i, x in enumerate(render)})
    for i, (w, b) in enumerate(init):
        arrays[f"w{i}"], arrays[f"b{i}"] = np.asarray(w), np.asarray(b)
    np.savez(root / "inputs.npz", pixels=pixels, **arrays)
    procs = []
    for world in WORLDS:
        for rank in range(world):
            procs.append(start([sys.executable, "-c", WORKER], port_env(
                RANK=str(rank), WORLD=str(world), KW=json.dumps(KW),
                INIT=f"file://{root}/store_{world}",
                OUT=str(root / f"w{world}_r{rank}"))))
    finish(procs, "mesh workers")
    out = {}
    for world in WORLDS:
        ranks = []
        for rank in range(world):
            base = root / f"w{world}_r{rank}"
            with np.load(f"{base}.npz") as f:
                arrays = dict(f)
            with open(f"{base}.json") as f:
                ranks.append((arrays, json.load(f)))
        out[world] = ranks
    return {"worlds": out, "init": init, "batch": (rays, pixels),
            "render": render}


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def held(arrays, name, state, stats):
    """The rank's arrays of ``name`` against a state and its stats."""
    for tree in ("params", "mu"):
        for i, (w, b) in enumerate(getattr(state, tree)):
            close(arrays[f"{name}/{tree}/w{i}"], w, f"{name} {tree} w{i}")
            close(arrays[f"{name}/{tree}/b{i}"], b, f"{name} {tree} b{i}")
    for k in ("loss", "losses", "grad_norm"):
        close(arrays[f"{name}/{k}"], getattr(stats, k), f"{name} {k}")


def port_state(init):
    p = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                              for w, b in init])
    z = lambda: [(torch.zeros_like(w), torch.zeros_like(b))  # noqa: E731
                 for w, b in p]
    return ttrain.TrainState(0, p, z(), z(), torch.Generator())


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_single_process_step(runs, world, use_pallas):
    """Rank 0's state and stats after one sharded step (its rows of the
    batch) against the port's step on the whole batch in one process: the
    whole batch's denominator makes the mean of the ranks' gradients the
    whole batch's, though the ranks' loss_mult sums differ."""
    cfg = tiny_config(**KW, use_pallas=use_pallas)
    rays, pixels = runs["batch"]
    state, stats = ttrain.make_train_step(cfg)(
        port_state(runs["init"]), Rays(*map(torch.from_numpy, rays)),
        torch.from_numpy(pixels))
    name = "fused" if use_pallas else "autograd"
    held(runs["worlds"][world][0][0], f"{name}/1", state, stats)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_jax_sharded_step(runs, world, use_pallas):
    """The same rank-0 state against JAX's ``make_sharded_train_step`` on
    a mesh of ``world`` virtual CPU devices (the fused level in interpret
    mode with ``use_pallas``)."""
    jc = jtiny(**KW, use_pallas=use_pallas)
    jm = jmesh.create_mesh(world)
    rays, pixels = runs["batch"]
    state, stats = jmesh.make_sharded_train_step(jc, jm)(
        jmesh.replicate_state(jm, jtrain.init_train_state(jc)),
        *jmesh.shard_batch(jm, JRays(*rays), pixels))
    name = "fused" if use_pallas else "autograd"
    held(runs["worlds"][world][0][0], f"{name}/1", state, stats)


@pytest.mark.parametrize("world", [2, 4])
def test_params_bit_equal_across_ranks(runs, world):
    """After three steps every rank holds the same params and moments."""
    ranks = runs["worlds"][world]
    for name in ("fused/3", "autograd/3", "random/3"):
        keys = [k for k in ranks[0][0] if k.startswith(name + "/")
                and ("/params/" in k or "/mu/" in k)]
        assert len(keys) == 4 * len(runs["init"]), keys
        for arrays, _ in ranks[1:]:
            for k in keys:
                np.testing.assert_array_equal(arrays[k], ranks[0][0][k],
                                              err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_draw_their_own_samples(runs, world):
    """randomized=True on the same rows on every rank: each rank's psnr
    (its own rows, not averaged) differs, the averaged loss does not."""
    ranks = runs["worlds"][world]
    psnrs = [float(a["random/1/psnr"]) for a, _ in ranks]
    assert len(set(psnrs)) == world, psnrs
    losses = {float(a["random/1/loss"]) for a, _ in ranks}
    assert len(losses) == 1, losses


def test_world_of_one_is_the_unsharded_step(runs):
    """In a group of one rank the sharded step (its all-reduces included)
    is bit-equal to ``make_train_step`` over three steps: the rank fold,
    the divide by the world size and the global denominator are
    identities there."""
    flags = runs["worlds"][1][0][1]
    for name in ("fused", "autograd", "random"):
        assert flags[f"{name}/world1_equal"], name


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_multi_step_equals_sharded_steps(runs, world):
    """The sharded multi-step of K=3 is bit-equal to three sharded steps
    on every rank."""
    for arrays, flags in runs["worlds"][world]:
        for name in ("fused", "autograd", "random"):
            assert flags[f"{name}/multi_equal"], name


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_render_matches_single_process(runs, world):
    """60 rays in chunks of 16 (rounded up to the ranks, a ragged tail)
    split over the ranks, gathered on every rank, against one process."""
    cfg = tiny_config(**KW)
    params = port_state(runs["init"]).params
    want = teval.render_image(teval.make_render_fn(cfg), params,
                              runs["render"], 6, 10, chunk=16, device="cpu")
    for arrays, _ in runs["worlds"][world]:
        for k, v in zip(("rgb", "dist", "acc"), want):
            np.testing.assert_allclose(arrays[f"render/{k}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_nan_on_one_rank_raises_on_every_rank(runs, world):
    """A NaN pixel on the last rank under check_numerics: every rank raises
    FloatingPointError (the check reads the averaged values), keeps its
    state, and all go on to the next step together."""
    ranks = runs["worlds"][world]
    afters = set()
    for arrays, flags in ranks:
        assert flags["nan/raised"] and "nan" in flags["nan/raised"], flags
        assert flags["nan/unchanged"], flags
        afters.add(tuple(flags["nan/after"]))
    assert len(afters) == 1 and next(iter(afters))[0] == 2, afters


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mesh_scenes")
    blender = str(root / "blender")
    write_blender_scene(blender)
    ds = j_dataset("train", blender, jparse([]))
    dump = str(root / "rays.bin")
    jbin.write_bin_dump(dump, ds._flat_rays, ds._flat_pixels)
    ds.close()
    return {"blender": blender, "bin": dump}


def same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("loader", ["blender", "multicam", "bin"])
def test_stripes_byte_equal_to_jax(scenes, monkeypatch, loader):
    """Rank r of 3: its pool is rows r::3 of the one-process pool, the
    three stripes together are the pool, and pool and batches (sampler
    seeded cfg.seed + 17 r) are byte-equal to the JAX loader's as process r
    of 3; the native loader's stripe equals JAX's native stripe."""
    monkeypatch.setattr(tbin, "USE_NATIVE", False)
    monkeypatch.setattr(jbin, "USE_NATIVE", False)
    data = scenes["bin" if loader == "bin" else "blender"]
    flags = [f"--dataset-loader={loader}", "--batch-size=32"]
    cfg, jcfg = parse_flags(flags), jparse(flags)
    with create_dataset("train", data, cfg) as full:
        pool = full._flat_pixels
        pool_rays = full._flat_rays
    count, sizes = 3, 0
    for r in range(count):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        monkeypatch.setattr(mesh, "world_size", lambda: count)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: count)
        with create_dataset("train", data, cfg) as ds, \
                j_dataset("train", data, jcfg) as jds:
            same_bytes(ds._flat_pixels, pool[r::count], f"stripe {r}")
            for x, y in zip(ds._flat_rays, pool_rays):
                same_bytes(x, y[r::count], f"stripe {r} rays")
            same_bytes(ds._flat_pixels, jds._flat_pixels, f"jax stripe {r}")
            rng = np.random.default_rng(cfg.seed + 17 * r)
            idx = rng.integers(0, ds.pool_size, size=(cfg.batch_size,))
            for k in range(2):
                (rays, pixels), (jrays, jpixels) = next(ds), next(jds)
                for x, y in zip(rays, jrays):
                    same_bytes(x, y, f"rank {r} batch {k} rays")
                same_bytes(pixels, jpixels, f"rank {r} batch {k}")
                if k == 0:
                    same_bytes(pixels, ds._flat_pixels[idx], "seed")
            sizes += ds.pool_size
    assert sizes == pool.shape[0]
    if loader == "bin" and jnative.native_available() and (
            tnative.native_available()):
        for r in range(count):
            jl = jnative.NativeRayLoader(data, 32, seed=42, stripe_index=r,
                                         stripe_count=count, workers=1)
            tl = tnative.NativeRayLoader(data, 32, seed=42, stripe_index=r,
                                         stripe_count=count, workers=1)
            try:
                for k in range(2):
                    (tr, tp), (jr, jp) = next(tl), next(jl)
                    same_bytes(tp, jp, f"native stripe {r} batch {k}")
            finally:
                tl.close()
                jl.close()


TRAIN_FLAGS = ["--num-samples=8", "--net-depth=2", "--net-width=32",
               "--net-width-condition=16", "--max-deg-point=4",
               "--randomized=false", "--batch-size=32",
               "--compute-dtype=float32", "--render-chunk-size=128",
               "--lr-delay-steps=0", "--print-every=2",
               "--test-render-interval=2", "--device=cpu"]

# ``run.main`` in a fresh process; RESULT: this process's rank, its final
# step and a hash of its params (rank 0's state on the CPU for a spawned
# run).
MAIN = r"""
import hashlib, sys
from nerf_or_nothing_tpu_torch import run
from nerf_or_nothing_tpu_torch.parallel import mesh
train = run.train


def traced(*a, **k):
    state = train(*a, **k)
    h = hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                for wb in state.params for t in wb))
    print("RESULT", mesh.rank(), state.step, h.hexdigest(), flush=True)
    return state


run.train = traced
for argv in sys.argv[1:]:
    run.main(argv.split())
"""


def results(out):
    return [line.split()[1:] for line in out.splitlines()
            if line.startswith("RESULT")]


def test_run_train_mesh_shape_two_on_cpu(scenes, tmp_path):
    """``run train --mesh-shape=2 --device=cpu``: two spawned gloo ranks of
    16 rays each; one log and one set of checkpoints (rank 0's), a test
    render by rank 0; a second run resumes from step 4 to step 6."""
    ckpt = tmp_path / "ckpt"
    args = [f"--data-dir={scenes['blender']}", *TRAIN_FLAGS,
            "--mesh-shape=2", f"--checkpoint-dir={ckpt}", "--save-every=2"]
    out, = finish([start([sys.executable, "-c", MAIN,
                          " ".join(["train", *args, "--max-steps=4"]),
                          " ".join(["train", *args, "--max-steps=6"])],
                         port_env())], "run train --mesh-shape=2")
    (r0, s0, h0), (r1, s1, h1) = results(out)
    assert (r0, s0, r1, s1) == ("0", "4", "0", "6"), out
    assert out.count("test view 0") == 3, out
    assert out.count("resumed from step 4") == 1, out
    with open(ckpt / "train_stats.csv") as f:
        rows = f.read().splitlines()
    assert [r.split(",")[0] for r in rows] == ["step", "2", "4", "6"], rows
    names = sorted(p.name for p in ckpt.glob("checkpoint_*.npz"))
    assert names == [f"checkpoint_00000000{s}.npz" for s in (2, 4, 6)]
    state = tckpt.restore_checkpoint(str(ckpt / names[-1]), parse_flags(
        [a for a in args if not a.startswith("--device")]))
    h = hashlib.sha256(b"".join(t.numpy().tobytes()
                                for wb in state.params for t in wb))
    assert h.hexdigest() == h1
    assert all(bool(torch.isfinite(t).all())
               for t in ttrain.state_tensors(state))


@pytest.mark.parametrize("how", ["flags", "env"])
def test_launch_flags_train_two_processes(scenes, tmp_path, how):
    """Two processes, each one rank of 32 rays (its stripe), joined by
    ``--coordinator`` / ``--num-processes`` / ``--process-id`` with
    ``--platform=cpu``, or by the ``NERF_*`` variables: they end on the
    same params and rank 0 alone logs."""
    port = free_port()
    args = [f"--data-dir={scenes['blender']}", *TRAIN_FLAGS[:-1],
            "--max-steps=3", "--test-render-interval=0"]
    procs = []
    for pid in (0, 1):
        launch = {"coordinator": f"127.0.0.1:{port}", "num_processes": "2",
                  "process_id": str(pid), "platform": "cpu"}
        if how == "flags":
            argv = ["train", *args, *[f"--{k.replace('_', '-')}={v}"
                                      for k, v in launch.items()]]
            env = port_env()
        else:
            argv = ["train", *args]
            env = port_env(**{f"NERF_{k.upper()}": v
                              for k, v in launch.items()})
        procs.append(start([sys.executable, "-c", MAIN, " ".join(argv)],
                           env))
    outs = finish(procs, f"launch {how}")
    res = [results(o) for o in outs]
    assert [r[0][:2] for r in res] == [["0", "3"], ["1", "3"]], res
    assert res[0][0][2] == res[1][0][2]
    assert "step       2  loss" in outs[0] and "loss" not in outs[1]


def test_two_axis_mesh_raises(scenes):
    """A mesh_shape of three axes raises ValueError (two axes train
    tensor-parallel: ``tests/test_torch_tensor_parallel.py``)."""
    cfg = parse_flags([f"--data-dir={scenes['blender']}", *TRAIN_FLAGS[:-1],
                       "--mesh-shape=2,2,1"])
    with pytest.raises(ValueError, match="1-D or 2-D"):
        trun.train(cfg, device="cpu")


def test_mesh_without_a_group_and_batch_rows():
    """Without a group: rank 0 of 1, no group, the device as given; a
    mesh of 2 is refused; ``shard_batch`` takes contiguous row blocks and
    refuses rows that do not split."""
    m = mesh.create_mesh(device="cpu")
    assert (m.rank, m.world_size, m.group, m.device.type) == (0, 1, None,
                                                              "cpu")
    with pytest.raises(ValueError, match="ranks"):
        mesh.create_mesh(2, device="cpu")
    rays, pixels = make_batch(8)
    half = mesh.Mesh(1, 2, torch.device("cpu"), None)
    r, p = mesh.shard_batch(half, rays, pixels)
    same_bytes(p, pixels[4:], "rows")
    same_bytes(r.directions, rays.directions[4:], "rays")
    [(r2, p2)] = mesh.shard_batch_stack(half, [(rays, pixels)])
    same_bytes(p2, p, "stack")
    with pytest.raises(ValueError, match="split"):
        mesh.shard_batch(mesh.Mesh(0, 3, torch.device("cpu"), None), rays,
                         pixels)


def test_spawn_raises_when_a_rank_fails():
    """A rank that exits with an error ends the run with RuntimeError."""
    with pytest.raises(RuntimeError, match="exited with code 3"):
        mesh.spawn(sys.exit, 2, "cpu", 3)


def jax_shards(x):
    """The per-device blocks of a JAX array sharded over its rows, in
    row order."""
    return [np.asarray(s.data) for s in sorted(
        x.addressable_shards, key=lambda s: s.index[0].start or 0)]


@pytest.mark.parametrize("loader", ["blender", "multicam", "bin", "native"])
def test_spawned_ranks_draw_jax_batches(scenes, monkeypatch, loader):
    """The ranks that ``run train --mesh-shape=2`` spawns read stripe 0 of
    1 (the whole pool, sampler seeded cfg.seed): their batches are JAX's
    one-process batches byte for byte, and rank r's rows
    (``mesh.shard_batch``) are the block that JAX's ``shard_batch`` puts on
    device r of a 2-device mesh. ``native``: the bin dump's C++ loader
    (one worker on both sides, so that its batches are a function of the
    seed: the port's because its ranks share the batch, JAX's patched
    so)."""
    native = loader == "native"
    monkeypatch.setattr(tbin, "USE_NATIVE", native)
    monkeypatch.setattr(jbin, "USE_NATIVE", native)
    if native:
        if not (jnative.native_available() and tnative.native_available()):
            pytest.skip("no C++ toolchain to build native/ray_loader.cpp")
        cls = jnative.NativeRayLoader
        monkeypatch.setattr(jnative, "NativeRayLoader",
                            lambda *a, **k: cls(*a, **k, workers=1))
        loader = "bin"
    data = scenes["bin" if loader == "bin" else "blender"]
    flags = [f"--dataset-loader={loader}", "--batch-size=32"]
    cfg, jcfg = parse_flags(flags), jparse(flags)
    jm = jmesh.create_mesh(2)
    with create_dataset("train", data, cfg, shared=True) as ds, \
            j_dataset("train", data, jcfg) as jds:
        assert (getattr(ds, "_native", None) is not None) == native
        for k in range(2):
            (rays, pixels), (jrays, jpixels) = next(ds), next(jds)
            for x, y in zip(rays, jrays):
                same_bytes(x, y, f"batch {k} rays")
            same_bytes(pixels, jpixels, f"batch {k}")
            jr, jp = jmesh.shard_batch(jm, JRays(*jrays), jpixels)
            for r in range(2):
                m = mesh.Mesh(r, 2, torch.device("cpu"), None)
                rr, rp = mesh.shard_batch(m, rays, pixels)
                same_bytes(rp, jax_shards(jp)[r], f"rank {r} batch {k}")
                for x, y in zip(rr, jr):
                    same_bytes(x, jax_shards(y)[r], f"rank {r} rays {k}")


def test_run_train_mesh_shape_two_matches_jax(scenes, tmp_path):
    """``run train --mesh-shape=2 --device=cpu --randomized=false`` (two
    spawned gloo ranks) ends within the f32 band of JAX's ``run train
    --mesh-shape=2`` on two virtual CPU devices after 3 steps from one JAX
    checkpoint of the initial state: the ranks train on JAX's batches, 16
    rows each of the global 32."""
    from nerf_or_nothing_tpu import checkpoint as jckpt
    from nerf_or_nothing_tpu import run as jrun

    flags = [f"--data-dir={scenes['blender']}", *TRAIN_FLAGS[:-1],
             "--use-pallas=false", "--max-steps=3", "--print-every=3",
             "--save-every=100", "--test-render-interval=0",
             "--mesh-shape=2", "--donate-params=false"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    start_state = jtrain.init_train_state(jparse(flags))
    jckpt.save_checkpoint(jdir, start_state)
    jckpt.save_checkpoint(tdir, start_state)
    finish([start([sys.executable, "-c", MAIN, " ".join(
        ["train", *flags, f"--checkpoint-dir={tdir}", "--device=cpu"])],
        port_env())], "run train --mesh-shape=2")
    jrun.train(jparse([*flags, f"--checkpoint-dir={jdir}"]))
    jpath, tpath = (tckpt.latest_checkpoint(d) for d in (jdir, tdir))
    assert jpath.endswith("checkpoint_000000003.npz")
    assert tpath.endswith("checkpoint_000000003.npz")
    with np.load(jpath) as j, np.load(tpath) as t:
        names = [k for k in j.files if k.split("/")[0] in ("params", "mu",
                                                           "nu")]
        assert len(names) == 3 * 2 * len(tmlp.layer_dims(parse_flags(flags)))
        for k in names:
            close(t[k], j[k], k)
