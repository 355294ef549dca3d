"""Fail-stop recovery of the port on the CPU, the counterparts of the JAX
package's ``tests/test_multihost.py::test_checkpoint_restart_recovery`` and
``::test_kill9_mid_training_recovery``, and of a killed ``run train``.

Two ranks are two ``python -c`` processes (``WORKER``, which imports the
port only), joined over gloo by ``mesh.initialize`` with a ``file://``
store in the test's temporary directory, at the JAX worker's tiny config
(batch 32, 8 samples, depth 2, width 16/8, ``max_deg_point`` 4,
``randomized=False``); each rank's fixed local batch of 16 rays comes from
``default_rng(100 + rank)``, as in JAX. The same batch every step, so the
end state depends on the step count alone and a restart from any whole
checkpoint must reach the uninterrupted run's. Every process runs in its
own session, every wait has a time limit, and a test kills what is left.

Tolerance: rel 1e-6, the JAX tests' (the runs are bit-equal on the CPU,
which the tests also report). Against JAX's own steps, the band of
``utils/parity.PARITY_BANDS`` for the compute dtype as a normalized error
under 1: in float32 the port's six sharded steps lie within 0.00012 of
the f32 band of JAX's; in bfloat16 (the JAX worker's default) a few Adam
moments of the two plain MLPs lie 1.1-1.8 of the f32 band apart (0.02 of
the bfloat16 band), a bfloat16 step at a few elements.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_mesh import (  # noqa: E402
    TRAIN_FLAGS,
    finish,
    make_batch,
    port_env,
    start,
)

from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.parallel import mesh as jmesh  # noqa: E402
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import checkpoint as tckpt  # noqa: E402
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import parse_flags  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.datasets import bin_dump as tbin  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402

KW = dict(batch_size=32, num_samples=8, net_depth=2, net_width=16,
          net_width_condition=8, max_deg_point=4, randomized=False,
          donate_params=False)
TOTAL = 6
TREES = ("params", "mu", "nu")
KILL_WAIT_S = 120  # the faulted run must pass its kill step within this

# One rank. STEPS: that many steps, then a checkpoint with SAVE=1. TOTAL:
# steps until the state's step reaches it, a checkpoint (rank 0) and this
# rank's progress file after each, PAUSE_S between steps. RESUME=1
# restores the newest checkpoint first. The final state goes to OUT.npz.
WORKER = r"""
import json, os, time
import numpy as np
import torch
torch.set_num_threads(1)
from nerf_or_nothing_tpu_torch import checkpoint as ckpt_lib
from nerf_or_nothing_tpu_torch import train as ttrain
from nerf_or_nothing_tpu_torch.config import tiny_config
from nerf_or_nothing_tpu_torch.models import mlp as tmlp
from nerf_or_nothing_tpu_torch.parallel import mesh
from nerf_or_nothing_tpu_torch.rays import Rays

env = os.environ
pid = int(env["PROC_ID"])
mesh.initialize(env["INIT"], 2, pid, "cpu")
m = mesh.create_mesh(2, device="cpu")
cfg = tiny_config(**json.loads(env["KW"]))
with np.load(env["PARAMS"]) as f:
    params = tmlp.params_from_jax([(f[f"w{i}"], f[f"b{i}"])
                                   for i in range(len(f.files) // 2)])
zeros = lambda: [(torch.zeros_like(w), torch.zeros_like(b))
                 for w, b in params]
state = ttrain.TrainState(0, params, zeros(), zeros(), torch.Generator(
    ).manual_seed(ttrain.step_seed(cfg.seed, 0)))
ckpt = env["CKPT_DIR"]
if env.get("RESUME") == "1":
    state = ckpt_lib.maybe_restore(ckpt, cfg, state)
    print(f"resumed from step {state.step}", flush=True)
state = mesh.replicate_state(state)

rng = np.random.default_rng(100 + pid)
r = cfg.batch_size // 2
d = rng.normal(size=(r, 3)).astype(np.float32)
ones = np.ones((r, 1), np.float32)
rays = Rays(*map(torch.from_numpy, (
    np.zeros((r, 3), np.float32), d,
    d / np.linalg.norm(d, axis=-1, keepdims=True),
    ones * 0.005, ones * 2.0, ones * 6.0, ones)))
pixels = torch.from_numpy(rng.uniform(size=(r, 3)).astype(np.float32))
step = mesh.make_sharded_train_step(cfg, m)
if "STEPS" in env:
    for _ in range(int(env["STEPS"])):
        state, _ = step(state, rays, pixels)
    if env.get("SAVE") == "1":
        ckpt_lib.save_checkpoint(ckpt, state, cfg)
else:
    while state.step < int(env["TOTAL"]):
        state, _ = step(state, rays, pixels)
        ckpt_lib.save_checkpoint(ckpt, state, cfg)  # rank 0 only
        with open(env["PROGRESS"], "w") as f:
            f.write(str(state.step))
        time.sleep(float(env.get("PAUSE_S", "0")))
np.savez(env["OUT"], **ckpt_lib.state_arrays(state, cfg.seed))
print("RESULT", pid, state.step, flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def init_params(tmp_path_factory):
    """JAX's initial params of the config, as numpy arrays in an npz (the
    same for either compute dtype)."""
    path = tmp_path_factory.mktemp("recovery") / "params.npz"
    init = jtrain.init_train_state(jtiny(**KW)).params
    arrays = {}
    for i, (w, b) in enumerate(init):
        arrays[f"w{i}"], arrays[f"b{i}"] = np.asarray(w), np.asarray(b)
    np.savez(path, **arrays)
    return str(path), arrays


def launch_pair(tmp_path, name, params, kw=KW, **env):
    """The two ranks of one run at config ``kw``; (processes, each rank's
    OUT and PROGRESS paths)."""
    procs, outs, progress = [], [], []
    for pid in (0, 1):
        out = str(tmp_path / f"{name}_r{pid}.npz")
        prog = str(tmp_path / f"{name}_progress_{pid}")
        procs.append(start([sys.executable, "-c", WORKER], port_env(
            PROC_ID=str(pid), INIT=f"file://{tmp_path}/store_{name}",
            KW=json.dumps(kw), PARAMS=params, OUT=out, PROGRESS=prog,
            **{k: str(v) for k, v in env.items()})))
        outs.append(out)
        progress.append(prog)
    return procs, outs, progress


def states(paths):
    out = []
    for p in paths:
        with np.load(p) as f:
            out.append(dict(f))
    return out


def assert_equal_states(a, b, what):
    """rel 1e-6 on every array (JAX's tolerance); True if bit-equal."""
    assert int(a["step"]) == int(b["step"]), (what, a["step"], b["step"])
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6,
                                   err_msg=f"{what} {k}")
    return all(np.array_equal(a[k], b[k]) for k in a)


def local_batch(pid):
    """``WORKER``'s batch of rank ``pid``: the Rays fields, then the
    pixels (the JAX recovery worker's draws)."""
    rng = np.random.default_rng(100 + pid)
    r = KW["batch_size"] // 2
    d = rng.normal(size=(r, 3)).astype(np.float32)
    ones = np.ones((r, 1), np.float32)
    return (np.zeros((r, 3), np.float32), d,
            d / np.linalg.norm(d, axis=-1, keepdims=True),
            ones * 0.005, ones * 2.0, ones * 6.0, ones,
            rng.uniform(size=(r, 3)).astype(np.float32))


def jax_steps(params, n, kw=KW):
    """JAX's ``make_sharded_train_step`` on a mesh of 2 virtual CPU
    devices, the two ranks' batches concatenated, ``n`` steps."""
    jc = jtiny(**kw)
    mesh = jmesh.create_mesh(2)
    cols = [np.concatenate(c) for c in zip(local_batch(0), local_batch(1))]
    state = jtrain.init_train_state(jc)
    n_layers = len(params) // 2
    state = state._replace(params=[(params[f"w{i}"], params[f"b{i}"])
                                   for i in range(n_layers)])
    state = jmesh.replicate_state(mesh, state)
    step = jmesh.make_sharded_train_step(jc, mesh)
    batch = jmesh.shard_batch(mesh, JRays(*cols[:7]), cols[7])
    for _ in range(n):
        state, _ = step(state, *batch)
    return state


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_two_process_restart_equals_uninterrupted(tmp_path, init_params,
                                                  compute_dtype):
    """6 straight steps against 3 steps + checkpoint + a fresh pair that
    restores + 3 steps: both runs equal, rank 0 equal to rank 1, and the
    6-step state within the band of the compute dtype of JAX's sharded
    steps from the same initial params."""
    params, arrays = init_params
    kw = dict(KW, compute_dtype=compute_dtype)
    ckpt = tmp_path / "ckpt"
    full, full_out, _ = launch_pair(tmp_path, "full", params, kw, STEPS=6,
                                    CKPT_DIR=tmp_path / "unused")
    half, _, _ = launch_pair(tmp_path, "half", params, kw, STEPS=3, SAVE=1,
                             CKPT_DIR=ckpt)
    finish(full + half, "the 6-step and the 3-step pairs")
    assert [p.name for p in ckpt.glob("checkpoint_*.npz")] == [
        "checkpoint_000000003.npz"]
    resumed, resumed_out, _ = launch_pair(tmp_path, "resumed", params, kw,
                                          STEPS=3, RESUME=1, CKPT_DIR=ckpt)
    outs = finish(resumed, "the resumed pair")
    assert all("resumed from step 3" in o for o in outs), outs
    (f0, f1), (r0, r1) = states(full_out), states(resumed_out)
    assert int(f0["step"]) == int(r0["step"]) == TOTAL
    bits = {"full_vs_resumed": assert_equal_states(f0, r0, "resumed"),
            "ranks_full": assert_equal_states(f0, f1, "rank 1, full"),
            "ranks_resumed": assert_equal_states(r0, r1, "rank 1, resumed")}
    print(f"bit-equal: {bits}")

    jstate = jax_steps(arrays, TOTAL, kw)
    assert int(jstate.step) == TOTAL
    atol, rtol = PARITY_BANDS[compute_dtype]
    errs = {f"{tree}/{k}{i}": normalized_err(
                np.asarray(x), f0[f"{tree}/{k}{i}"], atol, rtol)
            for tree in TREES
            for i, wb in enumerate(getattr(jstate, tree))
            for k, x in zip("wb", wb)}
    worst = max(errs, key=errs.get)
    print(f"against JAX: worst {worst} {errs[worst]:.3g} of the "
          f"{compute_dtype} band")
    assert errs[worst] < 1.0, (worst, errs[worst])


def _kill_session(proc):
    """SIGKILL a process's whole session; wait until no live process of it
    is left (the killed ones' zombies aside)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)
    deadline = time.time() + 30
    while live_in_session(proc.pid):
        assert time.time() < deadline, live_in_session(proc.pid)
        time.sleep(0.1)


def live_in_session(sid):
    """The pids of the processes of session ``sid`` that are not
    zombies (``/proc/<pid>/stat``: state, ppid, pgrp, session)."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(int(pid))
    return out


def check_survivors(ckpt_dir, cfg):
    """Every ``checkpoint_*.npz`` left loads as a whole train state; the
    steps they hold, and the ``mkstemp`` leftovers."""
    names = sorted(os.listdir(ckpt_dir))
    ckpts = [n for n in names if tckpt._CKPT_RE.match(n)]
    assert ckpts, f"no checkpoint survived the kill: {names}"
    steps = []
    for n in ckpts:
        state = tckpt.restore_checkpoint(os.path.join(ckpt_dir, n), cfg)
        assert n == f"checkpoint_{state.step:09d}.npz", n
        steps.append(state.step)
    return steps, [n for n in names if n.endswith(".tmp")]


def wait_progress(path, at_least, procs):
    deadline = time.time() + KILL_WAIT_S
    while time.time() < deadline:
        try:
            with open(path) as f:
                if int(f.read() or 0) >= at_least:
                    return
        except FileNotFoundError:
            pass
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.02)
    pytest.fail(f"no progress to step {at_least} with every rank alive")


def test_kill9_mid_training_recovery(tmp_path, init_params):
    """SIGKILL rank 1 once it passes step 2 (no clean exit, no final
    checkpoint), then rank 0, which either raises on the dead peer or
    blocks in its collective; every surviving checkpoint loads; both
    restart from the newest and end at step 6 equal to an uninterrupted
    run."""
    params, _ = init_params
    ref_dir, fault_dir = tmp_path / "ref", tmp_path / "fault"
    pace = dict(TOTAL=TOTAL, PAUSE_S=0.25)
    ref, ref_out, _ = launch_pair(tmp_path, "ref", params, CKPT_DIR=ref_dir,
                                  **pace)
    fault, _, progress = launch_pair(tmp_path, "fault", params,
                                     CKPT_DIR=fault_dir, **pace)
    try:
        wait_progress(progress[1], 2, fault)
        with open(progress[1]) as f:
            killed_at = int(f.read())
        assert killed_at < TOTAL and fault[1].poll() is None
        os.kill(fault[1].pid, signal.SIGKILL)
        fault[1].wait(timeout=30)
        assert fault[1].returncode == -signal.SIGKILL
        try:  # the survivor raises on the closed connection or blocks
            fault[0].wait(timeout=2)
            survivor = f"exited with {fault[0].returncode}"
        except subprocess.TimeoutExpired:
            survivor = "blocked"
    finally:
        for p in fault:
            _kill_session(p)
    finish(ref, "the uninterrupted pair")

    cfg = tiny_config(**KW)
    steps, leftovers = check_survivors(str(fault_dir), cfg)
    assert max(steps) < TOTAL, steps
    rec, rec_out, _ = launch_pair(tmp_path, "restart", params,
                                  CKPT_DIR=fault_dir, RESUME=1, **pace)
    outs = finish(rec, "the restarted pair")
    resumed = int(re.search(r"resumed from step (\d+)", outs[0]).group(1))
    assert resumed == max(steps) >= 2, (resumed, steps)
    (f0, _), (r0, r1) = states(ref_out), states(rec_out)
    assert int(r0["step"]) == int(r1["step"]) == TOTAL
    bits = {"ref_vs_restarted": assert_equal_states(f0, r0, "restarted"),
            "ranks": assert_equal_states(r0, r1, "rank 1, restarted")}
    print(f"rank 1 killed at step {killed_at}; rank 0 {survivor}; "
          f"checkpoints left {steps}, .tmp left {leftovers}; resumed from "
          f"{resumed}; bit-equal: {bits}")


# ``run.main`` (its second argument) in a fresh process; the final state's
# arrays (rank 0's, gathered on the CPU) saved to the first.
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
if __name__ == "__main__":
    run.main(sys.argv[2].split())
"""

CLI_STEPS = 120
CLI_KILL_AT = 16  # kill once this step's checkpoint exists


def test_run_train_killed_and_restarted_on_cpu(tmp_path):
    """``run train --mesh-shape=2 --device=cpu --steps-per-call=4`` on a
    bin dump of one repeated ray (every batch the same), killed as a whole
    process group once its step-16 checkpoint exists, then the same command
    again: it resumes and ends equal to an uninterrupted run with the same
    ``--max-steps`` (and so the same learning-rate schedule)."""
    rays, pixels = make_batch(1, seed=3)
    dump = str(tmp_path / "rays.bin")
    tbin.write_bin_dump(dump, Rays(*[np.repeat(x, 8, 0) for x in rays]),
                        np.repeat(pixels, 8, 0))
    flags = [a for a in TRAIN_FLAGS if not a.startswith(
        ("--test-render-interval", "--print-every"))]
    args = [f"--data-dir={dump}", "--dataset-loader=bin", *flags,
            "--test-render-interval=0", "--print-every=8", "--save-every=8",
            "--steps-per-call=4", f"--max-steps={CLI_STEPS}",
            "--mesh-shape=2"]
    ckpt, ref = tmp_path / "ckpt", tmp_path / "ref"

    def command(ckpt_dir, out):
        return start([sys.executable, "-c", SAVE, str(out), " ".join(
            ["train", *args, f"--checkpoint-dir={ckpt_dir}"])], port_env())

    reference = command(ref, tmp_path / "ref.npz")
    faulted = command(ckpt, tmp_path / "faulted.npz")
    target = ckpt / f"checkpoint_{CLI_KILL_AT:09d}.npz"
    try:
        deadline = time.time() + KILL_WAIT_S
        while not target.exists():
            assert faulted.poll() is None, faulted.communicate()
            assert time.time() < deadline, "no step-16 checkpoint in time"
            time.sleep(0.02)
        alive = faulted.poll() is None
    finally:
        _kill_session(faulted)
    assert alive
    finish([reference], "the uninterrupted run")
    cfg = parse_flags([a for a in args if not a.startswith("--device")])
    steps, leftovers = check_survivors(str(ckpt), cfg)
    assert CLI_KILL_AT <= max(steps) < CLI_STEPS, steps
    assert not (tmp_path / "faulted.npz").exists()

    out, = finish([command(ckpt, tmp_path / "restarted.npz")],
                  "the restarted run")
    resumed = int(re.search(r"resumed from step (\d+)", out).group(1))
    assert resumed == max(steps), (resumed, steps)
    (a,), (b,) = states([tmp_path / "ref.npz"]), states(
        [tmp_path / "restarted.npz"])
    assert int(a["step"]) == int(b["step"]) == CLI_STEPS
    bit_equal = assert_equal_states(a, b, "restarted run")
    with open(ckpt / "train_stats.csv") as f:
        logged = [int(r.split(",")[0]) for r in f.read().splitlines()[1:]]
    assert logged[-1] == CLI_STEPS, logged
    print(f"killed with checkpoints {steps} (.tmp left {leftovers}); "
          f"resumed from {resumed}; bit-equal {bit_equal}")
