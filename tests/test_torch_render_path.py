"""The render slice end to end: the port's make_render_fn / render_image,
evaluate_image and ``run eval`` / ``run render`` against the JAX package,
the device rule, and import hygiene.

Tiny 2-level config: depth 3, width 32, skip at 2, S=8, max_deg_point=4,
randomized=False. Tolerances: f32 rtol 1e-4 / atol 1e-5; bf16 within the
bf16 parity band (2e-3, 3e-2) as a normalized error < 1.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)

from nerf_or_nothing_tpu import checkpoint as jckpt  # noqa: E402
from nerf_or_nothing_tpu import eval as jeval  # noqa: E402
from nerf_or_nothing_tpu import run as jrun  # noqa: E402
from nerf_or_nothing_tpu.config import parse_flags as jparse  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu.train import init_train_state  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import eval as teval  # noqa: E402
from nerf_or_nothing_tpu_torch import run as trun  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402
from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "nerf_or_nothing_tpu_torch"
TINY = dict(batch_size=16, num_samples=8, num_levels=2, net_depth=3,
            net_width=32, net_width_condition=32, skip_layer=2,
            max_deg_point=4, randomized=False, use_pallas=True)
FLAGS = ["--num-samples=8", "--net-depth=3", "--net-width=32",
         "--net-width-condition=32", "--skip-layer=2", "--max-deg-point=4",
         "--randomized=false", "--use-pallas=true", "--compute-dtype=float32",
         "--render-chunk-size=128"]


def make_rays(R, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(R, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((R, 1), np.float32)
    return Rays(o, d, vd, ones * 0.005, ones * 2.0, ones * 6.0, ones)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_image_matches_jax(dtype):
    """40 rays in chunks of 16: the last chunk is padded on both sides."""
    jc = jtiny(**TINY, compute_dtype=dtype)
    tc = tiny_config(**TINY, compute_dtype=dtype)
    params = init_train_state(jc).params
    tp = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                               for w, b in params])
    rays = make_rays(40)
    j = jeval.render_image(jeval.make_render_fn(jc), params,
                           JRays(*map(jnp.asarray, rays)), 8, 5, chunk=16)
    t = teval.render_image(teval.make_render_fn(tc), tp, rays, 8, 5,
                           chunk=16, device="cpu")
    for a, b in zip(t, j):
        assert a.shape == b.shape
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        else:
            atol, rtol = PARITY_BANDS[dtype]
            assert normalized_err(a, b, atol, rtol) < 1.0


def test_level_weight_matches_jax():
    from nerf_or_nothing_tpu.models.mipnerf import level_weight as j_weight
    from nerf_or_nothing_tpu_torch.models.mipnerf import level_weight

    for levels, mult in [(2, 0.1), (3, 0.25)]:
        jc = jtiny(num_levels=levels, coarse_loss_mult=mult)
        tc = tiny_config(num_levels=levels, coarse_loss_mult=mult)
        assert [level_weight(tc, i) for i in range(levels)] == [
            j_weight(jc, i) for i in range(levels)]


def test_evaluate_image_matches_jax():
    rng = np.random.default_rng(1)
    gt = rng.uniform(size=(16, 12, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.1, size=gt.shape), -0.1, 1.1)
    pred = pred.astype(np.float32)
    t = teval.evaluate_image(pred, gt, device="cpu")
    j = jeval.evaluate_image(pred, gt)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def scene_and_ckpt(tmp_path_factory):
    """A 16x16 synthetic Blender scene (the port's writer) and a JAX
    checkpoint of the tiny config's initial state."""
    root = tmp_path_factory.mktemp("torch_scene")
    scene = str(root / "scene")
    write_scene(scene, n_train=1, n_test=2, size=16)
    ckpt = str(root / "ckpt")
    flags = [f"--data-dir={scene}", f"--checkpoint-dir={ckpt}", *FLAGS]
    jckpt.save_checkpoint(ckpt, init_train_state(jparse(flags)))
    return scene, ckpt, flags


@pytest.mark.parametrize("linear_color", [False, True])
def test_run_eval_matches_jax(scene_and_ckpt, capsys, linear_color):
    _, _, flags = scene_and_ckpt
    flags = [*flags, f"--linear-color={linear_color}"]
    assert trun.main(["eval", *flags, "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"eval"')][-1]
    port = json.loads(line)["eval"]
    ref = jrun.evaluate(jparse(flags))
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_run_render_pngs_match_jax(scene_and_ckpt, tmp_path):
    _, _, flags = scene_and_ckpt
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert trun.main(["render", *flags, "--device=cpu", f"--out={t_out}"]) == 0
    jrun.render(jparse(flags), j_out)
    names = sorted(os.listdir(j_out))
    assert sorted(os.listdir(t_out)) == names == ["render_000.png",
                                                  "render_001.png"]
    for n in names:
        a = np.asarray(Image.open(os.path.join(t_out, n)), np.int16)
        b = np.asarray(Image.open(os.path.join(j_out, n)), np.int16)
        assert a.shape == b.shape == (16, 16, 3)
        assert np.abs(a - b).max() <= 1, n


def test_entry_points_need_a_card_unless_cpu_is_asked(scene_and_ckpt):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, _, flags = scene_and_ckpt
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["eval", *flags])
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.evaluate_image(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["train", *flags])
    assert trun.main(["frobnicate"]) == 2


SCRIPTS = ["chip_smoke", "compare_kernels", "profile_render", "profile_train"]
# Runs on the card, where only PyTorch is installed.
CARD_TESTS = [REPO / "tests" / "test_torch_kernel_cuda.py"]


def _port_sources():
    return (sorted(PKG.rglob("*.py")) + [REPO / f"{m}.py" for m in SCRIPTS]
            + CARD_TESTS)


def test_port_imports_no_jax_ast():
    banned = ("jax", "nerf_or_nothing_tpu")
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}: imports {name}"


def test_port_imports_without_jax_subprocess():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nerf_or_nothing_tpu'] = None\n"
        f"for m in {mods + SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
