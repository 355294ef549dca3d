"""``pair_ipe`` and ``xt_ipe`` in the port against the JAX package, on the
CPU.

The JAX package feeds its TPU kernel the same IPE features in two
transposed layouts with these flags (``ops/ipe.integrated_pos_enc_split``,
``integrated_pos_enc_xt``); the port computes them in the interleaved
layout and the kernels' mode "t". ``run train`` (two steps from one JAX
checkpoint of the initial state, randomized=False) and ``run eval`` (with
``fuse_ipe_render=False``, so that the render path encodes outside the
kernel too) with each flag are held against JAX's: the checkpoints in the
f32 parity band (1e-6, 1e-3) as a normalized error < 1, the metrics to
rtol 1e-4 / atol 1e-5.

Tiny 2-level config: depth 3, width 32, skip at 2, S=8, max_deg_point=4,
16 rays a batch, f32.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu import checkpoint as jckpt  # noqa: E402
from nerf_or_nothing_tpu import run as jrun  # noqa: E402
from nerf_or_nothing_tpu.config import parse_flags as jparse  # noqa: E402
from nerf_or_nothing_tpu.train import init_train_state  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import checkpoint as tckpt  # noqa: E402
from nerf_or_nothing_tpu_torch import run as trun  # noqa: E402
from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene  # noqa: E402

FLAGS = ["--num-samples=8", "--net-depth=3", "--net-width=32",
         "--net-width-condition=32", "--skip-layer=2", "--max-deg-point=4",
         "--randomized=false", "--use-pallas=true", "--compute-dtype=float32",
         "--render-chunk-size=128", "--batch-size=16", "--lr-delay-steps=0",
         "--lr-init=2e-3", "--lr-final=2e-3", "--fuse-ipe-render=false"]
LAYOUT_FLAGS = ["--pair-ipe=true", "--xt-ipe=true"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ipe_flags") / "scene")
    write_scene(root, n_train=1, n_test=1, size=16)
    return root


@pytest.mark.parametrize("flag", LAYOUT_FLAGS)
def test_run_train_with_ipe_layout_flag_matches_jax(scene, tmp_path, flag):
    base = [f"--data-dir={scene}", *FLAGS, flag, "--max-steps=2",
            "--print-every=1", "--save-every=100",
            "--test-render-interval=0"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jflags = [*base, f"--checkpoint-dir={jdir}", "--mesh-shape=1",
              "--donate-params=false"]
    tflags = [*base, f"--checkpoint-dir={tdir}"]
    start = init_train_state(jparse(jflags))
    jckpt.save_checkpoint(jdir, start)
    jckpt.save_checkpoint(tdir, start)
    jrun.train(jparse(jflags))
    assert trun.main(["train", *tflags, "--device=cpu"]) == 0
    jpath, tpath = (tckpt.latest_checkpoint(d) for d in (jdir, tdir))
    assert jpath.endswith("checkpoint_000000002.npz")
    assert tpath.endswith("checkpoint_000000002.npz")
    atol, rtol = PARITY_BANDS["float32"]
    with np.load(jpath) as j, np.load(tpath) as t:
        names = [k for k in j.files if k.split("/")[0] in ("params", "mu",
                                                           "nu")]
        assert len(names) == 3 * 2 * 6
        for k in names:
            assert normalized_err(t[k], j[k], atol, rtol) < 1.0, k


@pytest.mark.parametrize("flag", LAYOUT_FLAGS)
def test_run_eval_with_ipe_layout_flag_matches_jax(scene, tmp_path, capsys,
                                                   flag):
    ckpt = str(tmp_path / "ckpt")
    flags = [f"--data-dir={scene}", f"--checkpoint-dir={ckpt}", *FLAGS, flag]
    jckpt.save_checkpoint(ckpt, init_train_state(jparse(flags)))
    assert trun.main(["eval", *flags, "--device=cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"eval"')][-1]
    port = json.loads(line)["eval"]
    ref = jrun.evaluate(jparse(flags))
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
