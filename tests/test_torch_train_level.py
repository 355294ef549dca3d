"""The port's train level and optimizer pieces against the JAX package on
the CPU: ``level_train_plain`` (through ``fused_level_train``) against the
JAX ``fused_level_train`` (Pallas, interpret mode), the autograd
``composite`` against torch autograd of its forward and the JAX custom
VJP, ``learning_rate_decay``, ``adam_update`` and ``clip_grads``, and the
train kernel's weight and gradient layouts.

Small config (``small_cfg`` of ``tests/test_kernels_level.py``): depth 3,
width 32/16, skip at 2, S=8, plus S=64 at a narrow width. Inputs are made
with numpy from a seed. Tolerances: the parity bands of
``nerf_or_nothing_tpu/utils/parity.py`` as a normalized error < 1, f32
(1e-6, 1e-3) for f32 and bf16 (2e-3, 3e-2) for bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_train as j_level,
)
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.ops import render as jrender  # noqa: E402
from nerf_or_nothing_tpu.ops.math_utils import (  # noqa: E402
    learning_rate_decay as j_lr,
)
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import render as trender  # noqa: E402
from nerf_or_nothing_tpu_torch.ops.math_utils import (  # noqa: E402
    learning_rate_decay,
)

SMALL = dict(net_depth=3, net_width=32, net_depth_condition=1,
             net_width_condition=16, skip_layer=2, max_deg_point=4,
             num_samples=8)

J, T = jnp.asarray, torch.from_numpy


def close(a, b, dtype, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    atol, rtol = PARITY_BANDS[dtype]
    err = normalized_err(a, b, atol, rtol)
    assert err < 1.0, (what, err)


def level_case(kw, R, seed, mask=None):
    """One level's inputs, made with numpy, and the weights of a JAX
    init carried to the port."""
    jc, tc = JConfig(**kw), Config(**kw)
    S = tc.num_samples
    rng = np.random.default_rng(seed)
    f32 = np.float32
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    case = dict(
        means=rng.normal(size=(R, S, 3)).astype(f32),
        covs=rng.uniform(0, 0.02, size=(R, S, 3)).astype(f32),
        x=(rng.normal(size=(R, S, tc.location_features)) * 0.5).astype(f32),
        dir_enc=(rng.normal(size=(R, 27)) * 0.5).astype(f32),
        t_vals=np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1).astype(f32),
        dirs=rng.normal(size=(R, 3)).astype(f32),
        pixels=rng.uniform(size=(R, 3)).astype(f32),
    )
    mask = np.ones(R, f32) if mask is None else np.asarray(mask, f32)
    case["g_scale"] = (0.1 * 2.0 * mask / mask.sum())[:, None].astype(f32)
    return jc, tc, jp, tp, case


def run_level(kw, mode, white_bkgd, R=6, seed=0, mask=None):
    jc, tc, jp, tp, c = level_case(kw, R, seed, mask)
    common_j = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]),
                J(c["pixels"]), J(c["g_scale"]), white_bkgd)
    common_t = (T(c["dir_enc"]), T(c["t_vals"]), T(c["dirs"]),
                T(c["pixels"]), T(c["g_scale"]), white_bkgd)
    if mode == "mv":
        ref = j_level(jp, jc, None, *common_j, tile=16,
                      means_covs=(J(c["means"]), J(c["covs"])))
        port = fl.fused_level_train(tp, tc, None, *common_t,
                                    means_covs=(T(c["means"]), T(c["covs"])))
    else:
        ref = j_level(jp, jc, J(c["x"]), *common_j, tile=16)
        port = fl.fused_level_train(tp, tc, T(c["x"]), *common_t)
    return port, ref


def compare_level(port, ref, dtype):
    for name, a, b in zip(("comp", "acc", "weights"), port[:3], ref[:3]):
        close(a.numpy(), b, dtype, name)
    assert len(port[3]) == len(ref[3])
    for i, ((dw, db), (rw, rb)) in enumerate(zip(port[3], ref[3])):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("white_bkgd", [True, False])
@pytest.mark.parametrize("mode", ["t", "mv"])
def test_level_train_plain_matches_jax(mode, white_bkgd, dtype):
    """6 rays x 8 samples against 16-row JAX tiles."""
    port, ref = run_level(dict(SMALL, compute_dtype=dtype), mode, white_bkgd)
    compare_level(port, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_train_plain_masked_ragged_matches_jax(dtype):
    """A non-uniform loss mask with a zero, 5 rays (a ragged JAX tile)."""
    port, ref = run_level(dict(SMALL, compute_dtype=dtype), "t", True, R=5,
                          seed=3, mask=[1.0, 4.0, 0.0, 2.0, 1.0])
    compare_level(port, ref, dtype)


def test_level_train_plain_s64_two_view_layers_matches_jax():
    """S=64, a deeper trunk with two skip layers and two view layers."""
    kw = dict(SMALL, num_samples=64, net_depth=5, net_depth_condition=2,
              compute_dtype="float32")
    port, ref = run_level(kw, "mv", True, R=3, seed=5)
    compare_level(port, ref, "float32")


def composite_inputs(R=5, S=8, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.uniform(size=(R, S, 3)).astype(f32),
            rng.uniform(0, 3, size=(R, S)).astype(f32),
            np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1).astype(f32),
            rng.normal(size=(R, 3)).astype(f32),
            rng.normal(size=(R, 3)).astype(f32),
            rng.normal(size=(R,)).astype(f32),
            rng.normal(size=(R, S)).astype(f32))


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_composite_backward_matches_autograd_and_jax(white_bkgd):
    """The hand-derived backward against torch autograd of the plain
    forward (f64, rtol 1e-9) and the JAX custom VJP (f32 band)."""
    rgb, dens, t_vals, dirs, g_rgb, g_acc, g_w = composite_inputs()

    def grads_of(fn, dtype):
        r = T(rgb).to(dtype).requires_grad_()
        d = T(dens).to(dtype).requires_grad_()
        outs = fn(r, d, T(t_vals).to(dtype), T(dirs).to(dtype))
        loss = sum((o * T(g).to(dtype)).sum()
                   for o, g in zip(outs, (g_rgb, g_acc, g_w)))
        return torch.autograd.grad(loss, (r, d)), outs

    def plain(r, d, tv, dr):
        _, _, w = trender.composite_weights(d, trender.interval_lengths(tv, dr))
        comp = torch.einsum("...s,...sc->...c", w, r)
        acc = w.sum(-1)
        return (comp + (1.0 - acc[..., None]) if white_bkgd else comp), acc, w

    def hand(r, d, tv, dr):
        return trender.composite(r, d, tv, dr, white_bkgd)

    (g_hand, out_hand) = grads_of(hand, torch.float64)
    (g_auto, _) = grads_of(plain, torch.float64)
    for a, b in zip(g_hand, g_auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)

    def jloss(r, d):
        outs = jrender.composite(r, d, J(t_vals), J(dirs), white_bkgd)
        return sum(jnp.sum(o * J(g)) for o, g in zip(outs, (g_rgb, g_acc, g_w)))

    j_grads = jax.grad(jloss, argnums=(0, 1))(J(rgb), J(dens))
    (g32, out32) = grads_of(hand, torch.float32)
    j_out = jrender.composite(J(rgb), J(dens), J(t_vals), J(dirs), white_bkgd)
    for a, b in zip(out32, j_out):
        close(a.detach().numpy(), b, "float32", "composite forward")
    for a, b in zip(g32, j_grads):
        close(a.numpy(), b, "float32", "composite backward")


def test_composite_no_grad_to_t_vals_and_dirs():
    rgb, dens, t_vals, dirs, *_ = composite_inputs()
    tv = T(t_vals).requires_grad_()
    dr = T(dirs).requires_grad_()
    comp, acc, w = trender.composite(T(rgb).requires_grad_(), T(dens), tv,
                                     dr, True)
    (comp.sum() + acc.sum() + w.sum()).backward()
    assert tv.grad is None and dr.grad is None


@pytest.mark.parametrize("delay", [0, 100])
def test_learning_rate_decay_matches_jax(delay):
    for step in [0, 1, 7, 50, 99, 100, 101, 999, 1000, 1500]:
        a = learning_rate_decay(step, 5e-4, 5e-6, 1000, delay, 0.01)
        b = j_lr(step, 5e-4, 5e-6, 1000, delay, 0.01)
        assert a.dtype == torch.float32
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=0)


def random_tree(cfg, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(i, o)).astype(np.float32) * scale,
             rng.normal(size=(o,)).astype(np.float32) * scale)
            for i, o in tmlp.layer_dims(cfg)]


def to_t(tree):
    return [(T(w.copy()), T(b.copy())) for w, b in tree]


def test_adam_update_matches_jax():
    """Three in-place steps against three JAX steps, eps inside the sqrt."""
    cfg = Config(**SMALL)
    jcfg = JConfig(**SMALL)
    p, m, v = (random_tree(cfg, 0), random_tree(cfg, 1, 0.01),
               [(np.abs(w), np.abs(b)) for w, b in random_tree(cfg, 2, 1e-4)])
    tp, tm, tv = to_t(p), to_t(m), to_t(v)
    jp, jm, jv = ([(J(w), J(b)) for w, b in t] for t in (p, m, v))
    for step in (1, 2, 3):
        g = random_tree(cfg, 10 + step, 0.1)
        lr = 5e-4 / step
        _, host = ttrain.adam_scalars(cfg, step)
        host[0] = lr
        s = torch.from_numpy(host)
        ttrain.adam_update(tp, to_t(g), tm, tv, s[0], s[1], s[2], cfg)
        jp, jm, jv = jtrain.adam_update(jp, [(J(w), J(b)) for w, b in g], jm,
                                        jv, jnp.float32(lr),
                                        jnp.asarray(step, jnp.int32), jcfg)
    for a_tree, b_tree, name in ((tp, jp, "params"), (tm, jm, "mu"),
                                 (tv, jv, "nu")):
        for (aw, ab), (bw, bb) in zip(a_tree, b_tree):
            close(aw.numpy(), bw, "float32", name)
            close(ab.numpy(), bb, "float32", name)


@pytest.mark.parametrize("max_norm,max_val", [(0.0, 0.0), (0.5, 0.0),
                                              (0.0, 0.05), (0.5, 0.05)])
def test_clip_grads_matches_jax(max_norm, max_val):
    kw = dict(SMALL, grad_max_norm=max_norm, grad_max_val=max_val)
    g = random_tree(Config(**kw), 4, 0.1)
    out, norm, clipped, amax = ttrain.clip_grads(to_t(g), Config(**kw))
    j_out, j_norm, j_clipped, j_amax = jtrain.clip_grads(
        [(J(w), J(b)) for w, b in g], JConfig(**kw))
    for a, b in ((norm, j_norm), (clipped, j_clipped), (amax, j_amax)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    for (aw, ab), (bw, bb) in zip(out, j_out):
        close(aw.numpy(), bw, "float32", "clipped dW")
        close(ab.numpy(), bb, "float32", "clipped db")


def test_use_fused_level_matches_jax():
    for kw in (dict(), dict(use_pallas=False), dict(fuse_level=False),
               dict(stop_level_grad=False), dict(fuse_ipe=True),
               dict(fuse_ipe=True, diag_covariance=False)):
        assert ttrain.use_fused_level(Config(**kw)) == \
            jtrain.use_fused_level(JConfig(**kw)), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_params_t_matches_kernel_layout(dtype):
    """W^T of the chained layers, read back with the kernel's offsets
    (csrc/train_level.cu: wt_off) and fragment indexing."""
    cfg = Config(net_depth=5, skip_layer=2, net_width=64,
                 net_width_condition=32, net_depth_condition=2,
                 max_deg_point=4)
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    wt = fl.pack_params_t(params, cfg, dtype).float().numpy()
    assert wt.size == fl.packed_t_size(cfg)
    W, Wc, D = 64, 32, cfg.net_depth

    def read(off, K, N):
        k = np.arange(K)[:, None]
        n = np.arange(N)[None, :]
        if dtype == torch.bfloat16:
            r = k % 16
            idx = ((((n // 8) * (K // 16) + k // 16) * 32
                    + (n % 8) * 4 + (r % 8) // 2) * 4 + (r // 8) * 2 + r % 2)
        else:
            idx = k * N + n
        return wt[off + idx]

    def exp(w):
        return w.to(dtype).float().numpy().T

    for i in range(1, D):
        np.testing.assert_array_equal(read((i - 1) * W * W, W, W),
                                      exp(params[i][0][:W]))
    v0 = (D - 1) * W * W
    np.testing.assert_array_equal(read(v0, Wc, W), exp(params[D + 1][0][:W]))
    np.testing.assert_array_equal(read(v0 + W * Wc, Wc, Wc),
                                  exp(params[D + 2][0]))


def test_unpack_grads_layout():
    """The kernel's flat output: every dW [fan_in, fan_out] row-major in
    layer order, then every db."""
    cfg = Config(**SMALL)
    dims = tmlp.layer_dims(cfg)
    flat = torch.arange(tmlp.num_params(cfg), dtype=torch.float32)
    grads = fl.unpack_grads(flat, cfg)
    off = 0
    for (dw, _), (i, o) in zip(grads, dims):
        assert dw.shape == (i, o) and float(dw[0, 0]) == off
        off += i * o
    for (_, db), (_, o) in zip(grads, dims):
        assert db.shape == (o,) and float(db[0]) == off
        off += o
    assert off == flat.numel()


def test_train_kernel_wrapper_checks_inputs():
    """CPU tensors, wrong shapes and unsupported widths are refused before
    any launch; the dispatcher sends CPU tensors to the plain version."""
    cfg = Config(**dict(SMALL, net_width_condition=32))
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    R, S = 3, cfg.num_samples
    xs = torch.zeros(R * S, cfg.location_features, dtype=torch.bfloat16)
    d = torch.zeros(R, 27, dtype=torch.bfloat16)
    delta, pixels, gsc = torch.zeros(R, S), torch.zeros(R, 3), torch.zeros(R, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.train_level_cuda(params, cfg, xs, d, delta, pixels, gsc, True, "t")
    with pytest.raises(ValueError, match="unknown input mode"):
        fl.train_level_cuda(params, cfg, xs, d, delta, pixels, gsc, True, "x")
    # net_width 1056 is taken (the wide route has no ceiling): the config
    # checks pass and the device check refuses the CPU tensors
    wide = cfg.replace(net_width=1056)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.train_level_cuda(tmlp.init_mlp(torch.Generator().manual_seed(0),
                                          wide), wide, xs, d, delta, pixels,
                            gsc, True, "t")
    with pytest.raises(ValueError, match="not supported"):
        fl.train_level_cuda(params, wide.replace(num_rgb_channels=4), xs, d,
                            delta, pixels, gsc, True, "t")
    before = fl.train_level.launches
    out = fl.train_level(params, cfg, xs, d, delta, pixels, gsc, True, "t")
    assert fl.train_level.launches == before
    assert [tuple(dw.shape) for dw, _ in out[3]] == tmlp.layer_dims(cfg)
