"""The fused-MLP path on the CPU against the JAX package: ``mlp_fwd_plain``
and ``mlp_bwd_plain`` against the JAX ``fused_mlp_apply`` /
``_fused_mlp_bwd_impl`` (Pallas, interpret mode), the port's
``fused_mlp_apply`` Function against ``jax.vjp`` of JAX's and against
torch autograd of ``apply_mlp``, the resampling gradient
(``stop_grad=False``) against ``jax.vjp``, and ``run eval`` at
``--fuse-level=false`` against the JAX package's.

Small config: depth 3 (5 for two skip layers), width 32/16, skip at 2,
max_deg_point 4 (24 features). Inputs are made with numpy from a seed.
Tolerances: the parity bands of ``nerf_or_nothing_tpu/utils/parity.py`` as
a normalized error < 1, f32 (1e-6, 1e-3) for f32 and bf16 (2e-3, 3e-2) for
bf16.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu import checkpoint as jckpt  # noqa: E402
from nerf_or_nothing_tpu import run as jrun  # noqa: E402
from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.config import RayShape as JRayShape  # noqa: E402
from nerf_or_nothing_tpu.config import parse_flags as jparse  # noqa: E402
from nerf_or_nothing_tpu.kernels import fused_mlp as jfm  # noqa: E402
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.ops import sampling as jsamp  # noqa: E402
from nerf_or_nothing_tpu.train import init_train_state  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import run as trun  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config, RayShape  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import sampling as tsamp  # noqa: E402
from nerf_or_nothing_tpu_torch.utils.synthetic import write_scene  # noqa: E402

SMALL = dict(net_depth=3, net_width=32, net_depth_condition=1,
             net_width_condition=16, skip_layer=2, max_deg_point=4)
J, T = jnp.asarray, torch.from_numpy


def close(a, b, dtype, what=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    atol, rtol = PARITY_BANDS[dtype]
    err = normalized_err(a, b, atol, rtol)
    assert err < 1.0, (what, err)


def mlp_case(kw, R, S, seed):
    """Weights of a JAX init carried to the port, and x [R, S, F],
    d [R, Fd] and head cotangents [R*S, C] from numpy."""
    jc, tc = JConfig(**kw), Config(**kw)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    x = (rng.normal(size=(R, S, tc.location_features)) * 0.5).astype(f32)
    d = (rng.normal(size=(R, tc.direction_features)) * 0.5).astype(f32)
    g_rgb = rng.normal(size=(R * S, tc.num_rgb_channels)).astype(f32)
    g_den = rng.normal(size=(R * S, tc.num_density_channels)).astype(f32)
    return jc, tc, jp, tp, x, d, g_rgb, g_den


def as_dt(a, tc):
    return T(a).to(tmlp.compute_dtype(tc))


FWD_CASES = {
    "f32": (dict(SMALL, compute_dtype="float32"), 4, 6, 8),
    "bf16": (dict(SMALL, compute_dtype="bfloat16"), 4, 6, 8),
    "f32_ragged": (dict(SMALL, compute_dtype="float32"), 3, 7, 16),
    "bf16_skip_inside": (dict(SMALL, compute_dtype="bfloat16", net_depth=5),
                         3, 5, 16),
    "bf16_heads_4_2": (dict(SMALL, compute_dtype="bfloat16",
                            num_rgb_channels=4, num_density_channels=2),
                       4, 4, 8),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_mlp_fwd_plain_matches_jax(case):
    """Ragged rows (21 rows against 16-row tiles, padded by JAX), a tile
    that straddles rays (JAX's pre-broadcast fallback), skips at layers 2
    and 4, and 4 rgb / 2 density heads."""
    kw, R, S, tile = FWD_CASES[case]
    jc, tc, jp, tp, x, d, _, _ = mlp_case(kw, R, S, seed=len(case))
    ref = jfm.fused_mlp_apply(jp, jc, J(x), J(d), tile=tile)
    out = fm.mlp_fwd_plain(tp, tc, as_dt(x, tc).reshape(R * S, -1),
                           as_dt(d, tc), S)
    for a, b, name in zip(out, ref, ("raw_rgb", "raw_den")):
        close(a.numpy(), np.asarray(b).reshape(a.shape), kw["compute_dtype"],
              name)


BWD_CASES = {
    "f32_dx": ("float32", True, {}),
    "f32_nodx": ("float32", False, {}),
    "bf16_dx": ("bfloat16", True, {}),
    "bf16_nodx": ("bfloat16", False, {}),
    "bf16_dx_heads_4_2": ("bfloat16", True,
                          dict(num_rgb_channels=4, num_density_channels=2)),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_mlp_bwd_plain_matches_jax(case):
    """Every dW/db, and dX / dD with input_grads; skips at layers 2 and 4
    (dX sums both x-row terms and layer 0's chain); 16 rows against 8-row
    tiles (dW summed over two grid steps)."""
    dtype, input_grads, extra = BWD_CASES[case]
    kw = dict(SMALL, compute_dtype=dtype, net_depth=5, **extra)
    R, S = 4, 4
    jc, tc, jp, tp, x, d, g_rgb, g_den = mlp_case(kw, R, S, seed=7)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params, ref_dx, ref_dd = jfm._fused_mlp_bwd_impl(
        jp, J(x).reshape(R * S, -1).astype(jdt), J(d).astype(jdt), J(g_rgb),
        J(g_den), cfg=jc, tile=8, s=S, input_grads=input_grads)
    d_params, dx, dd = fm.mlp_bwd_plain(
        tp, tc, as_dt(x, tc).reshape(R * S, -1), as_dt(d, tc), T(g_rgb),
        T(g_den), S, input_grads)
    assert len(d_params) == len(ref_params)
    for i, ((dw, db), (rw, rb)) in enumerate(zip(d_params, ref_params)):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")
    if input_grads:
        assert dx.dtype == tmlp.compute_dtype(tc) and dd.dtype == torch.float32
        close(dx.float().numpy(), ref_dx, dtype, "dX")
        close(dd.numpy(), ref_dd, dtype, "dD")
    else:
        assert dx is None and dd is None


def _loss_t(rgb, den):
    return torch.sum(torch.sin(rgb)) + torch.sum(den ** 2)


def _loss_j(rgb, den):
    return jnp.sum(jnp.sin(rgb)) + jnp.sum(den ** 2)


def _port_grads(apply, tp, tc, x, d, **kw):
    leaves = [t.clone().requires_grad_() for wb in tp for t in wb]
    xt, dt_ = T(x).requires_grad_(), T(d).requires_grad_()
    params = list(zip(leaves[0::2], leaves[1::2]))
    loss = _loss_t(*apply(params, tc, xt, dt_, **kw))
    grads = torch.autograd.grad(loss, leaves + [xt, dt_])
    return [g.numpy() for g in grads]


def test_fused_mlp_function_matches_jax_vjp():
    """bf16: the Function's parameter, x and dir_enc gradients against
    jax.grad through JAX's fused_mlp_apply (custom VJP, interpret mode)."""
    kw = dict(SMALL, compute_dtype="bfloat16", net_depth=4)
    R, S = 4, 4
    jc, tc, jp, tp, x, d, _, _ = mlp_case(kw, R, S, seed=3)
    ref = jax.grad(
        lambda p, xx, dd: _loss_j(*jfm.fused_mlp_apply(p, jc, xx, dd,
                                                       tile=8)),
        argnums=(0, 1, 2))(jp, J(x), J(d))
    ref = [np.asarray(t) for wb in ref[0] for t in wb] + [ref[1], ref[2]]
    out = _port_grads(fm.fused_mlp_apply, tp, tc, x, d)
    assert len(out) == len(ref)
    for k, (a, b) in enumerate(zip(out, ref)):
        close(a, b, "bfloat16", f"grad {k}")


def test_fused_mlp_function_matches_autograd_f32():
    """f32: the Function's gradients against torch autograd of the plain
    ``apply_mlp``; with input_grads=False, x gets zeros."""
    kw = dict(SMALL, compute_dtype="float32", net_depth=5)
    R, S = 3, 5
    _, tc, _, tp, x, d, _, _ = mlp_case(kw, R, S, seed=4)
    ref = _port_grads(tmlp.apply_mlp, tp, tc, x, d)
    out = _port_grads(fm.fused_mlp_apply, tp, tc, x, d)
    for k, (a, b) in enumerate(zip(out, ref)):
        close(a, b, "float32", f"grad {k}")
    no_dx = _port_grads(fm.fused_mlp_apply, tp, tc, x, d, input_grads=False)
    assert not no_dx[-2].any() and not no_dx[-1].any()
    for k, (a, b) in enumerate(zip(no_dx[:-2], ref[:-2])):
        close(a, b, "float32", f"grad {k}")


@pytest.mark.parametrize("randomized", [False, True])
def test_resample_gradient_matches_jax(randomized):
    """stop_grad=False: the gradient of (t_vals, means, covs) with respect to
    the coarse weights and t_vals, fed JAX's uniforms."""
    R, S = 6, 16
    rng = np.random.default_rng(20)
    f32 = np.float32
    o = rng.normal(size=(R, 3)).astype(f32)
    dirs = rng.normal(size=(R, 3)).astype(f32)
    radii = rng.uniform(1e-3, 1e-2, size=(R, 1)).astype(f32)
    bins = np.sort(rng.uniform(2, 6, (R, S + 1)), -1).astype(f32)
    w = rng.uniform(0, 1, (R, S)).astype(f32)
    w[1] = 0.0  # an empty ray: blurpool padding only
    cot = [rng.normal(size=s).astype(f32)
           for s in ((R, S + 1), (R, S, 3), (R, S, 3))]
    key = jax.random.PRNGKey(21)

    def j_fn(t, ww):
        nt, (m, c) = jsamp.resample_along_rays(
            key, J(o), J(dirs), J(radii), t, ww, randomized, JRayShape.CONE,
            0.01, stop_grad=False)
        return nt, m, c

    ref_out, vjp = jax.vjp(j_fn, J(bins), J(w))
    ref_grads = vjp(tuple(J(c) for c in cot))
    u = T(np.array(jax.random.uniform(key, (R, S + 1))))
    tb, tw = T(bins).requires_grad_(), T(w).requires_grad_()
    nt, (m, c) = tsamp.resample_along_rays(
        T(o), T(dirs), T(radii), tb, tw, randomized, RayShape.CONE, 0.01,
        stop_grad=False, u=u)
    for a, b, name in zip((nt, m, c), ref_out, ("t_vals", "means", "covs")):
        close(a.detach().numpy(), b, "float32", name)
    grads = torch.autograd.grad((nt, m, c), (tb, tw),
                                grad_outputs=[T(g) for g in cot])
    for a, b, name in zip(grads, ref_grads, ("d t_vals", "d weights")):
        close(a.numpy(), b, "float32", name)


FLAGS = ["--num-samples=8", "--net-depth=3", "--net-width=32",
         "--net-width-condition=32", "--skip-layer=2", "--max-deg-point=4",
         "--randomized=false", "--use-pallas=true", "--fuse-level=false",
         "--compute-dtype=float32", "--render-chunk-size=256"]


def test_run_eval_unfused_level_matches_jax(tmp_path, capsys):
    """``run eval --fuse-level=false`` (the fused-MLP route) on the CPU
    against the JAX package's ``run eval`` (its fused MLP kernel,
    interpret mode) on the same checkpoint."""
    scene, ckpt = str(tmp_path / "scene"), str(tmp_path / "ckpt")
    write_scene(scene, n_train=1, n_test=1, size=16)
    flags = [f"--data-dir={scene}", f"--checkpoint-dir={ckpt}", *FLAGS]
    jckpt.save_checkpoint(ckpt, init_train_state(jparse(flags)))
    launches = fm.mlp_fwd.launches
    assert trun.main(["eval", *flags, "--device=cpu"]) == 0
    assert fm.mlp_fwd.launches == launches  # CPU tensors: the plain version
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"eval"')][-1]
    port = json.loads(line)["eval"]
    ref = jrun.evaluate(jparse(flags))
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_pack_params_tx_matches_kernel_layout():
    """The x rows' W^T (layer 0, then each skip layer), zero-padded to KX
    columns, read back with the kernel's offsets (wtx_off) in f32 order."""
    cfg = Config(**dict(SMALL, net_depth=5))
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    wtx = fl.pack_params_tx(params, cfg, torch.float32).numpy()
    W, lx, kx = 32, cfg.location_features, fl.padded_location_features(cfg)
    assert wtx.size == fl.packed_tx_size(cfg) == 3 * W * kx
    for k, (i, rows) in enumerate(((0, slice(0, lx)), (2, slice(W, None)),
                                   (4, slice(W, None)))):
        block = wtx[k * W * kx:(k + 1) * W * kx].reshape(W, kx)
        np.testing.assert_array_equal(block[:, :lx],
                                      params[i][0][rows].numpy().T)
        assert not block[:, lx:].any()


def test_mlp_wrappers_check_inputs():
    """CPU tensors and unsupported widths are refused before any launch;
    heads of 1-8 channels are taken; the dispatchers send CPU tensors to
    the plain versions."""
    cfg = Config(**dict(SMALL, net_width_condition=32,
                        compute_dtype="bfloat16"))
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    R, S = 3, 4
    x = torch.zeros(R * S, cfg.location_features, dtype=torch.bfloat16)
    d = torch.zeros(R, 27, dtype=torch.bfloat16)
    g_rgb, g_den = torch.zeros(R * S, 3), torch.zeros(R * S, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.mlp_fwd_cuda(params, cfg, x, d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den, True)
    for bad in (dict(net_width=48), dict(num_rgb_channels=9),
                dict(num_density_channels=0)):
        with pytest.raises(ValueError, match="not supported"):
            fm.mlp_fwd_cuda(params, cfg.replace(**bad), x, d)
    fl.check_kernel_config(cfg.replace(num_rgb_channels=8), max_head=8)
    with pytest.raises(ValueError, match="3 rgb / 1 density"):
        fl.check_kernel_config(cfg.replace(num_rgb_channels=4))
    before = (fm.mlp_fwd.launches, fm.mlp_bwd.launches)
    rgb, den = fm.mlp_fwd(params, cfg, x, d)
    d_params, dx, dd = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, True)
    assert (fm.mlp_fwd.launches, fm.mlp_bwd.launches) == before
    assert rgb.shape == (R * S, 3) and den.shape == (R * S, 1)
    assert [tuple(dw.shape) for dw, _ in d_params] == tmlp.layer_dims(cfg)
    assert dx.shape == x.shape and dd.shape == (R, 27)
    assert fm.make_mlp_apply(cfg) is fm.fused_mlp_apply
    plain = fm.make_mlp_apply(cfg.replace(use_pallas=False))
    xs, ds = x.float().view(R, S, -1), d.float()
    for a, b in zip(plain(params, cfg, xs, ds),
                    tmlp.apply_mlp(params, cfg, xs, ds,
                                   compute_dtype=torch.bfloat16)):
        assert torch.equal(a, b)
