"""Every width on the CPU: the wide route without a ceiling (net_width
above 1024, net_width_condition above 256). The port's plain versions
(``fused_level_train``, ``fused_level_render``, ``fused_mlp_apply``,
``mlp_bwd_plain``: what the dispatchers run on CPU tensors) against the
JAX package's Pallas kernels (interpret mode) at net_width /
net_width_condition 512 / 320, 1056 / 288 and 2048 / 1056 in f32 and
bf16, two train steps against JAX's at 1056 / 288 in f32, JAX's weights
carried across at 2048 / 1056, the wide kernels' reads of the packed
streams at net_width_condition 288, 320 (a partial last slab) and 1056
(``test_torch_wide.wide_model``, ``test_torch_wide_f32.wide_f32_model``),
and the guard, which takes every width.

Config: depth 3, skip at 2, S=8, R=4, inputs made with numpy from a seed
(``test_torch_wide.case``, ``test_torch_wide_mlp.mlp_case``). Tolerance:
the parity bands of ``nerf_or_nothing_tpu/utils/parity.py`` (f32 (1e-6,
1e-3), bf16 (2e-3, 3e-2)) as a normalized error < 1. The kernels
themselves are held against the plain versions on a card
(``test_torch_kernel_cuda.py -k any_width``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_train_step import branch_kw, check_two_steps  # noqa: E402
from test_torch_wide import (  # noqa: E402
    WIDE,
    case,
    close,
    wide_model,
)
from test_torch_wide_f32 import wide_f32_model  # noqa: E402
from test_torch_wide_mlp import mlp_case  # noqa: E402

from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.kernels import fused_mlp as jfm  # noqa: E402
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_render as j_render,
)
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_train as j_level,
)
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
WIDTHS = [(512, 320), (1056, 288), (2048, 1056)]
IDS = [f"{w}_{wc}" for w, wc in WIDTHS]
DTYPES = ["float32", "bfloat16"]


def any_width(widths, dtype):
    W, Wc = widths
    return dict(WIDE, net_width=W, net_width_condition=Wc,
                compute_dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_any_width_train_level_matches_jax(widths, dtype):
    """One train level in mode "t", 4 rays x 8 samples against JAX's
    16-row tiles: comp, acc, weights and every dW / db."""
    jc, tc, jp, tp, c = case(any_width(widths, dtype), seed=2)
    assert fl.uses_wide(tc) and fl.kernel_cfg(tc) is tc
    ref = j_level(jp, jc, J(c["x"]), J(c["dir_enc"]), J(c["t_vals"]),
                  J(c["dirs"]), J(c["pixels"]), J(c["g_scale"]), True,
                  tile=16)
    port = fl.fused_level_train(tp, tc, T(c["x"]), T(c["dir_enc"]),
                                T(c["t_vals"]), T(c["dirs"]),
                                T(c["pixels"]), T(c["g_scale"]), True)
    for name, a, b in zip(("comp", "acc", "weights"), port[:3], ref[:3]):
        close(a.numpy(), b, dtype, name)
    assert len(port[3]) == len(ref[3]) == len(tmlp.layer_dims(tc))
    for i, ((dw, db), (rw, rb)) in enumerate(zip(port[3], ref[3])):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_any_width_render_level_matches_jax(widths, dtype):
    """One render level in mode "mv" (the IPE inside the level): comp,
    acc and weights."""
    jc, tc, jp, tp, c = case(any_width(widths, dtype), seed=3)
    common_j = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]), True)
    common_t = (T(c["dir_enc"]), T(c["t_vals"]), T(c["dirs"]), True)
    ref = j_render(jp, jc, None, *common_j, tile=16,
                   means_covs=(J(c["means"]), J(c["covs"])))
    port = fl.fused_level_render(tp, tc, None, *common_t,
                                 means_covs=(T(c["means"]), T(c["covs"])))
    for name, a, b in zip(("comp", "acc", "weights"), port, ref):
        close(a.numpy(), b, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_any_width_mlp_fwd_matches_jax(widths, dtype):
    """The port's ``fused_mlp_apply`` (``mlp_fwd_plain`` on the CPU)
    against JAX's, heads 4 / 2: raw_rgb and raw_den."""
    kw = dict(any_width(widths, dtype), num_rgb_channels=4,
              num_density_channels=2)
    jc, tc, jp, tp, x, d, _, _ = mlp_case(kw, seed=5)
    ref = jfm.fused_mlp_apply(jp, jc, J(x), J(d), tile=16)
    out = fm.fused_mlp_apply(tp, tc, T(x), T(d))
    for a, b, name in zip(out, ref, ("raw_rgb", "raw_den")):
        close(a.numpy(), np.asarray(b), dtype, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_any_width_mlp_bwd_matches_jax(widths, dtype):
    """``mlp_bwd_plain`` with input_grads against JAX's
    ``_fused_mlp_bwd_impl`` (8-row tiles): every dW / db, dX and dD."""
    jc, tc, jp, tp, x, d, g_rgb, g_den = mlp_case(any_width(widths, dtype),
                                                  seed=6)
    R, S = d.shape[0], tc.num_samples
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params, ref_dx, ref_dd = jfm._fused_mlp_bwd_impl(
        jp, J(x).reshape(R * S, -1).astype(jdt), J(d).astype(jdt), J(g_rgb),
        J(g_den), cfg=jc, tile=8, s=S, input_grads=True)
    dt = tmlp.compute_dtype(tc)
    d_params, dx, dd = fm.mlp_bwd_plain(
        tp, tc, T(x).reshape(R * S, -1).to(dt), T(d).to(dt), T(g_rgb),
        T(g_den), S, True)
    assert len(d_params) == len(ref_params) == len(tmlp.layer_dims(tc))
    for i, ((dw, db), (rw, rb)) in enumerate(zip(d_params, ref_params)):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")
    close(dx.float().numpy(), np.asarray(ref_dx, np.float32), dtype, "dX")
    close(dd.numpy(), ref_dd, dtype, "dD")


def test_any_width_two_train_steps_match_jax():
    """Two fused-level train steps at net_width 1056 / 288 in f32 from
    JAX's initial state (``test_torch_train_step.check_two_steps``): the
    stats after each step, then params, mu and nu."""
    kw = branch_kw("fused_level", net_width=1056, net_width_condition=288)
    assert fl.uses_wide(Config(**kw))
    check_two_steps(kw, True)


def test_any_width_weights_carry_across_from_jax():
    """JAX's init at Config(net_width=2048, net_width_condition=1056)
    through ``export_flat`` / ``import_flat`` and ``params_from_jax``:
    bit-equal, and the port's own flat round trip."""
    kw = dict(net_width=2048, net_width_condition=1056)
    jc, tc = JConfig(**kw), Config(**kw)
    jp = jmlp.init_mlp(jax.random.PRNGKey(4), jc)
    flat = jmlp.export_flat(jp)
    assert flat.size == tmlp.num_params(tc) == 31_967_204
    tp = tmlp.import_flat(flat, tc)
    direct = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                                   for w, b in jp])
    assert [tuple(w.shape) for w, _ in tp] == tmlp.layer_dims(tc)
    for (w, b), (dw, db), (jw, jb) in zip(tp, direct, jp):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        assert torch.equal(w, dw) and torch.equal(b, db)
    np.testing.assert_array_equal(tmlp.export_flat(tp), flat)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", [(512, 288), (512, 320), (1056, 1056)],
                         ids=["512_288", "512_320", "1056_1056"])
def test_any_width_kernel_reads_of_the_packed_streams(widths, dtype):
    """The wide kernels' reads of the packed streams at net_width_condition
    288 and 320 (a partial last slab of 64 k-rows: 5 and 5 slabs, the
    first view layer's column blocks partial) and 1056 (above 1024: the
    rgb head's K above the one-stage staging, a second view layer): bf16
    through ``wide_model`` (``pack_params_wg`` / ``pack_params_wgt``:
    forward and masked g), f32 through ``wide_f32_model`` (``pack_params``
    / ``pack_params_t`` / ``pack_params_tx``: forward, g-chain, dW, dX and
    dD), against ``mlp_forward_acts`` and ``mlp_backward_plain`` in the
    dtype's band."""
    W, Wc = widths
    cfg = Config(**dict(any_width(widths, dtype), net_depth_condition=2))
    assert fl.uses_wide(cfg) and fl.kernel_cfg(cfg) is cfg
    R, S = 3, cfg.num_samples
    rng = np.random.default_rng(W + Wc)
    params = tmlp.init_mlp(torch.Generator().manual_seed(6), cfg)
    params = [(w, torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)
                                   * 0.1)) for w, b in params]

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    dt = tmlp.compute_dtype(cfg)
    x = (randn(R * S, cfg.location_features) * 0.5).to(dt)
    d = (randn(R, cfg.direction_features) * 0.5).to(dt)
    g_rgb, g_den = randn(R * S, 3), randn(R * S, 1)
    p_rgb, p_den, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    d_params, p_dx, p_dd = fl.mlp_backward_plain(
        params, cfg, x, d, hs, vs, g_rgb, g_den, R, S, dt, input_grads=True)
    D = cfg.net_depth
    if dtype == "bfloat16":
        raw_rgb, raw_den, grads, acts = wide_model(params, cfg, x, d, R, S,
                                                   g_rgb, g_den)
        for k, g in grads.items():  # db is the column sum of the masked g
            layer = k if k < D else k + 1
            close(g.sum(0).numpy(), d_params[layer][1].numpy(), dtype,
                  f"db{layer}")
    else:
        raw_rgb, raw_den, acts, _, got, dx, dd = wide_f32_model(
            params, cfg, x, d, R, S, g_rgb, g_den)
        for layer, ((dw, db), (rw, rb)) in enumerate(zip(got, d_params)):
            close(dw.numpy(), rw.numpy(), dtype, f"dW{layer}")
            close(db.numpy(), rb.numpy(), dtype, f"db{layer}")
        close(dx.numpy(), p_dx.numpy(), dtype, "dX")
        close(dd.numpy(), p_dd.numpy(), dtype, "dD")
    close(raw_rgb.numpy(), p_rgb.numpy(), dtype, "raw_rgb")
    close(raw_den.numpy(), p_den.numpy(), dtype, "raw_den")
    for k, (a, r) in enumerate(zip(acts, hs + vs)):
        close(a.numpy(), r.float().numpy(), dtype, f"act{k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_any_width_guard_admits_every_width(dtype):
    """``check_kernel_config`` takes every net_width and
    net_width_condition of at least 1 (rounded up by ``kernel_cfg``; the
    wide route above 256) with heads 3 / 1 (the level kernels) or of any
    channel count (the MLP kernels), and the router places them (every
    kernel on the wide route above 256); it refuses heads other than 3 / 1
    for the level kernels, heads of 0 channels and widths below 1."""
    widths = (1, 7, 31, 32, 200, 256, 257, 288, 300, 1000, 1024, 1025,
              1056, 2048, 3000, 4096, 10000)
    for W in widths:
        for Wc in widths:
            cfg = Config(net_width=W, net_width_condition=Wc,
                         compute_dtype=dtype)
            kc = fl.kernel_cfg(cfg)
            assert kc.net_width == -(-max(W, Wc) // 32) * 32
            assert kc.net_width_condition == -(-Wc // 32) * 32
            assert fl.uses_wide(cfg) == (kc.net_width > 256)
            fl.check_kernel_config(cfg)
            fl.check_kernel_config(cfg.replace(num_rgb_channels=8,
                                               num_density_channels=1),
                                   any_heads=True)
            if W in (2048, 10000) and Wc in (288, 1056, 10000):
                for kernel in fl.KERNELS:
                    for input_grads in (True, False):
                        assert fl.takes_wide(cfg, kernel, 128, input_grads)
    wide = Config(net_width=2048, net_width_condition=1056,
                  compute_dtype=dtype)
    # heads of 9 channels are taken now (the MLP kernels run a head in
    # groups of 8 channels); the level kernels' 3 / 1 and heads of at
    # least 1 channel are what is still refused
    for heads, any_heads, refused in (((9, 1), True, False),
                                      ((1, 9), True, False),
                                      ((4, 1), False, True),
                                      ((3, 0), True, True)):
        cfg = wide.replace(num_rgb_channels=heads[0],
                           num_density_channels=heads[1])
        if refused:
            with pytest.raises(ValueError, match="not supported"):
                fl.check_kernel_config(cfg, any_heads=any_heads)
        else:
            fl.check_kernel_config(cfg, any_heads=any_heads)
    with pytest.raises(ValueError, match=">= 1"):
        fl.check_kernel_config(wide.replace(net_width_condition=0))


def test_any_width_f32_random_mlp_criterion_holds_for_the_plain_version():
    """The criterion of the card's f32 random-MLP test
    (``test_torch_kernel_cuda.py::
    test_any_width_f32_random_mlp_matches_plain_on_cuda``) held by the f32
    plain version at 512 / 320 (depth 8, R=12, S=128): the rows of
    ``near_zero_rows`` are at most half, and with their cotangents 0
    ``mlp_bwd_plain`` with input_grads is within the f32 band of the
    version with f64 products, as the train level's forward outputs are
    in modes "t" and "mv"."""
    from test_torch_kernel_cuda import (
        BANDS,
        any_width_cfg,
        mlp_inputs,
        near_zero_rows,
        normalized_err,
        tensors,
        train_inputs,
    )

    from nerf_or_nothing_tpu_torch.ops.render import interval_lengths
    from nerf_or_nothing_tpu_torch.utils.parity import reference_products

    dev = torch.device("cpu")
    cfg = any_width_cfg((512, 320), "float32")
    R, S = 12, cfg.num_samples
    params = tmlp.init_mlp(torch.Generator().manual_seed(1), cfg, device=dev)
    means, covs, d, t_vals, dirs, pixels, g_scale = train_inputs(R, S, 1, dev)
    x, _, g_rgb, g_den = mlp_inputs(cfg, params, R, 1, dev)
    delta = interval_lengths(t_vals, dirs)
    atol, rtol = BANDS["float32"]

    def in_band(got, ref, what):
        for k, (a, b) in enumerate(zip(tensors(got), tensors(ref))):
            err = normalized_err(a, b, atol, rtol)
            assert err < 1.0, (what, k, err)

    for mode, xs in (("t", x), ("mv", (means.reshape(-1, 3),
                                       covs.reshape(-1, 3)))):
        out = fl.level_train_plain(params, cfg, xs, d, delta, pixels,
                                   g_scale, True, mode)
        with reference_products(cfg):
            ref = fl.level_train_plain(params, cfg, xs, d, delta, pixels,
                                       g_scale, True, mode)
        in_band(out[:3], ref[:3], mode)
    near = near_zero_rows(params, cfg, x, d)
    assert 0 < int(near.sum()) and 2 * int(near.sum()) <= R * S
    g_rgb, g_den = (torch.where(near[:, None], 0.0, g) for g in (g_rgb, g_den))
    out = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S, True)
    with reference_products(cfg):
        ref = fm.mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den, S, True)
    in_band(out, ref, "mlp_bwd")
