"""Location features of any count on all five kernels on the CPU:
``max_deg_point`` 44, 56 and 70 and a band of frequencies from
``min_deg_point`` 8 to 60, past the narrow routes' shared memory (bf16:
``mlp_bwd``'s dX from 43, the render forward from 54, the train kernels
from 65; f32: ``mlp_bwd``'s dX from 43, the levels from 94), and a large
``deg_view``.

- The IPE on the means and covariances the model's own sampling gives
  (JAX's ``sample_along_rays``, cone, 2-6): ``ops/ipe.py`` against JAX's
  ``integrated_pos_enc`` and the kernels' function
  (``fused_level.encode_mv``) against JAX's in-kernel IPE
  (``_encode_chunk``), with the polynomial (``fast_ipe``) and the exact
  transcendentals: NaN in the same places in both packages (the
  polynomials overflow where |mean| 2^deg is far past 2^24 and are then
  multiplied by a damping of 0: from degree ~36 on these inputs; and the
  exact path where a variance is exactly 0 above degree 63, where 4^deg
  overflows f32), every other value in the f32 band.
- The plain versions of ``render_level``, ``train_level``,
  ``train_level_twopass``, ``mlp_fwd`` and ``mlp_bwd`` with input_grads
  (what the wrappers run on CPU tensors) against the JAX package's
  interpreted Pallas kernels on those inputs, in both dtypes, with the
  exact transcendentals (the polynomial's features are NaN there in both
  packages, above).
- Two fused-level train steps at ``max_deg_point`` 70 against JAX's.
- ``deg_view`` 32 (195 direction features) through the render level and
  the MLP kernels.
- The router (``fused_level.takes_wide``) at each kernel's threshold.
- The wide route's reads of the packed streams at a narrow width
  (64 / 32) with 420 feature columns (``mlp_bwd``'s dX there), modelled
  in Python
  (``test_torch_wide.wide_model``, ``test_torch_wide_f32.wide_f32_model``),
  against the plain version.

Config: depth 3, skip at 2, net_width 64 / 32, S=8, R=4. Tolerance: the
parity bands of ``utils/parity.py`` (f32 (1e-6, 1e-3), bf16 (2e-3, 3e-2))
as a normalized error < 1. The kernels are held against the plain
versions on a card (``test_torch_kernel_cuda.py -k any_features``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_train_step import branch_kw, check_two_steps  # noqa: E402
from test_torch_wide import WIDE, close, j_level, j_render  # noqa: E402
from test_torch_wide import wide_model  # noqa: E402
from test_torch_wide_f32 import wide_f32_model  # noqa: E402

from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.config import RayShape  # noqa: E402
from nerf_or_nothing_tpu.kernels import fused_level as jfl  # noqa: E402
from nerf_or_nothing_tpu.kernels import fused_mlp as jfm  # noqa: E402
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.ops import ipe as jipe  # noqa: E402
from nerf_or_nothing_tpu.ops import sampling as jsampling  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops import ipe as tipe  # noqa: E402
from nerf_or_nothing_tpu_torch.utils.parity import PARITY_BANDS  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
DEGREES = {"44": dict(max_deg_point=44), "56": dict(max_deg_point=56),
           "70": dict(max_deg_point=70),
           "8_60": dict(min_deg_point=8, max_deg_point=60)}
NARROW = dict(WIDE, net_width=64, net_width_condition=32, fast_ipe=False)


def sampled(cfg, R, seed):
    """t_vals [R, S+1], means and covariances [R, S, 3] of R rays cast
    as cones from near 2 to far 6 (JAX's ``sample_along_rays``), their
    directions, view directions and pixel radii (numpy)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    origins = (rng.normal(size=(R, 3)) * 0.5).astype(f32)
    dirs = rng.normal(size=(R, 3)).astype(f32)
    ones = np.ones((R, 1), f32)
    t_vals, (means, covs) = jsampling.sample_along_rays(
        jax.random.PRNGKey(seed), J(origins), J(dirs), J(ones * 0.002),
        cfg.num_samples, J(ones * 2.0), J(ones * 6.0), False, False,
        RayShape.CONE)
    vd = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (np.asarray(t_vals), np.asarray(means), np.asarray(covs), dirs,
            vd.astype(f32))


def level_case(kw, R=4, seed=0):
    """A JAX init carried to the port and one level's inputs (numpy) from
    the model's sampling: the IPE features of the samples (JAX's, exact
    transcendentals unless ``fast_ipe``), the view directions' encoding,
    pixels and per-ray loss scales."""
    jc, tc = JConfig(**kw), Config(**kw)
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    t_vals, means, covs, dirs, vd = sampled(tc, R, seed)
    x = np.asarray(jipe.integrated_pos_enc(
        (J(means), J(covs)), tc.min_deg_point, tc.max_deg_point, diag=True,
        fast=tc.fast_ipe))
    dir_enc = np.asarray(jipe.pos_enc(J(vd), 0, tc.deg_view))
    rng = np.random.default_rng(seed + 1)
    pixels = rng.uniform(size=(R, 3)).astype(np.float32)
    mask = np.array([1.0, 2.0, 0.0, 1.0], np.float32)[:R]
    g_scale = (0.1 * 2.0 * mask / mask.sum())[:, None].astype(np.float32)
    return jc, tc, jp, tp, dict(t_vals=t_vals, means=means, covs=covs,
                                dirs=dirs, x=x, dir_enc=dir_enc,
                                pixels=pixels, g_scale=g_scale)


def jax_kernel_ipe(cfg, means, covs):
    """JAX's in-kernel IPE (``fused_level._encode_chunk``, f32) of [N, 3]
    means and covariances, in the port's interleaved [N, 6F] order."""
    F = cfg.max_deg_point - cfg.min_deg_point
    s, c = jfl._encode_chunk(JConfig(**{k: getattr(cfg, k) for k in (
        "min_deg_point", "max_deg_point", "fast_ipe")}), jnp.float32,
        J(means.T), J(covs.T))
    s, c = np.asarray(s).T.reshape(-1, F, 3), np.asarray(c).T.reshape(-1, F, 3)
    return np.concatenate([s, c], axis=-1).reshape(-1, 6 * F)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("deg", sorted(DEGREES))
def test_ipe_at_high_degrees_matches_jax(deg, fast):
    """The IPE features of the model's samples: the port's ``ops/ipe.py``
    against JAX's (separate sin / cos): NaN in the same places; and the
    kernels' function (``encode_mv``: one shared reduction) against JAX's
    in-kernel IPE: with the polynomials, NaN in both packages from degree
    ~36, in other places (under 2% of the features; where one is NaN the
    other is 0), so both models give NaN there; every value finite in
    both is in the f32 band. With the exact transcendentals a sample whose
    variance is exactly 0 (which the model's sampling does not give) is
    NaN in both above degree 63, and nothing else is."""
    cfg = Config(**DEGREES[deg], num_samples=32, fast_ipe=fast)
    _, means, covs, _, _ = sampled(cfg, 64, seed=5)
    means, covs = means.reshape(-1, 3), covs.reshape(-1, 3).copy()
    if not fast:
        covs[0] = 0.0
    atol, rtol = PARITY_BANDS["float32"]
    pairs = [
        (tipe.integrated_pos_enc((T(means), T(covs)), cfg.min_deg_point,
                                 cfg.max_deg_point, diag=True,
                                 fast=fast).numpy(),
         np.asarray(jipe.integrated_pos_enc(
             (J(means), J(covs)), cfg.min_deg_point, cfg.max_deg_point,
             diag=True, fast=fast))),
        (fl.encode_mv(cfg, T(means), T(covs), torch.float32).numpy(),
         jax_kernel_ipe(cfg, means, covs))]
    # the zero variance's undamped features at |y| past 2^11: the sine of
    # a large argument, which JAX's in-kernel sin gives differently from
    # the port's (up to 2 apart at |y| near 2^44); ROADMAP queue C records
    # it (the model's samples damp those frequencies to below the band)
    F = cfg.max_deg_point - cfg.min_deg_point
    y = np.abs(means[0])[None, :] * 2.0 ** (cfg.min_deg_point + np.arange(F))[
        :, None]
    huge = np.concatenate([y, y], axis=1).reshape(-1) > 2.0 ** 11
    for k, (got, ref) in enumerate(pairs):
        gn, rn = np.isnan(got), np.isnan(ref)
        ok = ~gn & ~rn
        if not fast:
            ok[0] &= ~huge
        np.testing.assert_allclose(got[ok], ref[ok], atol=atol, rtol=rtol)
        if fast and k == 1:
            # The in-kernel polynomials overflow in other places in the two
            # packages (JAX's XLA evaluates them with fused multiply-adds):
            # where one is NaN the other's feature is a damped 0. ROADMAP
            # queue C records it.
            assert not ref[gn & ~rn].any() and not got[rn & ~gn].any()
            assert (gn != rn).mean() < 0.05
        else:
            np.testing.assert_array_equal(gn, rn)
        nan_rows = rn.any(axis=1)
        if not fast:
            assert nan_rows[0] == (cfg.max_deg_point > 64)
            assert not nan_rows[1:].any()
        else:
            assert nan_rows.sum() > 1 and gn.any(axis=1).sum() > 1


def train_common(c, lib):
    f = J if lib == "jax" else T
    return (f(c["dir_enc"]), f(c["t_vals"]), f(c["dirs"]), f(c["pixels"]),
            f(c["g_scale"]), True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deg", sorted(DEGREES))
def test_any_features_levels_match_jax(deg, dtype):
    """``render_level`` (mode "mv": the IPE in the level) and
    ``train_level`` (mode "mv"), the two-pass train level (mode "t"):
    comp, acc, weights and every dW / db against JAX's interpreted
    kernels (16-row tiles)."""
    jc, tc, jp, tp, c = level_case(dict(NARROW, **DEGREES[deg],
                                        compute_dtype=dtype), seed=1)
    mc_j, mc_t = (J(c["means"]), J(c["covs"])), (T(c["means"]),
                                                  T(c["covs"]))
    ref = j_render(jp, jc, None, *train_common(c, "jax")[:3], True, tile=16,
                   means_covs=mc_j)
    port = fl.fused_level_render(tp, tc, None, *train_common(c, "t")[:3],
                                 True, means_covs=mc_t)
    for name, a, b in zip(("comp", "acc", "weights"), port, ref):
        close(a.numpy(), b, dtype, f"render {name}")
    twopass = dict(NARROW, **DEGREES[deg], compute_dtype=dtype,
                   kernel_probes="fl_variant=twopass")
    for mode, kw in (("mv", None), ("t", twopass)):
        jc2, tc2 = (jc, tc) if kw is None else (JConfig(**kw), Config(**kw))
        if mode == "mv":
            ref = j_level(jp, jc2, None, *train_common(c, "jax"), tile=16,
                          means_covs=mc_j)
            port = fl.fused_level_train(tp, tc2, None, *train_common(c, "t"),
                                        means_covs=mc_t)
        else:
            assert fl.uses_twopass(tc2)
            ref = j_level(jp, jc2, J(c["x"]), *train_common(c, "jax"),
                          tile=16)
            port = fl.fused_level_train(tp, tc2, T(c["x"]),
                                        *train_common(c, "t"))
        for name, a, b in zip(("comp", "acc", "weights"), port[:3], ref[:3]):
            close(a.numpy(), b, dtype, f"{mode} {name}")
        for i, ((dw, db), (rw, rb)) in enumerate(zip(port[3], ref[3])):
            close(dw.numpy(), rw, dtype, f"{mode} dW{i}")
            close(db.numpy(), rb, dtype, f"{mode} db{i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deg", sorted(DEGREES))
def test_any_features_mlp_kernels_match_jax(deg, dtype):
    """``mlp_fwd_plain`` and ``mlp_bwd_plain`` with input_grads against
    JAX's ``fused_mlp_apply`` / ``_fused_mlp_bwd_impl``: raw heads, every
    dW / db, dX [N, location_features] and dD."""
    jc, tc, jp, tp, c = level_case(dict(NARROW, **DEGREES[deg],
                                        compute_dtype=dtype), seed=2)
    R, S = c["dir_enc"].shape[0], tc.num_samples
    x = c["x"].reshape(R, S, -1)
    ref = jfm.fused_mlp_apply(jp, jc, J(x), J(c["dir_enc"]), tile=16)
    out = fm.fused_mlp_apply(tp, tc, T(x), T(c["dir_enc"]))
    for a, b, name in zip(out, ref, ("raw_rgb", "raw_den")):
        close(a.numpy(), np.asarray(b), dtype, name)
    rng = np.random.default_rng(3)
    g_rgb = rng.normal(size=(R * S, 3)).astype(np.float32)
    g_den = rng.normal(size=(R * S, 1)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params, ref_dx, ref_dd = jfm._fused_mlp_bwd_impl(
        jp, J(x).reshape(R * S, -1).astype(jdt), J(c["dir_enc"]).astype(jdt),
        J(g_rgb), J(g_den), cfg=jc, tile=8, s=S, input_grads=True)
    dt = tmlp.compute_dtype(tc)
    d_params, dx, dd = fm.mlp_bwd_plain(
        tp, tc, T(x).reshape(R * S, -1).to(dt), T(c["dir_enc"]).to(dt),
        T(g_rgb), T(g_den), S, True)
    for i, ((dw, db), (rw, rb)) in enumerate(zip(d_params, ref_params)):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")
    assert dx.shape == (R * S, tc.location_features)
    close(dx.float().numpy(), np.asarray(ref_dx, np.float32), dtype, "dX")
    close(dd.numpy(), ref_dd, dtype, "dD")


def test_two_train_steps_at_max_deg_point_70_match_jax():
    """Two fused-level train steps at ``max_deg_point`` 70 (420 feature
    columns; exact transcendentals, whose features stay finite) against
    JAX's from JAX's initial state."""
    check_two_steps(branch_kw("fused_level", max_deg_point=70,
                              fast_ipe=False), True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_deg_view_matches_jax(dtype):
    """``deg_view`` 32 (195 direction features, the view layer's direction
    rows): the render level and ``fused_mlp_apply``'s forward and VJP
    (``mlp_bwd_plain`` with input_grads: dD [R, 195]) against JAX's."""
    kw = dict(NARROW, deg_view=32, compute_dtype=dtype)
    jc, tc, jp, tp, c = level_case(kw, seed=4)
    assert tc.direction_features == 195 == c["dir_enc"].shape[1]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = j_render(jp, jc, J(c["x"]).astype(jdt),
                   *train_common(c, "jax")[:3], True, tile=16)
    port = fl.fused_level_render(tp, tc, T(c["x"]), *train_common(c, "t")[:3],
                                 True)
    for name, a, b in zip(("comp", "acc", "weights"), port, ref):
        close(a.numpy(), b, dtype, name)
    R, S = c["dir_enc"].shape[0], tc.num_samples
    x = c["x"].reshape(R * S, -1)
    rng = np.random.default_rng(6)
    g_rgb = rng.normal(size=(R * S, 3)).astype(np.float32)
    g_den = rng.normal(size=(R * S, 1)).astype(np.float32)
    ref_params, ref_dx, ref_dd = jfm._fused_mlp_bwd_impl(
        jp, J(x).astype(jdt), J(c["dir_enc"]).astype(jdt), J(g_rgb),
        J(g_den), cfg=jc, tile=8, s=S, input_grads=True)
    dt = tmlp.compute_dtype(tc)
    d_params, dx, dd = fm.mlp_bwd_plain(tp, tc, T(x).to(dt),
                                        T(c["dir_enc"]).to(dt), T(g_rgb),
                                        T(g_den), S, True)
    for i, ((dw, db), (rw, rb)) in enumerate(zip(d_params, ref_params)):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")
    close(dx.float().numpy(), np.asarray(ref_dx, np.float32), dtype, "dX")
    close(dd.numpy(), ref_dd, dtype, "dD")


# The first max_deg_point at which each launch takes the wide route at
# Config() widths and S = 128 (fused_level.narrow_misfit's shared memory).
THRESHOLDS = {
    "bfloat16": {"render_level": 54, "train_level": 65,
                 "train_level_twopass": 65, "mlp_fwd": 65, "mlp_bwd": 65,
                 "mlp_bwd+dx": 43},
    "float32": {"render_level": 94, "train_level": 94,
                "train_level_twopass": 94, "mlp_fwd": 97, "mlp_bwd": 97,
                "mlp_bwd+dx": 43},
}


@pytest.mark.parametrize("dtype", sorted(THRESHOLDS))
def test_any_features_router(dtype):
    """Every launch takes the narrow route below its threshold and the wide
    route from it (the reason named by ``narrow_misfit``), up to degree
    128; ``check_kernel_config`` takes every degree; 102 layers and 25 dW
    products route like any other config (the C layer tables are sized
    from the config, the dW GEMMs launch in batches)."""
    for name, first in THRESHOLDS[dtype].items():
        kernel, _, dx = name.partition("+")
        for deg in (4, first - 1, first, 100, 128):
            cfg = Config(max_deg_point=deg, compute_dtype=dtype)
            fl.check_kernel_config(cfg)
            wide = fl.takes_wide(cfg, kernel, 128, bool(dx))
            assert wide == (deg >= first), (name, deg)
            why = fl.narrow_misfit(cfg, kernel, 128, bool(dx))
            assert (why is None) == (deg < first)
            if why is not None:
                assert "shared memory" in why
    # 102 layers at degree 70: the route of degree 70 alone (bf16 wide
    # past the narrow route's shared memory, f32 narrow)
    deep = Config(net_depth=100, max_deg_point=70, compute_dtype=dtype)
    for kernel in ("train_level", "train_level_twopass", "mlp_bwd"):
        assert fl.takes_wide(deep, kernel, 128) == (dtype == "bfloat16")
    # 25 dW products, past one dW launch's job table: the narrow route in
    # both dtypes, in two dW launches
    deeper = Config(net_depth=20, compute_dtype=dtype)
    assert fl.dw_jobs(deeper) == 25
    for kernel in fl.KERNELS:
        assert fl.narrow_misfit(deeper, kernel, 128) is None
        assert not fl.takes_wide(deeper, kernel, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_route_reads_at_a_narrow_width_with_420_features(dtype):
    """The wide route's reads of the packed streams (the Python models of
    its kernels) at net_width 64 / 32 and ``max_deg_point`` 70, where the
    router sends ``mlp_bwd`` with dX (x rows of 432 columns) in both
    dtypes: the forward, its activations and the g-chain's db (bf16; f32
    also dW, dX and dD) against ``mlp_forward_acts`` /
    ``mlp_backward_plain``."""
    cfg = Config(**dict(NARROW, max_deg_point=70, compute_dtype=dtype))
    assert fl.takes_wide(cfg, "mlp_bwd", cfg.num_samples, True)
    R, S = 3, cfg.num_samples
    rng = np.random.default_rng(12)
    params = tmlp.init_mlp(torch.Generator().manual_seed(5), cfg)
    params = [(w, torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)
                                   * 0.1)) for w, b in params]
    dt = tmlp.compute_dtype(cfg)
    x = torch.from_numpy(rng.normal(size=(R * S, cfg.location_features))
                         .astype(np.float32)).to(dt)
    d = torch.from_numpy(rng.normal(size=(R, cfg.direction_features))
                         .astype(np.float32)).to(dt)
    g_rgb = torch.from_numpy(rng.normal(size=(R * S, 3)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(R * S, 1)).astype(np.float32))
    p_rgb, p_den, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    ref, ref_dx, ref_dd = fl.mlp_backward_plain(params, cfg, x, d, hs, vs,
                                                g_rgb, g_den, R, S, dt, True)
    if dtype == "bfloat16":
        raw_rgb, raw_den, grads, acts = wide_model(params, cfg, x, d, R, S,
                                                   g_rgb, g_den)
        D = cfg.net_depth
        for k, g in grads.items():
            layer = k if k < D else k + 1
            close(g.sum(0).numpy(), ref[layer][1].numpy(), dtype, f"db{layer}")
    else:
        raw_rgb, raw_den, acts, _, got, dx, dd = wide_f32_model(
            params, cfg, x, d, R, S, g_rgb, g_den)
        for i, ((dw, db), (rw, rb)) in enumerate(zip(got, ref)):
            close(dw.numpy(), rw.numpy(), dtype, f"dW{i}")
            close(db.numpy(), rb.numpy(), dtype, f"db{i}")
        close(dx.numpy(), ref_dx.numpy(), dtype, "dX")
        close(dd.numpy(), ref_dd.numpy(), dtype, "dD")
    close(raw_rgb.numpy(), p_rgb.numpy(), dtype, "raw_rgb")
    close(raw_den.numpy(), p_den.numpy(), dtype, "raw_den")
    for k, (a, r) in enumerate(zip(acts, hs + vs)):
        close(a.numpy(), r.float().numpy(), dtype, f"act{k}")
