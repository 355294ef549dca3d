"""The wide route of the bf16 level kernels (net_width 288-1024) on the
CPU: the port's train level and render level (``fused_level_train`` /
``fused_level_render``, the plain versions on the CPU) against the JAX
package's (Pallas, interpret mode) at net_width 512 and 1024, one train
step against JAX's at 512, the weights carried across at 1024, the
widened guards, and the wide kernels' reads of the packed streams
(``csrc/wide_forward.cuh``: ``wide_offsets``, ``wide_head_kernel``;
``csrc/wide_train.cuh``: ``wide_chain_offsets``) modelled in Python,
with a forward and g-chain through them against the plain version.

Config: depth 3, skip at 2, net_width_condition 128, S=8, R=4, inputs made
with numpy from a seed. Tolerance: the parity bands of
``nerf_or_nothing_tpu/utils/parity.py`` (f32 (1e-6, 1e-3), bf16 (2e-3,
3e-2)) as a normalized error < 1. The kernels themselves are held against
the plain versions on a card (``test_torch_kernel_cuda.py -k wide``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_render as j_render,
)
from nerf_or_nothing_tpu.kernels.fused_level import (  # noqa: E402
    fused_level_train as j_level,
)
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu.utils.parity import (  # noqa: E402
    PARITY_BANDS,
    normalized_err,
)
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.ops.render import (  # noqa: E402
    interval_lengths,
)
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402

WIDE = dict(net_depth=3, net_depth_condition=1, net_width_condition=128,
            skip_layer=2, max_deg_point=4, num_samples=8)
J, T = jnp.asarray, torch.from_numpy


def close(a, b, dtype, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    atol, rtol = PARITY_BANDS[dtype]
    err = normalized_err(a, b, atol, rtol)
    assert err < 1.0, (what, err)


def case(kw, R=4, seed=0):
    """A JAX init carried to the port, and one level's inputs (numpy)."""
    jc, tc = JConfig(**kw), Config(**kw)
    S = tc.num_samples
    rng = np.random.default_rng(seed)
    f32 = np.float32
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    c = dict(
        means=rng.normal(size=(R, S, 3)).astype(f32),
        covs=rng.uniform(0, 0.02, size=(R, S, 3)).astype(f32),
        x=(rng.normal(size=(R, S, tc.location_features)) * 0.5).astype(f32),
        dir_enc=(rng.normal(size=(R, 27)) * 0.5).astype(f32),
        t_vals=np.sort(rng.uniform(2, 6, size=(R, S + 1)), -1).astype(f32),
        dirs=rng.normal(size=(R, 3)).astype(f32),
        pixels=rng.uniform(size=(R, 3)).astype(f32),
    )
    mask = np.array([1.0, 2.0, 0.0, 1.0], f32)[:R]
    c["g_scale"] = (0.1 * 2.0 * mask / mask.sum())[:, None].astype(f32)
    return jc, tc, jp, tp, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["t", "mv"])
@pytest.mark.parametrize("width", [512, 1024])
def test_wide_train_level_matches_jax(width, mode, dtype):
    """4 rays x 8 samples against JAX's 16-row tiles: comp, acc, weights
    and every dW / db."""
    jc, tc, jp, tp, c = case(dict(WIDE, net_width=width, compute_dtype=dtype))
    common_j = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]),
                J(c["pixels"]), J(c["g_scale"]), True)
    common_t = (T(c["dir_enc"]), T(c["t_vals"]), T(c["dirs"]),
                T(c["pixels"]), T(c["g_scale"]), True)
    if mode == "mv":
        ref = j_level(jp, jc, None, *common_j, tile=16,
                      means_covs=(J(c["means"]), J(c["covs"])))
        port = fl.fused_level_train(tp, tc, None, *common_t,
                                    means_covs=(T(c["means"]), T(c["covs"])))
    else:
        ref = j_level(jp, jc, J(c["x"]), *common_j, tile=16)
        port = fl.fused_level_train(tp, tc, T(c["x"]), *common_t)
    for name, a, b in zip(("comp", "acc", "weights"), port[:3], ref[:3]):
        close(a.numpy(), b, dtype, name)
    assert len(port[3]) == len(ref[3]) == len(tmlp.layer_dims(tc))
    for i, ((dw, db), (rw, rb)) in enumerate(zip(port[3], ref[3])):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["t", "mv"])
@pytest.mark.parametrize("width", [512, 1024])
def test_wide_render_level_matches_jax(width, mode, dtype):
    """4 rays x 8 samples: comp, acc and weights."""
    jc, tc, jp, tp, c = case(dict(WIDE, net_width=width, compute_dtype=dtype),
                             seed=1)
    common_j = (J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]), True)
    common_t = (T(c["dir_enc"]), T(c["t_vals"]), T(c["dirs"]), True)
    if mode == "mv":
        ref = j_render(jp, jc, None, *common_j, tile=16,
                       means_covs=(J(c["means"]), J(c["covs"])))
        port = fl.fused_level_render(tp, tc, None, *common_t,
                                     means_covs=(T(c["means"]),
                                                 T(c["covs"])))
    else:
        dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        ref = j_render(jp, jc, J(c["x"]).astype(dt), *common_j, tile=16)
        port = fl.fused_level_render(tp, tc, T(c["x"]), *common_t)
    for name, a, b in zip(("comp", "acc", "weights"), port, ref):
        close(a.numpy(), b, dtype, name)


def test_wide_train_step_matches_jax():
    """One fused-level train step at net_width 512 (f32) from JAX's
    initial state carried across, on the same batch: loss, per-level
    losses, grad norm, params, mu and nu."""
    kw = dict(batch_size=8, num_samples=8, num_levels=2, net_depth=3,
              net_width=512, net_width_condition=128, skip_layer=2,
              max_deg_point=4, randomized=False, donate_params=False,
              compute_dtype="float32", use_pallas=True, lr_delay_steps=0,
              lr_init=2e-3, lr_final=2e-3)
    jc, tc = jtiny(**kw), tiny_config(**kw)
    assert ttrain.use_fused_level(tc)
    jstate = jtrain.init_train_state(jc)
    params = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                                   for w, b in jstate.params])
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    state = ttrain.TrainState(0, params, zeros,
                              [(torch.zeros_like(w), torch.zeros_like(b))
                               for w, b in params],
                              torch.Generator().manual_seed(tc.seed))
    rng = np.random.default_rng(7)
    R = 8
    o = (rng.normal(size=(R, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((R, 1), np.float32)
    mult = rng.uniform(0.5, 2.0, size=(R, 1)).astype(np.float32)
    rays = (o, d, vd, ones * 0.005, ones * 2.0, ones * 6.0, mult)
    pixels = rng.uniform(size=(R, 3)).astype(np.float32)
    jstate, jstats = jtrain.make_jitted_train_step(jc)(
        jstate, JRays(*map(jnp.asarray, rays)), jnp.asarray(pixels))
    state, stats = ttrain.make_train_step(tc)(
        state, Rays(*map(torch.from_numpy, rays)), torch.from_numpy(pixels))
    for name in ("loss", "losses", "grad_norm", "weight_l2", "psnr"):
        close(getattr(stats, name).numpy(), getattr(jstats, name), "float32",
              name)
    for tree, jtree, name in ((state.params, jstate.params, "params"),
                              (state.mu, jstate.mu, "mu"),
                              (state.nu, jstate.nu, "nu")):
        for i, ((w, b), (jw, jb)) in enumerate(zip(tree, jtree)):
            close(w.numpy(), jw, "float32", f"{name} w{i}")
            close(b.numpy(), jb, "float32", f"{name} b{i}")


def test_wide_weights_carry_across_from_jax():
    """JAX's init at Config(net_width=1024) through ``export_flat`` /
    ``import_flat`` and ``params_from_jax``: 7,680,900 values, bit-equal,
    and the port's own flat round trip."""
    jc, tc = JConfig(net_width=1024), Config(net_width=1024)
    jp = jmlp.init_mlp(jax.random.PRNGKey(3), jc)
    flat = jmlp.export_flat(jp)
    assert flat.size == tmlp.num_params(tc) == 7_680_900
    tp = tmlp.import_flat(flat, tc)
    direct = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                                   for w, b in jp])
    dims = tmlp.layer_dims(tc)
    assert [tuple(w.shape) for w, _ in tp] == dims
    for (w, b), (dw, db), (jw, jb) in zip(tp, direct, jp):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        assert torch.equal(w, dw) and torch.equal(b, db)
    np.testing.assert_array_equal(tmlp.export_flat(tp), flat)


# ---------------------------------------------------------------------------
# The guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [288, 512, 1024])
def test_wide_widths_are_admitted_for_bf16_levels(width):
    """bf16 train_level / render_level take every multiple of 32 from 288
    to 1024 with net_width_condition up to 256; on CPU tensors their
    wrappers get past every config check to the device check."""
    for wc in (32, 128, 256):
        cfg = Config(net_width=width, net_width_condition=wc)
        assert fl.uses_wide(cfg)
        fl.check_kernel_config(cfg)
        for kernel in ("train_level", "render_level"):
            assert fl.takes_wide(cfg, kernel, 128)
    cfg = Config(**dict(WIDE, net_width=width))
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    R, S = 2, cfg.num_samples
    xs = torch.zeros(R * S, cfg.location_features, dtype=torch.bfloat16)
    d = torch.zeros(R, 27, dtype=torch.bfloat16)
    delta, pixels, gsc = torch.zeros(R, S), torch.zeros(R, 3), torch.zeros(R, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.train_level_cuda(params, cfg, xs, d, delta, pixels, gsc, True, "t")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl.render_level_cuda(params, cfg, xs, d, delta, True, "t")


def refused_routes(cfg):
    """Every wrapper call at ``cfg`` on CPU tensors, each of which raises
    ValueError: at a config check the config does not pass, else at the
    device check ("CUDA tensor")."""
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    R, S = 2, cfg.num_samples
    dt = torch.bfloat16
    x = torch.zeros(R * S, cfg.location_features, dtype=dt)
    d = torch.zeros(R, 27, dtype=dt)
    delta, pixels, gsc = torch.zeros(R, S), torch.zeros(R, 3), torch.zeros(R, 1)
    g_rgb, g_den = torch.zeros(R * S, 3), torch.zeros(R * S, 1)
    return {
        "train_level": lambda: fl.train_level_cuda(
            params, cfg, x, d, delta, pixels, gsc, True, "t"),
        "render_level": lambda: fl.render_level_cuda(
            params, cfg, x, d, delta, True, "t"),
        "train_level_twopass": lambda: fl.train_level_twopass_cuda(
            params, cfg, x, d, delta, pixels, gsc, True),
        "mlp_fwd": lambda: fm.mlp_fwd_cuda(params, cfg, x, d),
        "mlp_bwd": lambda: fm.mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den,
                                           True),
    }


@pytest.mark.parametrize("what,kw,routes", [
    ("f32 net_width_condition above 256",
     dict(net_width=512, net_width_condition=288, compute_dtype="float32"),
     ("train_level", "render_level", "train_level_twopass", "mlp_fwd",
      "mlp_bwd")),
    ("net_width_condition above 256",
     dict(net_width=512, net_width_condition=288),
     ("train_level", "render_level", "train_level_twopass", "mlp_fwd",
      "mlp_bwd")),
    ("net_width above 1024", dict(net_width=1056),
     ("train_level", "render_level", "train_level_twopass", "mlp_fwd",
      "mlp_bwd")),
    ("f32 net_width above 1024", dict(net_width=1056, compute_dtype="float32"),
     ("train_level", "render_level", "train_level_twopass", "mlp_fwd",
      "mlp_bwd")),
])
def test_routes_not_ported_still_raise(what, kw, routes):
    """The widths the wide route refused while it had a ceiling
    (net_width above 1024, net_width_condition above 256, in bf16 and f32)
    are taken now: on CPU tensors every wrapper passes its config checks
    and stops at the device check ("CUDA tensor"), nothing is launched,
    and the dispatchers compute the plain versions at these widths
    (finite, at the config's shapes; against JAX's there:
    ``test_torch_any_width.py``)."""
    cfg = Config(**dict(WIDE, **kw))
    assert fl.uses_wide(cfg) and fl.kernel_cfg(cfg) is cfg
    counters = (fl.train_level, fl.render_level, fl.train_level_twopass,
                fm.mlp_fwd, fm.mlp_bwd)
    before = [fn.launches for fn in counters]
    calls = refused_routes(cfg)
    for name in routes:
        with pytest.raises(ValueError, match="CUDA tensor"):
            calls[name]()
    params = tmlp.init_mlp(torch.Generator().manual_seed(1), cfg)
    R, S = 2, cfg.num_samples
    rng = np.random.default_rng(3)
    dt = tmlp.compute_dtype(cfg)
    x = T(rng.normal(size=(R * S, cfg.location_features))
          .astype(np.float32)).to(dt)
    d = T(rng.normal(size=(R, 27)).astype(np.float32)).to(dt)
    delta = T(rng.uniform(0.1, 0.5, size=(R, S)).astype(np.float32))
    pixels = T(rng.uniform(size=(R, 3)).astype(np.float32))
    gsc = torch.full((R, 1), 0.5)
    g_rgb = T(rng.normal(size=(R * S, 3)).astype(np.float32))
    g_den = T(rng.normal(size=(R * S, 1)).astype(np.float32))
    dims = tmlp.layer_dims(cfg)
    for level in (fl.train_level, fl.train_level_twopass):
        args = (params, cfg, x, d, delta, pixels, gsc, True)
        out = level(*args, "t") if level is fl.train_level else level(*args)
        assert [tuple(dw.shape) for dw, _ in out[3]] == dims, what
        assert all(bool(torch.isfinite(t).all()) for t in out[:3])
        assert all(bool(torch.isfinite(dw).all() and torch.isfinite(db).all())
                   for dw, db in out[3])
    comp, acc, weights = fl.render_level(params, cfg, x, d, delta, True, "t")
    assert comp.shape == (R, 3) and weights.shape == (R, S)
    assert bool(torch.isfinite(comp).all() and torch.isfinite(weights).all())
    rgb, den = fm.mlp_fwd(params, cfg, x, d)
    assert rgb.shape == (R * S, 3) and den.shape == (R * S, 1)
    d_params, dx, dd = fm.mlp_bwd(params, cfg, x, d, g_rgb, g_den, True)
    assert [tuple(dw.shape) for dw, _ in d_params] == dims
    assert dx.shape == x.shape and dd.shape == (R, 27)
    assert bool(torch.isfinite(dx.float()).all() and torch.isfinite(dd).all())
    assert [fn.launches for fn in counters] == before


def test_wide_guard_messages():
    """bf16 and f32 at 288-1024, and the widths the wide route refused
    while it had a ceiling (net_width 2048, net_width_condition 300 and
    384), pass the guard of every route (the level kernels' and, with
    heads of any channel count, the MLP kernels'); so do heads of 9
    channels, which the MLP kernels refused while a head was one group of
    8 channels; what is still refused, heads the kernels do not take,
    names itself."""
    for width in (288, 512, 1024):
        for dtype in ("bfloat16", "float32"):
            fl.check_kernel_config(Config(net_width=width,
                                          compute_dtype=dtype))
            fl.check_kernel_config(Config(net_width=width, num_rgb_channels=8,
                                          num_density_channels=8,
                                          compute_dtype=dtype),
                                   any_heads=True)
    for kw in (dict(net_width=2048, compute_dtype="float32"),
               dict(net_width=2048),
               dict(net_width=512, net_width_condition=384),
               dict(net_width=512, net_width_condition=300)):
        for any_heads in (False, True):
            fl.check_kernel_config(Config(**kw), any_heads=any_heads)
    for kw in (dict(net_width=2048, num_rgb_channels=9),
               dict(net_width=512, net_width_condition=384,
                    num_density_channels=9, compute_dtype="float32")):
        fl.check_kernel_config(Config(**kw), any_heads=True)
    cases = [(dict(net_width=2048, num_rgb_channels=4),
              "heads must be 3 rgb / 1 density", False),
             (dict(net_width=2048, num_rgb_channels=0),
              "heads must have at least 1 channel", True),
             (dict(net_width=512, net_width_condition=384,
                   num_density_channels=0, compute_dtype="float32"),
              "heads must have at least 1 channel", True)]
    for kw, text, any_heads in cases:
        with pytest.raises(ValueError, match=text):
            fl.check_kernel_config(Config(**kw), any_heads=any_heads)
    assert not fl.uses_wide(Config())
    assert fl.uses_wide(Config(net_width=512, compute_dtype="float32"))
    # widths that are not multiples of 32 run zero-padded (kernel_cfg)
    for any_heads in (False, True):
        fl.check_kernel_config(Config(net_width=48, net_width_condition=32),
                               any_heads=any_heads)


# ---------------------------------------------------------------------------
# The wide kernels' reads of the packed streams, modelled in Python
# ---------------------------------------------------------------------------


def wide_offsets(cfg):
    """``csrc/wide_forward.cuh::wide_offsets``: element offsets of each
    matrix in ``pack_params_wg``'s stream (a head of C channels as
    ceil(C / 8) groups of 8 rows a slab)."""
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    kx = fl.padded_location_features(cfg)
    nh, nc, nx = -(-W // 64), -(-Wc // 64), -(-kx // 64)
    o = {"trunk": [], "view": [], "nh": nh, "nc": nc, "nx": nx}
    off = 0
    for i in range(D):
        o["trunk"].append(off)
        off += ((0 if i == 0 else nh)
                + (nx if i == 0 or i % cfg.skip_layer == 0 else 0)) * W * 64
    o["den"] = off
    off += nh * -(-cfg.num_density_channels // 8) * 8 * 64
    o["view"].append(off)
    off += nh * Wc * 64
    for _ in range(1, Dc):
        o["view"].append(off)
        off += nc * Wc * 64
    o["rgb"] = off
    off += nc * -(-cfg.num_rgb_channels // 8) * 8 * 64
    o["dir"] = off
    return o


def wide_chain_offsets(cfg, o):
    """``csrc/wide_train.cuh::wide_chain_offsets``: offsets in
    ``pack_params_wgt``'s stream (views Dc-1 .. 1, view 0, trunk D-1 .. 1,
    then W_rgb^T [3, Wc] and W_den^T [1, W])."""
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    c = {"view": {}, "trunk": {}}
    off = 0
    for j in range(Dc - 1, 0, -1):
        c["view"][j] = off
        off += o["nc"] * Wc * 64
    c["view"][0] = off
    off += o["nc"] * W * 64
    for i in range(D - 1, 0, -1):
        c["trunk"][i] = off
        off += o["nh"] * W * 64
    c["rgb"] = off
    c["den"] = off + 3 * Wc
    return c


def gemm_b(stream, off, n_slabs, N):
    """The B operand [64 n_slabs, N] that ``wide_load`` stages from
    ``n_slabs`` slabs of N rows at ``off``: slab kt at off + kt N 64, row
    n's 16-byte chunk c read at position c ^ (n % 8) (the swizzle wgmma
    applies)."""
    t = stream[off:off + n_slabs * N * 64].view(n_slabs, N, 8, 8)
    n = torch.arange(N)
    pos = torch.arange(8)[None, :] ^ (n[:, None] % 8)    # position of chunk c
    t = t[:, n[:, None], pos]                            # [slab, n, chunk, e]
    return t.permute(0, 2, 3, 1).reshape(n_slabs * 64, N)


def head_w(stream, off, K, nc):
    """``wide_head_kernel``'s unswizzled head columns [K, nc]."""
    k = torch.arange(K)
    cols = []
    for c in range(nc):
        idx = off + (k >> 6) * 8 * 64 + c * 64 + ((((k & 63) >> 3) ^ c) << 3) + (k & 7)
        cols.append(stream[idx])
    return torch.stack(cols, 1)


def wide_model(params, cfg, x, d, R, S, g_rgb, g_den):
    """The wide route's forward and g-chain written from the kernels'
    reads: every product's operands from the packed streams at the kernel
    offsets, A zero-padded to whole slabs, f32 sums, the epilogues'
    rounding. Returns (raw_rgb, raw_den, masked g per layer by index)."""
    dt = torch.bfloat16
    w_fwd, b = fl.pack_params_wg(params, cfg, dt)
    w_fwd, b = w_fwd.float(), b.float()
    wt = fl.pack_params_wgt(params, cfg, dt).float()
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    o = wide_offsets(cfg)
    co = wide_chain_offsets(cfg, o)
    N = R * S
    kx = fl.padded_location_features(cfg)
    xs = torch.zeros(N, kx)
    xs[:, :cfg.location_features] = x.float()

    def pad(a, slabs):
        out = torch.zeros(a.shape[0], slabs * 64)
        out[:, :a.shape[1]] = a
        return out

    def rnd(v):
        return v.to(dt).float()

    acts = []
    b_off = 0
    h = None
    for i in range(D):
        parts = []
        if i > 0:
            parts.append(pad(h, o["nh"]))
        if i == 0 or i % cfg.skip_layer == 0:
            parts.append(pad(xs, o["nx"]))
        a = torch.cat(parts, 1)
        z = a @ gemm_b(w_fwd, o["trunk"][i], a.shape[1] // 64, W)
        h = rnd(torch.relu(z + b[b_off:b_off + W]))
        b_off += W
        acts.append(h)
    b_den = b[b_off:b_off + 1]
    raw_den = rnd(h) @ head_w(w_fwd, o["den"], W, 1) + b_den
    b_off += 1
    w_dir = w_fwd[o["dir"]:o["dir"] + cfg.direction_features * Wc].view(-1, Wc)
    dc = d.float() @ w_dir
    for j in range(Dc):
        a = pad(acts[D - 1] if j == 0 else acts[-1], o["nh"] if j == 0
                else o["nc"])
        z = a @ gemm_b(w_fwd, o["view"][j], a.shape[1] // 64, Wc)
        if j == 0:
            z = (z.view(R, S, Wc) + dc[:, None, :]).view(N, Wc)
        v = rnd(torch.relu(z + b[b_off:b_off + Wc]))
        b_off += Wc
        acts.append(v)
    raw_rgb = acts[-1] @ head_w(w_fwd, o["rgb"], Wc, 3) + b[b_off:b_off + 3]

    grads = {}
    w_rgb_t = wt[co["rgb"]:co["rgb"] + 3 * Wc].view(3, Wc)
    g = rnd(rnd(g_rgb) @ w_rgb_t) * (acts[D + Dc - 1] > 0)
    grads[D + Dc - 1] = g
    for j in range(Dc - 1, -1, -1):
        n_out = W if j == 0 else Wc
        z = pad(g, o["nc"]) @ gemm_b(wt, co["view"][j], o["nc"], n_out)
        g = rnd(z)
        if j == 0:
            w_den_t = wt[co["den"]:co["den"] + W].view(1, W)
            g = rnd(g + rnd(rnd(g_den) @ w_den_t))
        below = D - 1 if j == 0 else D + j - 1
        g = g * (acts[below] > 0)
        grads[below] = g
    for i in range(D - 1, 0, -1):
        z = pad(g, o["nh"]) @ gemm_b(wt, co["trunk"][i], o["nh"], W)
        g = rnd(z) * (acts[i - 1] > 0)
        grads[i - 1] = g
    return raw_rgb, raw_den, grads, acts


@pytest.mark.parametrize("kw", [
    dict(net_width=288, net_width_condition=96),
    dict(net_width=512, net_depth=5, net_depth_condition=2,
         net_width_condition=256),
])
def test_wide_kernel_reads_of_the_packed_streams(kw):
    """Forward and g-chain through the wide kernels' offsets and reads of
    ``pack_params_wg`` / ``pack_params_wgt`` (partial slabs at 288, a
    second view layer and two skip layers at 512) against
    ``mlp_forward_acts`` and ``mlp_backward_plain``'s masked g, in the
    bf16 band (the same rounding points; f32 sums in another order)."""
    cfg = Config(**dict(WIDE, **kw))
    R, S = 3, cfg.num_samples
    rng = np.random.default_rng(11)
    params = tmlp.init_mlp(torch.Generator().manual_seed(4), cfg)
    params = [(w, torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)
                                   * 0.1)) for w, b in params]
    dt = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(R * S, cfg.location_features))
                         .astype(np.float32)).to(dt)
    d = torch.from_numpy(rng.normal(size=(R, 27)).astype(np.float32)).to(dt)
    g_rgb = torch.from_numpy(rng.normal(size=(R * S, 3)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(size=(R * S, 1)).astype(np.float32))
    raw_rgb, raw_den, grads, acts = wide_model(params, cfg, x, d, R, S,
                                               g_rgb, g_den)
    p_rgb, p_den, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    close(raw_rgb.numpy(), p_rgb.numpy(), "bfloat16", "raw_rgb")
    close(raw_den.numpy(), p_den.numpy(), "bfloat16", "raw_den")
    for k, (a, r) in enumerate(zip(acts, hs + vs)):
        close(a.numpy(), r.float().numpy(), "bfloat16", f"act{k}")
    # db of each layer is the column sum of its masked g
    d_params, _, _ = fl.mlp_backward_plain(params, cfg, x, d, hs, vs, g_rgb,
                                           g_den, R, S, dt)
    D = cfg.net_depth
    for k, g in grads.items():
        layer = k if k < D else k + 1
        close(g.sum(0).numpy(), d_params[layer][1].numpy(), "bfloat16",
              f"db{layer}")


def test_wide_route_plain_version_on_cpu_tensors():
    """On CPU tensors the dispatchers run the plain versions at a wide
    width, and no launch is counted."""
    cfg = Config(**dict(WIDE, net_width=512))
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg)
    R, S = 2, cfg.num_samples
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(R * S, cfg.location_features))
                         .astype(np.float32)).to(torch.bfloat16)
    d = torch.zeros(R, 27, dtype=torch.bfloat16)
    t_vals = torch.linspace(2, 6, S + 1).repeat(R, 1)
    delta = interval_lengths(t_vals, torch.ones(R, 3)).contiguous()
    before = (fl.train_level.launches, fl.render_level.launches)
    comp, acc, weights = fl.render_level(params, cfg, x, d, delta, True, "t")
    out = fl.train_level(params, cfg, x, d, delta, torch.zeros(R, 3),
                         torch.full((R, 1), 0.5), True, "t")
    assert (fl.train_level.launches, fl.render_level.launches) == before
    assert comp.shape == (R, 3) and weights.shape == (R, S)
    assert bool(torch.isfinite(out[0]).all())
    assert [tuple(dw.shape) for dw, _ in out[3]] == tmlp.layer_dims(cfg)
