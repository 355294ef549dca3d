"""The wide route of the MLP kernels and the two-pass train level (bf16,
net_width 288-1024) on the CPU: the port's ``fused_mlp_apply`` (the plain
versions ``mlp_fwd_plain`` / ``mlp_bwd_plain`` on the CPU) against the JAX
package's ``fused_mlp_apply`` and ``_fused_mlp_bwd_impl`` (Pallas,
interpret mode) at net_width 512 and 1024, the Function's gradients
against ``jax.vjp``, the two-pass level against JAX's, one train step at
the slice config (``fuse_level=False``, ``stop_level_grad=False``) against
JAX's, the routes admitting 288-1024, and the new reads of the wide
kernels (``csrc/wide_train.cuh``: the "wgx" stream's x slabs by column
block as dX's B operand, ``wide_chain_offsets`` with them;
``csrc/wide_forward.cuh``: the head unswizzle of 1-8 channels) modelled in
Python, run as a forward, g-chain and dX against the plain version.

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

from test_torch_wide import (  # noqa: E402
    WIDE,
    case,
    close,
    gemm_b,
    head_w,
    refused_routes,
    wide_offsets,
)

from nerf_or_nothing_tpu import train as jtrain  # noqa: E402
from nerf_or_nothing_tpu.config import Config as JConfig  # noqa: E402
from nerf_or_nothing_tpu.config import tiny_config as jtiny  # noqa: E402
from nerf_or_nothing_tpu.kernels import fused_level as jfl  # noqa: E402
from nerf_or_nothing_tpu.kernels import fused_mlp as jfm  # noqa: E402
from nerf_or_nothing_tpu.models import mlp as jmlp  # noqa: E402
from nerf_or_nothing_tpu.rays import Rays as JRays  # noqa: E402
from nerf_or_nothing_tpu_torch import train as ttrain  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.config import tiny_config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.rays import Rays  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
HEADS = {"3_1": {}, "4_2": dict(num_rgb_channels=4, num_density_channels=2)}


def mlp_case(kw, R=4, seed=0):
    """A JAX init carried to the port, x [R, S, F], d [R, Fd] and head
    cotangents [R*S, C] (numpy)."""
    jc, tc = JConfig(**kw), Config(**kw)
    S = tc.num_samples
    rng = np.random.default_rng(seed)
    f32 = np.float32
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), jc)
    tp = tmlp.import_flat(jmlp.export_flat(jp), tc)
    x = (rng.normal(size=(R, S, tc.location_features)) * 0.5).astype(f32)
    d = (rng.normal(size=(R, tc.direction_features)) * 0.5).astype(f32)
    g_rgb = rng.normal(size=(R * S, tc.num_rgb_channels)).astype(f32)
    g_den = rng.normal(size=(R * S, tc.num_density_channels)).astype(f32)
    return jc, tc, jp, tp, x, d, g_rgb, g_den


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [512, 1024])
def test_wide_mlp_fwd_matches_jax(width, dtype, heads):
    """4 rays x 8 samples against JAX's 16-row tiles: the port's
    ``fused_mlp_apply`` (and ``mlp_fwd_plain``, the same function) against
    JAX's, raw_rgb and raw_den."""
    kw = dict(WIDE, net_width=width, compute_dtype=dtype, **HEADS[heads])
    jc, tc, jp, tp, x, d, _, _ = mlp_case(kw, seed=width % 7)
    R, S = d.shape[0], tc.num_samples
    ref = jfm.fused_mlp_apply(jp, jc, J(x), J(d), tile=16)
    out = fm.fused_mlp_apply(tp, tc, T(x), T(d))
    dt = tmlp.compute_dtype(tc)
    plain = fm.mlp_fwd_plain(tp, tc, T(x).reshape(R * S, -1).to(dt),
                             T(d).to(dt), S)
    for a, p, b, name in zip(out, plain, ref, ("raw_rgb", "raw_den")):
        assert torch.equal(a.reshape(p.shape), p), name
        close(a.numpy(), np.asarray(b), dtype, name)


@pytest.mark.parametrize("input_grads", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [512, 1024])
def test_wide_mlp_bwd_matches_jax(width, dtype, input_grads):
    """``mlp_bwd_plain`` against JAX's ``_fused_mlp_bwd_impl`` (8-row
    tiles): every dW / db and, with input_grads, dX and dD; heads 4 / 2
    at 512 in bf16."""
    extra = HEADS["4_2"] if (width, dtype) == (512, "bfloat16") else {}
    kw = dict(WIDE, net_width=width, compute_dtype=dtype, **extra)
    jc, tc, jp, tp, x, d, g_rgb, g_den = mlp_case(kw, seed=7)
    R, S = d.shape[0], tc.num_samples
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params, ref_dx, ref_dd = jfm._fused_mlp_bwd_impl(
        jp, J(x).reshape(R * S, -1).astype(jdt), J(d).astype(jdt), J(g_rgb),
        J(g_den), cfg=jc, tile=8, s=S, input_grads=input_grads)
    dt = tmlp.compute_dtype(tc)
    d_params, dx, dd = fm.mlp_bwd_plain(
        tp, tc, T(x).reshape(R * S, -1).to(dt), T(d).to(dt), T(g_rgb),
        T(g_den), S, input_grads)
    assert len(d_params) == len(ref_params) == len(tmlp.layer_dims(tc))
    for i, ((dw, db), (rw, rb)) in enumerate(zip(d_params, ref_params)):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")
    if input_grads:
        close(dx.float().numpy(), np.asarray(ref_dx, np.float32), dtype, "dX")
        close(dd.numpy(), ref_dd, dtype, "dD")
    else:
        assert dx is None and dd is None


def _loss_t(rgb, den):
    return torch.sum(torch.sin(rgb)) + torch.sum(den ** 2)


def _loss_j(rgb, den):
    return jnp.sum(jnp.sin(rgb)) + jnp.sum(den ** 2)


@pytest.mark.parametrize("width", [512, 1024])
def test_wide_fused_mlp_function_matches_jax_vjp(width):
    """bf16: the port's Function (``mlp_fwd`` forward, ``mlp_bwd`` with
    input_grads backward) against ``jax.grad`` through JAX's
    ``fused_mlp_apply`` (custom VJP, interpret mode): every parameter's
    gradient, x's and dir_enc's."""
    kw = dict(WIDE, net_width=width, compute_dtype="bfloat16")
    jc, tc, jp, tp, x, d, _, _ = mlp_case(kw, seed=3)
    ref = jax.grad(
        lambda p, xx, dd: _loss_j(*jfm.fused_mlp_apply(p, jc, xx, dd,
                                                       tile=16)),
        argnums=(0, 1, 2))(jp, J(x), J(d))
    ref = [np.asarray(t) for wb in ref[0] for t in wb] + [ref[1], ref[2]]
    leaves = [t.clone().requires_grad_() for wb in tp for t in wb]
    xt, dt_ = T(x).requires_grad_(), T(d).requires_grad_()
    params = list(zip(leaves[0::2], leaves[1::2]))
    loss = _loss_t(*fm.fused_mlp_apply(params, tc, xt, dt_))
    out = torch.autograd.grad(loss, leaves + [xt, dt_])
    assert len(out) == len(ref)
    for k, (a, b) in enumerate(zip(out, ref)):
        close(a.float().numpy(), np.asarray(b, np.float32), "bfloat16",
              f"grad {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_twopass_level_matches_jax(dtype):
    """``fused_level_train`` with ``fl_variant=twopass`` at net_width 512
    against JAX's (``_level_kernel_twopass``, interpret mode, 16-row
    tiles): comp, acc, weights and every dW / db; on the CPU it reaches
    ``train_level_twopass`` (whose plain version is
    ``level_train_plain``)."""
    kw = dict(WIDE, net_width=512, compute_dtype=dtype,
              kernel_probes="fl_variant=twopass")
    jc, tc, jp, tp, c = case(kw, seed=5)
    assert fl.uses_twopass(tc)
    calls = []
    orig = fl.train_level_twopass
    fl.train_level_twopass = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        port = fl.fused_level_train(
            tp, tc, T(c["x"]), T(c["dir_enc"]), T(c["t_vals"]), T(c["dirs"]),
            T(c["pixels"]), T(c["g_scale"]), True)
    finally:
        fl.train_level_twopass = orig
    assert calls == [1]
    ref = jfl.fused_level_train(
        jp, jc, J(c["x"]), J(c["dir_enc"]), J(c["t_vals"]), J(c["dirs"]),
        J(c["pixels"]), J(c["g_scale"]), True, tile=16)
    for name, a, b in zip(("comp", "acc", "weights"), port[:3], ref[:3]):
        close(a.numpy(), b, dtype, name)
    for i, ((dw, db), (rw, rb)) in enumerate(zip(port[3], ref[3])):
        close(dw.numpy(), rw, dtype, f"dW{i}")
        close(db.numpy(), rb, dtype, f"db{i}")


def test_wide_slice_train_step_matches_jax():
    """One train step at the slice config (``fuse_level=False``,
    ``stop_level_grad=False``: each level ``fused_mlp_apply``, level 1 with
    dX / dD through the resampling) at net_width 512 (f32), from JAX's
    initial state carried across, on the same batch: loss, per-level
    losses, grad norm, params, mu and nu."""
    kw = dict(batch_size=8, num_samples=8, num_levels=2, net_depth=3,
              net_width=512, net_width_condition=128, skip_layer=2,
              max_deg_point=4, randomized=False, donate_params=False,
              compute_dtype="float32", use_pallas=True, lr_delay_steps=0,
              lr_init=2e-3, lr_final=2e-3, fuse_level=False,
              stop_level_grad=False)
    jc, tc = jtiny(**kw), tiny_config(**kw)
    assert not ttrain.use_fused_level(tc)
    jstate = jtrain.init_train_state(jc)
    params = tmlp.params_from_jax([(np.asarray(w), np.asarray(b))
                                   for w, b in jstate.params])
    zeros = lambda: [(torch.zeros_like(w), torch.zeros_like(b))  # noqa: E731
                     for w, b in params]
    state = ttrain.TrainState(0, params, zeros(), zeros(),
                              torch.Generator().manual_seed(tc.seed))
    rng = np.random.default_rng(9)
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
    calls = []
    orig = fm.mlp_bwd
    fm.mlp_bwd = lambda *a, **k: calls.append(a[6]) or orig(*a, **k)
    try:
        state, stats = ttrain.make_train_step(tc)(
            state, Rays(*map(torch.from_numpy, rays)),
            torch.from_numpy(pixels))
    finally:
        fm.mlp_bwd = orig
    assert sorted(calls) == [False, True]  # level 0 without, level 1 with dX
    for name in ("loss", "losses", "grad_norm", "weight_l2", "psnr"):
        close(getattr(stats, name).numpy(), getattr(jstats, name), "float32",
              name)
    for tree, jtree, name in ((state.params, jstate.params, "params"),
                              (state.mu, jstate.mu, "mu"),
                              (state.nu, jstate.nu, "nu")):
        for i, ((w, b), (jw, jb)) in enumerate(zip(tree, jtree)):
            close(w.numpy(), jw, "float32", f"{name} w{i}")
            close(b.numpy(), jb, "float32", f"{name} b{i}")


# ---------------------------------------------------------------------------
# The guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [288, 512, 1024])
def test_wide_mlp_and_twopass_routes_are_admitted(width):
    """bf16 ``mlp_fwd``, ``mlp_bwd`` (with and without input_grads, heads
    of 1-8 channels) and ``train_level_twopass`` take net_width 288-1024:
    on CPU tensors their wrappers get past every config check to the
    device check, and the router sends ``mlp_bwd`` to the wide route."""
    for heads in ((3, 1), (8, 8), (1, 5)):
        cfg = Config(**dict(WIDE, net_width=width,
                            num_rgb_channels=heads[0],
                            num_density_channels=heads[1]))
        assert fl.uses_wide(cfg)
        fl.check_kernel_config(cfg, any_heads=True)
        for input_grads in (True, False):
            assert fl.takes_wide(cfg, "mlp_bwd", cfg.num_samples,
                                 input_grads)
    cfg = Config(**dict(WIDE, net_width=width))
    calls = refused_routes(cfg)
    for name in ("mlp_fwd", "mlp_bwd", "train_level_twopass"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            calls[name]()


# ---------------------------------------------------------------------------
# The wide MLP kernels' reads of the packed streams, modelled in Python
# ---------------------------------------------------------------------------


def dx_width(cfg):
    """``fused_level.dx_width`` (``cdiv(KX, 32) * 32`` in
    ``mlp_bwd.cu``)."""
    return -(-fl.padded_location_features(cfg) // 32) * 32


def wide_chain_offsets_x(cfg, o, nxw):
    """``csrc/wide_train.cuh::wide_chain_offsets`` with nxw: offsets in
    ``pack_params_wgx``'s stream (views Dc-1 .. 1, view 0, then for trunk
    layer i = D-1 .. 0 its x slabs (x layers) and its h slabs (i >= 1),
    then W_rgb^T [Cr, Wc] and W_den^T [Cd, W])."""
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    c = {"view": {}, "trunk": {}, "x": {}}
    off = 0
    for j in range(Dc - 1, 0, -1):
        c["view"][j] = off
        off += o["nc"] * Wc * 64
    c["view"][0] = off
    off += o["nc"] * W * 64
    for i in range(D - 1, -1, -1):
        if i == 0 or i % cfg.skip_layer == 0:
            c["x"][i] = off
            off += o["nh"] * nxw * 64
        if i >= 1:
            c["trunk"][i] = off
            off += o["nh"] * W * 64
    c["rgb"] = off
    c["den"] = off + cfg.num_rgb_channels * Wc
    return c


def gemm_b_blocks(stream, off, n_slabs, N, BN):
    """The B operand as ``wide_load`` stages it for ``launch_wide_gemm``:
    column block n0 = 0, BN, ... of each slab is the contiguous run of rows
    n0 .. n0 + BN - 1 (zero past N), read at chunk position c ^ (r % 8)
    for staged row r = n - n0; the blocks side by side, cut to N."""
    blocks = []
    for n0 in range(0, N, BN):
        t = torch.zeros(n_slabs, BN, 64, dtype=stream.dtype)
        rows = min(BN, N - n0)
        for s in range(n_slabs):
            base = off + s * N * 64 + n0 * 64
            t[s, :rows] = stream[base:base + rows * 64].view(rows, 64)
        r = torch.arange(BN)
        pos = torch.arange(8)[None, :] ^ (r[:, None] % 8)
        t = t.view(n_slabs, BN, 8, 8)[:, r[:, None], pos]
        blocks.append(t.permute(0, 2, 3, 1).reshape(n_slabs * 64, BN))
    return torch.cat(blocks, 1)[:, :N]


def wide_mlp_model(params, cfg, x, d, R, S, g_rgb, g_den):
    """``mlp_bwd``'s wide route written from its kernels' reads: the
    forward (``pack_params_wg``; heads of Cr / Cd channels through the
    head unswizzle), the g-chain from ``pack_params_wgx``'s slabs at
    ``wide_chain_offsets``' offsets (the rgb term over Cr channels, the
    density term over Cd, f32 sums from -0, rounded once), dX from the x
    slabs by 128-column blocks (the deepest x layer first, each term
    rounded and added in bf16), dD from the forward stream's direction
    rows. Returns (raw_rgb, raw_den, masked g by layer index, dX, dD)."""
    dt = torch.bfloat16
    w_fwd, b = fl.pack_params_wg(params, cfg, dt)
    w_fwd, b = w_fwd.float(), b.float()
    wt = fl.pack_params_wgx(params, cfg, dt).float()
    D, Dc, W, Wc = (cfg.net_depth, cfg.net_depth_condition, cfg.net_width,
                    cfg.net_width_condition)
    Cr, Cd, LX = (cfg.num_rgb_channels, cfg.num_density_channels,
                  cfg.location_features)
    o = wide_offsets(cfg)
    nxw = dx_width(cfg)
    co = wide_chain_offsets_x(cfg, o, nxw)
    N = R * S
    kx = fl.padded_location_features(cfg)
    xs = torch.zeros(N, kx)
    xs[:, :LX] = x.float()

    def pad(a, slabs):
        out = torch.zeros(a.shape[0], slabs * 64)
        out[:, :a.shape[1]] = a
        return out

    def rnd(v):
        return v.to(dt).float()

    acts, b_off, h = [], 0, None
    for i in range(D):
        parts = [pad(h, o["nh"])] if i > 0 else []
        if i == 0 or i % cfg.skip_layer == 0:
            parts.append(pad(xs, o["nx"]))
        a = torch.cat(parts, 1)
        z = a @ gemm_b(w_fwd, o["trunk"][i], a.shape[1] // 64, W)
        h = rnd(torch.relu(z + b[b_off:b_off + W]))
        b_off += W
        acts.append(h)
    raw_den = h @ head_w(w_fwd, o["den"], W, Cd) + b[b_off:b_off + Cd]
    b_off += Cd
    w_dir = w_fwd[o["dir"]:o["dir"] + cfg.direction_features * Wc].view(-1, Wc)
    dc = d.float() @ w_dir
    for j in range(Dc):
        a = pad(acts[D - 1] if j == 0 else acts[-1],
                o["nh"] if j == 0 else o["nc"])
        z = a @ gemm_b(w_fwd, o["view"][j], a.shape[1] // 64, Wc)
        if j == 0:
            z = (z.view(R, S, Wc) + dc[:, None, :]).view(N, Wc)
        acts.append(rnd(torch.relu(z + b[b_off:b_off + Wc])))
        b_off += Wc
    raw_rgb = acts[-1] @ head_w(w_fwd, o["rgb"], Wc, Cr) + b[b_off:b_off + Cr]

    grads = {}
    w_rgb_t = wt[co["rgb"]:co["rgb"] + Cr * Wc].view(Cr, Wc)
    g = rnd(rnd(g_rgb) @ w_rgb_t) * (acts[D + Dc - 1] > 0)
    grads[D + Dc - 1] = g
    for j in range(Dc - 1, -1, -1):
        n_out = W if j == 0 else Wc
        g = rnd(pad(g, o["nc"]) @ gemm_b(wt, co["view"][j], o["nc"], n_out))
        if j == 0:
            w_den_t = wt[co["den"]:co["den"] + Cd * W].view(Cd, W)
            g = rnd(g + rnd(rnd(g_den) @ w_den_t))
        below = D - 1 if j == 0 else D + j - 1
        g = g * (acts[below] > 0)
        grads[below] = g
    for i in range(D - 1, 0, -1):
        z = pad(g, o["nh"]) @ gemm_b(wt, co["trunk"][i], o["nh"], W)
        g = rnd(z) * (acts[i - 1] > 0)
        grads[i - 1] = g
    dx = None
    for i in range(D - 1, -1, -1):
        if not (i == 0 or i % cfg.skip_layer == 0):
            continue
        bx = gemm_b_blocks(wt, co["x"][i], o["nh"], nxw, 128)
        assert torch.equal(bx, gemm_b(wt, co["x"][i], o["nh"], nxw))
        term = rnd(pad(grads[i], o["nh"]) @ bx)[:, :LX]
        dx = term if dx is None else rnd(dx + term)
    g_ray = grads[D].view(R, S, Wc).sum(1)
    dd = rnd(g_ray) @ w_dir.t()
    return raw_rgb, raw_den, grads, dx, dd


@pytest.mark.parametrize("kw", [
    dict(net_width=288, net_width_condition=96, num_rgb_channels=4,
         num_density_channels=2),
    dict(net_width=512, net_depth=5, net_depth_condition=2,
         net_width_condition=256, num_rgb_channels=8, num_density_channels=8),
    dict(net_width=1024, num_rgb_channels=1, num_density_channels=3,
         max_deg_point=24),
])
def test_wide_mlp_kernel_reads_of_the_packed_streams(kw):
    """Forward, g-chain, dX and dD through the wide kernels' offsets and
    reads of ``pack_params_wg`` / ``pack_params_wgx`` (partial slabs at
    288; heads of 1-8 channels; two skip layers, a second view layer and
    8 / 8 heads at 512; x rows of 32 columns, and of 160 at 1024: two
    128-column blocks, the second zero-filled past 160)
    against ``mlp_forward_acts`` / ``mlp_backward_plain`` (heads, db of
    each layer's masked g, dX, dD), in the bf16 band (the same rounding
    points; f32 sums in another order)."""
    cfg = Config(**dict(WIDE, **kw))
    R, S = 3, cfg.num_samples
    rng = np.random.default_rng(13)
    params = tmlp.init_mlp(torch.Generator().manual_seed(4), cfg)
    params = [(w, torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)
                                   * 0.1)) for w, b in params]
    dt = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(R * S, cfg.location_features))
                         .astype(np.float32)).to(dt)
    d = torch.from_numpy(rng.normal(size=(R, 27)).astype(np.float32)).to(dt)
    g_rgb = torch.from_numpy(rng.normal(
        size=(R * S, cfg.num_rgb_channels)).astype(np.float32))
    g_den = torch.from_numpy(rng.normal(
        size=(R * S, cfg.num_density_channels)).astype(np.float32))
    # The head unswizzle of every width 1-8 reads W_den / W_rgb exactly.
    w_fwd = fl.pack_params_wg(params, cfg, dt)[0]
    o = wide_offsets(cfg)
    D = cfg.net_depth
    for nc in range(1, 9):
        got = head_w(w_fwd, o["den"], cfg.net_width, nc)
        exp = torch.zeros(cfg.net_width, 8, dtype=dt)
        exp[:, :cfg.num_density_channels] = params[D][0].to(dt)
        assert torch.equal(got, exp[:, :nc]), nc
    raw_rgb, raw_den, grads, dx, dd = wide_mlp_model(params, cfg, x, d, R, S,
                                                     g_rgb, g_den)
    p_rgb, p_den, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    close(raw_rgb.numpy(), p_rgb.numpy(), "bfloat16", "raw_rgb")
    close(raw_den.numpy(), p_den.numpy(), "bfloat16", "raw_den")
    d_params, p_dx, p_dd = fl.mlp_backward_plain(
        params, cfg, x, d, hs, vs, g_rgb, g_den, R, S, dt, input_grads=True)
    for k, g in grads.items():
        layer = k if k < D else k + 1
        close(g.sum(0).numpy(), d_params[layer][1].numpy(), "bfloat16",
              f"db{layer}")
    close(dx.numpy(), p_dx.float().numpy(), "bfloat16", "dX")
    close(dd.numpy(), p_dd.numpy(), "bfloat16", "dD")
