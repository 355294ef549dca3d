"""MLP heads of any channel count on ``mlp_fwd`` / ``mlp_bwd`` on the CPU:
the port's plain versions (what the wrappers run on CPU tensors) against
the JAX package's ``fused_mlp_apply`` and ``_fused_mlp_bwd_impl`` (Pallas,
interpret mode) at head pairs (9, 1), (1, 9), (16, 16), (17, 33) and
(3, 64) (a head wider than a narrow net_width_condition), at a narrow
(64 / 32) and a wide (288 / 64) width, in f32 and bf16; the Function's
gradients against ``jax.grad``; two train steps at
``num_density_channels=16`` on the MLP-kernel branch against JAX's; the
router (``fused_level.takes_wide``: heads keep the narrow route at narrow
widths); the bf16 slab stream's heads in groups of 8 channels
(``fused_level._wg_head``) read back as the kernels read them
(``csrc/forward_wg.cuh``'s N=8 products, ``csrc/wide_forward.cuh``'s
``wide_head_kernel`` at ``wide_offsets``), run as heads against the plain
version; and the bounds' byte counts at heads (16, 16).

Config: depth 3, skip at 2, one view layer, S=8, R=4, inputs made with
numpy from a seed. Tolerance: the parity bands of ``utils/parity.py``
(f32 (1e-6, 1e-3), bf16 (2e-3, 3e-2)) as a normalized error < 1. The
kernels themselves are held against the plain versions on a card
(``test_torch_kernel_cuda.py -k any_heads``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_train_step import branch_kw, check_two_steps  # noqa: E402
from test_torch_wide import WIDE, close, gemm_b, head_w  # noqa: E402
from test_torch_wide import wide_offsets  # noqa: E402
from test_torch_wide_mlp import mlp_case  # noqa: E402

from nerf_or_nothing_tpu.kernels import fused_mlp as jfm  # noqa: E402
from nerf_or_nothing_tpu_torch.config import Config  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_level as fl  # noqa: E402
from nerf_or_nothing_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_or_nothing_tpu_torch.models import mlp as tmlp  # noqa: E402
from nerf_or_nothing_tpu_torch.utils import profiling  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
HEADS = [(9, 1), (1, 9), (16, 16), (17, 33), (3, 64)]
WIDTHS = {"narrow": dict(net_width=64, net_width_condition=32),
          "wide": dict(net_width=288, net_width_condition=64)}


def heads_kw(width, heads, dtype):
    return dict(WIDE, **WIDTHS[width], num_rgb_channels=heads[0],
                num_density_channels=heads[1], compute_dtype=dtype)


def hid(h):
    return f"{h[0]}_{h[1]}"


@pytest.mark.parametrize("heads", HEADS, ids=hid)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_any_heads_mlp_fwd_matches_jax(width, dtype, heads):
    """raw_rgb [N, Cr] and raw_den [N, Cd] of the port's
    ``fused_mlp_apply`` (``mlp_fwd_plain`` on the CPU) against JAX's
    (16-row tiles)."""
    jc, tc, jp, tp, x, d, _, _ = mlp_case(heads_kw(width, heads, dtype),
                                          seed=sum(heads))
    R, S = d.shape[0], tc.num_samples
    ref = jfm.fused_mlp_apply(jp, jc, J(x), J(d), tile=16)
    out = fm.fused_mlp_apply(tp, tc, T(x), T(d))
    for a, b, name, c in zip(out, ref, ("raw_rgb", "raw_den"), heads):
        assert tuple(a.shape) == (R, S, c)
        close(a.numpy(), np.asarray(b), dtype, name)


@pytest.mark.parametrize("heads", HEADS, ids=hid)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_any_heads_mlp_bwd_matches_jax(width, dtype, heads):
    """``mlp_bwd_plain`` against JAX's ``_fused_mlp_bwd_impl`` (8-row
    tiles): every dW / db and, with input_grads (every other head pair,
    so both ways run at both widths and dtypes), dX and dD."""
    input_grads = HEADS.index(heads) % 2 == (width == "wide")
    jc, tc, jp, tp, x, d, g_rgb, g_den = mlp_case(
        heads_kw(width, heads, dtype), seed=7 + sum(heads))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_any_heads_function_matches_jax_vjp(width, dtype):
    """Heads 17 / 33: the port's Function (``mlp_fwd`` forward, ``mlp_bwd``
    with input_grads backward) against ``jax.grad`` through JAX's
    ``fused_mlp_apply`` (custom VJP, interpret mode): every parameter's
    gradient, x's and dir_enc's."""
    jc, tc, jp, tp, x, d, _, _ = mlp_case(heads_kw(width, (17, 33), dtype),
                                          seed=3)
    ref = jax.grad(
        lambda p, xx, dd: _loss_j(*jfm.fused_mlp_apply(p, jc, xx, dd, tile=16)),
        argnums=(0, 1, 2))(jp, J(x), J(d))
    leaves = [t.clone().requires_grad_() for wb in tp for t in wb]
    xt, dt_ = T(x).requires_grad_(), T(d).requires_grad_()
    out = fm.fused_mlp_apply(list(zip(leaves[0::2], leaves[1::2])), tc, xt,
                             dt_)
    grads = torch.autograd.grad(_loss_t(*out), leaves + [xt, dt_])
    flat_ref = [t for wb in ref[0] for t in wb] + [ref[1], ref[2]]
    assert len(grads) == len(flat_ref)
    for k, (a, b) in enumerate(zip(grads, flat_ref)):
        close(a.float().numpy(), np.asarray(b, np.float32), dtype, f"grad{k}")


@pytest.mark.parametrize("branch", ["autograd_pallas_cfg", "full_grad"])
def test_two_train_steps_with_16_density_channels_match_jax(branch):
    """``num_density_channels=16`` leaves the fused level (heads other than
    3 / 1) for the MLP kernels: two train steps on the MLP-kernel branch
    (and with the full gradient through resampling) against JAX's, from
    JAX's initial state (density from channel 0)."""
    check_two_steps(branch_kw(branch, num_density_channels=16), False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_any_heads_router(dtype):
    """Heads of any count pass ``check_kernel_config(any_heads=True)``
    (a head of 0 channels does not; the level kernels keep 3 / 1) and keep
    ``mlp_fwd`` / ``mlp_bwd`` on the narrow route at the narrow widths (the
    chain's db of every bias fits), the wide route at 288."""
    for heads in HEADS:
        for width in WIDTHS:
            cfg = Config(**heads_kw(width, heads, dtype))
            fl.check_kernel_config(cfg, any_heads=True)
            with pytest.raises(ValueError, match="3 rgb / 1 density"):
                fl.check_kernel_config(cfg)
            for kernel, input_grads in (("mlp_fwd", False),
                                        ("mlp_bwd", False),
                                        ("mlp_bwd", True)):
                assert fl.takes_wide(cfg, kernel, 8, input_grads) == (
                    width == "wide"), (heads, width, kernel)
    with pytest.raises(ValueError, match="at least 1 channel"):
        fl.check_kernel_config(Config(num_density_channels=0), any_heads=True)


@pytest.mark.parametrize("heads", HEADS, ids=hid)
def test_wg_stream_heads_in_groups_of_8(heads):
    """``pack_params_wg`` at heads (Cr, Cd): each head as ceil(C / 8)
    groups of 8 columns, each its own slabs of 8 rows (the last group
    zero-padded), at the offsets ``csrc/wide_forward.cuh::wide_offsets``
    and ``forward_wg.cuh::init_wg`` give (``head_cols``). Read back group by
    group as ``wide_head_kernel`` reads a head (``head_w``) and as the
    narrow forward's N=8 products take their B operand (``gemm_b``), the
    heads equal the layers' weights, and the stream's length is
    ``packed_wg_size``; a head of up to 8 channels packs as before, one
    group."""
    for width in WIDTHS:
        cfg = Config(**heads_kw(width, heads, "bfloat16"))
        params = tmlp.init_mlp(torch.Generator().manual_seed(1), cfg)
        stream = fl.pack_params_wg(params, cfg, torch.float32)[0]
        assert stream.numel() == fl.packed_wg_size(cfg)
        o = wide_offsets(cfg)
        D, Dc = cfg.net_depth, cfg.net_depth_condition
        W, Wc = cfg.net_width, cfg.net_width_condition
        for off, K, nk, w in ((o["den"], W, o["nh"], params[D][0]),
                              (o["rgb"], Wc, o["nc"], params[D + 1 + Dc][0])):
            C = w.shape[1]
            group = nk * 8 * 64
            for g in range(-(-C // 8)):
                nc = min(8, C - 8 * g)
                cols = head_w(stream, off + g * group, K, nc)
                assert torch.equal(cols, w[:, 8 * g:8 * g + nc]), (g, C)
                b = gemm_b(stream, off + g * group, nk, 8)
                assert torch.equal(b[:K, :nc], w[:, 8 * g:8 * g + nc])
                assert not b[:K, nc:].any() and not b[K:].any()
        assert o["dir"] + cfg.direction_features * Wc == stream.numel()
        small = Config(**heads_kw(width, (3, 1), "bfloat16"))
        sp = tmlp.init_mlp(torch.Generator().manual_seed(1), small)
        w = sp[small.net_depth][0]
        one = fl._wg_head(w)
        padded = torch.zeros(w.shape[0], 8)
        padded[:, :1] = w
        assert torch.equal(one, fl._wg_slabs(padded))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heads_run_from_the_stream_groups(dtype):
    """The heads at (17, 33) computed from the stream's groups as the
    kernels compute them (each group's 8 columns, the products of its
    slabs, the bias added, the valid columns written at their offset)
    equal ``mlp_forward_acts``' heads in the compute type's band."""
    cfg = Config(**heads_kw("narrow", (17, 33), dtype))
    params = tmlp.init_mlp(torch.Generator().manual_seed(2), cfg)
    dt = tmlp.compute_dtype(cfg)
    R, S = 4, cfg.num_samples
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(R * S, cfg.location_features, generator=gen) * 0.5).to(dt)
    d = (torch.randn(R, cfg.direction_features, generator=gen) * 0.5).to(dt)
    rgb, den, hs, vs = fl.mlp_forward_acts(params, cfg, x, d, R, S, dt)
    stream = fl.pack_params_wg(params, cfg, dt)[0].float()
    b = fl._pack_biases(params, cfg)
    o = wide_offsets(cfg)
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    nb = sum(p[1].numel() for p in params[:D])
    for a, off, nk, C, b0, ref in (
            (hs[-1], o["den"], o["nh"], cfg.num_density_channels, nb, den),
            (vs[-1], o["rgb"], o["nc"], cfg.num_rgb_channels,
             b.numel() - cfg.num_rgb_channels, rgb)):
        out = torch.empty(R * S, C)
        K = a.shape[1]
        for g in range(-(-C // 8)):
            nc = min(8, C - 8 * g)
            bw = gemm_b(stream, off + g * nk * 8 * 64, nk, 8)[:K]
            out[:, 8 * g:8 * g + nc] = (a.float() @ bw)[:, :nc] + b[
                b0 + 8 * g:b0 + 8 * g + nc]
        close(out.numpy(), ref.numpy(), dtype, f"heads {C}")


def test_bound_bytes_count_the_heads():
    """At heads (16, 16) ``mlp_roofline`` counts (16 + 16) f32 a row out
    (twice with the backward), and ``mlp_kernel_bytes`` (the bounds of
    ``chip_smoke.py``'s mlp_fwd / mlp_bwd rows) counts them out of the
    forward and into the backward."""
    base = dict(net_depth=3, net_width=64, net_width_condition=32,
                skip_layer=2, max_deg_point=4, num_samples=8)
    cfg = Config(**base, num_rgb_channels=16, num_density_channels=16)
    ref = Config(**base)
    rows, R, S = 1000, 10, 8
    for backward in (True, False):
        got = profiling.mlp_roofline(cfg, rows, backward, device="cpu")
        was = profiling.mlp_roofline(ref, rows, backward, device="cpu")
        params = (tmlp.num_params(cfg) - tmlp.num_params(ref)) * 4
        assert got["bytes"] - was["bytes"] == rows * (32 - 4) * 4 * (
            2 if backward else 1) + params
    x_in = R * S * cfg.location_features * 2 + R * cfg.direction_features * 2
    dims = tmlp.layer_dims(cfg)
    w = sum(i * o for i, o in dims) * 2 + sum(o for _, o in dims) * 4
    assert profiling.mlp_kernel_bytes(cfg, R, S) == (x_in + w, R * S * 32 * 4)
    for input_grads in (False, True):
        in_b, out_b = profiling.mlp_kernel_bytes(cfg, R, S, True, input_grads)
        assert in_b == x_in + w + R * S * 32 * 4
        assert out_b == tmlp.num_params(cfg) * 4 + (
            R * S * cfg.location_features * 2 + R * cfg.direction_features * 4
            if input_grads else 0)
