"""The whole-MLP forward and backward as hand-written CUDA kernels, each with
its plain PyTorch version beside it, behind one autograd Function.

``csrc/mlp_fwd.cu`` replaces the TPU kernel
``nerf_or_nothing_tpu/kernels/fused_mlp.py::_fwd_kernel``: encoded
positions [N, location_features] and per-ray direction features
[R, direction_features] (N = R * S, rows ray-major) in, raw_rgb
[N, C_rgb] and raw_den [N, C_den] f32 out. ``csrc/mlp_bwd.cu`` replaces
``_bwd_kernel``: it recomputes the forward from the same inputs and the
head cotangents, and gives f32 dW/db for every layer and, with
``input_grads``, dX [N, location_features] and dD [R, direction_features].

``fused_mlp_apply`` is the port of the JAX package's ``fused_mlp_apply``
(a ``custom_vjp``): the forward launches ``mlp_fwd``, the backward
``mlp_bwd``. It is the MLP of every level that the fused render or train
level does not take (``fuse_level=False``, ``stop_level_grad=False``,
heads other than 3 rgb / 1 density, a full covariance). The TPU grid
sizes (``tile``, ``tile_bwd``, ``interleave``) are not carried over, and
the kernels take per-ray directions for any S.

``mlp_fwd`` and ``mlp_bwd`` dispatch on the device of their inputs: CPU
tensors go to the plain version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.kernels.fused_level import (
    _DTYPE_CODE,
    _check,
    check_kernel_config,
    mlp_backward_plain,
    mlp_forward_acts,
    pack_params,
    pack_params_t,
    pack_params_tx,
    packed_sizes,
    packed_t_size,
    packed_tx_size,
    padded_location_features,
    train_splits,
    unpack_grads,
)
from nerf_or_nothing_tpu_torch.models.mlp import (
    Params,
    apply_mlp,
    compute_dtype,
    num_params,
)
from nerf_or_nothing_tpu_torch.ops.math_utils import exact_f32

MAX_HEAD = 8  # channels of one head: one n8 tile of the kernels' products


def mlp_fwd_plain(params: Params, cfg: Config, x, d, s: int):
    """``_fwd_kernel``'s function in plain PyTorch (``mlp_forward_acts``).

    Args:
      x: [R*s, location_features] and d: [R, direction_features], both in
        the compute dtype; s: samples per ray.
    Returns:
      raw_rgb [N, C_rgb], raw_den [N, C_den], f32.
    """
    exact_f32(x.device)
    dt = compute_dtype(cfg)
    raw_rgb, raw_den, _, _ = mlp_forward_acts(
        params, cfg, x.to(dt), d.to(dt), d.shape[0], s, dt, keep=False)
    return raw_rgb, raw_den


def mlp_bwd_plain(params: Params, cfg: Config, x, d, g_rgb, g_den, s: int,
                  input_grads: bool):
    """``_bwd_kernel``'s function in plain PyTorch: the forward again,
    keeping the activations, then ``mlp_backward_plain``.

    Args: as ``mlp_fwd_plain``, plus the cotangents g_rgb [N, C_rgb] and
      g_den [N, C_den] (f32).
    Returns:
      (d_params, dx, dd): d_params a list of (dW [fan_in, fan_out],
      db [fan_out]) f32 in layer order; with ``input_grads`` dx
      [N, location_features] in the compute dtype and dd
      [R, direction_features] f32, else None and None.
    """
    exact_f32(x.device)
    dt = compute_dtype(cfg)
    x, d = x.to(dt), d.to(dt)
    R = d.shape[0]
    _, _, hs, vs = mlp_forward_acts(params, cfg, x, d, R, s, dt)
    return mlp_backward_plain(params, cfg, x, d, hs, vs, g_rgb.float(),
                              g_den.float(), R, s, dt, input_grads)


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def pack_mlp_params(params: Params, cfg: Config, dt: torch.dtype,
                    backward: bool = True):
    """The kernels' weights, packed once for both levels: (weights, biases)
    in ``pack_params``' layout for the forward, and with ``backward`` also
    the chained layers' W^T (``pack_params_t``) and the x rows' W^T
    (``pack_params_tx``) for the backward. No autograd graph is kept."""
    with torch.no_grad():
        w_flat, b_flat = pack_params(params, cfg, dt)
        if not backward:
            return w_flat, b_flat
        return (w_flat, b_flat, pack_params_t(params, cfg, dt),
                pack_params_tx(params, cfg, dt))


def _check_mlp_inputs(cfg: Config, x, d):
    """Validate the kernels' x and d; returns (R, S)."""
    check_kernel_config(cfg, max_head=MAX_HEAD)
    dt = compute_dtype(cfg)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {device}")
    R = d.shape[0]
    N = x.shape[0]
    if R == 0 or N % R:
        raise ValueError(f"x has {N} rows, not a multiple of the {R} rays "
                         "of d")
    _check("x", x, dt, (N, cfg.location_features), device)
    _check("d", d, dt, (R, cfg.direction_features), device)
    return R, N // R


def _check_packed(cfg: Config, packed: Sequence[torch.Tensor], device):
    dt = compute_dtype(cfg)
    n_w, n_b = packed_sizes(cfg)
    sizes = (n_w, n_b, packed_t_size(cfg), packed_tx_size(cfg))
    names = ("packed weights", "packed biases", "packed W^T",
             "packed x-row W^T")
    for k, t in enumerate(packed):
        _check(names[k], t, torch.float32 if k == 1 else dt, (sizes[k],),
               device)


def _dims(cfg: Config):
    """The kernels' width arguments, in their C order."""
    return (cfg.net_depth, cfg.net_width, cfg.skip_layer,
            cfg.net_width_condition, cfg.net_depth_condition,
            cfg.location_features, padded_location_features(cfg),
            cfg.direction_features, cfg.num_rgb_channels,
            cfg.num_density_channels)


def _fwd_library():
    from nerf_or_nothing_tpu_torch.kernels import build

    fn = build.load("mlp_fwd").mlp_fwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 6 + [i] * 12 + [p]
        fn.restype = ctypes.c_int
    return fn


def mlp_fwd_cuda(params: Params, cfg: Config, x, d, packed=None):
    """Launch ``mlp_fwd`` on the current stream. Same inputs and outputs as
    ``mlp_fwd_plain`` (S is the rows of x over the rays of d);
    ``packed`` starts with ``pack_params``' result when the caller already
    has it."""
    R, S = _check_mlp_inputs(cfg, x, d)
    dt = compute_dtype(cfg)
    device = x.device
    if packed is None:
        packed = pack_mlp_params(params, cfg, dt, backward=False)
    w_flat, b_flat = packed[:2]
    _check_packed(cfg, (w_flat, b_flat), device)
    N = R * S
    raw_rgb = torch.empty((N, cfg.num_rgb_channels), dtype=torch.float32,
                          device=device)
    raw_den = torch.empty((N, cfg.num_density_channels), dtype=torch.float32,
                          device=device)
    err = _fwd_library()(
        _DTYPE_CODE[dt], x.data_ptr(), d.data_ptr(), w_flat.data_ptr(),
        b_flat.data_ptr(), raw_rgb.data_ptr(), raw_den.data_ptr(), R, S,
        *_dims(cfg), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mlp_fwd kernel launch failed: CUDA error {err}")
    mlp_fwd.launches += 1
    return raw_rgb, raw_den


def mlp_fwd(params: Params, cfg: Config, x, d, packed=None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if x.is_cuda:
        return mlp_fwd_cuda(params, cfg, x, d, packed=packed)
    return mlp_fwd_plain(params, cfg, x, d, x.shape[0] // d.shape[0])


mlp_fwd.launches = 0


def _bwd_library():
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("mlp_bwd")
    fn = lib.mlp_bwd_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i] + [p] * 9 + [ll] + [p] * 3 + [i] * 12 + [i, i, p])
        fn.restype = ctypes.c_int
        ws = lib.mlp_bwd_workspace
        ws.argtypes = [i] * 9 + [ll]
        ws.restype = ll
    return lib


def mlp_bwd_cuda(params: Params, cfg: Config, x, d, g_rgb, g_den,
                 input_grads: bool, packed=None):
    """Launch ``mlp_bwd`` on the current stream. Same inputs and outputs as
    ``mlp_bwd_plain``; ``packed`` is ``pack_mlp_params``' result when the
    caller already has it (once per step for both levels)."""
    R, S = _check_mlp_inputs(cfg, x, d)
    dt = compute_dtype(cfg)
    device = x.device
    N = R * S
    _check("g_rgb", g_rgb, torch.float32, (N, cfg.num_rgb_channels), device)
    _check("g_den", g_den, torch.float32, (N, cfg.num_density_channels),
           device)
    if packed is None or len(packed) < 4:
        packed = pack_mlp_params(params, cfg, dt)
    _check_packed(cfg, packed, device)
    w_flat, b_flat, wt_flat, wtx_flat = packed
    n_out = num_params(cfg)
    grads = torch.empty((n_out,), dtype=torch.float32, device=device)
    dx = dd = None
    if input_grads:
        dx = torch.empty((N, cfg.location_features), dtype=dt, device=device)
        dd = torch.empty((R, cfg.direction_features), dtype=torch.float32,
                         device=device)
    lib = _bwd_library()
    splits = train_splits(N)
    D, W, _, Wc, Dc, _, kx = _dims(cfg)[:7]
    ws_bytes = lib.mlp_bwd_workspace(_DTYPE_CODE[dt], R, S, D, W, Wc, Dc, kx,
                                     splits, n_out)
    workspace = torch.empty((ws_bytes,), dtype=torch.uint8, device=device)
    err = lib.mlp_bwd_launch(
        _DTYPE_CODE[dt], x.data_ptr(), d.data_ptr(), g_rgb.data_ptr(),
        g_den.data_ptr(), w_flat.data_ptr(), wt_flat.data_ptr(),
        wtx_flat.data_ptr(), b_flat.data_ptr(), grads.data_ptr(), n_out,
        dx.data_ptr() if input_grads else 0,
        dd.data_ptr() if input_grads else 0, workspace.data_ptr(), R, S,
        *_dims(cfg), splits, int(input_grads),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mlp_bwd kernel launch failed: CUDA error {err}")
    mlp_bwd.launches += 1
    return unpack_grads(grads, cfg), dx, dd


def mlp_bwd(params: Params, cfg: Config, x, d, g_rgb, g_den,
            input_grads: bool, packed=None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors.
    The ``fm_bwd`` probe values whose JAX kernel computes filler values
    raise NotImplementedError (``Config.check_probes``)."""
    cfg.check_probes("fm_bwd")
    if x.is_cuda:
        return mlp_bwd_cuda(params, cfg, x, d, g_rgb, g_den, input_grads,
                            packed=packed)
    return mlp_bwd_plain(params, cfg, x, d, g_rgb, g_den,
                         x.shape[0] // d.shape[0], input_grads)


mlp_bwd.launches = 0


# ---------------------------------------------------------------------------
# The autograd Function (the JAX package's custom_vjp)
# ---------------------------------------------------------------------------


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, input_grads, packed, x2d, d2d, *leaves):
        params = list(zip(leaves[0::2], leaves[1::2]))
        ctx.cfg, ctx.input_grads, ctx.packed = cfg, input_grads, packed
        ctx.save_for_backward(x2d, d2d, *leaves)
        return mlp_fwd(params, cfg, x2d, d2d, packed=packed)

    @staticmethod
    def backward(ctx, g_rgb, g_den):
        x2d, d2d, *leaves = ctx.saved_tensors
        params = list(zip(leaves[0::2], leaves[1::2]))
        d_params, dx, dd = mlp_bwd(
            params, ctx.cfg, x2d, d2d, g_rgb.float().contiguous(),
            g_den.float().contiguous(), ctx.input_grads, packed=ctx.packed)
        # Cotangents the caller said are unused come back as zeros, as the
        # JAX package gives them.
        if dx is None and ctx.needs_input_grad[3]:
            dx = torch.zeros_like(x2d)
        dd = (dd.to(d2d.dtype) if dd is not None
              else torch.zeros_like(d2d) if ctx.needs_input_grad[4] else None)
        return (None, None, None, dx, dd,
                *[t for wb in d_params for t in wb])


def fused_mlp_apply(params: Params, cfg: Config, x, dir_enc,
                    input_grads: bool = True, packed=None):
    """Drop-in for ``models.mlp.apply_mlp``, differentiable through the two
    kernels.

    Args:
      x: [..., S, location_features]; dir_enc: [..., direction_features].
      input_grads: when False, the backward skips dX / dD and gives zeros
        for them. Valid only when those cotangents cannot reach a
        parameter (level 0, or ``stop_level_grad``).
      packed: ``pack_mlp_params``' result, when the caller packs once for
        several calls; else the kernels pack on the card.
    Returns:
      raw_rgb [..., S, C_rgb], raw_density [..., S, C_den], f32.
    """
    lead = x.shape[:-1]
    n = math.prod(lead)
    num_rays = n // x.shape[-2]
    dt = compute_dtype(cfg)
    x2d = x.reshape(n, x.shape[-1]).to(dt).contiguous()
    d2d = dir_enc.reshape(num_rays, dir_enc.shape[-1]).to(dt).contiguous()
    raw_rgb, raw_den = _FusedMLP.apply(
        cfg, input_grads, packed, x2d, d2d,
        *[t for wb in params for t in wb])
    return (raw_rgb.reshape(*lead, cfg.num_rgb_channels),
            raw_den.reshape(*lead, cfg.num_density_channels))


def make_mlp_apply(cfg: Config):
    """The MLP forward per config: the fused kernels with ``use_pallas``,
    else the plain ``apply_mlp`` in the compute dtype."""
    if cfg.use_pallas:
        return fused_mlp_apply
    dt = compute_dtype(cfg)

    def plain(params, c, x, d):
        return apply_mlp(params, c, x, d, compute_dtype=dt)

    return plain

