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

Both take heads of any channel count. At net_width 288 and above, and
where the narrow route's shared memory does not hold the config (wide
location features, large heads), with no ceiling but the card's memory,
both run their wide route (``fused_level.takes_wide``; bf16:
``csrc/wide_forward.cuh``, ``csrc/wide_train.cuh``, f32:
``csrc/wide_f32.cuh``): ``mlp_fwd`` through ``mlp_fwd_wide_launch`` and a
workspace allocated here, ``mlp_bwd`` through the same entry point.
Widths that are not multiples of 32 run zero-padded, as the level
kernels do (``fused_level.kernel_cfg``).

``mlp_fwd`` and ``mlp_bwd`` dispatch on the device of their inputs: CPU
tensors go to the plain version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.kernels.fused_level import (
    _DTYPE_CODE,
    _check,
    check_kernel_config,
    f32_slabs,
    forward_weights_size,
    kernel_cfg,
    mlp_backward_plain,
    mlp_forward_acts,
    pack_forward,
    pack_params,
    pack_params_t,
    pack_params_tx,
    pack_params_wft,
    pack_params_wfx,
    pack_params_wgx,
    packed_sizes,
    packed_t_size,
    packed_tx_size,
    packed_wf_size,
    packed_wgx_size,
    padded_location_features,
    repack_f32,
    route_code,
    slab_streams,
    takes_wide,
    train_splits,
    unembed_grads,
    unpack_grads,
    weight_layout,
)
from nerf_or_nothing_tpu_torch.models.mlp import (
    Params,
    apply_mlp,
    compute_dtype,
    num_params,
)
from nerf_or_nothing_tpu_torch.ops.math_utils import exact_f32

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
                    backward: bool = True, layout: str = "wf",
                    wide: Optional[bool] = None):
    """The kernels' weights, packed once for both levels: (weights,
    biases) of ``pack_forward`` for ``mlp_fwd`` (bf16: the ``"wg"`` slab
    stream; f32: ``pack_params_wf`` where ``f32_slabs`` says so, route
    ``wide``), and with ``backward`` what ``mlp_bwd`` reading ``layout``
    (``weight_layout``) needs besides: in bf16 with the slab streams the
    g-chain stream with the x rows (``pack_params_wgx``; the recomputed
    forward reads the forward's stream); else its recompute weights (the
    forward's tensor in f32; ``pack_params``' layout for the earlier bf16
    ``mma.sync`` kernel), the chained layers' W^T and the x rows' W^T:
    ``pack_params_wft`` and ``pack_params_wfx`` on the f32 wide route,
    else ``pack_params_t`` and ``pack_params_tx``. No autograd graph is
    kept."""
    with torch.no_grad():
        w_fwd, b_flat = pack_forward(params, cfg, dt, layout, wide)
        if not backward:
            return w_fwd, b_flat
        if _bwd_wg(cfg, layout):
            return w_fwd, b_flat, pack_params_wgx(params, cfg, dt)
        if f32_slabs(cfg, layout, wide):
            return (w_fwd, b_flat, w_fwd, pack_params_wft(params, cfg, dt),
                    pack_params_wfx(params, cfg, dt))
        w_flat = (pack_params(params, cfg, dt)[0] if dt == torch.bfloat16
                  else w_fwd)
        return (w_fwd, b_flat, w_flat, pack_params_t(params, cfg, dt),
                pack_params_tx(params, cfg, dt))


def _bwd_wg(cfg: Config, layout: str) -> bool:
    """Whether ``mlp_bwd`` reading ``layout`` runs the bf16 ``wgmma``
    passes (which read the forward's stream and ``pack_params_wgx``)."""
    return slab_streams(layout) and compute_dtype(cfg) == torch.bfloat16


def _check_mlp_inputs(cfg: Config, x, d, kernel: str,
                      input_grads: bool = False):
    """Validate the kernels' x and d and pick ``kernel``'s route
    (``takes_wide``, which raises for a config no route takes); returns
    (R, S, whether the launch takes the wide route)."""
    check_kernel_config(cfg, any_heads=True)
    R, N = d.shape[0], x.shape[0]
    if R == 0 or N % R:
        raise ValueError(f"x has {N} rows, not a multiple of the {R} rays "
                         "of d")
    wide = takes_wide(cfg, kernel, N // R, input_grads)
    dt = compute_dtype(cfg)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {device}")
    _check("x", x, dt, (N, cfg.location_features), device)
    _check("d", d, dt, (R, cfg.direction_features), device)
    return R, N // R, wide


def _check_packed(cfg: Config, packed: Sequence[torch.Tensor], device,
                  fwd_layout: str = "wf", bwd_layout: Optional[str] = None,
                  wide: Optional[bool] = None):
    """``pack_mlp_params``' tensors: the forward's weights in
    ``fwd_layout`` and the biases, and with ``bwd_layout`` what ``mlp_bwd``
    reading it takes besides (the chain stream with the x rows; or the
    recompute weights, W^T and x-row W^T, as hi / lo slabs on the f32 wide
    route ``wide``)."""
    dt = compute_dtype(cfg)
    n_w, n_b = packed_sizes(cfg)
    sizes = [forward_weights_size(cfg, fwd_layout, wide), n_b]
    names = ["packed forward weights", "packed biases"]
    if bwd_layout is not None and _bwd_wg(cfg, bwd_layout):
        sizes.append(packed_wgx_size(cfg))
        names.append("packed chain weights")
    elif bwd_layout is not None and f32_slabs(cfg, bwd_layout, wide):
        sizes += [packed_wf_size(cfg), 2 * packed_t_size(cfg),
                  2 * packed_tx_size(cfg)]
        names += ["packed weights", "packed W^T", "packed x-row W^T"]
    elif bwd_layout is not None:
        sizes += [n_w, packed_t_size(cfg), packed_tx_size(cfg)]
        names += ["packed weights", "packed W^T", "packed x-row W^T"]
    if len(packed) != len(sizes):
        raise ValueError(f"packed must hold {len(sizes)} tensors "
                         f"({', '.join(names)}), got {len(packed)}")
    for k, t in enumerate(packed):
        _check(names[k], t, torch.float32 if k == 1 else dt, (sizes[k],),
               device)


def _dims(cfg: Config):
    """The kernels' width arguments, in their C order, at the kernel widths
    (``kernel_cfg``)."""
    kc = kernel_cfg(cfg)
    return (cfg.net_depth, kc.net_width, cfg.skip_layer,
            kc.net_width_condition, cfg.net_depth_condition,
            cfg.location_features, padded_location_features(cfg),
            cfg.direction_features, cfg.num_rgb_channels,
            cfg.num_density_channels)


def _fwd_library(source=None):
    """(launch function, weight layout) of ``csrc/mlp_fwd.cu`` or of
    another version of it."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("mlp_fwd", source)
    fn = lib.mlp_fwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 6 + [i] * 12 + [p]
        fn.restype = ctypes.c_int
    return fn, weight_layout(lib, "mlp_fwd")


def _wide_fwd_library(source=None):
    """(launch, workspace) of the wide route of ``csrc/mlp_fwd.cu`` or of
    another version of it (ValueError for a version without one)."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("mlp_fwd", source)
    if not hasattr(lib, "mlp_fwd_wide_workspace"):
        raise ValueError("mlp_fwd: this source version has no wide route")
    fn, ws = lib.mlp_fwd_wide_launch, lib.mlp_fwd_wide_workspace
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 6 + [i] * 12 + [p, p]
        fn.restype = ctypes.c_int
        ws.argtypes = [i] * 6
        ws.restype = ctypes.c_longlong
    return fn, ws


def mlp_fwd_cuda(params: Params, cfg: Config, x, d, packed=None,
                 source=None):
    """Launch ``mlp_fwd`` on the current stream. Same inputs and outputs as
    ``mlp_fwd_plain`` (S is the rows of x over the rays of d);
    ``packed`` starts with ``pack_forward``'s result when the caller
    already has it; ``source`` is another version of ``csrc/mlp_fwd.cu``
    with the same C interface, to time versions in turns
    (``compare_kernels.py``; ``packed`` then in the layout it reads).
    The wide route (``takes_wide``: net_width 288 and above, or features
    or heads past the narrow route's shared memory; ``mlp_fwd_wide_launch``,
    bf16 and f32) runs with a workspace allocated here (a ``source``
    version's own, where it has one)."""
    R, S, wide = _check_mlp_inputs(cfg, x, d, "mlp_fwd")
    dt = compute_dtype(cfg)
    device = x.device
    fn, layout = _fwd_library(source)
    if packed is None or repack_f32(cfg, layout, wide):
        packed = pack_mlp_params(params, cfg, dt, backward=False,
                                 layout=layout, wide=wide)
    w_flat, b_flat = packed[:2]
    _check_packed(cfg, (w_flat, b_flat), device, layout, wide=wide)
    N = R * S
    raw_rgb = torch.empty((N, cfg.num_rgb_channels), dtype=torch.float32,
                          device=device)
    raw_den = torch.empty((N, cfg.num_density_channels), dtype=torch.float32,
                          device=device)
    ptrs = (x.data_ptr(), d.data_ptr(), w_flat.data_ptr(), b_flat.data_ptr(),
            raw_rgb.data_ptr(), raw_den.data_ptr())
    stream = torch.cuda.current_stream(device).cuda_stream
    if wide:
        fn, workspace_bytes = _wide_fwd_library(source)
        _, W, _, Wc = _dims(cfg)[:4]
        workspace = torch.empty(
            (workspace_bytes(_DTYPE_CODE[dt], R, S, W, Wc,
                             padded_location_features(cfg)),),
            dtype=torch.uint8, device=device)
        err = fn(_DTYPE_CODE[dt], *ptrs, R, S, *_dims(cfg),
                 workspace.data_ptr(), stream)
    else:
        err = fn(_DTYPE_CODE[dt], *ptrs, R, S, *_dims(cfg), stream)
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


def _bwd_library(source=None):
    """(library, weight layout) of ``csrc/mlp_bwd.cu`` or of another
    version of it."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("mlp_bwd", source)
    fn = lib.mlp_bwd_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i] + [p] * 9 + [ll] + [p] * 3 + [i] * 12 + [i, i, p])
        fn.restype = ctypes.c_int
        # An earlier version's workspace function ignores the trailing
        # arguments: the head channels (its dbpart held 16), then the
        # direction features and density channels (its split partials held
        # every output).
        ws = lib.mlp_bwd_workspace
        ws.argtypes = [i] * 9 + [ll, i, i, i]
        ws.restype = ll
    return lib, weight_layout(lib, "mlp_bwd")


def mlp_bwd_cuda(params: Params, cfg: Config, x, d, g_rgb, g_den,
                 input_grads: bool, packed=None, source=None):
    """Launch ``mlp_bwd`` on the current stream. Same inputs and outputs as
    ``mlp_bwd_plain``; ``packed`` is ``pack_mlp_params``' result when the
    caller already has it (once per step for both levels); ``source`` is
    another version of ``csrc/mlp_bwd.cu`` with the same C interface, to
    time versions in turns (``compare_kernels.py``; ``packed`` then in the
    layout it reads). The wide route (bf16 and f32) runs in the same entry
    point where ``takes_wide`` picks it (``route_code``). Configs no route
    takes raise ValueError before anything runs."""
    R, S, wide = _check_mlp_inputs(cfg, x, d, "mlp_bwd", input_grads)
    code = route_code(cfg, "mlp_bwd", S, input_grads, source)
    dt = compute_dtype(cfg)
    device = x.device
    N = R * S
    _check("g_rgb", g_rgb, torch.float32, (N, cfg.num_rgb_channels), device)
    _check("g_den", g_den, torch.float32, (N, cfg.num_density_channels),
           device)
    lib, layout = _bwd_library(source)
    if packed is None or len(packed) == 2 or repack_f32(cfg, layout, wide):
        packed = pack_mlp_params(params, cfg, dt, layout=layout, wide=wide)
    _check_packed(cfg, packed, device, layout, layout, wide)
    if _bwd_wg(cfg, layout):  # the forward's stream and the chain stream
        w_flat, b_flat, wt_flat = packed
        wtx_ptr = 0
    else:
        _, b_flat, w_flat, wt_flat, wtx_flat = packed
        wtx_ptr = wtx_flat.data_ptr()
    n_out = num_params(kernel_cfg(cfg))
    # Room for n_out rounded up to even: the kernel's split partials keep
    # 8-byte aligned rows (``partial_stride`` in csrc/mlp_bwd.cu).
    grads = torch.empty((n_out + n_out % 2,), dtype=torch.float32,
                        device=device)
    dx = dd = None
    if input_grads:
        dx = torch.empty((N, cfg.location_features), dtype=dt, device=device)
        dd = torch.empty((R, cfg.direction_features), dtype=torch.float32,
                         device=device)
    splits = train_splits(N)
    D, W, _, Wc, Dc, _, kx = _dims(cfg)[:7]
    ws_bytes = lib.mlp_bwd_workspace(
        code, R, S, D, W, Wc, Dc, kx, splits, n_out,
        cfg.num_rgb_channels + cfg.num_density_channels,
        cfg.direction_features, cfg.num_density_channels)
    workspace = torch.empty((ws_bytes,), dtype=torch.uint8, device=device)
    err = lib.mlp_bwd_launch(
        code, x.data_ptr(), d.data_ptr(), g_rgb.data_ptr(),
        g_den.data_ptr(), w_flat.data_ptr(), wt_flat.data_ptr(), wtx_ptr,
        b_flat.data_ptr(), grads.data_ptr(), n_out,
        dx.data_ptr() if input_grads else 0,
        dd.data_ptr() if input_grads else 0, workspace.data_ptr(), R, S,
        *_dims(cfg), splits, int(input_grads),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mlp_bwd kernel launch failed: CUDA error {err}")
    mlp_bwd.launches += 1
    return unpack_grads(unembed_grads(grads[:n_out], cfg), cfg), dx, dd


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

