"""One render level (IPE + MLP forward + activations + compositing) and
one train level (the same, then the loss gradient, the compositing
backward and the MLP backward with dW/db) as hand-written CUDA kernels,
each with its plain PyTorch version beside it.

The render kernel (``csrc/render_level.cu``) replaces the TPU kernel
``nerf_or_nothing_tpu/kernels/fused_level.py::_render_kernel``; the train
kernel (``csrc/train_level.cu``) replaces ``_level_kernel``, and the
two-pass train kernel (``csrc/train_level_twopass.cu``, kernel_probes
``fl_variant=twopass``) replaces ``_level_kernel_twopass``. The first two
take the sample means/variances [N, 3] and run the IPE themselves (mode
``"mv"``), or take encoded features [N, location_features] (mode ``"t"``,
the only mode of the two-pass kernel); rows are ray-major (row = ray * S +
sample), features in the interleaved [sin3, cos3]-per-frequency order, so
no weight permutation is needed.

``render_level``, ``train_level`` and ``train_level_twopass`` dispatch on
the device of their inputs: CPU tensors go to the plain version; CUDA
tensors launch the kernel, or raise. There is no fallback from the card to
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.models.mlp import (
    Params,
    compute_dtype,
    dense,
    layer_dims,
    num_params,
)
from nerf_or_nothing_tpu_torch.ops.fastmath import fast_exp_neg, fast_sincos
from nerf_or_nothing_tpu_torch.ops.math_utils import exact_f32, softplus
from nerf_or_nothing_tpu_torch.ops.render import (
    composite_weights,
    interval_lengths,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MODE_CODE = {"mv": 0, "t": 1}


def encode_mv(cfg: Config, means, variances, dt):
    """In-kernel IPE of [N, 3] means/variances -> [N, 6F] features in the
    interleaved order: y = mean * 2^(min_deg + i), damping
    exp(-var/2 * 4^(min_deg + i)), shared-reduction sin/cos, in f32, then
    rounded to ``dt``."""
    F = cfg.max_deg_point - cfg.min_deg_point
    scales = torch.tensor(
        [2.0 ** (cfg.min_deg_point + i) for i in range(F)],
        dtype=torch.float32, device=means.device,
    )[None, :, None]                                   # [1, F, 1]
    y = means[:, None, :] * scales                     # [N, F, 3]
    v = (variances[:, None, :] * 0.5) * (scales * scales)
    if cfg.fast_ipe:
        damp = fast_exp_neg(v)
        sin_y, cos_y = fast_sincos(y)
    else:
        damp = torch.exp(-v)
        sin_y, cos_y = torch.sin(y), torch.cos(y)
    feats = torch.cat([damp * sin_y, damp * cos_y], dim=-1)  # [N, F, 6]
    return feats.reshape(means.shape[0], 6 * F).to(dt)


def render_level_plain(params: Params, cfg: Config, xs, d, delta,
                       white_bkgd: bool, mode: str):
    """The kernel's function in plain PyTorch, with the kernel's arithmetic:
    operands rounded to the compute dtype and multiplied in f32 (no TF32),
    ReLU epilogues in f32 then rounded, f32 heads, f32 compositing.

    Args:
      xs: (means [N,3], variances [N,3]) f32 for mode "mv", or features
        [N, location_features] in the compute dtype for mode "t";
      d: [R, direction_features] in the compute dtype; delta: [R, S] f32.
    Returns:
      comp [R, 3], acc [R], weights [R, S], f32.
    """
    dt = compute_dtype(cfg)
    exact_f32(delta.device)
    R, S = delta.shape
    x = encode_mv(cfg, *xs, dt) if mode == "mv" else xs.to(dt)
    raw_rgb, raw_den, _, _ = mlp_forward_acts(params, cfg, x, d, R, S, dt,
                                              keep=False)
    raw_den = raw_den[:, 0]

    p = cfg.rgb_padding
    rgb = (torch.sigmoid(raw_rgb) * (1.0 + 2.0 * p) - p).view(R, S, 3)
    sigma = softplus(raw_den + cfg.density_bias).view(R, S)
    _, _, weights = composite_weights(sigma, delta)
    acc = torch.sum(weights, dim=-1)
    comp = torch.einsum("rs,rsc->rc", weights, rgb)
    if white_bkgd:
        comp = comp + (1.0 - acc[:, None])
    return comp, acc, weights


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def padded_location_features(cfg: Config) -> int:
    """Feature columns the kernel reads: location_features padded to 16."""
    return -(-cfg.location_features // 16) * 16


def check_kernel_config(cfg: Config, max_head: int = 0) -> None:
    """Raise ValueError for configs the CUDA kernels do not take. The level
    kernels composite 3 rgb / 1 density channels (``max_head`` 0); the MLP
    kernels (``kernels/fused_mlp.py``) take heads of 1 to ``max_head``
    channels each."""
    problems = []
    if cfg.net_width % 32 or not 32 <= cfg.net_width <= 256:
        problems.append("net_width must be a multiple of 32 in [32, 256]")
    if cfg.net_width_condition % 32 or not (
            32 <= cfg.net_width_condition <= cfg.net_width):
        problems.append(
            "net_width_condition must be a multiple of 32 in [32, net_width]"
        )
    heads = (cfg.num_rgb_channels, cfg.num_density_channels)
    if max_head == 0 and heads != (3, 1):
        problems.append("heads must be 3 rgb / 1 density")
    if max_head and not all(1 <= c <= max_head for c in heads):
        problems.append(f"heads must have 1 to {max_head} channels each")
    if cfg.net_depth < 1 or cfg.net_depth_condition < 1:
        problems.append("net_depth and net_depth_condition must be >= 1")
    if problems:
        raise ValueError("config not supported by the CUDA kernels: "
                         + "; ".join(problems))


def _pack_mma(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    """[K, N] weights (K zero-padded to ``k_pad``) in mma.m16n8k16 B-fragment
    order: [N/8][K/16][32 lanes][4], lane = 4*g + t holding
    W[16kt + 8h + 2t + {0,1}, 8nt + g] for h = 0, 1."""
    K, N = w.shape
    wp = torch.zeros((k_pad, N), dtype=w.dtype, device=w.device)
    wp[:K] = w
    wt = wp.t().reshape(N // 8, 8, k_pad // 16, 2, 4, 2)
    return wt.permute(0, 2, 1, 4, 3, 5).reshape(-1)


def _pack_mat(w: torch.Tensor, k_pad: int, fragments: bool) -> torch.Tensor:
    """A [K, N] matrix the kernels multiply on tensor cores: fragment order
    (bf16) or row-major (f32), K zero-padded to ``k_pad``."""
    if fragments:
        return _pack_mma(w, k_pad)
    wp = torch.zeros((k_pad, w.shape[1]), dtype=w.dtype, device=w.device)
    wp[: w.shape[0]] = w
    return wp.reshape(-1)


def _layout(params: Params, cfg: Config, fragments: bool):
    """The render kernel's weight layout of ``params`` (layer order; see
    ``csrc/render_level.cu``): trunk layers as [K_pad, W] (x rows padded
    to ``padded_location_features``), density head transposed
    [C_den, W], first view layer's h-rows [W, Wc] then d-rows [Fd, Wc]
    row-major, further view layers [Wc, Wc], rgb head transposed
    [C_rgb, Wc]."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    lx, kx = cfg.location_features, padded_location_features(cfg)
    parts = []
    for i in range(D):
        w = params[i][0]
        if i == 0:
            parts.append(_pack_mat(w, kx, fragments))
        elif i % cfg.skip_layer == 0:
            xrows = torch.zeros((kx, nw), dtype=w.dtype, device=w.device)
            xrows[:lx] = w[nw:]
            parts.append(_pack_mat(torch.cat([w[:nw], xrows]), nw + kx,
                                   fragments))
        else:
            parts.append(_pack_mat(w, nw, fragments))
    parts.append(params[D][0].t().reshape(-1))
    w_v0 = params[D + 1][0]
    parts.append(_pack_mat(w_v0[:nw], nw, fragments))
    parts.append(w_v0[nw:].reshape(-1))
    for j in range(1, Dc):
        parts.append(_pack_mat(params[D + 1 + j][0], cfg.net_width_condition,
                               fragments))
    parts.append(params[D + 1 + Dc][0].t().reshape(-1))
    return torch.cat(parts)


def _layout_t(params: Params, cfg: Config, fragments: bool):
    """W^T of the layers the train kernel's g-chain multiplies through:
    trunk layers 1..D-1 (their h rows) as [W, W], the first view layer's h
    rows as [Wc, W], further view layers as [Wc, Wc]
    (``csrc/train_level.cu``: wt_off)."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    nwc = cfg.net_width_condition
    parts = [_pack_mat(params[i][0][:nw].t(), nw, fragments)
             for i in range(1, D)]
    parts.append(_pack_mat(params[D + 1][0][:nw].t(), nwc, fragments))
    for j in range(1, Dc):
        parts.append(_pack_mat(params[D + 1 + j][0].t(), nwc, fragments))
    return torch.cat(parts)


def _layout_tx(params: Params, cfg: Config, fragments: bool):
    """W^T of the x rows, for the MLP backward's dX (``csrc/
    level_backward.cuh``: wtx_off): layer 0, then each skip layer's x rows,
    zero-padded to ``padded_location_features`` and transposed to [W, KX]."""
    D, nw = cfg.net_depth, cfg.net_width
    lx, kx = cfg.location_features, padded_location_features(cfg)
    parts = []
    for i in range(D):
        if i == 0 or i % cfg.skip_layer == 0:
            w = params[i][0]
            xrows = torch.zeros((kx, nw), dtype=w.dtype, device=w.device)
            xrows[:lx] = w if i == 0 else w[nw:]
            parts.append(_pack_mat(xrows.t(), nw, fragments))
    return torch.cat(parts)


_LAYOUTS = {"fwd": _layout, "t": _layout_t, "tx": _layout_tx}


@functools.lru_cache(maxsize=32)
def _pack_index(cfg: Config, fragments: bool, kind: str,
                device: torch.device) -> torch.Tensor:
    """Where each element of a packed layout comes from: 1 + its index in
    the weights flattened in layer order, 0 for padding. Built once per
    config by running the layout on index tensors."""
    idx, off = [], 1
    for i, o in layer_dims(cfg):
        idx.append((torch.arange(off, off + i * o).view(i, o), None))
        off += i * o
    return _LAYOUTS[kind](idx, cfg, fragments).to(device)


def _gather(params: Params, cfg: Config, dt: torch.dtype, kind: str):
    w = params[0][0]
    flat = torch.cat([w.new_zeros(1)] + [p.reshape(-1) for p, _ in params])
    idx = _pack_index(cfg, dt == torch.bfloat16, kind, w.device)
    return flat.to(dt)[idx]


def pack_params(params: Params, cfg: Config, dt: torch.dtype):
    """Weights and biases in the render kernel's flat layout (``_layout``),
    matrices the kernel multiplies on tensor cores in fragment order for
    bf16 and row-major for f32; one gather with a cached index."""
    b_flat = torch.cat([b.float().reshape(-1) for _, b in params])
    return _gather(params, cfg, dt, "fwd"), b_flat


def pack_params_t(params: Params, cfg: Config, dt: torch.dtype):
    """W^T of the chained layers in ``_layout_t``'s layout, one gather."""
    return _gather(params, cfg, dt, "t")


def pack_params_tx(params: Params, cfg: Config, dt: torch.dtype):
    """W^T of the x rows in ``_layout_tx``'s layout, one gather."""
    return _gather(params, cfg, dt, "tx")


def packed_tx_size(cfg: Config) -> int:
    """Length of ``pack_params_tx``'s buffer."""
    n_x = 1 + sum(1 for i in range(1, cfg.net_depth) if i % cfg.skip_layer == 0)
    return n_x * cfg.net_width * padded_location_features(cfg)


def packed_t_size(cfg: Config) -> int:
    """Length of ``pack_params_t``'s buffer."""
    W, Wc = cfg.net_width, cfg.net_width_condition
    return ((cfg.net_depth - 1) * W * W + W * Wc
            + (cfg.net_depth_condition - 1) * Wc * Wc)


def pack_train_params(params: Params, cfg: Config, dt: torch.dtype):
    """(weights, biases, W^T) in the train kernel's layouts: pack once per
    step for both levels."""
    w_flat, b_flat = pack_params(params, cfg, dt)
    return w_flat, b_flat, pack_params_t(params, cfg, dt)


def packed_sizes(cfg: Config) -> Tuple[int, int]:
    """Lengths of ``pack_params``'s weight and bias buffers."""
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    W, Wc, kx = cfg.net_width, cfg.net_width_condition, \
        padded_location_features(cfg)
    trunk = sum(
        ((0 if i == 0 else W) + (kx if i == 0 or i % cfg.skip_layer == 0
                                 else 0)) * W
        for i in range(D)
    )
    c_rgb, c_den = cfg.num_rgb_channels, cfg.num_density_channels
    n_w = (trunk + c_den * W + W * Wc + cfg.direction_features * Wc
           + (Dc - 1) * Wc * Wc + c_rgb * Wc)
    n_b = D * W + c_den + Dc * Wc + c_rgb
    return n_w, n_b


def _check(name: str, t: torch.Tensor, dtype, shape: Sequence[int],
           device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_level_inputs(cfg: Config, xs, d, delta, mode: str):
    """Validate one level's kernel inputs (both kernels take the same);
    returns the (means, variances, x) pointers, 0 where absent."""
    check_kernel_config(cfg)
    if mode not in _MODE_CODE:
        raise ValueError(f"unknown input mode {mode!r}")
    dt = compute_dtype(cfg)
    R, S = delta.shape
    N = R * S
    device = delta.device
    if device.type != "cuda":
        raise ValueError(f"delta must be a CUDA tensor, got {device}")
    _check("delta", delta, torch.float32, (R, S), device)
    _check("d", d, dt, (R, cfg.direction_features), device)
    if mode == "t":
        _check("x", xs, dt, (N, cfg.location_features), device)
        return 0, 0, xs.data_ptr()
    if cfg.location_features % 6:
        raise ValueError("mode mv needs location_features = 6F")
    means, variances = xs
    _check("means", means, torch.float32, (N, 3), device)
    _check("variances", variances, torch.float32, (N, 3), device)
    return means.data_ptr(), variances.data_ptr(), 0


def _library(source=None):
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("render_level", source)
    fn = lib.render_level_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i] + [p] * 10 + [i] * 12 + [f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def render_level_cuda(params: Params, cfg: Config, xs, d, delta,
                      white_bkgd: bool, mode: str,
                      packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      source=None):
    """Launch the CUDA kernel on the current stream. Same arguments and
    outputs as ``render_level_plain``; ``packed`` is ``pack_params``'s
    result when the caller already has it; ``source`` is another version
    of ``csrc/render_level.cu`` with the same C interface, to time versions
    in turns (``compare_kernels.py``)."""
    ptrs = _check_level_inputs(cfg, xs, d, delta, mode)
    dt = compute_dtype(cfg)
    R, S = delta.shape
    lx, fd = cfg.location_features, cfg.direction_features
    device = delta.device
    if packed is None:
        packed = pack_params(params, cfg, dt)
    w_flat, b_flat = packed
    n_w, n_b = packed_sizes(cfg)
    _check("packed weights", w_flat, dt, (n_w,), device)
    _check("packed biases", b_flat, torch.float32, (n_b,), device)

    comp = torch.empty((R, 3), dtype=torch.float32, device=device)
    acc = torch.empty((R,), dtype=torch.float32, device=device)
    weights = torch.empty((R, S), dtype=torch.float32, device=device)
    if R == 0:
        return comp, acc, weights
    fn = _library(source)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(
        _DTYPE_CODE[dt], _MODE_CODE[mode], *ptrs,
        d.data_ptr(), delta.data_ptr(), w_flat.data_ptr(),
        b_flat.data_ptr(), comp.data_ptr(), acc.data_ptr(),
        weights.data_ptr(),
        R, S, cfg.net_depth, cfg.net_width, cfg.skip_layer,
        cfg.net_width_condition, cfg.net_depth_condition, lx,
        padded_location_features(cfg), fd, cfg.min_deg_point,
        int(cfg.fast_ipe), float(cfg.density_bias), float(cfg.rgb_padding),
        int(white_bkgd), stream,
    )
    if err != 0:
        raise RuntimeError(f"render_level kernel launch failed: CUDA error {err}")
    render_level.launches += 1
    return comp, acc, weights


def render_level(params: Params, cfg: Config, xs, d, delta, white_bkgd: bool,
                 mode: str, packed=None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if delta.is_cuda:
        return render_level_cuda(params, cfg, xs, d, delta, white_bkgd, mode,
                                 packed=packed)
    return render_level_plain(params, cfg, xs, d, delta, white_bkgd, mode)


render_level.launches = 0


def fused_level_render(params: Params, cfg: Config, x_enc, dir_enc, t_vals,
                       dirs, white_bkgd: bool, means_covs=None, packed=None):
    """One level's render pass (MLP + activations + compositing) as a single
    kernel launch.

    Args:
      x_enc: [R, S, F] IPE features, or None with ``means_covs``;
      dir_enc: [R, Fd]; t_vals: [R, S+1]; dirs: [R, 3] (unnormalized);
      means_covs: ([R, S, 3] means, [R, S, 3] diagonal covariances): the
        IPE then runs inside the kernel (mode "mv").
    Returns:
      comp_rgb [R, 3], acc [R], weights [R, S].
    """
    num_rays, s = t_vals.shape[0], t_vals.shape[1] - 1
    dt = compute_dtype(cfg)
    if means_covs is not None:
        means, covs = means_covs
        n = num_rays * s
        xs = (means.reshape(n, 3).float().contiguous(),
              covs.reshape(n, 3).float().contiguous())
        mode = "mv"
    else:
        xs = x_enc.reshape(num_rays * s, x_enc.shape[-1]).to(dt).contiguous()
        mode = "t"
    d2d = dir_enc.reshape(num_rays, dir_enc.shape[-1]).to(dt).contiguous()
    delta = interval_lengths(t_vals, dirs).float().contiguous()
    return render_level(params, cfg, xs, d2d, delta, white_bkgd, mode,
                        packed=packed)


# ---------------------------------------------------------------------------
# The train level
# ---------------------------------------------------------------------------


def _composite_backward(cfg: Config, raw_rgb, raw_den, delta, pixels,
                        g_scale, white_bkgd: bool):
    """Composite, loss gradient g_scale * (comp - pixel) and the composite /
    activation backward of ``_composite_planes``. Returns comp [R,3],
    acc [R], weights [R,S], g_rgb [N,3] and g_den [N] (f32)."""
    R, S = delta.shape
    p = cfg.rgb_padding
    sig = torch.sigmoid(raw_rgb).view(R, S, 3)
    rgb = sig * (1.0 + 2.0 * p) - p
    sp_in = (raw_den + cfg.density_bias).view(R, S)
    alpha, trans, weights = composite_weights(softplus(sp_in), delta)
    acc = torch.sum(weights, dim=-1)
    comp = torch.einsum("rs,rsc->rc", weights, rgb)
    if white_bkgd:
        comp = comp + (1.0 - acc[:, None])
    g_comp = g_scale.reshape(R, 1) * (comp - pixels)
    dl_dw = (g_comp[:, None, 0] * rgb[..., 0] + g_comp[:, None, 1] * rgb[..., 1]
             + g_comp[:, None, 2] * rgb[..., 2])
    if white_bkgd:
        dl_dw = dl_dw - torch.sum(g_comp, dim=-1, keepdim=True)
    wdw = dl_dw * weights
    suffix = torch.sum(wdw, dim=-1, keepdim=True) - torch.cumsum(wdw, dim=-1)
    dl_dalpha = dl_dw * trans - suffix / torch.clamp(1.0 - alpha, min=1e-10)
    dl_dsigma = dl_dalpha * (1.0 - alpha) * delta
    g_rgb = ((g_comp[:, None, :] * weights[..., None])
             * (sig * (1.0 - sig) * (1.0 + 2.0 * p))).reshape(R * S, 3)
    g_den = (dl_dsigma * torch.sigmoid(sp_in)).reshape(R * S)
    return comp, acc, weights, g_rgb, g_den


def mlp_forward_acts(params: Params, cfg: Config, x, d, R: int, S: int,
                     dt: torch.dtype, keep: bool = True):
    """The kernels' MLP forward in plain PyTorch: operands rounded to ``dt``
    and multiplied in f32 (no TF32), ``relu(z + b)`` in f32 then rounded,
    the skip layer as ``h @ W_top + x @ W_bot``, the first view layer's
    ``d @ W_bot`` once per ray and broadcast to its S rows, f32 heads.

    Args: x [R*S, location_features] and d [R, direction_features] in
      ``dt``. Returns raw_rgb [N, C_rgb], raw_den [N, C_den] (f32) and the
      trunk and view activations (lists of [N, width] in ``dt``, empty
      unless ``keep``).
    """
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    hs, vs = [], []
    h = x
    for i in range(D):
        w, b = params[i]
        if i % cfg.skip_layer == 0 and i > 0:
            z = dense(h, w[:nw], dt) + dense(x, w[nw:], dt)
        else:
            z = dense(h, w, dt)
        h = torch.relu(z + b).to(dt)
        if keep:
            hs.append(h)
    w, b = params[D]
    raw_den = dense(h, w, dt) + b
    for j in range(Dc):
        w, b = params[D + 1 + j]
        if j == 0:
            dc = dense(d, w[nw:], dt)
            z = (dense(h, w[:nw], dt).view(R, S, -1) + dc[:, None, :])
            z = z.view(R * S, -1)
        else:
            z = dense(h, w, dt)
        h = torch.relu(z + b).to(dt)
        if keep:
            vs.append(h)
    w, b = params[D + 1 + Dc]
    raw_rgb = dense(h, w, dt) + b
    return raw_rgb, raw_den, hs, vs


def mlp_backward_plain(params: Params, cfg: Config, x, d, hs, vs, g_rgb,
                       g_den, R: int, S: int, dt: torch.dtype,
                       input_grads: bool = False):
    """The kernels' MLP backward in plain PyTorch, written out step by step
    with their rounding points (not autograd, which would round
    elsewhere): the f32 head cotangents rounded to ``dt`` as operands; the
    g-chain rounded to ``dt`` after every product; the density head's term
    added to the view chain in ``dt``; ReLU masks ``activation > 0``; dW
    from ``dt`` operands with f32 sums; db summed in f32; the view layer's
    direction rows from the per-ray f32 sum g_ray of its g.

    With ``input_grads``, also dX [N, location_features] in ``dt``,
    accumulated in ``dt`` (the skip layers' x-row terms from the deepest
    skip up, layer 0's chain last) and dD = round(g_ray) @ W_d^T
    [R, direction_features] in f32; else both are None.

    Args: ``mlp_forward_acts``' inputs and activations, g_rgb [N, C_rgb]
      and g_den [N, C_den] f32. Returns (d_params, dx, dd), d_params a
      list of (dW [fan_in, fan_out], db [fan_out]) f32 in layer order.
    """
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width

    def chain(g, w):
        """round(g @ w^T), compute-dtype operands, f32 sum."""
        return dense(g, w.t(), dt).to(dt)

    def dw(a, g):
        return dense(a.t(), g, dt)

    d_params = [None] * len(params)
    i_rgb = D + 1 + Dc
    d_params[i_rgb] = (dw(vs[-1], g_rgb), g_rgb.sum(0))
    g = chain(g_rgb, params[i_rgb][0])
    dd = None
    for j in reversed(range(Dc)):
        i = D + 1 + j
        g = g * (vs[j] > 0)
        db = g.float().sum(0)
        if j == 0:
            g_ray = g.float().view(R, S, -1).sum(1)
            d_params[i] = (torch.cat([dw(hs[-1], g), dw(d, g_ray)]), db)
            if input_grads:
                dd = dense(g_ray, params[i][0][nw:].t(), dt)
            g = chain(g, params[i][0][:nw])
        else:
            d_params[i] = (dw(vs[j - 1], g), db)
            g = chain(g, params[i][0])
    d_params[D] = (dw(hs[-1], g_den), g_den.sum(0))
    g = (g.float() + chain(g_den, params[D][0]).float()).to(dt)
    dx = None

    def add_dx(term):
        return term if dx is None else (dx.float() + term.float()).to(dt)

    for i in reversed(range(D)):
        g = g * (hs[i] > 0)
        db = g.float().sum(0)
        if i == 0:
            d_params[i] = (dw(x, g), db)
            if input_grads:
                dx = add_dx(chain(g, params[i][0]))
        elif i % cfg.skip_layer == 0:
            d_params[i] = (torch.cat([dw(hs[i - 1], g), dw(x, g)]), db)
            if input_grads:
                dx = add_dx(chain(g, params[i][0][nw:]))
            g = chain(g, params[i][0][:nw])
        else:
            d_params[i] = (dw(hs[i - 1], g), db)
            g = chain(g, params[i][0])
    return d_params, dx, dd


def level_train_plain(params: Params, cfg: Config, xs, d, delta, pixels,
                      g_scale, white_bkgd: bool, mode: str):
    """The train kernels' function in plain PyTorch with the kernels'
    rounding points: ``mlp_forward_acts`` keeping the activations, the
    composite backward in f32, then ``mlp_backward_plain`` (no dX or dD).

    It is also the plain version of the two-pass kernel
    (``_level_kernel_twopass``, ``csrc/train_level_twopass.cu``): the two
    passes split where the products run, not where they round. Its g-chain
    rounds g to the compute type after every product as here, its masked g
    and activations are parked in the compute type (which they already
    are), db is summed in f32 from those g and from the f32 head
    cotangents, and g_ray is rounded to the compute type before ``d^T
    g_ray``, as ``dense`` rounds its operands
    (``tests/test_torch_twopass.py`` holds this against the interpreted JAX
    kernel).

    Args: as ``render_level_plain``, plus pixels [R, 3] f32 and g_scale
      [R, 1] f32 (level_weight * 2 * mask / sum(mask)).
    Returns:
      comp [R, 3], acc [R], weights [R, S], and d_params: a list of
      (dW [fan_in, fan_out], db [fan_out]) f32 in layer order.
    """
    dt = compute_dtype(cfg)
    exact_f32(delta.device)
    R, S = delta.shape
    x = encode_mv(cfg, *xs, dt) if mode == "mv" else xs.to(dt)
    raw_rgb, raw_den, hs, vs = mlp_forward_acts(params, cfg, x, d, R, S, dt)
    comp, acc, weights, g_rgb, g_den = _composite_backward(
        cfg, raw_rgb, raw_den[:, 0], delta, pixels.float(), g_scale.float(),
        white_bkgd)
    d_params, _, _ = mlp_backward_plain(params, cfg, x, d, hs, vs, g_rgb,
                                        g_den[:, None], R, S, dt)
    return comp, acc, weights, d_params


def unpack_grads(flat: torch.Tensor, cfg: Config) -> Params:
    """The train kernel's flat f32 output (every dW as [fan_in, fan_out]
    row-major in layer order, then every db) as a list of (dW, db)."""
    dims = layer_dims(cfg)
    sizes = [i * o for i, o in dims] + [o for _, o in dims]
    parts = torch.split(flat, sizes)
    n = len(dims)
    return [(parts[k].view(dims[k]), parts[n + k]) for k in range(n)]


def train_splits(rows: int) -> int:
    """Row chunks of the dW products: about 4096 rows each, at most 32."""
    return max(1, min(32, -(-rows // 4096)))


def _train_library(name: str):
    """(launch, workspace) C functions of ``csrc/<name>.cu``; both train
    kernels have the same C interface."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    ws = getattr(lib, f"{name}_workspace")
    if fn.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = [i, i] + [p] * 14 + [ll, p] + [i] * 12 + [f, f, i, i, p]
        fn.restype = ctypes.c_int
        ws.argtypes = [i] * 9 + [ll]
        ws.restype = ll
    return fn, ws


def _launch_train(name: str, counted, params: Params, cfg: Config, xs, d,
                  delta, pixels, g_scale, white_bkgd: bool, mode: str,
                  packed):
    """Check the inputs, launch ``csrc/<name>.cu`` on the current stream
    and add one to ``counted.launches``."""
    ptrs = _check_level_inputs(cfg, xs, d, delta, mode)
    dt = compute_dtype(cfg)
    R, S = delta.shape
    N = R * S
    lx, fd = cfg.location_features, cfg.direction_features
    device = delta.device
    _check("pixels", pixels, torch.float32, (R, 3), device)
    gsc = g_scale.reshape(R)
    _check("g_scale", gsc, torch.float32, (R,), device)
    if packed is None:
        packed = pack_train_params(params, cfg, dt)
    w_flat, b_flat, wt_flat = packed
    n_w, n_b = packed_sizes(cfg)
    _check("packed weights", w_flat, dt, (n_w,), device)
    _check("packed biases", b_flat, torch.float32, (n_b,), device)
    _check("packed W^T", wt_flat, dt, (packed_t_size(cfg),), device)

    comp = torch.empty((R, 3), dtype=torch.float32, device=device)
    acc = torch.empty((R,), dtype=torch.float32, device=device)
    weights = torch.empty((R, S), dtype=torch.float32, device=device)
    n_out = num_params(cfg)
    grads = torch.empty((n_out,), dtype=torch.float32, device=device)
    if R == 0:
        return comp, acc, weights, unpack_grads(grads.zero_(), cfg)
    launch, workspace_bytes = _train_library(name)
    kx, splits = padded_location_features(cfg), train_splits(N)
    D, W, Wc, Dc = (cfg.net_depth, cfg.net_width, cfg.net_width_condition,
                    cfg.net_depth_condition)
    ws_bytes = workspace_bytes(_DTYPE_CODE[dt], R, S, D, W, Wc, Dc, kx,
                               splits, n_out)
    workspace = torch.empty((ws_bytes,), dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = launch(
        _DTYPE_CODE[dt], _MODE_CODE[mode], *ptrs, d.data_ptr(),
        delta.data_ptr(), pixels.data_ptr(), gsc.data_ptr(), w_flat.data_ptr(),
        wt_flat.data_ptr(), b_flat.data_ptr(), comp.data_ptr(),
        acc.data_ptr(), weights.data_ptr(), grads.data_ptr(), n_out,
        workspace.data_ptr(), R, S, D, W, cfg.skip_layer, Wc, Dc, lx, kx, fd,
        cfg.min_deg_point, int(cfg.fast_ipe), float(cfg.density_bias),
        float(cfg.rgb_padding), int(white_bkgd), splits, stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counted.launches += 1
    return comp, acc, weights, unpack_grads(grads, cfg)


def train_level_cuda(params: Params, cfg: Config, xs, d, delta, pixels,
                     g_scale, white_bkgd: bool, mode: str, packed=None):
    """Launch the train kernel on the current stream. Same arguments and
    outputs as ``level_train_plain``; ``packed`` is ``pack_train_params``'
    result when the caller already has it (once per step for both
    levels)."""
    return _launch_train("train_level", train_level, params, cfg, xs, d,
                         delta, pixels, g_scale, white_bkgd, mode, packed)


def train_level_twopass_cuda(params: Params, cfg: Config, x, d, delta,
                             pixels, g_scale, white_bkgd: bool, packed=None):
    """Launch the two-pass train kernel (``csrc/train_level_twopass.cu``)
    on the current stream: ``train_level_cuda`` in mode ``"t"``, the same
    outputs, in the TPU kernel's two phases (forward, composite and g-chain
    with db; then the dW products)."""
    return _launch_train("train_level_twopass", train_level_twopass, params,
                         cfg, x, d, delta, pixels, g_scale, white_bkgd, "t",
                         packed)


def train_level(params: Params, cfg: Config, xs, d, delta, pixels, g_scale,
                white_bkgd: bool, mode: str, packed=None):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors."""
    if delta.is_cuda:
        return train_level_cuda(params, cfg, xs, d, delta, pixels, g_scale,
                                white_bkgd, mode, packed=packed)
    return level_train_plain(params, cfg, xs, d, delta, pixels, g_scale,
                             white_bkgd, mode)


train_level.launches = 0


def train_level_twopass(params: Params, cfg: Config, x, d, delta, pixels,
                        g_scale, white_bkgd: bool, packed=None):
    """Plain version (``level_train_plain`` in mode ``"t"``) for CPU
    tensors; the two-pass CUDA kernel for CUDA tensors."""
    if delta.is_cuda:
        return train_level_twopass_cuda(params, cfg, x, d, delta, pixels,
                                        g_scale, white_bkgd, packed=packed)
    return level_train_plain(params, cfg, x, d, delta, pixels, g_scale,
                             white_bkgd, "t")


train_level_twopass.launches = 0


def fused_level_train(params: Params, cfg: Config, x_enc, dir_enc, t_vals,
                      dirs, pixels, g_scale, white_bkgd: bool,
                      means_covs=None, packed=None):
    """One level's full train pass (forward, loss gradient, backward) as
    one ``train_level`` call, or one ``train_level_twopass`` call with
    kernel_probes ``fl_variant=twopass`` in mode "t" (as the JAX package
    picks ``_level_kernel_twopass``). Probe values whose JAX kernels
    compute filler values raise NotImplementedError (``Config.check_probes``).

    Args:
      x_enc: [R, S, F] IPE features, or None with ``means_covs``
        ([R, S, 3] means, [R, S, 3] diagonal covariances; the IPE then runs
        inside the kernel, mode "mv");
      dir_enc: [R, Fd]; t_vals: [R, S+1]; dirs: [R, 3] (unnormalized);
      pixels: [R, 3]; g_scale: [R, 1] per-ray dL/dcomp scale
        (level_weight * 2 * mask / sum(mask));
      packed: ``pack_train_params``' result, once per step.
    Returns:
      comp_rgb [R, 3], acc [R], weights [R, S], d_params (list of
      (dW [fan_in, fan_out], db [fan_out]), f32).

    Valid only with ``stop_level_grad``: the sampled Gaussians are
    constants with respect to the parameters.
    """
    cfg.check_probes("fl_variant", "fm_bwd")
    num_rays, s = t_vals.shape[0], t_vals.shape[1] - 1
    dt = compute_dtype(cfg)
    if means_covs is not None:
        means, covs = means_covs
        n = num_rays * s
        xs = (means.reshape(n, 3).float().contiguous(),
              covs.reshape(n, 3).float().contiguous())
        mode = "mv"
    else:
        xs = x_enc.reshape(num_rays * s, x_enc.shape[-1]).to(dt).contiguous()
        mode = "t"
    d2d = dir_enc.reshape(num_rays, dir_enc.shape[-1]).to(dt).contiguous()
    delta = interval_lengths(t_vals, dirs).float().contiguous()
    pixels = pixels.float().contiguous()
    g_scale = g_scale.float().reshape(num_rays, 1).contiguous()
    if mode == "t" and cfg.probe("fl_variant") == "twopass":
        return train_level_twopass(params, cfg, xs, d2d, delta, pixels,
                                   g_scale, white_bkgd, packed=packed)
    return train_level(params, cfg, xs, d2d, delta, pixels, g_scale,
                       white_bkgd, mode, packed=packed)
