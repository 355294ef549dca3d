"""One render level (IPE + MLP forward + activations + compositing) as one
hand-written CUDA kernel, with its plain PyTorch version beside it.

The kernel (``csrc/render_level.cu``) replaces the TPU kernel
``nerf_or_nothing_tpu/kernels/fused_level.py::_render_kernel``. It takes
the sample means/variances [N, 3] and runs the IPE itself (mode ``"mv"``),
or takes encoded features [N, location_features] (mode ``"t"``); rows are
ray-major (row = ray * S + sample), features in the interleaved
[sin3, cos3]-per-frequency order, so no weight permutation is needed.

``render_level`` dispatches on the device of its inputs: CPU tensors go to
``render_level_plain``; CUDA tensors launch the kernel, or raise. There is
no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from nerf_or_nothing_tpu_torch.config import Config
from nerf_or_nothing_tpu_torch.models.mlp import Params, compute_dtype, dense
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
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    x = encode_mv(cfg, *xs, dt) if mode == "mv" else xs.to(dt)

    h = x
    for i in range(D):
        w, b = params[i]
        if i % cfg.skip_layer == 0 and i > 0:
            z = dense(h, w[:nw], dt) + dense(x, w[nw:], dt)
        else:
            z = dense(h, w, dt)
        h = torch.relu(z + b).to(dt)
    w, b = params[D]
    raw_den = (dense(h, w, dt) + b)[:, 0]

    for j in range(Dc):
        w, b = params[D + 1 + j]
        if j == 0:
            dc = dense(d, w[nw:], dt)                      # [R, Wc], per ray
            z = (dense(h, w[:nw], dt).view(R, S, -1) + dc[:, None, :])
            z = z.view(R * S, -1)
        else:
            z = dense(h, w, dt)
        h = torch.relu(z + b).to(dt)
    w, b = params[D + 1 + Dc]
    raw_rgb = dense(h, w, dt) + b

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


def check_kernel_config(cfg: Config) -> None:
    """Raise ValueError for configs the CUDA kernel does not take."""
    problems = []
    if cfg.net_width % 32 or not 32 <= cfg.net_width <= 256:
        problems.append("net_width must be a multiple of 32 in [32, 256]")
    if cfg.net_width_condition % 32 or not (
            32 <= cfg.net_width_condition <= cfg.net_width):
        problems.append(
            "net_width_condition must be a multiple of 32 in [32, net_width]"
        )
    if cfg.num_rgb_channels != 3 or cfg.num_density_channels != 1:
        problems.append("heads must be 3 rgb / 1 density")
    if cfg.net_depth < 1 or cfg.net_depth_condition < 1:
        problems.append("net_depth and net_depth_condition must be >= 1")
    if problems:
        raise ValueError("config not supported by the CUDA render kernel: "
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


def pack_params(params: Params, cfg: Config, dt: torch.dtype):
    """Weights and biases in the kernel's flat layout (layer order; see
    ``csrc/render_level.cu``): trunk layers as [K_pad, W] (x rows padded to
    ``padded_location_features``), density head [W], first view layer's
    h-rows [W, Wc] then d-rows [Fd, Wc] row-major, further view layers
    [Wc, Wc], rgb head transposed [3, Wc]. Matrices the kernel multiplies
    on tensor cores are in fragment order for bf16, row-major for f32."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    lx, kx = cfg.location_features, padded_location_features(cfg)

    def mat(w, k_pad):
        w = w.to(dt)
        if dt == torch.bfloat16:
            return _pack_mma(w, k_pad)
        wp = torch.zeros((k_pad, w.shape[1]), dtype=dt, device=w.device)
        wp[: w.shape[0]] = w
        return wp.reshape(-1)

    parts = []
    for i in range(D):
        w = params[i][0]
        if i == 0:
            parts.append(mat(w, kx))
        elif i % cfg.skip_layer == 0:
            xrows = torch.zeros((kx, nw), dtype=w.dtype, device=w.device)
            xrows[:lx] = w[nw:]
            parts.append(mat(torch.cat([w[:nw], xrows]), nw + kx))
        else:
            parts.append(mat(w, nw))
    parts.append(params[D][0][:, 0].to(dt))
    w_v0 = params[D + 1][0]
    parts.append(mat(w_v0[:nw], nw))
    parts.append(w_v0[nw:].to(dt).reshape(-1))
    for j in range(1, Dc):
        parts.append(mat(params[D + 1 + j][0], cfg.net_width_condition))
    parts.append(params[D + 1 + Dc][0].t().to(dt).reshape(-1))
    w_flat = torch.cat(parts).contiguous()
    b_flat = torch.cat([b.float().reshape(-1) for _, b in params]).contiguous()
    return w_flat, b_flat


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
    n_w = (trunk + W + W * Wc + cfg.direction_features * Wc
           + (Dc - 1) * Wc * Wc + 3 * Wc)
    n_b = D * W + 1 + Dc * Wc + 3
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
    check_kernel_config(cfg)
    if mode not in _MODE_CODE:
        raise ValueError(f"unknown input mode {mode!r}")
    dt = compute_dtype(cfg)
    R, S = delta.shape
    N = R * S
    lx, fd = cfg.location_features, cfg.direction_features
    device = delta.device
    if device.type != "cuda":
        raise ValueError(f"delta must be a CUDA tensor, got {device}")
    _check("delta", delta, torch.float32, (R, S), device)
    if mode == "mv":
        means, variances = xs
        _check("means", means, torch.float32, (N, 3), device)
        _check("variances", variances, torch.float32, (N, 3), device)
        x_ptr = 0
        if lx % 6:
            raise ValueError("mode mv needs location_features = 6F")
    else:
        _check("x", xs, dt, (N, lx), device)
        means = variances = None
        x_ptr = xs.data_ptr()
    _check("d", d, dt, (R, fd), device)
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
        _DTYPE_CODE[dt], _MODE_CODE[mode],
        means.data_ptr() if means is not None else 0,
        variances.data_ptr() if variances is not None else 0,
        x_ptr, d.data_ptr(), delta.data_ptr(), w_flat.data_ptr(),
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
