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

All three (and ``kernels/fused_mlp.py``'s two) have a wide route in the
same libraries, a GEMM launch a layer through a workspace: bf16 on
``wgmma`` on the same packed weights (``csrc/wide_forward.cuh``,
``csrc/wide_train.cuh``), f32 as 3xTF32 ``wgmma`` (``csrc/wide_f32.cuh``)
on the weights split once a step into TF32 hi / lo slab streams
(``pack_params_wf``, ``_wft``, ``_wfx``; the f32 packers lay them out
where every launch takes the wide route, ``f32_slabs``). A launch takes it
at net_width 288 and above, and
wherever the narrow route's shared memory does not hold the config (wide
location features, a large head): ``takes_wide`` picks the route before
any launch. It has no width or feature ceiling: any config runs, as far
as the card's memory holds the workspace (``torch.empty`` raises when it
does not).

Widths that are not multiples of 32, and a net_width_condition above
net_width, run zero-padded (``kernel_cfg``): the packers embed the weights
in zeros at the rounded-up widths, the wrappers pass those widths to C and
drop the padded rows and columns of dW/db.

``render_level``, ``train_level`` and ``train_level_twopass`` dispatch on
the device of their inputs: CPU tensors go to the plain version; CUDA
tensors launch the kernel, or raise. There is no fallback from the card to
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
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
from nerf_or_nothing_tpu_torch.ops.math_utils import (
    exact_f32,
    softplus,
    split_tf32,
)
from nerf_or_nothing_tpu_torch.ops.render import (
    composite_weights,
    interval_lengths,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Added to a dtype code: the wide route at any width (csrc: kWideRoute).
WIDE_ROUTE = 2
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


MAX_WIDTH = 256  # the narrow routes' widest net_width; wider takes the wide route


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def kernel_cfg(cfg: Config) -> Config:
    """The config the kernels run: net_width rounded up to a multiple of 32
    of max(net_width, net_width_condition), net_width_condition rounded up
    to a multiple of 32. ``cfg`` itself when both already are (and
    net_width_condition <= net_width), so those configs pack and launch as
    they always did.

    The packers embed each layer's weights in zeros at these widths
    (``_embed_layers``; biases zero on the padded columns), the wrappers
    pass them to C, and the un-embedding drops the padded rows and columns
    of dW/db (``unembed_grads``). The padding is exact: a padded column is
    ReLU(0 + 0) = 0 and its outgoing rows are zero, so it adds exact zeros
    to every later sum; its g is zero, so its dW, db and dX terms are zero.
    Its cost is the padded FLOPs: ``utils/profiling.level_flops`` at the
    two configs, which ``chip_smoke.py``'s padded_widths phase prints
    beside each kernel's time."""
    W, Wc = cfg.net_width, cfg.net_width_condition
    kw, kwc = _round32(max(W, Wc)), _round32(Wc)
    if (kw, kwc) == (W, Wc):
        return cfg
    return _padded_cfg(cfg, kw, kwc)


@functools.lru_cache(maxsize=32)
def _padded_cfg(cfg: Config, W: int, Wc: int) -> Config:
    return cfg.replace(net_width=W, net_width_condition=Wc)


def uses_wide(cfg: Config) -> bool:
    """Whether every kernel takes its wide route by width alone (bf16:
    ``csrc/wide_forward.cuh``, ``csrc/wide_train.cuh``, f32:
    ``csrc/wide_f32.cuh``): a kernel net_width (``kernel_cfg``) above
    ``MAX_WIDTH``, in either compute dtype. ``takes_wide`` is the route of
    one launch, which also goes wide where the narrow route's shared
    memory does not hold the config."""
    return kernel_cfg(cfg).net_width > MAX_WIDTH


def check_kernel_config(cfg: Config, any_heads: bool = False) -> None:
    """Raise ValueError for configs the CUDA kernels do not take. The level
    kernels composite 3 rgb / 1 density channels; the MLP kernels
    (``kernels/fused_mlp.py``, ``any_heads``) take heads of any channel
    count from 1. Every net_width and net_width_condition of at least 1
    is taken, as ``kernel_cfg`` rounds them up, and every feature count,
    on the route ``takes_wide`` picks for each launch, with no ceiling but
    the card's memory."""
    problems = []
    if min(cfg.net_width, cfg.net_width_condition) < 1:
        problems.append("net_width and net_width_condition must be >= 1")
    heads = (cfg.num_rgb_channels, cfg.num_density_channels)
    if not any_heads and heads != (3, 1):
        problems.append("heads must be 3 rgb / 1 density")
    if any_heads and min(heads) < 1:
        problems.append("heads must have at least 1 channel each")
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


def _chain_mats(params: Params, cfg: Config):
    """W^T of the layers the train kernel's g-chain multiplies through:
    trunk layers 1..D-1 (their h rows) as [W, W], the first view layer's h
    rows as [Wc, W], further view layers as [Wc, Wc]."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    return ([params[i][0][:nw].t() for i in range(1, D)]
            + [params[D + 1][0][:nw].t()]
            + [params[D + 1 + j][0].t() for j in range(1, Dc)])


def _dx_mats(params: Params, cfg: Config):
    """W^T of the x rows, for the MLP backward's dX: layer 0, then each
    skip layer's x rows, zero-padded to ``padded_location_features`` and
    transposed to [W, KX]."""
    D, nw = cfg.net_depth, cfg.net_width
    lx, kx = cfg.location_features, padded_location_features(cfg)
    out = []
    for i in range(D):
        if i == 0 or i % cfg.skip_layer == 0:
            w = params[i][0]
            xrows = torch.zeros((kx, nw), dtype=w.dtype, device=w.device)
            xrows[:lx] = w if i == 0 else w[nw:]
            out.append(xrows.t())
    return out


def _layout_t(params: Params, cfg: Config, fragments: bool):
    """``_chain_mats`` as ``_pack_mat`` (``csrc/train_level.cu``: wt_off)."""
    return torch.cat([_pack_mat(m, m.shape[0], fragments)
                      for m in _chain_mats(params, cfg)])


def _layout_tx(params: Params, cfg: Config, fragments: bool):
    """``_dx_mats`` as ``_pack_mat`` (``csrc/level_backward.cuh``:
    wtx_off)."""
    return torch.cat([_pack_mat(m, m.shape[0], fragments)
                      for m in _dx_mats(params, cfg)])


WG_SLAB_K = 64    # K rows of one weight slab: 128 bytes of bf16
F32_SLAB_K = 32   # K rows of one f32 slab: 128 bytes of f32
WG_HEAD_N = 8     # columns of one head group: one m64n8k16 product


def _wg_slabs(w: torch.Tensor, k: int = WG_SLAB_K) -> torch.Tensor:
    """A [K, N] matrix as the ``wgmma`` B operand of ``csrc/forward_wg.cuh``
    (``k`` = ``WG_SLAB_K``, bf16) or of ``csrc/wide_f32.cuh`` (``k`` =
    ``F32_SLAB_K``, f32): K zero-padded to whole slabs of ``k``; slab s
    holds W^T rows n = 0..N-1 of k k-values each (128 bytes), the 16-byte
    chunk c of row n stored at chunk position c ^ (n % 8) (the 128-byte
    swizzle)."""
    K, N = w.shape
    ns = -(-K // k)
    wp = torch.zeros((ns * k, N), dtype=w.dtype, device=w.device)
    wp[:K] = w
    t = wp.t().reshape(N, ns, 8, k // 8)             # [n, slab, chunk, e]
    pos = torch.arange(8, device=w.device)
    src = pos[None, :] ^ (torch.arange(N, device=w.device)[:, None] % 8)
    t = t[torch.arange(N, device=w.device)[:, None], :, src]  # [n, pos, slab, e]
    return t.permute(2, 0, 1, 3).reshape(-1)


def _head_cols(c: int) -> int:
    """Columns of a head of ``c`` channels in the slab stream: whole groups
    of ``WG_HEAD_N``."""
    return -(-c // WG_HEAD_N) * WG_HEAD_N


def _wg_head(w: torch.Tensor) -> torch.Tensor:
    """A head [K, C] as groups of ``WG_HEAD_N`` columns (the last one
    zero-padded), group after group, each as slabs: the kernels run a group
    as one N=8 product (a head of up to 8 channels is one group, as
    before)."""
    K, C = w.shape
    wp = torch.zeros((K, _head_cols(C)), dtype=w.dtype, device=w.device)
    wp[:, :C] = w
    return torch.cat([_wg_slabs(wp[:, g:g + WG_HEAD_N])
                      for g in range(0, wp.shape[1], WG_HEAD_N)])


def _layout_wg(params: Params, cfg: Config, fragments: bool):
    """The bf16 forward's weight stream (``csrc/forward_wg.cuh``): every
    matrix as ``_wg_slabs`` in the order the kernel multiplies them, so one
    block reads the pack front to back once per 128 rows. Trunk layer i:
    its h rows, then (layer 0 and skip layers) its x rows padded to whole
    slabs; the density head (``_wg_head``: groups of 8 columns); the first
    view layer's h rows; further view layers; the rgb head (groups of 8
    columns). Then the first view layer's direction rows, row-major
    [Fd, Wc], for the per-ray term.
    ``fragments`` is unused: the layout is the same for every dtype."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    parts = []
    for i in range(D):
        w = params[i][0]
        if i > 0:
            parts.append(_wg_slabs(w[:nw]))
        if i == 0 or i % cfg.skip_layer == 0:
            parts.append(_wg_slabs(w if i == 0 else w[nw:]))
    parts.append(_wg_head(params[D][0]))
    parts.append(_wg_slabs(params[D + 1][0][:nw]))
    for j in range(1, Dc):
        parts.append(_wg_slabs(params[D + 1 + j][0]))
    parts.append(_wg_head(params[D + 1 + Dc][0]))
    parts.append(params[D + 1][0][nw:].reshape(-1))
    return torch.cat(parts)


def _layout_wgt(params: Params, cfg: Config, fragments: bool):
    """The bf16 train kernel's g-chain stream (``csrc/train_wg.cuh``): each
    chained layer's W^T as ``_wg_slabs`` (its K-major form is W's own rows)
    in the chain's order, top layer first: view layers Dc-1 .. 1 [Wc, Wc],
    the first view layer's h rows [Wc, W], trunk layers D-1 .. 1 [W, W].
    Then the heads' W^T row-major: rgb [C_rgb, Wc], density [C_den, W].
    ``fragments`` is unused."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    parts = [_wg_slabs(params[D + 1 + j][0].t()) for j in range(Dc - 1, 0, -1)]
    parts.append(_wg_slabs(params[D + 1][0][:nw].t()))
    parts += [_wg_slabs(params[i][0][:nw].t()) for i in range(D - 1, 0, -1)]
    parts.append(params[D + 1 + Dc][0].t().reshape(-1))
    parts.append(params[D][0].t().reshape(-1))
    return torch.cat(parts)


def dx_width(cfg: Config) -> int:
    """Columns of the x rows' W^T in ``_layout_wgx`` (the dX product's N):
    ``padded_location_features`` rounded up to 32, a width the kernels'
    ``wgmma`` products have."""
    return -(-padded_location_features(cfg) // 32) * 32


def _layout_wgx(params: Params, cfg: Config, fragments: bool):
    """``mlp_bwd``'s bf16 g-chain stream (``csrc/train_wg.cuh``, kDx): the
    chain stream of ``_layout_wgt`` with, in the chain's order, W_x^T of
    layer 0 and of each skip layer ([W, LX] zero-padded to ``dx_width``
    columns) as slabs before that layer's h rows: view layers Dc-1 .. 1,
    the first view layer's h rows, then for trunk layer i = D-1 .. 0 its
    x rows (layer 0 and skip layers) and its h rows (i >= 1). Then the
    heads' W^T row-major. ``fragments`` is unused."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    lx, nxw = cfg.location_features, dx_width(cfg)
    parts = [_wg_slabs(params[D + 1 + j][0].t()) for j in range(Dc - 1, 0, -1)]
    parts.append(_wg_slabs(params[D + 1][0][:nw].t()))
    for i in range(D - 1, -1, -1):
        w = params[i][0]
        if i == 0 or i % cfg.skip_layer == 0:
            xt = torch.zeros((nw, nxw), dtype=w.dtype, device=w.device)
            xt[:, :lx] = (w if i == 0 else w[nw:]).t()
            parts.append(_wg_slabs(xt))
        if i > 0:
            parts.append(_wg_slabs(w[:nw].t()))
    parts.append(params[D + 1 + Dc][0].t().reshape(-1))
    parts.append(params[D][0].t().reshape(-1))
    return torch.cat(parts)


def _layout_wfs(params: Params, cfg: Config, fragments: bool):
    """The f32 wide route's forward slabs (``csrc/wide_f32.cuh``:
    ``WideF32Route``), one copy: every product's B as ``_wg_slabs`` of
    ``F32_SLAB_K`` in the order the forward multiplies them: trunk layer i
    (its h rows for i >= 1, then its x rows for layer 0 and the skip
    layers, each part padded to whole slabs), the first view layer's h
    rows, further view layers. ``fragments`` is unused."""
    D, Dc, nw = cfg.net_depth, cfg.net_depth_condition, cfg.net_width
    parts = []
    for i in range(D):
        w = params[i][0]
        if i > 0:
            parts.append(_wg_slabs(w[:nw], F32_SLAB_K))
        if i == 0 or i % cfg.skip_layer == 0:
            parts.append(_wg_slabs(w if i == 0 else w[nw:], F32_SLAB_K))
    parts.append(_wg_slabs(params[D + 1][0][:nw], F32_SLAB_K))
    for j in range(1, Dc):
        parts.append(_wg_slabs(params[D + 1 + j][0], F32_SLAB_K))
    return torch.cat(parts)


def _layout_wfts(params: Params, cfg: Config, fragments: bool):
    """The f32 wide g-chain's slabs, one copy: ``_chain_mats`` as
    ``_wg_slabs`` of ``F32_SLAB_K`` (their K-major rows are W's own); every
    K is a multiple of 32, so each matrix starts where ``_layout_t`` puts it
    (``wt_off``). ``fragments`` is unused."""
    return torch.cat([_wg_slabs(m, F32_SLAB_K)
                      for m in _chain_mats(params, cfg)])


def _layout_wfxs(params: Params, cfg: Config, fragments: bool):
    """The f32 wide dX's slabs, one copy: ``_dx_mats`` as ``_wg_slabs`` of
    ``F32_SLAB_K``, at ``_layout_tx``'s offsets (``wtx_off``).
    ``fragments`` is unused."""
    return torch.cat([_wg_slabs(m, F32_SLAB_K)
                      for m in _dx_mats(params, cfg)])


_LAYOUTS = {"fwd": _layout, "t": _layout_t, "tx": _layout_tx, "wg": _layout_wg,
            "wgt": _layout_wgt, "wgx": _layout_wgx, "wfs": _layout_wfs,
            "wfts": _layout_wfts, "wfxs": _layout_wfxs}


def _layer_blocks(cfg: Config):
    """Per layer in layer order: the row blocks of its fan_in (h rows, then
    the x rows of a skip layer or the d rows of the first view layer) and
    its fan_out."""
    D, W, Wc = cfg.net_depth, cfg.net_width, cfg.net_width_condition
    lx, fd = cfg.location_features, cfg.direction_features
    blocks = [((lx,), W)]
    blocks += [((W, lx) if i % cfg.skip_layer == 0 else (W,), W)
               for i in range(1, D)]
    blocks.append(((W,), cfg.num_density_channels))
    blocks.append(((W, fd), Wc))
    blocks += [((Wc,), Wc)] * (cfg.net_depth_condition - 1)
    blocks.append(((Wc,), cfg.num_rgb_channels))
    return blocks


def _embed_layers(mats: Sequence[torch.Tensor], cfg: Config):
    """Each layer's [fan_in, fan_out] matrix (or [fan_out] bias) at
    ``cfg``'s widths embedded in zeros at ``kernel_cfg(cfg)``'s: every row
    block at the start of its padded block (the x rows of a skip layer and
    the d rows of the first view layer after the padded h rows), the
    columns at the start of the padded columns. The one embedding of every
    packed layout, the biases and, inverted, the grads."""
    out = []
    for m, (rows, _), (krows, kcols) in zip(
            mats, _layer_blocks(cfg), _layer_blocks(kernel_cfg(cfg))):
        if m.dim() == 1:
            e = m.new_zeros(kcols)
            e[:m.shape[0]] = m
            out.append(e)
            continue
        e = m.new_zeros((sum(krows), kcols))
        r0 = k0 = 0
        for r, kr in zip(rows, krows):
            e[k0:k0 + r, :m.shape[1]] = m[r0:r0 + r]
            r0, k0 = r0 + r, k0 + kr
        out.append(e)
    return out


def embed_params(params: Params, cfg: Config) -> Params:
    """``params`` at ``kernel_cfg(cfg)``'s widths, zero-padded
    (``_embed_layers``): what the kernels compute with."""
    if kernel_cfg(cfg) is cfg:
        return params
    return list(zip(_embed_layers([w for w, _ in params], cfg),
                    _embed_layers([b for _, b in params], cfg)))


def _index_layers(cfg: Config, biases: bool):
    """Each layer's weights (or biases) as 1 + their index in the weights
    (biases) flattened in layer order."""
    out, off = [], 1
    for i, o in layer_dims(cfg):
        shape = (o,) if biases else (i, o)
        out.append(torch.arange(off, off + math.prod(shape)).view(shape))
        off += math.prod(shape)
    return out


@functools.lru_cache(maxsize=32)
def _pack_index(cfg: Config, fragments: bool, kind: str,
                device: torch.device) -> torch.Tensor:
    """Where each element of a packed layout comes from: 1 + its index in
    the weights flattened in layer order, 0 for padding. Built once per
    config by running the layout on index tensors, embedded at the
    kernel widths (``kernel_cfg``)."""
    idx = _index_layers(cfg, False)
    kc = kernel_cfg(cfg)
    if kc is not cfg:
        idx = _embed_layers(idx, cfg)
    return _LAYOUTS[kind]([(m, None) for m in idx], kc, fragments).to(device)


@functools.lru_cache(maxsize=32)
def _bias_index(cfg: Config, device: torch.device) -> torch.Tensor:
    """The biases' gather at the kernel widths: 1 + index, 0 for padding."""
    return torch.cat(_embed_layers(_index_layers(cfg, True), cfg)).to(device)


def _gather(params: Params, cfg: Config, dt: torch.dtype, kind: str):
    w = params[0][0]
    flat = torch.cat([w.new_zeros(1)] + [p.reshape(-1) for p, _ in params])
    idx = _pack_index(cfg, dt == torch.bfloat16, kind, w.device)
    return flat.to(dt)[idx]


def _pack_biases(params: Params, cfg: Config) -> torch.Tensor:
    """Every bias in layer order, f32, at the kernel widths (zero on padded
    columns: one gather with a cached index)."""
    if kernel_cfg(cfg) is cfg:
        return torch.cat([b.float().reshape(-1) for _, b in params])
    device = params[0][1].device
    flat = torch.cat([torch.zeros(1, device=device)]
                     + [b.float().reshape(-1) for _, b in params])
    return flat[_bias_index(cfg, device)]


@functools.lru_cache(maxsize=32)
def _unembed_index(cfg: Config, device: torch.device) -> torch.Tensor:
    """For each element of the grads at ``cfg`` (every dW, then every db),
    its position in the kernels' grads at the kernel widths: the inverse
    of ``_embed_layers``."""
    dws = _index_layers(cfg, False)
    n_w = sum(m.numel() for m in dws)
    dbs = [m + n_w for m in _index_layers(cfg, True)]
    emb = torch.cat([m.reshape(-1) for m in _embed_layers(dws, cfg)]
                    + _embed_layers(dbs, cfg))
    pos = torch.nonzero(emb).reshape(-1)
    inv = torch.empty(num_params(cfg), dtype=torch.long)
    inv[emb[pos] - 1] = pos
    return inv.to(device)


def unembed_grads(flat: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The kernels' flat grads at ``kernel_cfg(cfg)``'s widths as the flat
    grads at ``cfg``'s (``unpack_grads``' layout): one cached gather that
    drops the padded rows and columns; ``flat`` itself when nothing is
    padded."""
    if kernel_cfg(cfg) is cfg:
        return flat
    return flat[_unembed_index(cfg, flat.device)]


def pack_params(params: Params, cfg: Config, dt: torch.dtype):
    """Weights and biases in the render kernel's flat layout (``_layout``),
    matrices the kernel multiplies on tensor cores in fragment order for
    bf16 and row-major for f32; one gather with a cached index."""
    return _gather(params, cfg, dt, "fwd"), _pack_biases(params, cfg)


def pack_params_t(params: Params, cfg: Config, dt: torch.dtype):
    """W^T of the chained layers in ``_layout_t``'s layout, one gather."""
    return _gather(params, cfg, dt, "t")


def pack_params_tx(params: Params, cfg: Config, dt: torch.dtype):
    """W^T of the x rows in ``_layout_tx``'s layout, one gather."""
    return _gather(params, cfg, dt, "tx")


def pack_params_wg(params: Params, cfg: Config, dt: torch.dtype):
    """Weights in ``_layout_wg``'s slab stream and the biases, one gather.
    The bf16 forward kernels read it; any ``dt`` packs (the CPU tests run
    the slab stream in f32)."""
    return _gather(params, cfg, dt, "wg"), _pack_biases(params, cfg)


def pack_params_wgt(params: Params, cfg: Config, dt: torch.dtype):
    """The g-chain stream of ``_layout_wgt``, one gather."""
    return _gather(params, cfg, dt, "wgt")


def pack_params_wgx(params: Params, cfg: Config, dt: torch.dtype):
    """The g-chain stream with the x rows, ``_layout_wgx``, one gather."""
    return _gather(params, cfg, dt, "wgx")


def tf32_pair(stream: torch.Tensor) -> torch.Tensor:
    """An f32 slab stream split as the f32 wide GEMM takes its B: hi =
    rna_tf32(w) (``ops/math_utils.tf32_round``, a NaN as the quiet NaN, which
    the tensor core's truncation keeps a NaN), then lo = rna_tf32(w - hi),
    each the whole stream: hi + lo is w within 2^-22 of |w|."""
    hi, _ = split_tf32(stream)
    hi = torch.where(torch.isnan(hi), float("nan"), hi)
    return torch.cat([hi, split_tf32(stream.float() - hi)[0]])


def pack_params_wf(params: Params, cfg: Config, dt: torch.dtype):
    """The f32 wide route's weights (``csrc/wide_f32.cuh``) and the biases:
    ``pack_params``' layout (the heads and the direction rows are read
    there), then ``_layout_wfs``' forward slabs as ``tf32_pair``; two
    gathers with cached indices. ``dt`` must be f32."""
    w = torch.cat([_gather(params, cfg, dt, "fwd"),
                   tf32_pair(_gather(params, cfg, dt, "wfs"))])
    return w, _pack_biases(params, cfg)


def pack_params_wft(params: Params, cfg: Config, dt: torch.dtype):
    """The f32 wide g-chain's slabs, ``_layout_wfts`` as ``tf32_pair``."""
    return tf32_pair(_gather(params, cfg, dt, "wfts"))


def pack_params_wfx(params: Params, cfg: Config, dt: torch.dtype):
    """The f32 wide dX's slabs, ``_layout_wfxs`` as ``tf32_pair``."""
    return tf32_pair(_gather(params, cfg, dt, "wfxs"))


def f32_slabs(cfg: Config, layout: str = "wf",
              wide: Optional[bool] = None) -> bool:
    """Whether f32 weights are packed as the wide route's slab streams
    (``pack_params_wf``, ``_wft``, ``_wfx``): for a kernel reading
    ``layout`` ``"wf"`` (``weight_layout``; earlier versions read the
    row-major layouts on both f32 routes) on the wide route: ``wide``, or
    by default ``uses_wide(cfg)``, where every launch takes it. A launch
    that takes the wide route below that (its features or heads past the
    narrow route's shared memory) packs the streams itself
    (``repack_f32``)."""
    if compute_dtype(cfg) != torch.float32 or layout != "wf":
        return False
    return uses_wide(cfg) if wide is None else wide


def repack_f32(cfg: Config, layout: str, wide: bool) -> bool:
    """Whether a launch on route ``wide`` reading ``layout`` needs other f32
    weights than the default packing gives (``f32_slabs``): the wide route
    below a kernel net_width of 288."""
    return f32_slabs(cfg, layout, wide) != f32_slabs(cfg, layout)


def pack_forward(params: Params, cfg: Config, dt: torch.dtype,
                 layout: str = "wf", wide: Optional[bool] = None):
    """The forward kernels' (``render_level``, ``mlp_fwd``) weights: the
    ``"wg"`` slab stream for bf16; for f32 ``pack_params_wf``'s slab
    streams where ``f32_slabs`` says so (the wide route of a kernel reading
    ``layout``), else ``pack_params``' row-major layout."""
    if dt == torch.bfloat16:
        return pack_params_wg(params, cfg, dt)
    if f32_slabs(cfg, layout, wide):
        return pack_params_wf(params, cfg, dt)
    return pack_params(params, cfg, dt)


def _slabs(k: int) -> int:
    return -(-k // WG_SLAB_K)


def packed_wfs_size(cfg: Config) -> int:
    """Length of one copy of ``_layout_wfs``' slabs (``WideF32Route::len``)."""
    cfg = kernel_cfg(cfg)
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    W, Wc, K = cfg.net_width, cfg.net_width_condition, F32_SLAB_K
    nh, nc = -(-W // K), -(-Wc // K)
    nx = -(-padded_location_features(cfg) // K)
    trunk = sum((0 if i == 0 else nh) + (nx if i == 0 or i % cfg.skip_layer == 0
                                         else 0) for i in range(D)) * W * K
    return trunk + (nh * Wc + (Dc - 1) * nc * Wc) * K


def packed_wf_size(cfg: Config) -> int:
    """Length of ``pack_params_wf``'s weight buffer."""
    return packed_sizes(cfg)[0] + 2 * packed_wfs_size(cfg)


def packed_wg_size(cfg: Config) -> int:
    """Length of ``pack_params_wg``'s weight buffer."""
    cfg = kernel_cfg(cfg)
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    W, Wc, S = cfg.net_width, cfg.net_width_condition, WG_SLAB_K
    nx = _slabs(cfg.location_features)
    trunk = sum((0 if i == 0 else _slabs(W))
                + (nx if i == 0 or i % cfg.skip_layer == 0 else 0)
                for i in range(D)) * W * S
    return (trunk + _slabs(W) * _head_cols(cfg.num_density_channels) * S
            + _slabs(W) * Wc * S + (Dc - 1) * _slabs(Wc) * Wc * S
            + _slabs(Wc) * _head_cols(cfg.num_rgb_channels) * S
            + cfg.direction_features * Wc)


def packed_wgt_size(cfg: Config) -> int:
    """Length of ``pack_params_wgt``'s buffer."""
    cfg = kernel_cfg(cfg)
    D, Dc = cfg.net_depth, cfg.net_depth_condition
    W, Wc, S = cfg.net_width, cfg.net_width_condition, WG_SLAB_K
    nh, nc = _slabs(W), _slabs(Wc)
    return (((Dc - 1) * nc * Wc + nc * W + (D - 1) * nh * W) * S
            + cfg.num_rgb_channels * Wc + cfg.num_density_channels * W)


def _x_layers(cfg: Config) -> int:
    """Layers that multiply the features: layer 0 and the skip layers."""
    return 1 + sum(1 for i in range(1, cfg.net_depth)
                   if i % cfg.skip_layer == 0)


def packed_wgx_size(cfg: Config) -> int:
    """Length of ``pack_params_wgx``'s buffer."""
    cfg = kernel_cfg(cfg)
    return packed_wgt_size(cfg) + (_x_layers(cfg) * _slabs(cfg.net_width)
                                   * dx_width(cfg) * WG_SLAB_K)


SMEM_LIMIT = 232448  # bytes of shared memory one block may have (sm_90)
WG_ROWS = 128        # rows of one round: two consumer warpgroups x 64


def wg_rays_per_group(cfg: Config, S: int) -> int:
    """Rays of one work unit of the bf16 forward (``forward_wg.cuh``:
    ``wg_rays``): whole rays filling 128 rows, with each of the two
    buffers of the per-ray direction term [rays, Wc] f32 held to 16 KB
    (Wc of ``kernel_cfg``)."""
    return max(1, min(WG_ROWS // S,
                      4096 // kernel_cfg(cfg).net_width_condition))


def wg_smem(cfg: Config, S: int, composite: bool):
    """(bytes, ring stages) of the bf16 forward's shared memory, as
    ``forward_wg.cuh::init_wg`` computes it: the ring of weight slabs
    (``stages`` x W x 128 bytes), two activation tiles [64, W] and two
    feature tiles [64, KX padded to 64] in bf16, the raw heads of two
    rounds (render only), the direction terms of two units, the barriers
    and 1 KB for the alignment of the tiles. The ring takes 4 stages, else
    3, else 2; bytes is None when not even 2 fit. Widths are
    ``kernel_cfg``'s."""
    cfg = kernel_cfg(cfg)
    W = cfg.net_width
    nx = _slabs(padded_location_features(cfg))
    fixed = (1024 + 2 * 8192 * _slabs(W) + 2 * 8192 * nx
             + (2 * WG_ROWS * 16 if composite else 0)
             + 2 * wg_rays_per_group(cfg, S) * cfg.net_width_condition * 4)
    for stages in (4, 3, 2):
        total = fixed + stages * W * 128 + 16 * stages
        if total <= SMEM_LIMIT:
            return total, stages
    return None, 0


def chain_wg_smem(cfg: Config, dx: bool = False):
    """(bytes, ring stages) of the bf16 g-chain's shared memory, as
    ``train_wg.cuh::init_chain`` computes it: the ring (``stages`` slots of
    the widest slab: W, with ``dx`` also ``dx_width`` rows of 128 bytes),
    two masked-g tiles [64, W] in bf16, with ``dx`` the two consumers' dX
    partials [64, dx_width] in bf16, the helpers' column partials (2 x 96 x
    8 f32), the block's db (every bias, f32), the barriers and 1 KB of
    alignment. bytes is None when not even 2 stages fit, or (``dx``) the x
    rows are wider than 256. Widths are ``kernel_cfg``'s."""
    cfg = kernel_cfg(cfg)
    W = cfg.net_width
    nxw = dx_width(cfg) if dx else 0
    if nxw > 256:
        return None, 0
    n_b = packed_sizes(cfg)[1]
    fixed = (1024 + 2 * 8192 * _slabs(W) + 2 * 64 * nxw * 2 + 2 * 96 * 8 * 4
             + -(-n_b * 4 // 16) * 16)
    for stages in (4, 3, 2):
        total = fixed + stages * max(W, nxw) * 128 + 16 * stages
        if total <= SMEM_LIMIT:
            return total, stages
    return None, 0


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def f32_smem(cfg: Config, kernel: str, S: int, input_grads: bool = False):
    """Bytes of shared memory of the largest block that ``kernel``'s narrow
    f32 route launches at ``S`` samples a ray, as its C source computes it
    (``level_common.cuh::smem_bytes``: the activation and feature tiles
    [64, W + 4] and [64, KX + 4], the direction terms and raw heads of the
    block's rays and two staged weight tiles; ``level_backward.cuh::
    chain_smem``: the g-chain's tiles, with ``input_grads`` the dX tile,
    and the head cotangents [64, Cr + Cd]); None when it exceeds
    ``SMEM_LIMIT``, or with ``input_grads`` when the x rows are wider than
    the 256 columns of one product. Widths are ``kernel_cfg``'s."""
    kc = kernel_cfg(cfg)
    W, Wc = kc.net_width, kc.net_width_condition
    KX = padded_location_features(cfg)
    RB = 1 if S >= 64 else 64 // S
    h, x = _align16(4 * 64 * (W + 4)), _align16(4 * 64 * (KX + 4))

    def stage(n):  # wstage_bytes: two [8, round32(n) + 8] f32 tiles
        return 4 * 2 * 8 * (_round32(n) + 8)

    def tiles(s):  # smem_bytes<float>(p, s)
        return h + x + _align16(4 * RB * Wc) + _align16(16 * RB * s) + stage(W)

    def chain(dx):  # chain_smem<float>(p, dx)
        heads = cfg.num_rgb_channels + cfg.num_density_channels
        return (h + (x if dx else 0) + stage(KX if dx and KX > W else W)
                + 4 * (64 * heads + RB * Wc))

    if kernel == "render_level":
        sizes = [tiles(S)]
    elif kernel == "mlp_fwd":
        sizes = [tiles(0)]
    elif kernel == "train_level":
        sizes = [tiles(S) + 16 * RB * S, chain(False)]
    elif kernel == "train_level_twopass":
        sizes = [tiles(S) + 16 * RB * S,
                 _align16(chain(False)) + 4 * packed_sizes(cfg)[1]]
    else:
        if input_grads and KX > 256:
            return None
        sizes = [tiles(0), chain(input_grads)]
    return max(sizes) if max(sizes) <= SMEM_LIMIT else None


KERNELS = ("render_level", "train_level", "train_level_twopass", "mlp_fwd",
           "mlp_bwd")


def dw_jobs(cfg: Config) -> int:
    """dW products of one backward launch: one a layer, a second for each
    skip layer's x rows (the heads' and direction rows' are apart)."""
    return (cfg.net_depth + cfg.net_depth_condition
            + sum(1 for i in range(1, cfg.net_depth)
                  if i % cfg.skip_layer == 0))


def narrow_misfit(cfg: Config, kernel: str, S: int,
                  input_grads: bool = False) -> Optional[str]:
    """What of ``kernel``'s narrow route does not hold ``cfg`` at ``S``
    samples a ray (with ``input_grads``: ``mlp_bwd``'s dX), or None when it
    takes the config: a kernel net_width above ``MAX_WIDTH``; in bf16 the
    forward's shared memory (``wg_smem``; the render kernel's with its
    raw heads) or the g-chain's (``chain_wg_smem``: the train kernels';
    ``mlp_bwd``'s with the dX partials and x rows of ``input_grads``); in
    f32 ``f32_smem``."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if uses_wide(cfg):
        return f"net_width above {MAX_WIDTH}"
    backward = kernel in ("train_level", "train_level_twopass", "mlp_bwd")
    over = f"shared memory above {SMEM_LIMIT} bytes"
    if compute_dtype(cfg) != torch.bfloat16:
        if f32_smem(cfg, kernel, S, input_grads) is None:
            return f"the f32 tiles' {over}"
    elif wg_smem(cfg, S, kernel == "render_level")[0] is None:
        return f"the bf16 forward's {over}"
    elif backward and chain_wg_smem(
            cfg, dx=kernel == "mlp_bwd" and input_grads)[0] is None:
        return f"the g-chain's {over}"
    return None


def takes_wide(cfg: Config, kernel: str, S: int,
               input_grads: bool = False) -> bool:
    """The route of one launch of ``kernel`` (one of ``KERNELS``) at ``S``
    samples a ray, picked before the launch: the wide route where the
    narrow route does not hold the config (``narrow_misfit``: net_width
    above ``MAX_WIDTH``, or features, heads or biases past its shared
    memory), else the narrow route. Both read the same packed weights; the
    routes take any depth (the C layer tables are sized from the config,
    and the dW GEMMs go in launches of a fixed number of products)."""
    return narrow_misfit(cfg, kernel, S, input_grads) is not None


def packed_tx_size(cfg: Config) -> int:
    """Length of ``pack_params_tx``'s buffer."""
    cfg = kernel_cfg(cfg)
    n_x = 1 + sum(1 for i in range(1, cfg.net_depth) if i % cfg.skip_layer == 0)
    return n_x * cfg.net_width * padded_location_features(cfg)


def packed_t_size(cfg: Config) -> int:
    """Length of ``pack_params_t``'s buffer."""
    cfg = kernel_cfg(cfg)
    W, Wc = cfg.net_width, cfg.net_width_condition
    return ((cfg.net_depth - 1) * W * W + W * Wc
            + (cfg.net_depth_condition - 1) * Wc * Wc)


def pack_train_params(params: Params, cfg: Config, dt: torch.dtype):
    """(weights, biases, W^T) in the narrow f32 train kernels' layouts (and
    the earlier ``mma.sync`` kernels'): ``pack_params``' and
    ``pack_params_t``'."""
    w_flat, b_flat = pack_params(params, cfg, dt)
    return w_flat, b_flat, pack_params_t(params, cfg, dt)


def slab_streams(layout: str) -> bool:
    """Whether a kernel reading ``layout`` (``weight_layout``) takes the
    bf16 slab streams: ``"wg"``, and ``"wf"``, which adds the f32 wide
    route's (``f32_slabs``)."""
    return layout in ("wg", "wf")


def pack_train_level(params: Params, cfg: Config, dt: torch.dtype,
                     layout: str = "wf", wide: Optional[bool] = None):
    """(weights, biases, chain weights) of ``train_level`` (and
    ``train_level_twopass``) reading ``layout`` (``weight_layout``): in
    bf16 with the slab streams (``slab_streams``) the forward's
    (``pack_params_wg``) and the g-chain's (``pack_params_wgt``); in f32
    where ``f32_slabs`` says so (route ``wide``) ``pack_params_wf`` and
    ``pack_params_wft``; else ``pack_train_params``' layouts (the narrow f32
    route, and the earlier kernels)."""
    if slab_streams(layout) and dt == torch.bfloat16:
        w_flat, b_flat = pack_params_wg(params, cfg, dt)
        return w_flat, b_flat, pack_params_wgt(params, cfg, dt)
    if f32_slabs(cfg, layout, wide):
        w_flat, b_flat = pack_params_wf(params, cfg, dt)
        return w_flat, b_flat, pack_params_wft(params, cfg, dt)
    return pack_train_params(params, cfg, dt)


def train_weight_sizes(cfg: Config, layout: str,
                       wide: Optional[bool] = None) -> Tuple[int, int]:
    """Lengths of ``pack_train_level``'s weight and chain-weight buffers
    in ``cfg``'s compute dtype."""
    if slab_streams(layout) and compute_dtype(cfg) == torch.bfloat16:
        return packed_wg_size(cfg), packed_wgt_size(cfg)
    if f32_slabs(cfg, layout, wide):
        return packed_wf_size(cfg), 2 * packed_t_size(cfg)
    return packed_sizes(cfg)[0], packed_t_size(cfg)


def uses_twopass(cfg: Config) -> bool:
    """Whether ``fused_level_train`` launches the two-pass kernel: the
    probe ``fl_variant=twopass`` in mode "t" (not the in-kernel IPE)."""
    return (cfg.probe("fl_variant") == "twopass"
            and not (cfg.fuse_ipe and cfg.diag_covariance))


def pack_train(params: Params, cfg: Config, dt: torch.dtype):
    """One train step's packing, once for both levels: ``pack_train_level``,
    which both train kernels read (the two-pass kernel's bf16 route runs
    ``train_level``'s passes)."""
    return pack_train_level(params, cfg, dt)


def packed_sizes(cfg: Config) -> Tuple[int, int]:
    """Lengths of ``pack_params``'s weight and bias buffers (every size
    here is at the kernel widths, ``kernel_cfg``)."""
    cfg = kernel_cfg(cfg)
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


def route_code(cfg: Config, kernel: str, S: int, input_grads: bool = False,
               source=None) -> int:
    """The dtype code a launch of ``kernel`` passes to C: ``_DTYPE_CODE``,
    plus ``WIDE_ROUTE`` where ``takes_wide`` picks the wide route below
    net_width 288 (from 288 the C sources take it by width). A ``source``
    version (``compare_kernels.py``) is launched on the narrow route only
    there: an earlier version reads no route in its dtype code."""
    code = _DTYPE_CODE[compute_dtype(cfg)]
    if not takes_wide(cfg, kernel, S, input_grads) or uses_wide(cfg):
        return code
    if source is not None:
        raise ValueError(f"{kernel}: a source version takes no wide route "
                         "below net_width 288")
    return code + WIDE_ROUTE


def _check_level_inputs(cfg: Config, xs, d, delta, mode: str):
    """Validate one level's kernel inputs (the level kernels take the
    same). Returns the (means, variances, x) pointers, 0 where absent."""
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


def weight_layout(lib, name: str) -> str:
    """The weights a built kernel reads: what its library's
    ``<name>_weight_layout`` returns, ``"wf"`` (the bf16 slab streams, and
    in f32 on the wide route ``pack_params_wf``'s hi / lo slabs) or
    ``"wg"`` (the bf16 slab streams, f32 row-major: the versions before the
    f32 wide GEMM took ``wgmma``); ``"fwd"`` where it exports none
    (``pack_params``' fragments, which the earlier ``mma.sync`` kernels
    read)."""
    try:
        fn = getattr(lib, f"{name}_weight_layout")
    except AttributeError:
        return "fwd"
    fn.restype = ctypes.c_char_p
    return fn().decode()


def forward_weights_size(cfg: Config, layout: str,
                         wide: Optional[bool] = None) -> int:
    """Length of the packed weights of a forward kernel reading ``layout``
    in ``cfg``'s compute dtype (``pack_forward``)."""
    if slab_streams(layout) and compute_dtype(cfg) == torch.bfloat16:
        return packed_wg_size(cfg)
    if f32_slabs(cfg, layout, wide):
        return packed_wf_size(cfg)
    return packed_sizes(cfg)[0]


def _library(source=None):
    """(launch function, weight layout) of ``csrc/render_level.cu`` or of
    another version of it."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("render_level", source)
    fn = lib.render_level_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i] + [p] * 10 + [i] * 12 + [f, f, i, p]
        fn.restype = ctypes.c_int
    return fn, weight_layout(lib, "render_level")


def _wide_render_library(source=None):
    """(launch, workspace) of the wide route of ``csrc/render_level.cu`` or
    of another version of it (ValueError for a version without one)."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load("render_level", source)
    if not hasattr(lib, "render_level_wide_workspace"):
        raise ValueError("render_level: this source version has no wide route")
    fn, ws = lib.render_level_wide_launch, lib.render_level_wide_workspace
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i] + [p] * 10 + [i] * 12 + [f, f, i, p, p]
        fn.restype = ctypes.c_int
        ws.argtypes = [i] * 6
        ws.restype = ctypes.c_longlong
    return fn, ws


def render_level_cuda(params: Params, cfg: Config, xs, d, delta,
                      white_bkgd: bool, mode: str,
                      packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      source=None):
    """Launch the CUDA kernel on the current stream. Same arguments and
    outputs as ``render_level_plain``; ``packed`` is ``pack_forward``'s
    result when the caller already has it; ``source`` is another version
    of ``csrc/render_level.cu`` with the same C interface, to time versions
    in turns (``compare_kernels.py``; ``packed`` then in the layout that
    version reads, ``weight_layout``). The wide route (``takes_wide``:
    net_width 288 and above, or features past the narrow route's shared
    memory; ``render_level_wide_launch``, bf16 and f32) runs with a
    workspace allocated here (a ``source`` version's own, where it has
    one). Widths that are not multiples of 32 run zero-padded
    (``kernel_cfg``)."""
    wide = takes_wide(cfg, "render_level", delta.shape[1])
    ptrs = _check_level_inputs(cfg, xs, d, delta, mode)
    kc = kernel_cfg(cfg)
    dt = compute_dtype(cfg)
    R, S = delta.shape
    lx, fd = cfg.location_features, cfg.direction_features
    device = delta.device
    comp = torch.empty((R, 3), dtype=torch.float32, device=device)
    acc = torch.empty((R,), dtype=torch.float32, device=device)
    weights = torch.empty((R, S), dtype=torch.float32, device=device)
    if R == 0:
        return comp, acc, weights
    fn, layout = _library(source)
    if packed is None or repack_f32(cfg, layout, wide):
        packed = pack_forward(params, cfg, dt, layout, wide)
    w_flat, b_flat = packed
    _check("packed weights", w_flat, dt,
           (forward_weights_size(cfg, layout, wide),), device)
    _check("packed biases", b_flat, torch.float32, (packed_sizes(cfg)[1],),
           device)
    stream = torch.cuda.current_stream(device).cuda_stream
    shape = (R, S, cfg.net_depth, kc.net_width, cfg.skip_layer,
             kc.net_width_condition, cfg.net_depth_condition, lx,
             padded_location_features(cfg), fd, cfg.min_deg_point,
             int(cfg.fast_ipe), float(cfg.density_bias),
             float(cfg.rgb_padding), int(white_bkgd))
    outs = (d.data_ptr(), delta.data_ptr(), w_flat.data_ptr(),
            b_flat.data_ptr(), comp.data_ptr(), acc.data_ptr(),
            weights.data_ptr())
    if wide:
        fn, workspace_bytes = _wide_render_library(source)
        workspace = torch.empty(
            (workspace_bytes(_DTYPE_CODE[dt], R, S, kc.net_width,
                             kc.net_width_condition,
                             padded_location_features(cfg)),),
            dtype=torch.uint8, device=device)
        err = fn(_DTYPE_CODE[dt], _MODE_CODE[mode], *ptrs, *outs, *shape,
                 workspace.data_ptr(), stream)
    else:
        err = fn(_DTYPE_CODE[dt], _MODE_CODE[mode], *ptrs, *outs, *shape,
                 stream)
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


def _train_library(name: str, source=None):
    """(launch, workspace, weight layout) of ``csrc/<name>.cu`` or of
    another version of it (``source``); both train kernels have the same C
    interface, and each reads the layout its library declares
    (``weight_layout``: ``"wf"`` for the bf16 ``wgmma`` passes of
    ``train_level`` and ``train_level_twopass`` and their f32 wide route's
    slab streams, ``"wg"`` for a version whose f32 wide route reads
    ``pack_train_params``, ``"fwd"`` for the earlier ``mma.sync`` versions,
    which read ``pack_train_params`` in both dtypes)."""
    from nerf_or_nothing_tpu_torch.kernels import build

    lib = build.load(name, source)
    fn = getattr(lib, f"{name}_launch")
    ws = getattr(lib, f"{name}_workspace")
    if fn.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = [i, i] + [p] * 14 + [ll, p] + [i] * 12 + [f, f, i, i, p]
        fn.restype = ctypes.c_int
        # An earlier version's workspace function ignores the trailing
        # direction features: its split partials held every output.
        ws.argtypes = [i] * 9 + [ll, i]
        ws.restype = ll
    return fn, ws, weight_layout(lib, name)


def _launch_train(name: str, counted, params: Params, cfg: Config, xs, d,
                  delta, pixels, g_scale, white_bkgd: bool, mode: str,
                  packed, source=None):
    """Check the inputs, launch ``csrc/<name>.cu`` (or ``source``) on the
    current stream at the kernel widths (``kernel_cfg``) on the route
    ``takes_wide`` picks (``route_code``) and add one to
    ``counted.launches``; the grads come back at ``cfg``'s widths
    (``unembed_grads``)."""
    code = route_code(cfg, name, delta.shape[1], source=source)
    ptrs = _check_level_inputs(cfg, xs, d, delta, mode)
    kc = kernel_cfg(cfg)
    dt = compute_dtype(cfg)
    R, S = delta.shape
    N = R * S
    lx, fd = cfg.location_features, cfg.direction_features
    device = delta.device
    _check("pixels", pixels, torch.float32, (R, 3), device)
    gsc = g_scale.reshape(R)
    _check("g_scale", gsc, torch.float32, (R,), device)

    comp = torch.empty((R, 3), dtype=torch.float32, device=device)
    acc = torch.empty((R,), dtype=torch.float32, device=device)
    weights = torch.empty((R, S), dtype=torch.float32, device=device)
    if R == 0:
        return comp, acc, weights, unpack_grads(
            torch.zeros((num_params(cfg),), device=device), cfg)
    n_out = num_params(kc)
    grads = torch.empty((n_out,), dtype=torch.float32, device=device)
    launch, workspace_bytes, layout = _train_library(name, source)
    wide = takes_wide(cfg, name, S)
    if packed is None or repack_f32(cfg, layout, wide):
        packed = pack_train_level(params, cfg, dt, layout, wide)
    w_flat, b_flat, wt_flat = packed
    n_w, n_wt = train_weight_sizes(cfg, layout, wide)
    _check("packed weights", w_flat, dt, (n_w,), device)
    _check("packed biases", b_flat, torch.float32, (packed_sizes(cfg)[1],),
           device)
    _check("packed chain weights", wt_flat, dt, (n_wt,), device)
    kx, splits = padded_location_features(cfg), train_splits(N)
    D, W, Wc, Dc = (cfg.net_depth, kc.net_width, kc.net_width_condition,
                    cfg.net_depth_condition)
    ws_bytes = workspace_bytes(code, R, S, D, W, Wc, Dc, kx, splits, n_out,
                               fd)
    workspace = torch.empty((ws_bytes,), dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = launch(
        code, _MODE_CODE[mode], *ptrs, d.data_ptr(),
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
    return comp, acc, weights, unpack_grads(unembed_grads(grads, cfg), cfg)


def train_level_cuda(params: Params, cfg: Config, xs, d, delta, pixels,
                     g_scale, white_bkgd: bool, mode: str, packed=None,
                     source=None):
    """Launch the train kernel on the current stream. Same arguments and
    outputs as ``level_train_plain``; ``packed`` is ``pack_train_level``'s
    result when the caller already has it (once per step for both
    levels); ``source`` is another version of ``csrc/train_level.cu`` with
    the same C interface, to time versions in turns (``packed`` then in
    the layout that version reads). The wide route (bf16 and f32) runs at
    net_width 288 and above, and where the narrow route's shared memory
    does not hold the config (``takes_wide``). Configs the kernel does not
    take raise ValueError before anything runs."""
    check_kernel_config(cfg)
    return _launch_train("train_level", train_level, params, cfg, xs, d,
                         delta, pixels, g_scale, white_bkgd, mode, packed,
                         source)


def train_level_twopass_cuda(params: Params, cfg: Config, x, d, delta,
                             pixels, g_scale, white_bkgd: bool, packed=None,
                             source=None):
    """Launch the two-pass train kernel (``csrc/train_level_twopass.cu``)
    on the current stream: ``train_level_cuda`` in mode ``"t"``, the same
    outputs, in the TPU kernel's two phases (forward, composite and g-chain
    with db; then the dW products), on ``train_level``'s bf16 passes;
    ``packed`` is ``pack_train_level``'s result, ``source`` another version
    of the source, as for ``train_level_cuda``. Where ``takes_wide`` picks
    it, ``train_level``'s wide route runs (bf16 and f32), in the same two
    phases. Configs the kernel does not take raise ValueError before
    anything runs."""
    check_kernel_config(cfg)
    return _launch_train("train_level_twopass", train_level_twopass, params,
                         cfg, x, d, delta, pixels, g_scale, white_bkgd, "t",
                         packed, source)


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
      packed: ``pack_train``'s result, once per step.
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
