"""Metric / init math: PSNR, SSIM, avg-error, sRGB, Glorot init, the
learning-rate schedule; and a plain model of the f32 kernels' 3xTF32
products (``tf32_round``, ``dense_3xtf32``), which only the tests use.

Same formulas as ``nerf_or_nothing_tpu/ops/math_utils.py``. SSIM's
separable Gaussian blur runs as two ``conv2d`` passes; cuDNN would run an
f32 convolution in TF32, so ``compute_ssim`` turns TF32 off
(``exact_f32``) before it convolves on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_LN10 = 2.3025850929940456840179914546844


def exact_f32(device: torch.device) -> None:
    """Run f32 matrix products and convolutions in full f32 on the card:
    TF32 (about three decimal digits) is turned off for both cuBLAS and
    cuDNN, whose convolutions default to it."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 as ``cvt.rna.tf32.f32`` rounds them: to
    the nearest value with 10 explicit mantissa bits, ties away from zero
    (the low 13 bits of the magnitude's bit pattern rounded off, so
    subnormals round the same way and a value past the largest TF32 one
    becomes inf); inf stays inf and NaN stays NaN."""
    x = x.float()
    mag = x.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    mag = ((mag + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, torch.copysign(mag, x))


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = tf32_round(x), lo = tf32_round(x - hi), the split of
    an f32 operand in the kernels' 3xTF32 products; hi + lo is x within
    2^-22 of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def dense_3xtf32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w (f32 operands) as the f32 kernels take it on the tensor cores
    (``csrc/level_common.cuh``: gemm, ``csrc/level_backward.cuh``: the dW
    GEMM): both operands split (``split_tf32``), lo @ hi + hi @ lo + hi @ hi,
    lo @ lo dropped, each term exact and summed in f64, then rounded to f32.
    The card's f32 sums run in another order; this models the split, not
    the accumulation."""
    h_hi, h_lo = (t.double() for t in split_tf32(h))
    w_hi, w_lo = (t.double() for t in split_tf32(w))
    return ((h_lo @ w_hi + h_hi @ w_lo) + h_hi @ w_hi).float()


def softplus(x):
    """log(1 + e^x) as max(x, 0) + log1p(e^-|x|), jax.nn.softplus's form."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def mse_to_psnr(mse):
    return -10.0 / _LN10 * torch.log(torch.as_tensor(mse, dtype=torch.float32))


def psnr_to_mse(psnr):
    return torch.exp(-0.1 * _LN10 * torch.as_tensor(psnr, dtype=torch.float32))


def glorot_uniform(generator: torch.Generator, fan_in: int, fan_out: int,
                   shape, device="cpu"):
    """U(-lim, lim), lim = sqrt(6/(fan_in+fan_out))."""
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * (2.0 * lim) - lim).to(device)


def compute_avg_error(psnr, ssim, lpips):
    """Geometric mean of MSE, sqrt(DSSIM), LPIPS."""
    mse = psnr_to_mse(psnr)
    dssim = torch.sqrt(1.0 - torch.as_tensor(ssim, dtype=torch.float32))
    vals = torch.stack([
        mse, dssim.to(mse.device),
        torch.as_tensor(lpips, dtype=torch.float32).to(mse.device),
    ])
    return torch.exp(torch.mean(torch.log(vals)))


def linear_to_srgb(linear):
    linear = torch.as_tensor(linear)
    return torch.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * torch.clamp(linear, min=1e-10) ** (1.0 / 2.4) - 0.055,
    )


def srgb_to_linear(srgb):
    srgb = torch.as_tensor(srgb)
    return torch.where(
        srgb <= 0.04045,
        srgb / 12.92,
        (torch.clamp(srgb, min=0.0) / 1.055 + 0.055 / 1.055) ** 2.4,
    )


def learning_rate_decay(step, lr_init: float, lr_final: float,
                        max_steps: int, lr_delay_steps: int = 0,
                        lr_delay_mult: float = 1.0) -> torch.Tensor:
    """Log-lerp learning rate with a sine warm-up delay, in f32 on the
    step as the JAX package computes it (a 0-dim f32 tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if lr_delay_steps > 0:
        delay_progress = torch.clamp(step / lr_delay_steps, 0.0, 1.0)
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * np.pi * delay_progress
        )
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(np.log(lr_init) * (1.0 - t) + np.log(lr_final) * t)
    return delay_rate * log_lerp


def _gaussian_filter_1d(size: int, sigma: float) -> np.ndarray:
    half = size // 2
    x = np.arange(size, dtype=np.float64) - half
    f = np.exp(-(x**2) / (2.0 * sigma**2))
    return (f / f.sum()).astype(np.float32)


def compute_ssim(
    img0: torch.Tensor,
    img1: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    """SSIM with an 11x1 / 1x11 separable Gaussian, zero padding at the
    borders (same-size output).

    Args:
      img0/img1: [H, W, C] in [0, max_val].
    """
    exact_f32(img0.device)
    filt = torch.from_numpy(_gaussian_filter_1d(filter_size, filter_sigma))
    filt = filt.to(img0.device)
    hw = filter_size // 2
    k_h = filt.view(1, 1, filter_size, 1)
    k_w = filt.view(1, 1, 1, filter_size)

    def blur(img):
        x = img.permute(2, 0, 1).unsqueeze(1)  # [C, 1, H, W]
        x = F.conv2d(x, k_h, padding=(hw, 0))
        x = F.conv2d(x, k_w, padding=(0, hw))
        return x.squeeze(1).permute(1, 2, 0)

    mu0 = blur(img0)
    mu1 = blur(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = torch.clamp(blur(img0 * img0) - mu00, min=0.0)
    sigma11 = torch.clamp(blur(img1 * img1) - mu11, min=0.0)
    sigma01 = torch.clamp(blur(img0 * img1) - mu01, min=0.0)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else torch.mean(ssim_map)
