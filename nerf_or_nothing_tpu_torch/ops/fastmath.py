"""Reduced-precision transcendentals for the IPE encode.

Polynomial sin/cos/exp with the same constants and operation order as
``nerf_or_nothing_tpu/ops/fastmath.py``. The CUDA render kernel
(``csrc/render_level.cu``) evaluates the same polynomials per element; these
torch versions are its plain counterpart.

Accuracy: sin/cos < 4e-7 absolute while the reduction quotient |k| < 2^16
(|x| <~ 2e5, the IPE's live range: |mean| * 2^15); exp(-x) < 2e-6
relative over x in [0, 87], exactly 0 beyond. The products k*_PI_A are
exact only below |k| < 2^16 (_PI_A has 8 significant bits).
"""

from __future__ import annotations

import torch

# pi split into 3 parts: pi = _PI_A + _PI_B + _PI_C.
_PI_A = 3.140625
_PI_B = 9.67502593994140625e-4
_PI_C = 1.509957990978376432e-7
_INV_PI = 0.3183098861837907
_HALF_PI = 1.5707963267948966

# sin(r)/r on [-pi/2, pi/2], even polynomial in r^2.
_S1 = -1.6666667e-1
_S2 = 8.3333310e-3
_S3 = -1.9840874e-4
_S4 = 2.7525562e-6
_S5 = -2.3889859e-8

_LOG2E = 1.4426950408889634
# 2^f on [0, 1]: degree-6 Taylor in ln2.
_E1 = 6.93147180559945286e-1
_E2 = 2.40226506959100694e-1
_E3 = 5.55041086648215800e-2
_E4 = 9.61812910762847687e-3
_E5 = 1.33335581464284411e-3
_E6 = 1.54035303933816099e-4

# cos(r) on [-pi/2, pi/2], even polynomial in r^2 (Taylor deg 10).
_C2 = -0.5
_C4 = 4.16666666666666644e-2
_C6 = -1.38888888888888894e-3
_C8 = 2.48015873015873016e-5
_C10 = -2.75573192239858925e-7


def _sin_poly(r):
    r2 = r * r
    p = _S5
    p = p * r2 + _S4
    p = p * r2 + _S3
    p = p * r2 + _S2
    p = p * r2 + _S1
    return r + r * (r2 * p)


def _cos_poly(r):
    r2 = r * r
    p = _C10
    p = p * r2 + _C8
    p = p * r2 + _C6
    p = p * r2 + _C4
    p = p * r2 + _C2
    return 1.0 + r2 * p


def _reduce(x, shift: float):
    """k = floor(x/pi + shift), r = x - k*pi (3-term split), (-1)^k."""
    k = torch.floor(x * _INV_PI + shift)
    r = x - k * _PI_A
    r = r - k * _PI_B
    r = r - k * _PI_C
    sign = 1.0 - 2.0 * torch.bitwise_and(k.to(torch.int32), 1).to(torch.float32)
    return r, sign


def fast_sin(x):
    """sin(x) to ~4e-7 absolute, f32."""
    r, sign = _reduce(x.to(torch.float32), 0.5)
    return sign * _sin_poly(r)


def fast_cos(x):
    """cos(x) = sin(x + pi/2), the shift added to the reduced residual."""
    r, sign = _reduce(x.to(torch.float32), 1.0)
    return sign * _sin_poly(r + _HALF_PI)


def fast_sincos(x):
    """(sin(x), cos(x)) with one shared range reduction."""
    r, sign = _reduce(x.to(torch.float32), 0.5)
    return sign * _sin_poly(r), sign * _cos_poly(r)


def fast_exp_neg(x):
    """exp(-x) for x >= 0, to ~2e-6 relative; underflows cleanly to 0."""
    x = x.to(torch.float32)
    t = -x * _LOG2E
    t_clamped = torch.clamp(t, min=-126.0)
    k = torch.floor(t_clamped)
    f = t_clamped - k
    p = _E6
    p = p * f + _E5
    p = p * f + _E4
    p = p * f + _E3
    p = p * f + _E2
    p = p * f + _E1
    pow2f = 1.0 + f * p
    pow2k = torch.bitwise_left_shift(k.to(torch.int32) + 127, 23).view(
        torch.float32
    )
    out = pow2k * pow2f
    return torch.where(t < -125.0, torch.zeros_like(out), out)
