# A frozen copy of raft_tpu_torch/core/bessel.py for the benchmark's reference;
# it imports nothing of the program.
"""Bessel functions J0, J1, Y0, Y1 on tensors (port of
``raft_tpu.core.bessel``).

The same Abramowitz & Stegun rational/asymptotic approximations (the
Numerical Recipes coefficients, absolute error < 2e-7), evaluated
elementwise with the JAX package's guards, so the port's Green function
agrees with the reference to roundoff.  ``raft_tpu_torch/csrc/bem_wave.cu``
carries ``__device__`` copies of these polynomials (not CUDA's own ``j0``/
``y0``, which use other approximations).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_2_OVER_PI = 0.636619772367581343

J0_SMALL_NUM = (57568490574.0, -13362590354.0, 651619640.7,
                -11214424.18, 77392.33017, -184.9052456)
J0_SMALL_DEN = (57568490411.0, 1029532985.0, 9494680.718,
                59272.64853, 267.8532712, 1.0)
J1_SMALL_NUM = (72362614232.0, -7895059235.0, 242396853.1,
                -2972611.439, 15704.48260, -30.16036606)
J1_SMALL_DEN = (144725228442.0, 2300535178.0, 18583304.74,
                99447.43394, 376.9991397, 1.0)
Y0_SMALL_NUM = (-2957821389.0, 7062834065.0, -512359803.6,
                10879881.29, -86327.92757, 228.4622733)
Y0_SMALL_DEN = (40076544269.0, 745249964.8, 7189466.438,
                47447.26470, 226.1030244, 1.0)
Y1_SMALL_NUM = (-0.4900604943e13, 0.1275274390e13, -0.5153438139e11,
                0.7349264551e9, -0.4237922726e7, 0.8511937935e4)
Y1_SMALL_DEN = (0.2499580570e14, 0.4244419664e12, 0.3733650367e10,
                0.2245904002e8, 0.1020426050e6, 0.3549632885e3, 1.0)
P0 = (1.0, -0.1098628627e-2, 0.2734510407e-4, -0.2073370639e-5, 0.2093887211e-6)
Q0 = (-0.1562499995e-1, 0.1430488765e-3, -0.6911147651e-5, 0.7621095161e-6,
      -0.934935152e-7)
P1 = (1.0, 0.183105e-2, -0.3516396496e-4, 0.2457520174e-5, -0.240337019e-6)
Q1 = (0.04687499995, -0.2002690873e-3, 0.8449199096e-5, -0.88228987e-6,
      0.105787412e-6)


def _poly(y: Tensor, coeffs) -> Tensor:
    """Horner: c0 + y (c1 + y (c2 + ...))."""
    acc = coeffs[-1] + torch.zeros_like(y)
    for c in reversed(coeffs[:-1]):
        acc = c + y * acc
    return acc


def _j0_large(ax: Tensor) -> Tensor:
    z = 8.0 / ax
    y = z * z
    xx = ax - 0.785398164
    return torch.sqrt(_2_OVER_PI / ax) * (torch.cos(xx) * _poly(y, P0)
                                          - z * torch.sin(xx) * _poly(y, Q0))


def _j1_large(ax: Tensor) -> Tensor:
    z = 8.0 / ax
    y = z * z
    xx = ax - 2.356194491
    return torch.sqrt(_2_OVER_PI / ax) * (torch.cos(xx) * _poly(y, P1)
                                          - z * torch.sin(xx) * _poly(y, Q1))


def j0(x: Tensor) -> Tensor:
    ax = torch.abs(x)
    small = ax < 8.0
    ax_l = torch.where(small, torch.full_like(ax, 8.0), ax)   # double-where:
    y = torch.where(small, ax * ax, torch.zeros_like(ax))     # untaken branch finite
    return torch.where(small, _poly(y, J0_SMALL_NUM) / _poly(y, J0_SMALL_DEN),
                       _j0_large(ax_l))


def j1(x: Tensor) -> Tensor:
    ax = torch.abs(x)
    small = ax < 8.0
    ax_l = torch.where(small, torch.full_like(ax, 8.0), ax)
    y = torch.where(small, ax * ax, torch.zeros_like(ax))
    out = torch.where(small, ax * _poly(y, J1_SMALL_NUM) / _poly(y, J1_SMALL_DEN),
                      _j1_large(ax_l))
    return torch.sign(x) * torch.where(x == 0, torch.zeros_like(out), out)


def y0(x: Tensor) -> Tensor:
    """Y0 for x > 0 (guarded at 0: returns the value at a tiny clamp)."""
    x = torch.clamp(x, min=1e-30)
    small = x < 8.0
    x_s = torch.where(small, x, torch.ones_like(x))
    y = x_s * x_s
    small_val = (_poly(y, Y0_SMALL_NUM) / _poly(y, Y0_SMALL_DEN)
                 + _2_OVER_PI * j0(x_s) * torch.log(x_s))
    x_l = torch.where(small, torch.full_like(x, 8.0), x)
    z = 8.0 / x_l
    yl = z * z
    xx = x_l - 0.785398164
    large_val = torch.sqrt(_2_OVER_PI / x_l) * (torch.sin(xx) * _poly(yl, P0)
                                                + z * torch.cos(xx) * _poly(yl, Q0))
    return torch.where(small, small_val, large_val)


def y1(x: Tensor) -> Tensor:
    """Y1 for x > 0 (guarded at 0)."""
    x = torch.clamp(x, min=1e-30)
    small = x < 8.0
    x_s = torch.where(small, x, torch.ones_like(x))
    y = x_s * x_s
    small_val = (x_s * _poly(y, Y1_SMALL_NUM) / _poly(y, Y1_SMALL_DEN)
                 + _2_OVER_PI * (j1(x_s) * torch.log(x_s) - 1.0 / x_s))
    x_l = torch.where(small, torch.full_like(x, 8.0), x)
    z = 8.0 / x_l
    yl = z * z
    xx = x_l - 2.356194491
    large_val = torch.sqrt(_2_OVER_PI / x_l) * (torch.sin(xx) * _poly(yl, P1)
                                                + z * torch.cos(xx) * _poly(yl, Q1))
    return torch.where(small, small_val, large_val)
