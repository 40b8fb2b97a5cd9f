# A frozen copy of raft_tpu_torch/core/waves.py for the benchmark's reference;
# it imports nothing of the program.
"""Linear wave theory: spectrum, dispersion, kinematics (port of
``raft_tpu.core.waves``)."""
from __future__ import annotations

import math

import torch

from . import cplx
from .cplx import Cx
from .device import to_device

Tensor = torch.Tensor

# kh beyond which the finite-depth ratios overflow (deep-water form)
_KH_DEEP = 89.4


def jonswap(w: Tensor, Hs, Tp, gamma=1.0) -> Tensor:
    """One-sided JONSWAP spectral density S(w) [m^2/(rad/s)]; gamma=1 is
    Pierson-Moskowitz.  A degenerate ``Tp = 0`` gives NaN, as in the JAX
    package (whose numpy scalars divide to infinity), not an exception:
    the lane-health verdicts of the batched sweeps report it."""
    f = 0.5 / math.pi * w
    fpOvrf4 = (Tp * f) ** (-4.0)
    C = 1.0 - 0.287 * math.log(gamma)
    inv_tp = 1.0 / Tp if isinstance(Tp, torch.Tensor) or Tp != 0 else math.inf
    sigma = torch.where(f <= inv_tp, torch.full_like(f, 0.07), torch.full_like(f, 0.09))
    alpha = torch.exp(-0.5 * ((f * Tp - 1.0) / sigma) ** 2)
    return (
        0.5 / math.pi * C * 0.3125 * Hs * Hs * fpOvrf4 / f
        * torch.exp(-1.25 * fpOvrf4) * gamma**alpha
    )


def wave_number(w: Tensor, depth, g: float = 9.81, iters: int = 30) -> Tensor:
    """k(w, h) from w^2 = g k tanh(k h) by a fixed 30-step Newton solve from
    the deep-water guess."""
    w2g = w * w / g
    k = torch.clamp(w2g, min=1e-12)
    for _ in range(iters):
        kh = k * depth
        t = torch.tanh(kh)
        f = k * t - w2g
        fp = t + kh * (1.0 - t * t)
        k_new = k - f / torch.where(fp != 0, fp, torch.ones_like(fp))
        k = torch.clamp(k_new, min=1e-12)
    return k


def depth_ratios(k: Tensor, z: Tensor, depth):
    """sinh(k(z+h))/sinh(kh), cosh(k(z+h))/sinh(kh), cosh(k(z+h))/cosh(kh)
    with the deep-water guard at kh > 89.4; broadcasts k against z."""
    z = torch.clamp(z, max=0.0)
    kh = k * depth
    kz = k * z
    deep = kh > _KH_DEEP
    kh_safe = torch.where(deep, torch.ones_like(kh), kh)
    kzh = torch.where(deep, torch.zeros_like(kz), k * (z + depth))
    shallow_s = torch.sinh(kzh) / torch.sinh(kh_safe)
    shallow_c = torch.cosh(kzh) / torch.sinh(kh_safe)
    shallow_cc = torch.cosh(kzh) / torch.cosh(kh_safe)
    deep_e = torch.exp(kz)
    s = torch.where(deep, deep_e, shallow_s)
    c = torch.where(deep, deep_e, shallow_c)
    cc = torch.where(deep, deep_e + torch.exp(-k * (z + 2.0 * depth)), shallow_cc)
    ok = k > 0
    zero = torch.zeros_like(s)
    return torch.where(ok, s, zero), torch.where(ok, c, zero), torch.where(ok, cc, zero)


def wave_kinematics(zeta0: Tensor, w: Tensor, k: Tensor, depth, r: Tensor,
                    beta=0.0, rho: float = 1025.0, g: float = 9.81):
    """Complex velocity (..., 3, nw), acceleration (..., 3, nw) and dynamic
    pressure (..., nw) amplitudes at field points r (..., 3)."""
    beta = to_device(beta, w.dtype, w.device)
    cb, sb = torch.cos(beta), torch.sin(beta)
    x = r[..., 0:1]
    y = r[..., 1:2]
    z = r[..., 2:3]
    phase = Cx.expi(-(k * (cb * x + sb * y)))
    s, c, cc = depth_ratios(k, z, depth)
    submerged = (z < 0).to(phase.re.dtype)
    zeta = phase * (zeta0 * submerged)
    ux = zeta * (w * c * cb)
    uy = zeta * (w * c * sb)
    uz = (zeta * (w * s)).mul_i()
    u = cplx.stack([ux, uy, uz], axis=-2)
    ud = (u * w).mul_i()
    pDyn = zeta * (rho * g * cc)
    return u, ud, pDyn


