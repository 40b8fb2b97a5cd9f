"""Frustum volume / centroid / moment-of-inertia (port of
``raft_tpu.core.frustum``): a 3-point Gauss-Legendre rule, exact for the
degree <= 4 polynomial integrands of a linearly tapered section."""
from __future__ import annotations

import math

import torch

from raft_tpu_torch.core.device import to_device

Tensor = torch.Tensor

# 3-point Gauss-Legendre nodes/weights on [0, 1]
_GL_X = (0.5 - math.sqrt(3.0 / 20.0), 0.5, 0.5 + math.sqrt(3.0 / 20.0))
_GL_W = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)


def _gl(like: Tensor):
    x = to_device(_GL_X, like.dtype, like.device)
    w = to_device(_GL_W, like.dtype, like.device)
    return x, w


def _sections(dA: Tensor, dB: Tensor, xi: Tensor) -> Tensor:
    """Linear side lengths at the 3 quadrature points: (..., 3, 2)."""
    return dA[..., None, :] + (dB - dA)[..., None, :] * xi[:, None]


def _areas(s: Tensor, circ: Tensor) -> Tensor:
    a_circ = 0.25 * math.pi * s[..., 0] * s[..., 1]
    a_rect = s[..., 0] * s[..., 1]
    return torch.where(circ[..., None], a_circ, a_rect)


def frustum_vcv(dA: Tensor, dB: Tensor, H: Tensor, circ: Tensor):
    """Volume and centroid height (above the lower face) of a linear frustum."""
    xi, w = _gl(dA)
    A = _areas(_sections(dA, dB, xi), circ)
    V = H * torch.einsum("q,...q->...", w, A)
    Mz = H * H * torch.einsum("q,q,...q->...", w, xi, A)
    hc = Mz / torch.where(V != 0, V, torch.ones_like(V))
    return V, hc


def frustum_moi(dA: Tensor, dB: Tensor, H: Tensor, rho: Tensor, circ: Tensor):
    """(Ixx_end, Iyy_end, Izz) of a solid linear frustum about its lower end."""
    xi, w = _gl(dA)
    s = _sections(dA, dB, xi)
    L, W = s[..., 0], s[..., 1]
    z2 = (H[..., None] * xi) ** 2

    d4 = (L * L) * (W * W)
    ixx_c = math.pi / 64.0 * d4
    izz_c = math.pi / 32.0 * d4
    A_c = 0.25 * math.pi * L * W
    ixx_r = (L * W**3) / 12.0
    iyy_r = (L**3 * W) / 12.0
    A_r = L * W

    c = circ[..., None]
    ixx = torch.where(c, ixx_c, ixx_r)
    iyy = torch.where(c, ixx_c, iyy_r)
    izz = torch.where(c, izz_c, ixx_r + iyy_r)
    A = torch.where(c, A_c, A_r)

    Ixx_end = rho * H * torch.einsum("q,...q->...", w, ixx + A * z2)
    Iyy_end = rho * H * torch.einsum("q,...q->...", w, iyy + A * z2)
    Izz = rho * H * torch.einsum("q,...q->...", w, izz)
    return Ixx_end, Iyy_end, Izz
