# A frozen copy of raft_tpu_torch/core/transforms.py for the benchmark's reference;
# it imports nothing of the program.
"""Rigid-body transforms broadcasting over leading axes (port of
``raft_tpu.core.transforms``)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis with explicit broadcasting."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return torch.linalg.cross(a.expand(shape), b.expand(shape), dim=-1)


def alternator(r: Tensor) -> Tensor:
    """H(r) with H[0,1]=z, H[0,2]=-y, H[1,2]=x: (..., 3) -> (..., 3, 3)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, z, -y], dim=-1),
            torch.stack([-z, zero, x], dim=-1),
            torch.stack([y, -x, zero], dim=-1),
        ],
        dim=-2,
    )


def vec_outer(v: Tensor) -> Tensor:
    """Outer product v v^T, (..., 3) -> (..., 3, 3)."""
    return v[..., :, None] * v[..., None, :]


def translate_force_3to6(r: Tensor, f: Tensor) -> Tensor:
    """Force at point r -> 6-DOF force/moment about the origin."""
    shape = torch.broadcast_shapes(r.shape, f.shape)
    return torch.cat([f.expand(shape), cross(r, f)], dim=-1)


def translate_matrix_3to6(r: Tensor, M: Tensor) -> Tensor:
    """3x3 mass-like matrix at point r -> 6x6 about the origin."""
    H = alternator(r)
    MH = M @ H
    top = torch.cat([M.expand(MH.shape), MH], dim=-1)
    HT = H.transpose(-1, -2)
    bot = torch.cat([MH.transpose(-1, -2), H @ M @ HT], dim=-1)
    return torch.cat([top, bot], dim=-2)


def translate_matrix_6to6(r: Tensor, M: Tensor) -> Tensor:
    """6x6 matrix about a point at r -> 6x6 about the origin."""
    H = alternator(r)
    HT = H.transpose(-1, -2)
    m = M[..., :3, :3]
    J = M[..., :3, 3:]
    I = M[..., 3:, 3:]
    JT = J.transpose(-1, -2)
    Jp = m @ H + J
    Ip = H @ m @ HT + JT @ H + HT @ J + I
    top = torch.cat([m.expand(Jp.shape), Jp], dim=-1)
    bot = torch.cat([Jp.transpose(-1, -2), Ip], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rotate_diag_tensor(R: Tensor, Ixx: Tensor, Iyy: Tensor, Izz: Tensor) -> Tensor:
    """R diag(Ixx, Iyy, Izz) R^T: (..., 3, 3)."""
    zeros = torch.zeros_like(Ixx)
    I_loc = torch.stack(
        [
            torch.stack([Ixx, zeros, zeros], dim=-1),
            torch.stack([zeros, Iyy, zeros], dim=-1),
            torch.stack([zeros, zeros, Izz], dim=-1),
        ],
        dim=-2,
    )
    return R @ I_loc @ R.transpose(-1, -2)


