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


def small_rotation_displacement(r: Tensor, th: Tensor) -> Tensor:
    """Displacement of a point at ``r`` under small rotations ``th``:
    th x r (the intended behaviour of the reference's SmallRotate,
    raft/raft.py:998-1006, used for platform-motion node kinematics).
    Broadcasts; ``th`` may be complex (a rotation amplitude), ``r`` is then
    promoted to its dtype."""
    if th.is_complex() and not r.is_complex():
        r = r.to(th.dtype)
    return cross(th, r)


def euler_z1y2z3(beta: Tensor, phi: Tensor, gamma: Tensor) -> Tensor:
    """Z1Y2Z3 Euler rotation matrix, broadcast over leading axes."""
    s1, c1 = torch.sin(beta), torch.cos(beta)
    s2, c2 = torch.sin(phi), torch.cos(phi)
    s3, c3 = torch.sin(gamma), torch.cos(gamma)
    z = torch.zeros_like(s1 + s2 + s3)
    r00 = c1 * c2 * c3 - s1 * s3 + z
    r01 = -c3 * s1 - c1 * c2 * s3 + z
    r02 = c1 * s2 + z
    r10 = c1 * s3 + c2 * c3 * s1 + z
    r11 = c1 * c3 - c2 * s1 * s3 + z
    r12 = s1 * s2 + z
    r20 = -c3 * s2 + z
    r21 = s2 * s3 + z
    r22 = c2 + z
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def member_orientation(rA: Tensor, rB: Tensor, gamma: Tensor):
    """(q, p1, p2, R) of members from end points and twist [rad]."""
    rAB = rB - rA
    l = torch.linalg.norm(rAB, dim=-1, keepdim=True)
    q = rAB / torch.where(l > 0, l, torch.ones_like(l))
    beta = torch.atan2(q[..., 1], q[..., 0])
    phi = torch.atan2(torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2), q[..., 2])
    R = euler_z1y2z3(beta, phi, gamma)
    p1 = R[..., :, 0]
    p2 = cross(q, p1)
    return q, p1, p2, R


def heading_rotation(heading_deg) -> Tensor:
    """Member-pattern heading rotation about z, the reference's convention
    for replicated member patterns (raft/raft.py:71-77): [[c, s, 0], [-s,
    c, 0], [0, 0, 1]] with c, s of +heading, a clockwise rotation of
    coordinates.  ``heading_deg``: a float or a tensor of headings in
    degrees -> (..., 3, 3)."""
    if not isinstance(heading_deg, Tensor):
        heading_deg = torch.as_tensor(heading_deg, dtype=torch.float64)
    a = torch.deg2rad(heading_deg)
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, s, z], dim=-1),
            torch.stack([-s, c, z], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
