"""Natural frequencies and mode shapes (port of ``raft_tpu.solve.eigen``,
the path without BEM added mass)."""
from __future__ import annotations

import dataclasses
import math

import torch

from raft_tpu_torch.core.linalg6 import generalized_eigh

Tensor = torch.Tensor

_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class EigenResult:
    fns: Tensor    # (..., 6) natural frequencies [Hz], ordered by dominant DOF
    wns: Tensor    # (..., 6) natural frequencies [rad/s]
    modes: Tensor  # (..., 6, 6) mode shapes, column i dominated by DOF i
    order: Tensor  # (..., 6) raw eigenpair assigned to each DOF


def dominance_order(modes: Tensor) -> Tensor:
    """Greedy injective assignment of each DOF to the eigenvector it
    dominates most (first maximum on a tie)."""
    mag = torch.abs(modes)
    norm = torch.amax(mag, dim=-2, keepdim=True)
    rel = mag / torch.where(norm > 0, norm, torch.ones_like(norm))
    n = modes.shape[-1]
    avail = torch.ones(rel.shape[:-2] + (n,), dtype=rel.dtype, device=rel.device)
    picks = []
    for dof in range(n):
        score = torch.where(avail > 0, rel[..., dof, :], torch.full_like(avail, -1.0))
        pick = torch.argmax(score, dim=-1)
        picks.append(pick)
        avail = avail * (1.0 - torch.nn.functional.one_hot(pick, n).to(rel.dtype))
    return torch.stack(picks, dim=-1)


def diagonal_estimates(M_tot: Tensor, C_tot: Tensor) -> Tensor:
    """Per-DOF natural-frequency estimates [Hz] from the diagonal entries,
    roll and pitch taken about the effective center of mass."""

    def safe_div(a, b):
        nz = torch.abs(b) > 0
        return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)), torch.zeros_like(a))

    zMoorx = safe_div(C_tot[..., 0, 4], C_tot[..., 0, 0])
    zMoory = safe_div(C_tot[..., 1, 3], C_tot[..., 1, 1])
    zCMx = safe_div(M_tot[..., 0, 4], M_tot[..., 0, 0])
    zCMy = safe_div(M_tot[..., 1, 3], M_tot[..., 1, 1])

    def wn2(c, m):
        return torch.where(m > 0, torch.clamp(safe_div(c, m), min=0.0), torch.zeros_like(c))

    diagC = torch.diagonal(C_tot, dim1=-2, dim2=-1)
    diagM = torch.diagonal(M_tot, dim1=-2, dim2=-1)
    w2 = [wn2(diagC[..., i], diagM[..., i]) for i in range(6)]
    c_roll = diagC[..., 3] + diagC[..., 1] * ((zCMy - zMoory) ** 2 - zMoory**2)
    m_roll = diagM[..., 3] - diagM[..., 1] * zCMy**2
    c_pitch = diagC[..., 4] + diagC[..., 0] * ((zCMx - zMoorx) ** 2 - zMoorx**2)
    m_pitch = diagM[..., 4] - diagM[..., 0] * zCMx**2
    w2[3] = wn2(c_roll, m_roll)
    w2[4] = wn2(c_pitch, m_pitch)
    return torch.sqrt(torch.stack(w2, dim=-1)) / _TWO_PI


def solve_eigen(M_tot: Tensor, C_tot: Tensor, sweeps: int = 12) -> EigenResult:
    """Natural frequencies of the undamped 6-DOF system C x = lambda M x."""
    lam, X = generalized_eigh(C_tot, M_tot, sweeps=sweeps)
    wns_raw = torch.sqrt(torch.clamp(lam, min=0.0))
    order = dominance_order(X)
    wns = torch.gather(wns_raw, -1, order)
    modes = torch.gather(X, -1, order[..., None, :].expand(X.shape))
    norm = torch.amax(torch.abs(modes), dim=-2, keepdim=True)
    modes = modes / torch.where(norm > 0, norm, torch.ones_like(norm))
    return EigenResult(fns=wns / _TWO_PI, wns=wns, modes=modes, order=order)
