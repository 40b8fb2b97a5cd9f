"""Natural frequencies and mode shapes (port of ``raft_tpu.solve.eigen``),
with or without frequency-dependent BEM added mass."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
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
    cols = torch.arange(n, device=rel.device)
    picks = []
    for dof in range(n):
        score = torch.where(avail > 0, rel[..., dof, :], torch.full_like(avail, -1.0))
        pick = torch.argmax(score, dim=-1)
        picks.append(pick)
        # one_hot(pick, n) without its range check, which reads back on the CPU
        avail = avail * (1.0 - (cols == pick[..., None]).to(rel.dtype))
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


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``numpy.interp`` on tensors (``jnp.interp``'s formula): linear in
    ``xp``, constant beyond its ends.  ``fp``: (len(xp), ...) values."""
    x = x.contiguous()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = (xp[i] - xp[i - 1]).reshape((-1,) + (1,) * (fp.dim() - 1))
    delta = (x - xp[i - 1]).reshape(dx.shape)
    tiny = torch.abs(dx) <= float(np.spacing(torch.finfo(xp.dtype).eps))
    f = torch.where(tiny, fp[i - 1], fp[i - 1] + (delta / torch.where(tiny, torch.ones_like(dx), dx)) * df)
    lo = (x < xp[0]).reshape(dx.shape)
    hi = (x > xp[-1]).reshape(dx.shape)
    return torch.where(lo, fp[0], torch.where(hi, fp[-1], f))


def eigen_with_bem_batched(M_base: Tensor, C_tot: Tensor, A_w: Tensor, w_grid: Tensor,
                           n_pass: int = 3):
    """Eigen solve with frequency-dependent BEM added mass, evaluated at
    each mode's own natural frequency by a small fixed point: solve with
    A(w_n) interpolated per mode, update w_n, repeat ``n_pass`` times.

    ``M_base``/``C_tot``: (nT, 6, 6) structural + Morison mass (potMod
    members excluded) and total stiffness; ``A_w``: (nw, 6, 6) BEM added
    mass on ``w_grid`` (nw,).  Returns ``(EigenResult with (nT, 6)
    fields, estimates (nT, 6) in Hz)``."""
    if n_pass < 1:
        raise ValueError(f"eigen_with_bem_batched needs n_pass >= 1, got {n_pass}")
    nT = M_base.shape[0]
    wns = w_grid[0].expand(nT, 6)
    for _ in range(n_pass):
        A_modes = interp(wns.reshape(-1), w_grid, A_w).reshape(nT, 6, 6, 6)
        eigs = solve_eigen(M_base[:, None] + A_modes, C_tot[:, None].expand(nT, 6, 6, 6))
        wns = torch.diagonal(eigs.wns, dim1=-2, dim2=-1)      # mode i at assembly i
    idx = torch.arange(6, device=M_base.device)
    res = EigenResult(fns=wns / _TWO_PI, wns=wns,
                      modes=eigs.modes[:, idx, :, idx].permute(1, 2, 0),
                      order=eigs.order[:, idx, idx])
    est = torch.diagonal(diagonal_estimates(M_base[:, None] + A_modes,
                                            C_tot[:, None].expand(nT, 6, 6, 6)),
                         dim1=-2, dim2=-1)
    return res, est


def eigen_with_bem(M_base: Tensor, C_tot: Tensor, A_w: Tensor, w_grid: Tensor,
                   n_pass: int = 3):
    """One design's :func:`eigen_with_bem_batched`: ``M_base``/``C_tot``
    (6, 6).  Returns ``(EigenResult with (6,) fields, estimates (6,))``."""
    res, est = eigen_with_bem_batched(M_base[None], C_tot[None], A_w, w_grid, n_pass=n_pass)
    return EigenResult(fns=res.fns[0], wns=res.wns[0], modes=res.modes[0],
                       order=res.order[0]), est[0]
