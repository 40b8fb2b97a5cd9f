"""Drag-linearized fixed point of the frequency-domain equation of motion,
the reference's own: each solve is ``torch.linalg.solve`` on complex
tensors, the loop always runs ``n_iter`` steps and freezes a lane once it
has converged.  A lane's iterate, iteration count and convergence are then
those of an early-exit loop capped at ``n_iter``.

Per iteration: linearize the drag about the current iterate, solve
``(-w^2 M + i w (B + B_drag) + C) Xi = F + F_drag`` at every frequency,
test the largest relative change against ``tol``, under-relax."""
from __future__ import annotations

import dataclasses

import torch

from . import cplx
from .cplx import Cx
from .strip import linearized_drag

Tensor = torch.Tensor
#: the convergence test's tolerance: a lane has converged once the largest
#: relative change of a step is below it
TOL = 0.01


@dataclasses.dataclass
class LinearCoeffs:
    """M, B: (..., nw, 6, 6); C: (..., 6, 6); F: Cx (..., nw, 6)."""

    M: Tensor
    B: Tensor
    C: Tensor
    F: Cx


@dataclasses.dataclass
class RAOResult:
    Xi: Cx
    n_iter: Tensor
    converged: Tensor
    history: list | None = None     # the raw solve of every step, lanes never frozen
    errors: list | None = None      # the convergence test of every step, the same way


def _solve(M, B, C, w, B_drag, F: Cx) -> Cx:
    w_ = w[..., :, None, None]
    Z = torch.complex(-(w_ * w_) * M + C[..., None, :, :], w_ * (B + B_drag[..., None, :, :]))
    x = torch.linalg.solve(Z, torch.complex(F.re, F.im)[..., None])[..., 0]
    return Cx(x.real, x.imag)


def _error(Xi: Cx, Xi_last: Cx, tol: float) -> Tensor:
    num = (Xi - Xi_last).abs()
    den = Xi.abs() + tol
    return torch.amax(num / den, dim=(-2, -1))


def solve_dynamics(m, kin, wave, env, lin: LinearCoeffs, n_iter: int = 15, tol: float = TOL,
                   relax: float = 0.8, history: bool = False) -> RAOResult:
    """``history``: no lane is frozen and each step's raw solve and
    convergence test are kept, so a lane's iterate after any number k of
    steps is ``history[k - 1]`` and the test that ended or continued its
    k-th step ``errors[k - 1]`` (its answer that of its own count, as
    without ``history``)."""
    nw = wave.w.shape[-1]
    dtype, dev = lin.C.dtype, lin.C.device
    lead = tuple(lin.F.re.shape[:-2])
    Xi_last = Cx(torch.full(lead + (nw, 6), 0.1, dtype=dtype, device=dev),
                 torch.zeros(lead + (nw, 6), dtype=dtype, device=dev))
    Xi_out = Xi_last
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    count = torch.zeros(lead, dtype=torch.int32, device=dev)
    hist, errs = [], []
    for _ in range(n_iter):
        B_drag, F_drag = linearized_drag(m, kin, Xi_last, wave, env)
        Xi = _solve(lin.M, lin.B, lin.C, wave.w, B_drag, lin.F + F_drag)
        err = _error(Cx(Xi.re.detach(), Xi.im.detach()),
                     Cx(Xi_last.re.detach(), Xi_last.im.detach()), tol)
        d = done[..., None, None]
        if history:
            hist.append(Xi)
            errs.append(err)
            d = torch.zeros_like(d)
        Xi_out = cplx.where(d, Xi_out, Xi)
        Xi_last = cplx.where(d, Xi_last, Xi_last * (1.0 - relax) + Xi * relax)
        count = count + (~done).to(count.dtype)
        done = done | (err < tol)
    if history:
        idx = (count.long() - 1).clamp(min=0).reshape(lead + (1, 1, 1))
        idx = idx.expand(lead + (1, nw, 6))
        Xi_out = Cx(*(torch.stack(part, dim=-3).gather(-3, idx).squeeze(-3)
                      for part in ([h.re for h in hist], [h.im for h in hist])))
    return RAOResult(Xi=Xi_out, n_iter=count, converged=done, history=hist if history else None,
                     errors=errs if history else None)
