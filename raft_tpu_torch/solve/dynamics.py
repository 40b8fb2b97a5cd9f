"""Frequency-domain RAO solve by drag-linearized fixed point (port of
``raft_tpu.solve.dynamics``).

The JAX package solves one lane and batches with ``jax.vmap``; here the
batch is an explicit leading axis of the linear coefficients (``()`` for a
single design, ``(B,)`` for a design batch).  Two loops share one step:

* ``method="while"``: a host loop that runs while any lane is live (one
  host sync per iteration).  A lane is updated only while it is not done
  and under the iteration cap, exactly the select that ``vmap`` of
  ``while_loop`` applies.  Each solve is kernel K1
  (:func:`raft_tpu_torch.core.cuda6.solve_rao`).
* ``method="scan"``: exactly ``n_iter`` steps with no host sync, each
  lane's updates frozen once it has converged -- the same results on
  converged lanes, and reverse-differentiable: each solve is
  :func:`~raft_tpu_torch.core.cuda6.solve_rao_ad`, whose backward launches
  K1 again on the adjoint system.  ``remat=True`` recomputes each step in
  the backward pass (``torch.utils.checkpoint``, the counterpart of
  ``jax.checkpoint``) instead of keeping its intermediates.

On CPU tensors both take K1's plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from raft_tpu_torch.core import cplx
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.cuda6 import solve_rao, solve_rao_ad
from raft_tpu_torch.core.types import Env, MemberSet, WaveState
from raft_tpu_torch.hydro.strip import StripKin, linearized_drag

Tensor = torch.Tensor


@dataclasses.dataclass
class LinearCoeffs:
    """Response-independent terms of the equation of motion.

    M, B: (..., nw, 6, 6); C: (..., 6, 6); F: Cx (..., nw, 6)."""

    M: Tensor
    B: Tensor
    C: Tensor
    F: Cx


@dataclasses.dataclass
class RAOResult:
    Xi: Cx             # (..., nw, 6) response amplitudes
    n_iter: Tensor     # (...,) int32 iterations used per lane
    converged: Tensor  # (...,) bool
    B_drag: Tensor     # (..., 6, 6) linearized drag damping at the solution
    F_drag: Cx         # (..., nw, 6) drag excitation at the solution
    err_hist: Optional[Tensor] = None  # (..., n_iter) with history=True


def impedance(w: Tensor, M: Tensor, B: Tensor, C: Tensor) -> Cx:
    """Z(w) = -w^2 M + i w B + C as a (..., nw, 6, 6) Cx; C (..., 6, 6) is
    shared over the frequency axis."""
    w2 = (w * w)[..., None, None]
    return Cx(-w2 * M + C[..., None, :, :], w[..., None, None] * B)


def _error(Xi: Cx, Xi_last: Cx, tol: float) -> Tensor:
    """Relative change, reduced per lane over (nw, 6)."""
    num = (Xi - Xi_last).abs()
    den = Xi.abs() + tol
    return torch.amax(num / den, dim=(-2, -1))


def solve_dynamics(m: MemberSet, kin: StripKin, wave: WaveState, env: Env,
                   lin: LinearCoeffs, n_iter: int = 15, tol: float = 0.01,
                   relax: float = 0.8, method: str = "scan", remat: bool = False,
                   history: bool = False, tik: float = 0.0) -> RAOResult:
    """Solve Xi(w) by fixed-point drag linearization.

    Per iteration: linearize the drag about the current iterate, solve all
    frequencies of all lanes at once, test the relative change against
    ``tol``, under-relax ``Xi_last <- (1-relax) Xi_last + relax Xi``.  The
    result is the last raw solve of each lane.  ``method`` picks the loop
    (``"scan"``, the default as in the JAX package: exactly ``n_iter`` steps
    with frozen lanes, reverse-differentiable, ``remat`` applies to it only;
    ``"while"``: early exit, not differentiable on the card).
    ``history`` records each lane's convergence error per iteration (NaN
    past its exit); ``tik`` > 0 lifts each frequency's impedance diagonal
    by ``tik`` times its largest diagonal magnitude (sign-following), as in
    the JAX package.
    """
    if method not in ("while", "scan"):
        raise ValueError(f"unknown method {method!r}")
    nw = wave.w.shape[-1]
    dtype, dev = lin.C.dtype, lin.C.device
    lead = tuple(lin.F.re.shape[:-2])

    Xi0 = Cx(torch.full(lead + (nw, 6), 0.1, dtype=dtype, device=dev),
             torch.zeros(lead + (nw, 6), dtype=dtype, device=dev))
    if wave.freq_mask is not None:
        Xi0 = Cx(Xi0.re * wave.freq_mask[..., None].to(dtype), Xi0.im)
    Z0 = impedance(wave.w, lin.M, lin.B, lin.C)
    if tik:
        d_re = torch.diagonal(Z0.re, dim1=-2, dim2=-1)
        dmag = torch.sqrt(d_re**2 + torch.diagonal(Z0.im, dim1=-2, dim2=-1) ** 2)
        lam = tik * torch.amax(dmag, dim=-1)
        shift = torch.where(d_re >= 0, 1.0, -1.0).to(dtype) * lam[..., None]
        Z0 = Cx(Z0.re + shift[..., None] * torch.eye(6, dtype=dtype, device=dev), Z0.im)

    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    count = torch.zeros(lead, dtype=torch.int32, device=dev)
    hist = (torch.full(lead + (n_iter,), float("nan"), dtype=dtype, device=dev)
            if history else None)

    def log_error(hist, err, live, count):
        """Write each live lane's error at its own iteration index."""
        idx = torch.clamp(count, max=n_iter - 1).long()[..., None]
        cur = hist.gather(-1, idx)
        return hist.scatter(-1, idx, torch.where(live[..., None], err[..., None], cur))

    if method == "while":
        Xi_last, Xi_out = Xi0, Xi0
        while True:
            active = ~done & (count < n_iter)
            if not bool(active.any()):
                break
            B_drag, F_drag = linearized_drag(m, kin, Xi_last, wave, env)
            Xi = solve_rao(Z0, wave.w, B_drag, lin.F + F_drag)
            err = _error(Xi, Xi_last, tol)
            a = active[..., None, None]
            Xi_out = cplx.where(a, Xi, Xi_out)
            Xi_last = cplx.where(a, Xi_last * (1.0 - relax) + Xi * relax, Xi_last)
            if hist is not None:
                hist = log_error(hist, err, active, count)
            count = count + active.to(count.dtype)
            done = done | (active & (err < tol))
    else:
        def advance(last_re, last_im, out_re, out_im, done):
            """One step with the post-convergence freeze, in the JAX
            loop's order of selects (Xi_out, then Xi_next)."""
            Xi_last = Cx(last_re, last_im)
            B_drag, F_drag = linearized_drag(m, kin, Xi_last, wave, env)
            Xi = solve_rao_ad(Z0, wave.w, B_drag, lin.F + F_drag)
            # only decides convergence: |.| at an exact zero would put NaN
            # into the backward pass
            err = _error(Cx(Xi.re.detach(), Xi.im.detach()),
                         Cx(last_re.detach(), last_im.detach()), tol)
            d = done[..., None, None]
            Xi_out = cplx.where(d, Cx(out_re, out_im), Xi)
            Xi_next = cplx.where(d, Xi_last, Xi_last * (1.0 - relax) + Xi * relax)
            return Xi_next.re, Xi_next.im, Xi_out.re, Xi_out.im, err

        state = (Xi0.re, Xi0.im, Xi0.re, Xi0.im)
        for _ in range(n_iter):
            if remat:
                *state, err = checkpoint(advance, *state, done, use_reentrant=False)
            else:
                *state, err = advance(*state, done)
            if hist is not None:
                hist = log_error(hist, err, ~done, count)
            count = count + (~done).to(count.dtype)
            done = done | (err < tol)
        Xi_out = Cx(state[2], state[3])

    B_drag, F_drag = linearized_drag(m, kin, Xi_out, wave, env)
    return RAOResult(Xi=Xi_out, n_iter=count, converged=done, B_drag=B_drag,
                     F_drag=F_drag, err_hist=hist)
