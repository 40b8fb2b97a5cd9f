"""Gradient-based co-design, the WEIS inner loop (port of
``raft_tpu.parallel.optimize``).

The whole pipeline (statics -> Morison hydro -> drag-linearized RAO fixed
point -> response statistics) is reverse-differentiable through the scan
loop (:mod:`raft_tpu_torch.solve.dynamics`), whose every solve is kernel
K1 forward and K1 again on the adjoint system backward.  Design
optimization is plain gradient descent: Adam with optax's defaults
(``torch.optim.Adam``), box bounds by projection.

The JAX package batches designs with ``jax.vmap``; here a ``theta`` with a
leading lane axis, through an ``apply_fn`` that maps it to a design batch,
gives each lane its own objective and, through the sum of the lanes'
objectives, its own gradient.  Not ported yet: batched sea states
(``make_wave_states``, ``case_reduce`` over a DLC table, per-lane
headings) and the differentiable panel re-solve ``bem_fn`` (ROADMAP.md,
queue 1), and the JAX package's compiled-executable cache around the
value-and-grad step (queue 1, item 7: PyTorch runs eagerly).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.types import Env, MemberSet, RNA, WaveState
from raft_tpu_torch.parallel.sweep import forward_response, scale_diameters, stage_bem

Tensor = torch.Tensor


def nacelle_accel_std(Xi: Cx, wave: WaveState, rna: RNA) -> Tensor:
    """Std dev of the nacelle fore-aft acceleration
    ``a(w) = -w^2 (Xi_surge + hHub Xi_pitch)`` on the spectral-amplitude
    basis: ``sigma^2 = sum |a|^2 dw``.  The double-where guard around the
    sqrt gives a zero-response lane gradient 0, not NaN."""
    w = wave.w
    a_re = -(w**2) * (Xi.re[..., 0] + rna.hHub * Xi.re[..., 4])
    a_im = -(w**2) * (Xi.im[..., 0] + rna.hHub * Xi.im[..., 4])
    dw = w[..., 1] - w[..., 0]
    s = torch.sum(a_re**2 + a_im**2, dim=-1) * dw
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))


def energy_sum(sigmas: Tensor) -> Tensor:
    """Root-sum-of-squares of independent lanes' std devs (the components
    of one short-crested sea)."""
    return torch.sqrt(torch.sum(sigmas**2))


def _stage(bem, wave: WaveState, env: Env):
    """The single-sea-state BEM layouts of the JAX package's ``_make_loss``
    -> staged (A, B, F Cx) on the wave's device: ``stage_bem`` output as
    given, a raw host (A[6, 6, nw], B[6, 6, nw], F[6, nw]) tuple, or a
    heading grid (betas, F_all[nb, 6, nw], A, B) interpolated to the wave's
    heading."""
    if len(bem) == 4:
        from raft_tpu_torch.model import interp_heading_excitation

        bgrid, F_all, A_h, B_h = bem
        beta = float(env.beta if wave.beta is None else wave.beta)
        return stage_bem((A_h, B_h, interp_heading_excitation(bgrid, F_all, beta)), wave)
    if isinstance(bem[2], Cx):
        return bem
    return stage_bem(bem, wave)


def _make_loss(members: MemberSet, rna: RNA, env: Env, wave: WaveState, C_moor,
               objective: Callable, apply_fn: Callable, bem, n_iter: int, remat: bool,
               case_reduce=None, moor=None, moor_apply_fn=None, r6_moor=None,
               bem_fn=None, dtype=torch.float64, device=None):
    """theta -> objective(Xi) through the reverse-differentiable pipeline.

    ``bem`` (frozen at the nominal hull) is ``stage_bem`` output, the raw
    host tuple or a heading grid (see :func:`_stage`).  With ``moor`` and
    ``moor_apply_fn(moor, theta)`` the mooring stiffness is recomputed
    inside the loss from the theta-modified system at ``r6_moor`` (default
    zeros), and ``C_moor`` is ignored.  ``case_reduce`` applies to batched
    sea states only, which are not ported.
    """
    if wave.zeta.ndim == 2:
        raise NotImplementedError(
            "batched sea states (make_wave_states, case_reduce, per-lane headings) come "
            "with the scenario-batch slice (ROADMAP.md, queue 1, item 6)")
    if bem_fn is not None:
        raise NotImplementedError(
            "bem_fn, the differentiable panel re-solve, comes with the BEM-gradient slice "
            "(ROADMAP.md, queue 1)")
    dev = resolve_device(device)
    if bem is not None:
        bem = _stage(bem, wave, env)

    def loss(theta: Tensor) -> Tensor:
        m = apply_fn(members, theta)
        if moor is not None:
            from raft_tpu_torch.mooring.system import mooring_stiffness

            sys_t = moor_apply_fn(moor, theta)
            r0 = (torch.zeros(6, dtype=sys_t.r_anchor.dtype, device=sys_t.r_anchor.device)
                  if r6_moor is None else r6_moor)
            C = mooring_stiffness(sys_t, r0)
        else:
            C = C_moor
        out = forward_response(m, rna, env, wave, C, bem=bem, n_iter=n_iter, method="scan",
                               remat=remat, dtype=dtype, device=dev)
        return objective(out.Xi, wave, rna)

    return loss


def _theta(theta, dtype, dev) -> Tensor:
    return torch.as_tensor(theta, dtype=dtype, device=dev).detach().clone()


def _value_and_grad(loss, theta: Tensor):
    """(objective, d sum(objective) / d theta), both detached."""
    th = theta.detach().requires_grad_(True)
    val = loss(th)
    (g,) = torch.autograd.grad(val.sum(), th)
    return val.detach(), g


class OptResult(NamedTuple):
    theta: np.ndarray        # optimized parameters
    objective: float         # objective at theta
    history: np.ndarray      # (steps+1,) objective trajectory
    thetas: np.ndarray       # (steps+1, ...) parameter trajectory
    grad_norm: float         # |grad| at the last evaluated step


def optimize_design(members: MemberSet, rna: RNA, env: Env, wave: WaveState, C_moor,
                    theta0, objective: Callable = nacelle_accel_std,
                    apply_fn: Callable = scale_diameters, steps: int = 30,
                    learning_rate: float = 0.02, optimizer=None, bounds: tuple | None = None,
                    bem=None, n_iter: int = 25, remat: bool = False, case_reduce=None,
                    moor=None, moor_apply_fn=None, r6_moor=None, bem_fn=None,
                    dtype=torch.float64, device=None) -> OptResult:
    """Minimize a response statistic over a geometry parameterization.

    ``objective(Xi, wave, rna) -> scalar`` is evaluated on the scan-loop
    RAO solve of ``apply_fn(members, theta)``; each step is one
    value-and-gradient evaluation and one optimizer update, Adam by default
    (optax's defaults: b1 0.9, b2 0.999, eps 1e-8).  ``optimizer``, if
    given, builds a ``torch.optim.Optimizer`` from the parameter list.
    ``bounds=(lo, hi)`` projects theta back into the box after each update.
    With ``moor`` and ``moor_apply_fn`` (e.g.
    :func:`raft_tpu_torch.mooring.system.scale_mooring`) the mooring
    stiffness follows theta too.  With ``bem`` staged, the potential-flow
    coefficients are the nominal hull's and are held constant.  Returns the
    parameter and objective trajectory.
    """
    dev = resolve_device(device)
    loss = _make_loss(members, rna, env, wave, C_moor, objective, apply_fn, bem, n_iter,
                      remat, case_reduce=case_reduce, moor=moor, moor_apply_fn=moor_apply_fn,
                      r6_moor=r6_moor, bem_fn=bem_fn, dtype=dtype, device=dev)
    theta = _theta(theta0, dtype, dev).requires_grad_(True)
    opt = (torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
           if optimizer is None else optimizer([theta]))
    history, thetas = [], [theta.detach().cpu().numpy().copy()]
    g_norm = 0.0
    for _ in range(steps):
        val, g = _value_and_grad(loss, theta)
        history.append(float(val))
        g_norm = float(torch.linalg.vector_norm(g))
        opt.zero_grad(set_to_none=True)
        theta.grad = g
        opt.step()
        if bounds is not None:
            with torch.no_grad():
                theta.clamp_(bounds[0], bounds[1])
        thetas.append(theta.detach().cpu().numpy().copy())
    history.append(float(_value_and_grad(loss, theta)[0]))
    return OptResult(theta=theta.detach().cpu().numpy(), objective=history[-1],
                     history=np.asarray(history), thetas=np.stack(thetas), grad_norm=g_norm)


def grad_nacelle_accel_std(members: MemberSet, rna: RNA, env: Env, wave: WaveState, C_moor,
                           theta, apply_fn: Callable = scale_diameters, bem=None,
                           n_iter: int = 25, remat: bool = False, case_reduce=None,
                           dtype=torch.float64, device=None) -> Tensor:
    """d sigma_nacelle / d theta, the headline co-design derivative
    (``BASELINE.json`` configs[4]).  A ``theta`` with a leading lane axis
    gives each lane's own gradient."""
    dev = resolve_device(device)
    loss = _make_loss(members, rna, env, wave, C_moor, nacelle_accel_std, apply_fn, bem,
                      n_iter, remat, case_reduce=case_reduce, dtype=dtype, device=dev)
    return _value_and_grad(loss, _theta(theta, dtype, dev))[1]
