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
objectives, its own gradient.  A batched sea state
(:func:`~raft_tpu_torch.parallel.sweep.make_wave_states`) makes each case
a lane of one design instead, reduced by ``case_reduce`` (robust design
over a DLC table).  ``bem_fn``
(:func:`raft_tpu_torch.hydro.torch_bem.make_bem_fn`) re-solves the panel
method inside the loss, so the gradient carries the potential-flow
coefficients' dependence on the hull.  Not ported: the JAX package's
compiled-executable cache around the value-and-grad step (ROADMAP.md,
queue 1, item 7.2, the cache slice: PyTorch runs eagerly).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.types import Env, MemberSet, RNA, WaveState
from raft_tpu_torch.parallel.sweep import (_bem_device_layout, _stage_heading_rows, _stage_zeta,
                                           forward_response, scale_diameters)

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


def _make_loss(members: MemberSet, rna: RNA, env: Env, wave: WaveState, C_moor,
               objective: Callable, apply_fn: Callable, bem, n_iter: int, remat: bool,
               case_reduce=None, moor=None, moor_apply_fn=None, r6_moor=None,
               bem_fn=None, dtype=torch.float64, device=None):
    """theta -> objective(Xi) through the reverse-differentiable pipeline.

    With ``moor`` and ``moor_apply_fn(moor, theta)`` the mooring stiffness
    is recomputed inside the loss from the theta-modified system at
    ``r6_moor`` (default zeros), and ``C_moor`` is ignored.

    ``wave`` may be one sea state or a batch with a case axis
    (:func:`~raft_tpu_torch.parallel.sweep.make_wave_states`): each case is
    then a lane of one design with its own drag-linearized fixed point, and
    the per-case objectives reduce with ``case_reduce`` (default
    ``torch.max``, worst case over the DLC table; :func:`energy_sum` for
    the lanes of one spread sea).

    ``bem_fn`` (not with ``bem``): ``theta -> (A[nw, 6, 6], B[nw, 6, 6],
    F Cx[nw, 6])`` re-solved inside the loss, one solve per theta shared by
    every sea state, zeta-staged per case.  ``bem``, frozen at the nominal
    hull: ``stage_bem`` output (one sea state only), the raw host tuple
    (A[6, 6, nw], B[6, 6, nw], F[6, nw]) when every lane has one heading,
    or the staged heading grid (betas, F_all[nb, 6, nw], A, B) of
    ``Model.calcBEM(headings=...)``, each lane's excitation interpolated to
    its heading."""
    dev = resolve_device(device)
    batched = wave.zeta.ndim == 2
    if case_reduce is None:
        case_reduce = torch.max
    if bem_fn is not None and bem is not None:
        raise ValueError("pass bem (frozen coefficients) OR bem_fn (differentiable re-solve), "
                         "not both")
    if bem_fn is not None and batched and wave.beta is not None:
        raise ValueError("bem_fn solves one heading; lanes carrying their own wave headings "
                         "need the staged heading-grid bem instead")
    staged = None          # (A, B, F_re, F_im) to zeta-stage per case
    if bem is not None:
        if len(bem) == 4:                                   # staged heading grid
            if batched:
                betas_eval = (wave.beta.cpu().numpy() if wave.beta is not None
                              else np.full(wave.zeta.shape[0], float(env.beta)))
            else:
                betas_eval = [float(env.beta if wave.beta is None else wave.beta)]
            staged = _stage_heading_rows(bem, betas_eval, dtype, dev)
            if not batched:
                bem = _stage_zeta(staged[:2] + (staged[2][0], staged[3][0]), wave.zeta)
                staged = None
        elif isinstance(bem[2], Cx):                        # stage_bem output
            if batched:
                raise ValueError(
                    "batched sea states need the raw (A[6,6,nw], B[6,6,nw], F[6,nw]) "
                    "coefficient tuple, not stage_bem output: the zeta scaling is per-case")
        else:                                               # raw host layout
            if batched and wave.beta is not None:
                raise ValueError(
                    "lanes vary the wave heading but bem is a single-heading (A, B, F) tuple; "
                    "pass the staged heading grid (betas, F_all, A, B) from "
                    "Model.calcBEM(headings=...) so each lane's excitation matches its heading")
            staged = _bem_device_layout(bem, dtype, dev)
            if not batched:
                bem = _stage_zeta(staged, wave.zeta)
                staged = None

    def loss(theta: Tensor) -> Tensor:
        m = apply_fn(members, theta)
        b = bem
        if bem_fn is not None:
            A_d, B_d, F_cx = bem_fn(theta)
            b = _stage_zeta((A_d, B_d, F_cx.re, F_cx.im), wave.zeta)
        elif staged is not None:
            b = _stage_zeta(staged, wave.zeta)
        if moor is not None:
            from raft_tpu_torch.mooring.system import mooring_stiffness

            sys_t = moor_apply_fn(moor, theta)
            r0 = (torch.zeros(6, dtype=sys_t.r_anchor.dtype, device=sys_t.r_anchor.device)
                  if r6_moor is None else r6_moor)
            C = mooring_stiffness(sys_t, r0)
        else:
            C = C_moor
        out = forward_response(m, rna, env, wave, C, bem=b, n_iter=n_iter, method="scan",
                               remat=remat, dtype=dtype, device=dev)
        per = objective(out.Xi, wave, rna)
        return case_reduce(per) if batched else per

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
    coefficients are the nominal hull's and are held constant; with
    ``bem_fn`` (:func:`raft_tpu_torch.hydro.torch_bem.make_bem_fn`) the panel
    solve runs differentiably inside each step instead.  A batched ``wave``
    reduces its cases with ``case_reduce`` (see :func:`_make_loss`).
    Returns the parameter and objective trajectory.
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
    gives each lane's own gradient; a batched ``wave`` gives the gradient
    of the ``case_reduce`` (default worst-case) statistic."""
    dev = resolve_device(device)
    loss = _make_loss(members, rna, env, wave, C_moor, nacelle_accel_std, apply_fn, bem,
                      n_iter, remat, case_reduce=case_reduce, dtype=dtype, device=dev)
    return _value_and_grad(loss, _theta(theta, dtype, dev))[1]
