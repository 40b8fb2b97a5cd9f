# A frozen copy of raft_tpu_torch/mooring/catenary.py for the benchmark's reference;
# it imports nothing of the program.
"""Analytic elastic catenary with seabed contact and friction (port of
``raft_tpu.mooring.catenary``).

The fairlead tensions (H, V) solve the closed-form catenary equations by a
fixed-iteration damped Newton with the analytic 2x2 Jacobian.  The solve
carries an implicit forward- and reverse-mode derivative, so
``torch.func.jacfwd`` of the mooring force (the stiffness) does not trace
the Newton iterations: eager PyTorch pays for every traced operation, and
a traced 60-step Newton inside every equilibrium step made one OC3
analysis take minutes on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

_H_MIN = 1e-6


@dataclasses.dataclass
class LineProps:
    """Per-line scalar properties (each (nl,))."""

    L: Tensor      # unstretched length [m]
    w: Tensor      # submerged weight per unit length [N/m]
    EA: Tensor     # axial stiffness [N]
    CB: Tensor     # seabed friction coefficient [-]


@dataclasses.dataclass
class CatenaryState:
    H: Tensor
    V: Tensor
    Ta: Tensor
    Tf: Tensor
    LB: Tensor
    residual: Tensor


def _where0(cond, a):
    return torch.where(cond, a, torch.zeros_like(a))


def _profile_residual(H, V, xf, zf, p: LineProps):
    """Residuals (x_model - xf, z_model - zf), branch chosen by V."""
    return _residual_and_jac(H, V, xf, zf, p)[0]


def initial_guess(xf, zf, p: LineProps):
    """MAP-style starting point for (H, V)."""
    L, w = p.L, p.w
    slack = L * L > xf * xf + zf * zf
    arg = torch.clamp((L * L - zf * zf) / torch.clamp(xf * xf, min=1e-12) - 1.0, min=1e-6)
    lam = torch.where(slack, torch.sqrt(3.0 * arg), torch.full_like(arg, 0.2))
    lam = torch.where(xf <= 1e-6, torch.full_like(lam, 1000.0), lam)
    H0 = torch.clamp(torch.abs(0.5 * w * xf / lam), min=10.0)
    V0 = 0.5 * w * (zf / torch.tanh(lam) + L)
    return H0, V0


def _residual_and_jac(H, V, xf, zf, p: LineProps):
    """The residuals (rx, rz) and their analytic Jacobian in (H, V) -- the
    derivative the JAX package takes with ``jax.jvp`` -- in one pass.

    Suspended (V - wL >= 0):
      x = (H/w)[asinh(V/H) - asinh((V-wL)/H)] + H L/EA
      z = (H/w)[sqrt(1+(V/H)^2) - sqrt(1+((V-wL)/H)^2)] + (V L - w L^2/2)/EA
    Seabed contact (resting length LB = max(L - V/w, 0), friction CB):
      x = LB + (H/w) asinh(V/H) + H L/EA + (CB w/(2EA)) (x0 max(x0,0) - LB^2)
      z = (H/w)[sqrt(1+(V/H)^2) - 1] + V^2/(2 EA w),  x0 = LB - H/(CB w)
    """
    w, L, EA = p.w, p.L, p.EA
    Va = V - w * L
    touchdown = Va < 0.0
    s_f = V / H
    s_a = Va / H
    sq_f = torch.sqrt(1.0 + s_f * s_f)
    sq_a = torch.sqrt(1.0 + s_a * s_a)
    as_f = torch.asinh(s_f)
    as_a = torch.asinh(s_a)
    HL_EA = H * L / EA

    x_susp = (H / w) * (as_f - as_a) + HL_EA
    z_susp = (H / w) * (sq_f - sq_a) + (V * L - 0.5 * w * L * L) / EA
    xs_H = (as_f - as_a - s_f / sq_f + s_a / sq_a) / w + L / EA
    xs_V = (1.0 / sq_f - 1.0 / sq_a) / w       # equals dz/dH when suspended
    zs_V = (s_f / sq_f - s_a / sq_a) / w + L / EA

    LB = torch.clamp(L - V / w, min=0.0)
    dLB_V = torch.where(L - V / w > 0, -1.0 / w, torch.zeros_like(w))
    cbw = p.CB * w
    pos = cbw > 0
    cbw_safe = torch.where(pos, cbw, torch.ones_like(cbw))
    x0 = LB - H / cbw_safe
    c = _where0(pos, cbw / (2.0 * EA))
    x0p = torch.clamp(x0, min=0.0)
    fric = c * (x0 * x0p - LB * LB)
    x_td = LB + (H / w) * as_f + HL_EA + fric
    z_td = (H / w) * (sq_f - 1.0) + V * V / (2.0 * EA * w)
    xt_H = (as_f - s_f / sq_f) / w + L / EA - c * 2.0 * x0p / cbw_safe
    xt_V = dLB_V + 1.0 / (w * sq_f) + c * (2.0 * x0p * dLB_V - 2.0 * LB * dLB_V)
    zt_H = (1.0 / sq_f - 1.0) / w
    zt_V = s_f / (w * sq_f) + V / (EA * w)

    res = (torch.where(touchdown, x_td, x_susp) - xf,
           torch.where(touchdown, z_td, z_susp) - zf)
    jac = ((torch.where(touchdown, xt_H, xs_H), torch.where(touchdown, xt_V, xs_V)),
           (torch.where(touchdown, zt_H, xs_V), torch.where(touchdown, zt_V, zs_V)))
    return res, jac


def _newton(xf, zf, p: LineProps, iters: int):
    """Damped Newton for (H, V): steps capped at 50% of the iterate (+1)."""
    H, V = initial_guess(xf, zf, p)
    for _ in range(iters):
        (rx, rz), ((drx_dH, drx_dV), (drz_dH, drz_dV)) = _residual_and_jac(H, V, xf, zf, p)
        det = drx_dH * drz_dV - drx_dV * drz_dH
        det = torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
        dH = (-rx * drz_dV + rz * drx_dV) / det
        dV = (-rz * drx_dH + rx * drz_dH) / det
        capH = 0.5 * torch.abs(H) + 1.0
        capV = 0.5 * torch.abs(V) + 1.0
        dH = torch.minimum(torch.maximum(dH, -capH), capH)
        dV = torch.minimum(torch.maximum(dV, -capV), capV)
        H = torch.clamp(H + dH, min=_H_MIN)
        V = V + dV
    return H, V


class _CatenaryHV(torch.autograd.Function):
    """(xf, zf, line properties) -> converged (H, V), differentiated
    implicitly: at the solution r(H, V; inputs) = 0, so
    J d(H, V) = -dr/d(inputs) with J the residual Jacobian in (H, V) -- the
    value the JAX package's forward-mode derivative through the converged
    Newton iterations reaches."""

    generate_vmap_rule = True

    @staticmethod
    def forward(xf, zf, L, w, EA, CB, iters):
        return _newton(xf, zf, LineProps(L=L, w=w, EA=EA, CB=CB), iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:6], *output)
        ctx.save_for_backward(*inputs[:6], *output)

    @staticmethod
    def _split(saved):
        """(residual as a function of the six inputs, J^-1 entries)."""
        xf, zf, L, w, EA, CB, H, V = saved

        def resid(*x):
            return torch.stack(_profile_residual(
                H, V, x[0], x[1], LineProps(L=x[2], w=x[3], EA=x[4], CB=x[5])))

        (a, b), (c, d) = _residual_and_jac(H, V, xf, zf, LineProps(L=L, w=w, EA=EA, CB=CB))[1]
        det = a * d - b * c
        return resid, (xf, zf, L, w, EA, CB), (d / det, -b / det, -c / det, a / det)

    @staticmethod
    def jvp(ctx, *tangents):
        resid, primals, (i00, i01, i10, i11) = _CatenaryHV._split(ctx.saved_tensors)
        tan = tuple(torch.zeros_like(p) if t is None else t
                    for p, t in zip(primals, tangents[:6]))
        dr = torch.func.jvp(resid, primals, tan)[1]
        return -(i00 * dr[0] + i01 * dr[1]), -(i10 * dr[0] + i11 * dr[1])

    @staticmethod
    def backward(ctx, gH, gV):
        resid, primals, (i00, i01, i10, i11) = _CatenaryHV._split(ctx.saved_tensors)
        lam = torch.stack([i00 * gH + i10 * gV, i01 * gH + i11 * gV])
        grads = torch.func.vjp(resid, *primals)[1](-lam)
        return (*grads, None)


def solve_catenary(xf, zf, p: LineProps, iters: int = 60) -> CatenaryState:
    """Solve the catenary equations for (H, V) by damped Newton; all
    arguments broadcast over a batch of lines."""
    H, V = _CatenaryHV.apply(xf, zf, p.L, p.w, p.EA, p.CB, iters)
    rx, rz = _profile_residual(H, V, xf, zf, p)
    Va = torch.clamp(V - p.w * p.L, min=0.0)
    LB = torch.clamp(p.L - V / p.w, min=0.0)
    Ha = torch.where(V < p.w * p.L, torch.clamp(H - p.CB * p.w * LB, min=0.0), H)
    Ta2 = Ha * Ha + Va * Va
    pos = Ta2 > 0
    Ta = _where0(pos, torch.sqrt(torch.where(pos, Ta2, torch.ones_like(Ta2))))
    return CatenaryState(H=H, V=V, Ta=Ta, Tf=torch.sqrt(H * H + V * V), LB=LB,
                         residual=torch.maximum(torch.abs(rx), torch.abs(rz)))
