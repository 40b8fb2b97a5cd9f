# A frozen copy of raft_tpu_torch/mooring/system.py for the benchmark's reference;
# it imports nothing of the program.
"""Quasi-static mooring system: parse, equilibrium, linearized stiffness
(port of ``raft_tpu.mooring.system``).

Every quantity is a function of the 6-DOF platform displacement ``r6``;
stiffness and tension Jacobians are ``torch.func.jacfwd`` through the
catenary Newton solve, as the JAX package uses ``jax.jacfwd``.

PyTorch numbers its forward-mode AD levels process-wide, so two threads
inside ``jacfwd`` at once corrupt each other's levels ("Trying to access
a forward AD level with an invalid index"): every Jacobian here is taken
under one process-wide lock (the serving daemon stages lanes, mooring
stiffness included, in several connection threads at once).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch.func import jacfwd

from .transforms import cross
from .catenary import CatenaryState, LineProps, solve_catenary

Tensor = torch.Tensor

#: serializes forward-mode AD across threads (see the module docstring);
#: reentrant, since a vmapped caller reaches the same Jacobian again
_JACFWD_LOCK = threading.RLock()


def _jacfwd(fn, **kwargs):
    """``torch.func.jacfwd(fn, **kwargs)``, evaluated under
    :data:`_JACFWD_LOCK`."""
    jac = jacfwd(fn, **kwargs)

    def locked(x):
        with _JACFWD_LOCK:
            return jac(x)

    return locked


@dataclasses.dataclass
class MooringSystem:
    """Stacked single-body mooring system (nl lines, vessel <-> anchor)."""

    r_anchor: Tensor      # (nl, 3) anchor positions, global frame
    r_fair_body: Tensor   # (nl, 3) fairlead positions, body frame
    props: LineProps      # per-line L / w / EA / CB
    depth: Tensor         # () water depth [m]
    yaw_stiffness: Tensor  # () additive C[5, 5]


def mooring_arrays(mooring: dict, rho: float = 1025.0, g: float = 9.81,
                   yaw_stiffness: float = 0.0) -> dict:
    """The :class:`MooringSystem` of a design-YAML ``mooring`` dict as host
    numpy arrays by field (fixed <-> vessel lines; w = g (m_lin - rho pi/4
    d^2)).  A design batch stacks these on the host and copies them once
    (:func:`mooring_from_arrays`)."""
    pts = {p["name"]: p for p in mooring["points"]}
    types = {t["name"]: t for t in mooring["line_types"]}
    anchors, fairs, Ls, ws, EAs, CBs = [], [], [], [], [], []
    for ln in mooring["lines"]:
        a, b = pts[ln["endA"]], pts[ln["endB"]]
        if a["type"] == "vessel":
            a, b = b, a
        if a["type"] != "fixed" or b["type"] != "vessel":
            raise ValueError(f"line {ln['name']}: only fixed<->vessel lines are supported")
        t = types[ln["type"]]
        anchors.append(a["location"])
        fairs.append(b["location"])
        Ls.append(ln["length"])
        m_lin = float(t["mass_density"])
        d = float(t["diameter"])
        ws.append(g * (m_lin - rho * np.pi / 4.0 * d * d))
        EAs.append(float(t["stiffness"]))
        CBs.append(float(t.get("seabed_friction", t.get("cb", 0.0))))
    f = lambda x: np.asarray(x, dtype=float)  # noqa: E731
    return {"r_anchor": f(anchors), "r_fair_body": f(fairs), "L": f(Ls), "w": f(ws),
            "EA": f(EAs), "CB": f(CBs), "depth": f(float(mooring.get("water_depth", 300.0))),
            "yaw_stiffness": f(float(yaw_stiffness))}


def mooring_from_arrays(arrays: dict, device, dtype=torch.float64) -> MooringSystem:
    """Host arrays of :func:`mooring_arrays` (one system, or several with
    the same line count stacked along a leading axis) -> a
    :class:`MooringSystem` on ``device``."""
    def ten(key):
        return torch.as_tensor(arrays[key], device=device).to(dtype)

    return MooringSystem(
        r_anchor=ten("r_anchor"), r_fair_body=ten("r_fair_body"),
        props=LineProps(L=ten("L"), w=ten("w"), EA=ten("EA"), CB=ten("CB")),
        depth=ten("depth"), yaw_stiffness=ten("yaw_stiffness"))


def parse_mooring(mooring: dict, device, dtype=torch.float64, rho: float = 1025.0,
                  g: float = 9.81, yaw_stiffness: float = 0.0) -> MooringSystem:
    """Build a :class:`MooringSystem` from the design-YAML ``mooring`` dict
    on ``device`` (fixed <-> vessel lines; w = g (m_lin - rho pi/4 d^2))."""
    return mooring_from_arrays(mooring_arrays(mooring, rho=rho, g=g, yaw_stiffness=yaw_stiffness),
                               device, dtype)


def _per_system(fn, sys: MooringSystem, *args):
    """``fn(one system, *one lane of args)`` over the leading axis of a
    stacked system (:func:`stack_systems`) in one batched call
    (``torch.func.vmap``, the counterpart of the JAX package's
    ``jax.vmap`` over a stacked MooringSystem)."""
    def one(r_anchor, r_fair_body, L, w, EA, CB, depth, yaw, *a):
        return fn(MooringSystem(r_anchor, r_fair_body, LineProps(L, w, EA, CB), depth, yaw), *a)

    p = sys.props
    return torch.func.vmap(one)(sys.r_anchor, sys.r_fair_body, p.L, p.w, p.EA, p.CB, sys.depth,
                                sys.yaw_stiffness, *args)


def _rotation(r6: Tensor) -> Tensor:
    """Roll-pitch-yaw rotation R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr = torch.cos(r6[3]), torch.sin(r6[3])
    cp, sp = torch.cos(r6[4]), torch.sin(r6[4])
    cy, sy = torch.cos(r6[5]), torch.sin(r6[5])
    o, z = torch.ones_like(cr), torch.zeros_like(cr)
    Rx = torch.stack([torch.stack([o, z, z]), torch.stack([z, cr, -sr]), torch.stack([z, sr, cr])])
    Ry = torch.stack([torch.stack([cp, z, sp]), torch.stack([z, o, z]), torch.stack([-sp, z, cp])])
    Rz = torch.stack([torch.stack([cy, -sy, z]), torch.stack([sy, cy, z]), torch.stack([z, z, o])])
    return Rz @ Ry @ Rx


def fairlead_positions(sys: MooringSystem, r6: Tensor) -> Tensor:
    """Global fairlead positions (nl, 3) for platform displacement r6."""
    return r6[:3] + sys.r_fair_body @ _rotation(r6).T


def line_states(sys: MooringSystem, r6: Tensor) -> CatenaryState:
    """Every line's catenary at the given platform displacement."""
    rf = fairlead_positions(sys, r6)
    dxy = rf[:, :2] - sys.r_anchor[:, :2]
    xf = torch.sqrt(torch.sum(dxy * dxy, dim=-1) + 1e-12)
    zf = rf[:, 2] - sys.r_anchor[:, 2]
    return solve_catenary(xf, zf, sys.props)


def mooring_force(sys: MooringSystem, r6: Tensor) -> Tensor:
    """Net 6-DOF mooring load on the platform at displacement r6."""
    rf = fairlead_positions(sys, r6)
    dxy = sys.r_anchor[:, :2] - rf[:, :2]
    dist = torch.sqrt(torch.sum(dxy * dxy, dim=-1) + 1e-12)
    u = dxy / dist[:, None]
    st = line_states(sys, r6)
    F3 = torch.cat([st.H[:, None] * u, -st.V[:, None]], dim=-1)
    M3 = cross(rf - r6[:3], F3)
    return torch.cat([F3.sum(dim=0), M3.sum(dim=0)])


def mooring_stiffness(sys: MooringSystem, r6: Tensor) -> Tensor:
    """Linearized 6x6 mooring stiffness C = -dF/dr6 about r6, plus the yaw
    spring.  A stacked system with ``r6`` (nT, 6) gives (nT, 6, 6) in one
    batched call."""
    if r6.ndim > 1:
        return _per_system(mooring_stiffness, sys, r6)
    C = -_jacfwd(lambda x: mooring_force(sys, x))(r6)
    C = C.clone()
    C[5, 5] += sys.yaw_stiffness
    return C


def fairlead_tensions(sys: MooringSystem, r6: Tensor) -> Tensor:
    """Fairlead tension magnitude per line (nl,); (nT, nl) for a stacked
    system with ``r6`` (nT, 6)."""
    if r6.ndim > 1:
        return _per_system(fairlead_tensions, sys, r6)
    return line_states(sys, r6).Tf


def solve_equilibrium(sys: MooringSystem, F_const: Tensor, C_body: Tensor,
                      r6_init: Tensor | None = None, iters: int = 40):
    """Mean-offset equilibrium F_const - C_body r6 + F_moor(r6) = 0 by a
    fixed-iteration damped Newton; returns (r6_eq, residual norm).  A
    stacked system with ``F_const`` (nT, 6) and ``C_body`` (nT, 6, 6)
    solves every turbine in one batched Newton: (nT, 6), (nT,)."""
    if F_const.ndim > 1:
        init = () if r6_init is None else (r6_init,)
        return _per_system(lambda s, f, c, *r: solve_equilibrium(s, f, c, *r, iters=iters),
                           sys, F_const, C_body, *init)
    dtype, dev = sys.r_anchor.dtype, sys.r_anchor.device
    r6 = torch.zeros(6, dtype=dtype, device=dev) if r6_init is None else r6_init

    def residual(x):
        r = F_const - C_body @ x + mooring_force(sys, x)
        return r, r

    cap = torch.tensor([10.0, 10.0, 10.0, 0.1, 0.1, 0.1], dtype=dtype, device=dev)
    for _ in range(iters):
        J, r = _jacfwd(residual, has_aux=True)(r6)    # one catenary solve for both
        dx = torch.linalg.solve(J, -r)
        dx = torch.minimum(torch.maximum(dx, -cap), cap)
        r6 = r6 + dx
    res = residual(r6)[0]
    return r6, torch.sqrt(torch.sum(res * res))

