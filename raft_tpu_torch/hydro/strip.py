"""Strip-theory (Morison) hydrodynamics over the stacked node axis (port of
``raft_tpu.hydro.strip``).

Frequency is the leading data axis of assembled outputs: excitation is
(..., nw, 6), node kinematics (..., N, nw, 3).  Every function broadcasts
over a leading design axis; the frequency grid ``w`` is shared by all
designs of a batch, and the Env's fields may be (B,) tensors, one per
lane (:func:`~raft_tpu_torch.core.types.per_lane`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from raft_tpu_torch.core import cplx
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.transforms import (
    cross, translate_force_3to6, translate_matrix_3to6, vec_outer,
)
from raft_tpu_torch.core.device import to_device
from raft_tpu_torch.core.types import Env, MemberSet, WaveState, per_lane
from raft_tpu_torch.core.waves import wave_kinematics

Tensor = torch.Tensor

_SQRT_8_PI = math.sqrt(8.0 / math.pi)


def _t(x, like: Tensor) -> Tensor:
    return to_device(x, like.dtype, like.device)


def node_current(m: MemberSet, env: Env) -> Tensor:
    """Per-node steady-current velocity vectors (..., N, 3), power-law
    shear profile over the water column."""
    z = m.node_r[..., 2]
    depth = per_lane(env.depth, 1)
    frac = torch.clamp((depth + z) / depth, 0.0, 1.0)
    u = per_lane(env.current, 1) * frac ** per_lane(env.current_exp, 1)
    ch = _t(per_lane(env.current_heading, 1), z)
    dirv = torch.stack([torch.cos(ch), torch.sin(ch), torch.zeros_like(ch)], dim=-1)
    return u[..., None] * dirv


def _gauss_drag_slope(U: Tensor, sigma: Tensor) -> Tensor:
    """MMSE linearization slope of |X| X for X ~ N(U, sigma^2), with the
    double-where guard for sigma = 0 lanes."""
    pos = sigma > 0
    s_safe = torch.where(pos, sigma, torch.ones_like(sigma))
    r = U / (s_safe * math.sqrt(2.0))
    slope = 2.0 * U * torch.erf(r) + _SQRT_8_PI * sigma * torch.exp(-(r**2))
    return torch.where(pos, slope, 2.0 * torch.abs(U))


def _end_area_signed(m: MemberSet) -> Tensor:
    a_circ = math.pi * m.node_ds[..., 0] * m.node_drs[..., 0]
    a_rect = (m.node_ds[..., 0] + m.node_drs[..., 0]) * (m.node_ds[..., 1] + m.node_drs[..., 1]) - (
        m.node_ds[..., 0] - m.node_drs[..., 0]
    ) * (m.node_ds[..., 1] - m.node_drs[..., 1])
    return torch.where(m.node_circ, a_circ, a_rect)


def _drag_areas(m: MemberSet):
    """Per-node drag reference areas (axial skin, p1, p2, end disk)."""
    d0, d1 = m.node_ds[..., 0], m.node_ds[..., 1]
    dls = m.node_dls
    a_q = torch.where(m.node_circ, math.pi * d0 * dls, 2.0 * (d0 + d1) * dls)
    a_p1 = d0 * dls
    a_p2 = torch.where(m.node_circ, d0 * dls, d1 * dls)
    a_end = torch.abs(_end_area_signed(m))
    return a_q, a_p1, a_p2, a_end


def _submerged(m: MemberSet) -> Tensor:
    return (m.node_r[..., 2] < 0.0) & m.node_mask


def current_mean_force(m: MemberSet, env: Env) -> Tensor:
    """Mean 6-DOF drag load of the steady current about the PRP."""
    uc = node_current(m, env)
    U_q = (uc * m.node_q).sum(-1)
    U_p1 = (uc * m.node_p1).sum(-1)
    U_p2 = (uc * m.node_p2).sum(-1)
    a_q, a_p1, a_p2, a_end = _drag_areas(m)
    half_rho = 0.5 * per_lane(env.rho, 1)

    def mean_drag(U, a, Cd):
        return half_rho * a * Cd * torch.abs(U) * U

    F3 = (
        (mean_drag(U_q, a_q, m.node_Cd_q)
         + mean_drag(U_q, a_end, m.node_Cd_end))[..., None] * m.node_q
        + mean_drag(U_p1, a_p1, m.node_Cd_p1)[..., None] * m.node_p1
        + mean_drag(U_p2, a_p2, m.node_Cd_p2)[..., None] * m.node_p2
    )
    F3 = F3 * _submerged(m).to(F3.dtype)[..., None]
    return translate_force_3to6(m.node_r, F3).sum(dim=-2)


@dataclasses.dataclass
class StripKin:
    """Wave kinematics at the strip nodes."""

    u: Cx      # (..., N, nw, 3) velocity amplitudes
    ud: Cx     # (..., N, nw, 3) acceleration amplitudes
    pDyn: Cx   # (..., N, nw)    dynamic pressure amplitudes


def node_kinematics(m: MemberSet, wave: WaveState, env: Env) -> StripKin:
    """Wave kinematics at every strip node.  A ``wave.zeta`` with a leading
    lane axis (B, nw) makes each sea state a lane (outputs (B, N, ...)),
    each at its own heading when ``env.beta`` is a (B,) tensor: the lanes
    of one design's nodes (``k`` one (nw,) grid), or of a design batch,
    whose ``k`` (B, nw) and Env fields (B,) carry each lane's own water
    depth.  ``w`` stays one (nw,) grid."""
    zeta, k = wave.zeta, wave.k
    if zeta.ndim > 1:
        zeta = zeta[..., None, :]
    if k.ndim > 1:
        k = k[..., None, :]
    u, ud, pDyn = wave_kinematics(
        zeta, wave.w, k, per_lane(env.depth, 2), m.node_r, per_lane(env.beta, 2),
        per_lane(env.rho, 2), per_lane(env.g, 2))
    return StripKin(u=u.swapaxes(-1, -2), ud=ud.swapaxes(-1, -2), pDyn=pDyn)


def _morison_active(m: MemberSet) -> Tensor:
    """Submerged nodes whose inertial hydro comes from strip theory
    (circular potMod members are left to a BEM provider)."""
    act = _submerged(m)
    if m.node_potmod is not None:
        act = act & ~(m.node_potmod & m.node_circ)
    return act


def _side_volume(m: MemberSet) -> Tensor:
    d0, d1 = m.node_ds[..., 0], m.node_ds[..., 1]
    return torch.where(m.node_circ, 0.25 * math.pi * d0 * d0 * m.node_dls,
                       d0 * d1 * m.node_dls)


def _end_volume(m: MemberSet) -> Tensor:
    d_c = m.node_ds[..., 0]
    dr_c = m.node_drs[..., 0]
    v_circ = math.pi / 6.0 * ((d_c + dr_c) ** 3 - (d_c - dr_c) ** 3)
    dm = 0.5 * (m.node_ds[..., 0] + m.node_ds[..., 1])
    drm = 0.5 * (m.node_drs[..., 0] + m.node_drs[..., 1])
    v_rect = math.pi / 6.0 * ((dm + drm) ** 3 - (dm - drm) ** 3)
    return torch.where(m.node_circ, v_circ, v_rect)


def _direction_mats(m: MemberSet):
    return vec_outer(m.node_q), vec_outer(m.node_p1), vec_outer(m.node_p2)


def strip_added_mass(m: MemberSet, env: Env, exclude_potmod: bool = False) -> Tensor:
    """Morison added-mass matrix (..., 6, 6) about the PRP."""
    qq, p1p1, p2p2 = _direction_mats(m)
    v_side = _side_volume(m)
    v_end = _end_volume(m)
    Amat = per_lane(env.rho, 3) * (
        v_side[..., None, None]
        * (
            m.node_Ca_q[..., None, None] * qq
            + m.node_Ca_p1[..., None, None] * p1p1
            + m.node_Ca_p2[..., None, None] * p2p2
        )
        + (v_end * m.node_Ca_end)[..., None, None] * qq
    )
    act = _morison_active(m) if exclude_potmod else _submerged(m)
    A6 = translate_matrix_3to6(m.node_r, Amat) * act.to(Amat.dtype)[..., None, None]
    return A6.sum(dim=-3)


def _translate_force_cx(r: Tensor, F: Cx) -> Cx:
    """Complex force at points r (..., N, 3), F (..., N, nw, 3) -> (..., N, nw, 6)."""
    rb = r[..., None, :]
    return Cx(translate_force_3to6(rb, F.re), translate_force_3to6(rb, F.im))


def strip_excitation(m: MemberSet, kin: StripKin, env: Env,
                     exclude_potmod: bool = False) -> Cx:
    """Froude-Krylov + dynamic-pressure excitation (..., nw, 6)."""
    qq, p1p1, p2p2 = _direction_mats(m)
    v_side = _side_volume(m)
    v_end = _end_volume(m)
    Imat = per_lane(env.rho, 3) * (
        v_side[..., None, None]
        * (
            m.node_Ca_q[..., None, None] * qq
            + (1.0 + m.node_Ca_p1)[..., None, None] * p1p1
            + (1.0 + m.node_Ca_p2)[..., None, None] * p2p2
        )
        + (v_end * (1.0 + m.node_Ca_end))[..., None, None] * qq
    )
    F3 = cplx.einsum("...nij,...nwj->...nwi", Imat, kin.ud)
    pa = _end_area_signed(m)[..., None]
    Fp = Cx(kin.pDyn.re * pa, kin.pDyn.im * pa)
    F3 = F3 + Cx(Fp.re[..., None] * m.node_q[..., None, :],
                 Fp.im[..., None] * m.node_q[..., None, :])
    act = _morison_active(m) if exclude_potmod else _submerged(m)
    wgt = act.to(F3.re.dtype)[..., None, None]
    F6 = _translate_force_cx(m.node_r, F3)
    return Cx(F6.re * wgt, F6.im * wgt).sum(axis=-3)


def node_motion(m: MemberSet, Xi: Cx, w: Tensor) -> Cx:
    """Node velocity amplitudes (..., N, nw, 3) from the response Xi
    (..., nw, 6): v = i w (Xi_t + Xi_r x r)."""
    r = m.node_r[..., None, :]                                  # (..., N, 1, 3)

    def disp(x):
        x = x[..., None, :, :]                                  # (..., 1, nw, 6)
        return x[..., :3] + cross(x[..., 3:], r)

    dr = Cx(disp(Xi.re), disp(Xi.im))
    return Cx(dr.re * w[:, None], dr.im * w[:, None]).mul_i()


def linearized_drag(m: MemberSet, kin: StripKin, Xi: Cx, wave: WaveState,
                    env: Env):
    """Stochastically linearized Morison drag about the iterate Xi.

    Returns (B_drag (..., 6, 6), F_drag Cx (..., nw, 6)); the vRMS spectral
    moment reduces per design over (frequency, xyz) only."""
    vnode = node_motion(m, Xi, wave.w)
    vrel = kin.u - vnode

    def vrms(unit):
        w2 = unit[..., None, :] ** 2
        s = ((vrel.re**2 + vrel.im**2) * w2).sum(dim=(-1, -2))
        pos = s > 0
        s_safe = torch.where(pos, s, torch.ones_like(s))
        return torch.where(pos, torch.sqrt(s_safe), torch.zeros_like(s))

    vRMS_q = vrms(m.node_q)
    vRMS_p1 = vrms(m.node_p1)
    vRMS_p2 = vrms(m.node_p2)

    uc = node_current(m, env)
    U_q = (uc * m.node_q).sum(-1)
    U_p1 = (uc * m.node_p1).sum(-1)
    U_p2 = (uc * m.node_p2).sum(-1)

    a_q, a_p1, a_p2, a_end = _drag_areas(m)
    half_rho = 0.5 * per_lane(env.rho, 1)
    Bq = _gauss_drag_slope(U_q, vRMS_q) * half_rho * a_q * m.node_Cd_q
    Bp1 = _gauss_drag_slope(U_p1, vRMS_p1) * half_rho * a_p1 * m.node_Cd_p1
    Bp2 = _gauss_drag_slope(U_p2, vRMS_p2) * half_rho * a_p2 * m.node_Cd_p2
    Bend = _gauss_drag_slope(U_q, vRMS_q) * half_rho * a_end * m.node_Cd_end

    qq, p1p1, p2p2 = _direction_mats(m)
    Bmat = (
        (Bq + Bend)[..., None, None] * qq
        + Bp1[..., None, None] * p1p1
        + Bp2[..., None, None] * p2p2
    )
    Bmat = Bmat * _submerged(m).to(Bmat.dtype)[..., None, None]
    B6 = translate_matrix_3to6(m.node_r, Bmat).sum(dim=-3)
    F3 = cplx.einsum("...nij,...nwj->...nwi", Bmat, kin.u)
    F6 = _translate_force_cx(m.node_r, F3).sum(axis=-3)
    return B6, F6
