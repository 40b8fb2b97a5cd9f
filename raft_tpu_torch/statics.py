"""Statics assembly: MemberSet + RNA + Env -> 6-DOF rigid-body coefficients
(port of ``raft_tpu.statics``).  Broadcasts over a leading design axis,
with the Env's and RNA's fields (B,) tensors there."""
from __future__ import annotations

import math

import torch

from raft_tpu_torch.core.device import to_device
from raft_tpu_torch.core.frustum import frustum_moi, frustum_vcv
from raft_tpu_torch.core.transforms import (
    rotate_diag_tensor,
    translate_force_3to6,
    translate_matrix_6to6,
)
from raft_tpu_torch.core.types import Env, MemberSet, RigidBodyCoeffs, RNA, per_lane

Tensor = torch.Tensor

_EPS = 1e-12


def _safe_div(a, b):
    ok = torch.abs(b) > _EPS
    return a / torch.where(ok, b, torch.ones_like(b)) * ok


def _sel(cond, a, b):
    """torch.where with a scalar branch promoted to the tensor's dtype."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def segment_inertia(m: MemberSet):
    """Per-segment (mass, center, M6 about the PRP, shell mass, fill mass)."""
    l = m.seg_l
    V_o, hc_o = frustum_vcv(m.seg_dA, m.seg_dB, l, m.seg_circ)
    V_i, hc_i = frustum_vcv(m.seg_diA, m.seg_diB, l, m.seg_circ)
    v_shell = V_o - V_i
    m_shell = v_shell * m.seg_rho_shell
    hc_shell = _safe_div(hc_o * V_o - hc_i * V_i, v_shell)

    frac = _safe_div(m.seg_l_fill, l)
    diB_fill = m.seg_diA + (m.seg_diB - m.seg_diA) * frac[..., None]
    v_fill, hc_fill = frustum_vcv(m.seg_diA, diB_fill, m.seg_l_fill, m.seg_circ)
    m_fill = v_fill * m.seg_rho_fill

    mass = m_shell + m_fill
    hc = _safe_div(hc_fill * m_fill + hc_shell * m_shell, mass)
    center = m.seg_rA + m.seg_q * hc[..., None]

    Ixx_o, Iyy_o, Izz_o = frustum_moi(m.seg_dA, m.seg_dB, l, m.seg_rho_shell, m.seg_circ)
    Ixx_i, Iyy_i, Izz_i = frustum_moi(m.seg_diA, m.seg_diB, l, m.seg_rho_shell, m.seg_circ)
    Ixx_f, Iyy_f, Izz_f = frustum_moi(m.seg_diA, diB_fill, m.seg_l_fill, m.seg_rho_fill, m.seg_circ)
    mh2 = mass * hc * hc
    Ixx = Ixx_o - Ixx_i + Ixx_f - mh2
    Iyy = Iyy_o - Iyy_i + Iyy_f - mh2
    Izz = Izz_o - Izz_i + Izz_f

    I_rot = rotate_diag_tensor(m.seg_R, Ixx, Iyy, Izz)
    M6 = torch.zeros((*mass.shape, 6, 6), dtype=mass.dtype, device=mass.device)
    eye3 = torch.eye(3, dtype=mass.dtype, device=mass.device)
    M6[..., :3, :3] = mass[..., None, None] * eye3
    M6[..., 3:, 3:] = I_rot
    M6_prp = translate_matrix_6to6(center, M6)
    return mass, center, M6_prp, m_shell, m_fill


def segment_hydrostatics(m: MemberSet, env: Env):
    """Per-segment buoyancy force F6, stiffness C6 and waterplane terms
    (crossing / submerged / dry by mask; caps contribute nothing)."""
    rho, g = per_lane(env.rho, 1), per_lane(env.g, 1)
    rA0 = m.seg_rA
    rB0 = m.seg_rA + m.seg_q * m.seg_l[..., None]
    flip = rA0[..., 2] > rB0[..., 2]
    f3 = flip[..., None]
    rA_s = torch.where(f3, rB0, rA0)
    rB_s = torch.where(f3, rA0, rB0)
    qv = torch.where(f3, -m.seg_q, m.seg_q)
    dA = torch.where(flip[..., None], m.seg_dB, m.seg_dA)
    dB = torch.where(flip[..., None], m.seg_dA, m.seg_dB)

    zA = rA_s[..., 2]
    zB = rB_s[..., 2]
    live = m.seg_mask & ~m.seg_is_cap
    crossing = (zA < 0.0) & (zB >= 0.0) & live
    submerged = (zA <= 0.0) & (zB <= 0.0) & ~crossing & live

    cosPhi = torch.clamp(qv[..., 2], min=_EPS)
    sinPhi = torch.sqrt(torch.clamp(qv[..., 0] ** 2 + qv[..., 1] ** 2, 0.0, 1.0))
    tanPhi = sinPhi / cosPhi
    beta = torch.atan2(qv[..., 1], qv[..., 0])

    frac = _safe_div(0.0 - zA, zB - zA)
    dWP = dA + (dB - dA) * frac[..., None]
    xWP = rA_s[..., 0] + (rB_s[..., 0] - rA_s[..., 0]) * frac
    yWP = rA_s[..., 1] + (rB_s[..., 1] - rA_s[..., 1]) * frac
    AWP_c = torch.where(m.seg_circ, 0.25 * math.pi * dWP[..., 0] * dWP[..., 1],
                        dWP[..., 0] * dWP[..., 1])
    IxWP_rect = dWP[..., 0] * dWP[..., 1] ** 3 / 12.0
    IyWP_rect = dWP[..., 0] ** 3 * dWP[..., 1] / 12.0
    I_rot = rotate_diag_tensor(m.seg_R, IxWP_rect, IyWP_rect, torch.zeros_like(IxWP_rect))
    IWP_circ = math.pi / 64.0 * (dWP[..., 0] * dWP[..., 1]) ** 2
    IxWP = torch.where(m.seg_circ, IWP_circ, I_rot[..., 0, 0])
    IyWP = torch.where(m.seg_circ, IWP_circ, I_rot[..., 1, 1])

    LWP = torch.abs(zA) / cosPhi
    V_c, hc_c = frustum_vcv(dA, dWP, LWP, m.seg_circ)
    r_center_c = rA_s + qv * hc_c[..., None]

    Fz_c = rho * g * V_c
    dWPm = 0.5 * (dWP[..., 0] + dWP[..., 1])
    M_incline = (
        -rho * g * math.pi
        * (dWPm**2 / 32.0 * (2.0 + tanPhi**2) + 0.5 * (zA / cosPhi) ** 2)
        * sinPhi
    )
    Mx_c = M_incline * (-torch.sin(beta))
    My_c = M_incline * torch.cos(beta)

    V_s, hc_s = frustum_vcv(dA, dB, m.seg_l, m.seg_circ)
    r_center_s = rA_s + qv * hc_s[..., None]

    V = _sel(crossing, V_c, _sel(submerged, V_s, 0.0))
    r_center = _sel(crossing[..., None], r_center_c,
                    _sel(submerged[..., None], r_center_s, 0.0))

    F6_c = torch.zeros((*V.shape, 6), dtype=V.dtype, device=V.device)
    F6_c[..., 2] = Fz_c
    F6_c[..., 3] = Mx_c + Fz_c * rA_s[..., 1]
    F6_c[..., 4] = My_c - Fz_c * rA_s[..., 0]
    fz_s = torch.stack([torch.zeros_like(V_s), torch.zeros_like(V_s), rho * g * V_s], dim=-1)
    F6_s = translate_force_3to6(r_center_s, fz_s)
    F6 = _sel(crossing[..., None], F6_c, _sel(submerged[..., None], F6_s, 0.0))

    C6 = torch.zeros((*V.shape, 6, 6), dtype=V.dtype, device=V.device)
    rgAWP = rho * g * AWP_c
    C6[..., 2, 2] = rgAWP / cosPhi
    C6[..., 2, 3] = -rgAWP * yWP
    C6[..., 3, 2] = -rgAWP * yWP
    C6[..., 2, 4] = rgAWP * xWP
    C6[..., 4, 2] = rgAWP * xWP
    C6[..., 3, 3] = rho * g * (IxWP + AWP_c * yWP**2)
    C6[..., 4, 4] = rho * g * (IyWP + AWP_c * xWP**2)
    C6[..., 3, 4] = rgAWP * xWP * yWP
    C6[..., 4, 3] = rgAWP * xWP * yWP
    C6 = _sel(crossing[..., None, None], C6, 0.0)
    rgVz = rho * g * V * r_center[..., 2]
    C6[..., 3, 3] += rgVz
    C6[..., 4, 4] += rgVz

    return {
        "F6": F6,
        "C6": C6,
        "V": V,
        "r_center": r_center,
        "AWP": _sel(crossing, AWP_c, 0.0),
        "IxWP": _sel(crossing, IxWP, 0.0),
        "IyWP": _sel(crossing, IyWP, 0.0),
        "xWP": _sel(crossing, xWP, 0.0),
        "yWP": _sel(crossing, yWP, 0.0),
    }


def assemble_statics(m: MemberSet, rna: RNA, env: Env) -> RigidBodyCoeffs:
    """Full statics assembly (cf. ``raft_tpu.statics.assemble_statics``)."""
    g = env.g
    smask = m.seg_mask
    w = smask.to(m.seg_l.dtype)

    mass, center, M6, m_shell_seg, m_fill_seg = segment_inertia(m)
    mass = mass * w
    M6 = M6 * w[..., None, None]
    zero = torch.zeros_like(mass)

    W_struc = translate_force_3to6(
        center, torch.stack([zero, zero, -per_lane(g, 1) * mass], dim=-1)).sum(dim=-2)
    M_struc = M6.sum(dim=-3)
    Sum_M_center = (mass[..., None] * center).sum(dim=-2)

    is_tow = (m.seg_type <= 1) & smask
    is_sub = (m.seg_type > 1) & smask
    wt = is_tow.to(mass.dtype)
    ws = is_sub.to(mass.dtype)
    one = torch.ones_like(mass[..., 0])
    m_tower = (mass * wt).sum(dim=-1)
    rCG_tower = ((mass * wt)[..., None] * center).sum(dim=-2) / torch.where(
        m_tower > 0, m_tower, one)[..., None]
    m_sub = (mass * ws).sum(dim=-1)
    rCG_sub = ((mass * ws)[..., None] * center).sum(dim=-2) / torch.where(
        m_sub > 0, m_sub, one)[..., None]
    m_shell = (m_shell_seg * ws).sum(dim=-1)
    m_ballast = (m_fill_seg * ws).sum(dim=-1)

    I44B = (M6[..., 3, 3] * ws).sum(dim=-1)
    I55B = (M6[..., 4, 4] * ws).sum(dim=-1)
    I66B = (M6[..., 5, 5] * ws).sum(dim=-1)
    x2 = rCG_sub[..., 1] ** 2 + rCG_sub[..., 2] ** 2
    y2 = rCG_sub[..., 0] ** 2 + rCG_sub[..., 2] ** 2
    z2 = rCG_sub[..., 0] ** 2 + rCG_sub[..., 1] ** 2
    I44 = I44B - m_sub * x2
    I55 = I55B - m_sub * y2
    I66 = I66B - m_sub * z2

    hs = segment_hydrostatics(m, env)
    W_hydro = (hs["F6"] * w[..., None]).sum(dim=-2)
    C_hydro = (hs["C6"] * w[..., None, None]).sum(dim=-3)
    V = (hs["V"] * w).sum(dim=-1)
    rCB = _safe_div((hs["V"][..., None] * hs["r_center"]).sum(dim=-2), V[..., None])
    AWP = (hs["AWP"] * w).sum(dim=-1)
    IWPx = ((hs["IxWP"] + hs["AWP"] * hs["yWP"] ** 2) * w).sum(dim=-1)
    IWPy = ((hs["IyWP"] + hs["AWP"] * hs["xWP"] ** 2) * w).sum(dim=-1)

    dtype, dev = mass.dtype, mass.device

    def scalar(x):
        return to_device(x, dtype, dev)

    xcg = scalar(rna.xCG_RNA)
    rna_center = torch.stack([xcg, torch.zeros_like(xcg), scalar(rna.hHub)], dim=-1)
    mR = scalar(rna.mRNA)
    rna_M = torch.zeros((*mR.shape, 6, 6), dtype=dtype, device=dev)
    rna_M[..., 0, 0] = mR
    rna_M[..., 1, 1] = mR
    rna_M[..., 2, 2] = mR
    rna_M[..., 3, 3] = scalar(rna.IxRNA)
    rna_M[..., 4, 4] = scalar(rna.IrRNA)
    rna_M[..., 5, 5] = scalar(rna.IrRNA)
    W_struc = W_struc + translate_force_3to6(
        rna_center, torch.stack([mR * 0, mR * 0, -g * mR], dim=-1))
    M_struc = M_struc + translate_matrix_6to6(rna_center, rna_M)
    Sum_M_center = Sum_M_center + mR[..., None] * rna_center

    mTOT = M_struc[..., 0, 0]
    rCG = Sum_M_center / mTOT[..., None]
    zMeta = _sel(V > 0, rCB[..., 2] + _safe_div(IWPx, V), 0.0)

    C_struc = torch.zeros_like(M_struc)
    cg_term = -mTOT * g * rCG[..., 2]
    C_struc[..., 3, 3] = cg_term
    C_struc[..., 4, 4] = cg_term

    return RigidBodyCoeffs(
        M_struc=M_struc, C_struc=C_struc, W_struc=W_struc, C_hydro=C_hydro,
        W_hydro=W_hydro, mass=mTOT, rCG=rCG, V=V, rCB=rCB, AWP=AWP,
        IWPx=IWPx, IWPy=IWPy, zMeta=zMeta, m_tower=m_tower,
        rCG_tower=rCG_tower, m_sub=m_sub, rCG_sub=rCG_sub, m_shell=m_shell,
        m_ballast=m_ballast, I44=I44, I55=I55, I66=I66, I44B=I44B, I55B=I55B,
    )
