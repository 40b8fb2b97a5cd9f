"""The reference's forward pipeline: design YAML -> per-lane RAO statistics,
in plain PyTorch on the frozen copies beside this file.

Statics, strip hydrodynamics, the undisplaced mooring stiffness, optional
panel-BEM coefficients of the nominal hull added to every lane, and the
drag-linearized fixed point of :mod:`.dynamics` (``torch.linalg.solve`` on
complex tensors).  It imports nothing of the program: each stage is worked
out again from the design file, the seeded lanes and the cell's settings.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import yaml

from .cplx import Cx
from .dynamics import LinearCoeffs, solve_dynamics
from .geometry import make_scale_plan, make_stretch_draft
from .members import build_member_set, build_rna
from .mesh import mesh_design
from .mooring import mooring_stiffness, parse_mooring
from .panel import solve_bem
from .rtypes import Env, MemberSet, WaveState
from .statics import assemble_statics
from .strip import node_kinematics, strip_added_mass, strip_excitation
from .waves import jonswap, wave_number

Tensor = torch.Tensor


def load_design(path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


@dataclasses.dataclass
class Inputs:
    design: dict
    members: MemberSet
    rna: object
    env: Env
    wave: WaveState
    C_moor: Tensor


def design_inputs(design: dict, nw: int, w_min: float, w_max: float, Hs: float, Tp: float,
                  dtype, device) -> Inputs:
    """One design's members, RNA, sea state (JONSWAP on ``linspace(w_min,
    w_max, nw)``) and undisplaced mooring stiffness, in ``dtype``."""
    depth = float(design["mooring"]["water_depth"])
    w = torch.as_tensor(np.linspace(w_min, w_max, nw), device=device).to(dtype)
    wave = WaveState(w=w, k=wave_number(w, depth), zeta=torch.sqrt(jonswap(w, Hs, Tp)))
    moor = parse_mooring(design["mooring"], device, dtype,
                         yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0))
    return Inputs(design=design, members=build_member_set(design, device, dtype),
                  rna=build_rna(design), env=Env(Hs=Hs, Tp=Tp, depth=depth), wave=wave,
                  C_moor=mooring_stiffness(moor, torch.zeros(6, dtype=dtype, device=device)))


def scale_diameters(members: MemberSet, scale: Tensor) -> MemberSet:
    """One lane per entry of ``scale`` (B,): every field gains the lane
    axis, every member cross-section is scaled by its lane's entry."""
    B = scale.shape[0]
    scaled = ("seg_dA", "seg_dB", "seg_diA", "seg_diB", "node_ds", "node_drs")
    out = {}
    for f in dataclasses.fields(members):
        a = getattr(members, f.name)
        a = a.expand((B,) + tuple(a.shape))
        if f.name in scaled:
            a = a * scale.reshape((B,) + (1,) * (a.ndim - 1))
        out[f.name] = a
    return MemberSet(**out)


def plan_draft(members: MemberSet):
    """``theta (B, 2) -> members``: plan radius by theta[:, 0], draft by
    theta[:, 1] (the substructure's x, y about the centerline, then its
    vertical extent about the waterline)."""
    draft, plan = make_stretch_draft(members), make_scale_plan(members)
    return lambda m, th: plan(draft(m, th[..., 1]), th[..., 0])


def forward(inp: Inputs, members: MemberSet, bem=None, n_iter: int = 25,
            history: bool = False):
    """Statics, strip hydro and the fixed point for every lane of
    ``members``; ``bem`` (A, B (nw, 6, 6), F Cx (nw, 6)) on the
    spectral-amplitude basis replaces the potMod members' Morison added
    mass and excitation."""
    env, wave = inp.env, inp.wave
    nw = wave.w.shape[-1]
    exclude = bem is not None
    stat = assemble_statics(members, inp.rna, env)
    kin = node_kinematics(members, wave, env)
    A = strip_added_mass(members, env, exclude_potmod=exclude)
    F = strip_excitation(members, kin, env, exclude_potmod=exclude)
    if bem is not None:
        F = F + bem[2]
    M = (stat.M_struc + A)[..., None, :, :].expand(*F.re.shape[:-2], nw, 6, 6)
    B = torch.zeros_like(M)
    if bem is not None:
        M = M + bem[0]
        B = B + bem[1]
    lin = LinearCoeffs(M=M, B=B, C=stat.C_struc + stat.C_hydro + inp.C_moor, F=F)
    return solve_dynamics(members, kin, wave, env, lin, n_iter=n_iter, history=history)


def response_std(Xi: Cx, w: Tensor) -> Tensor:
    """Std dev of each DOF, (..., 6)."""
    return torch.sqrt(torch.sum(Xi.abs2(), dim=-2) * (w[1] - w[0]))


def std_history(res, w: Tensor) -> Tensor:
    """(n_iter, ..., 6) std dev of each step's raw solve (``history=True``)."""
    return torch.stack([response_std(x, w) for x in res.history])


def error_history(res) -> Tensor:
    """(n_iter, ...) the convergence test of each step (``history=True``)."""
    return torch.stack(res.errors)


def nacelle_accel_std(Xi: Cx, w: Tensor, hHub: float) -> Tensor:
    """Std dev of the nacelle fore-aft acceleration -w^2 (surge + hHub pitch)."""
    a_re = -(w**2) * (Xi.re[..., 0] + hHub * Xi.re[..., 4])
    a_im = -(w**2) * (Xi.im[..., 0] + hHub * Xi.im[..., 4])
    return torch.sqrt(torch.sum(a_re**2 + a_im**2, dim=-1) * (w[1] - w[0]))


def interp_to_grid(w_src, arr, w_dst):
    """Linear interpolation of (..., nw_src) coefficients onto ``w_dst``."""
    flat = arr.reshape(-1, arr.shape[-1])
    out = np.stack([np.interp(w_dst, w_src, row.real) + (
        1j * np.interp(w_dst, w_src, row.imag) if np.iscomplexobj(arr) else 0.0)
        for row in flat])
    return out.reshape(arr.shape[:-1] + (len(w_dst),))


def bem_coefficients(design: dict, nw_bem: int, w_min: float, w_max: float, nw: int,
                     dz_max: float, da_max: float, dtype, device):
    """The design's panel coefficients at ``nw_bem`` frequencies, linearly
    interpolated to the sweep's ``nw`` (host layout: A, B (6, 6, nw), F (6,
    nw) complex), and the panel count."""
    depth = float(design["mooring"]["water_depth"])
    panels = mesh_design(design, dz_max=dz_max, da_max=da_max)
    w_bem = np.linspace(w_min, w_max, nw_bem)
    A, B, F, _ = solve_bem(panels, w_bem, beta=0.0, depth=depth, dtype=dtype, device=device)
    w = np.linspace(w_min, w_max, nw)
    return tuple(interp_to_grid(w_bem, a, w) for a in (A, B, F)), len(panels)


def stage_bem(bem, wave: WaveState, dtype, device):
    """Host-layout (A, B, F) -> (A, B (nw, 6, 6), F Cx (nw, 6)) with F on
    the spectral-amplitude basis."""
    A, B, F = bem
    A_t = torch.as_tensor(np.moveaxis(A, -1, 0), device=device).to(dtype)
    B_t = torch.as_tensor(np.moveaxis(B, -1, 0), device=device).to(dtype)
    Fw = np.moveaxis(F, -1, 0)
    z = wave.zeta[:, None].to(dtype)
    return (A_t, B_t, Cx(z * torch.as_tensor(Fw.real, device=device).to(dtype),
                         z * torch.as_tensor(Fw.imag, device=device).to(dtype)))
