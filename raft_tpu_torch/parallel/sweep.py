"""Design-batch forward pipeline and the north-star variant sweep (port of
``raft_tpu.parallel.sweep``: ``scale_diameters``, ``forward_response``,
``response_std``, ``stage_bem``, ``grad_response_std``).

A design batch is a MemberSet with a leading axis; ``forward_response``
runs statics, strip hydrodynamics and the batched drag-linearized fixed
point for every lane at once (the job ``jax.vmap`` does in the JAX
package).  :func:`sweep_north_star` is ``bench.py::north_star``'s
workload: VolturnUS-S plan-radius x draft variants x 200 frequencies, in
chunks, with the std dev reduced on the device.  The caller may add the
nominal hull's BEM coefficients to every lane (:func:`stage_north_star_bem`
solves them on the device with the panel BEM); without them it is the
same sweep on the strip-theory path alone.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from raft_tpu_torch.build.members import build_member_set, build_rna
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.device import require_on, resolve_device
from raft_tpu_torch.core.types import Env, MemberSet, RNA, WaveState
from raft_tpu_torch.core.waves import jonswap, wave_number
from raft_tpu_torch.hydro.strip import node_kinematics, strip_added_mass, strip_excitation
from raft_tpu_torch.mooring.system import mooring_stiffness, parse_mooring
from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
from raft_tpu_torch.solve.dynamics import LinearCoeffs, RAOResult, solve_dynamics
from raft_tpu_torch.statics import assemble_statics

Tensor = torch.Tensor

#: the north star's platform, read as a data file
VOLTURNUS_S = Path(__file__).resolve().parents[2] / "raft_tpu" / "designs" / "VolturnUS-S.yaml"


def scale_diameters(members: MemberSet, scale) -> MemberSet:
    """Uniformly scale all member cross-sections."""
    return dataclasses.replace(
        members,
        seg_dA=members.seg_dA * scale,
        seg_dB=members.seg_dB * scale,
        seg_diA=members.seg_diA * scale,
        seg_diB=members.seg_diB * scale,
        node_ds=members.node_ds * scale,
        node_drs=members.node_drs * scale,
    )


def stage_bem(bem, wave: WaveState):
    """Host-layout BEM coefficients -> frequency-leading device tensors.

    ``bem``: (A[6, 6, nw], B[6, 6, nw], F[6, nw] complex) per unit wave
    amplitude, numpy (the panel solver's / WAMIT reader's layout).
    Returns (A[nw, 6, 6], B[nw, 6, 6], F Cx[nw, 6]) on the wave's device in
    its dtype, with the excitation scaled onto the spectral-amplitude basis
    (zeta = sqrt(S)) of the Morison path."""
    A_bem, B_bem, F_bem = bem
    dev, dtype = wave.zeta.device, wave.zeta.dtype

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    Fb = np.moveaxis(np.asarray(F_bem), -1, 0)           # (nw, 6) complex, host
    z = wave.zeta[:, None]
    return (t(np.moveaxis(np.asarray(A_bem), -1, 0)), t(np.moveaxis(np.asarray(B_bem), -1, 0)),
            Cx(z * t(Fb.real), z * t(Fb.imag)))


def forward_response(members: MemberSet, rna: RNA, env: Env, wave: WaveState,
                     C_moor: Tensor, bem=None, n_iter: int = 25,
                     method: str = "while", remat: bool = False, relax: float = 0.8,
                     tik: float = 0.0, dtype=torch.float64, device=None) -> RAOResult:
    """Design (batch) -> RAO solve: statics, strip hydro, drag fixed point.

    ``members`` may carry a leading design axis; ``wave`` (and its grid) is
    shared by every lane.  ``bem``: optional pre-staged ``(A, B, F)`` with
    A, B (..., nw, 6, 6) and F a Cx (..., nw, 6) on the spectral-amplitude
    basis; the potMod members then leave the Morison added mass and
    excitation.  ``method="scan"`` (with ``remat``) is the
    reverse-differentiable loop: it always runs ``n_iter`` steps, so keep
    the cap tight for gradient work.  Inputs must already lie on ``device``
    in ``dtype``.
    """
    dev = resolve_device(device)
    require_on(dev, dtype, node_r=members.node_r, w=wave.w, zeta=wave.zeta, C_moor=C_moor)
    if wave.beta is not None:
        env = dataclasses.replace(env, beta=wave.beta)
    exclude = bem is not None
    stat = assemble_statics(members, rna, env)
    kin = node_kinematics(members, wave, env)
    A = strip_added_mass(members, env, exclude_potmod=exclude)
    F = strip_excitation(members, kin, env, exclude_potmod=exclude)
    nw = wave.w.shape[-1]
    MA = stat.M_struc + A
    M = MA[..., None, :, :].expand(*MA.shape[:-2], nw, 6, 6)
    B = torch.zeros_like(M)
    if bem is not None:
        A_bem, B_bem, F_bem = bem
        M = M + A_bem
        B = B + B_bem
        F = F + F_bem
    lin = LinearCoeffs(M=M, B=B, C=stat.C_struc + stat.C_hydro + C_moor, F=F)
    return solve_dynamics(members, kin, wave, env, lin, n_iter=n_iter, relax=relax,
                          method=method, remat=remat, tik=tik)


def response_std(Xi_abs2: Tensor, w: Tensor) -> Tensor:
    """Std dev of each DOF from spectral amplitudes |Xi|^2 (..., nw, 6),
    with the double-where guard around sqrt at exactly-zero DOFs."""
    dw = w[1] - w[0]
    s = torch.sum(Xi_abs2, dim=-2) * dw
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))


def grad_response_std(members: MemberSet, rna: RNA, env: Env, wave: WaveState,
                      C_moor: Tensor, theta, dof: int = 0, apply_fn=scale_diameters,
                      n_iter: int = 25, dtype=torch.float64, device=None) -> Tensor:
    """d sigma_dof / d theta: the exact co-design gradient through the whole
    pipeline (statics, Morison, drag-linearized fixed point, scan loop).
    A ``theta`` with a leading lane axis (one design per lane through
    ``apply_fn``) gives each lane's own gradient."""
    dev = resolve_device(device)
    th = torch.as_tensor(theta, dtype=dtype, device=dev).detach().requires_grad_(True)
    out = forward_response(apply_fn(members, th), rna, env, wave, C_moor, n_iter=n_iter,
                           method="scan", dtype=dtype, device=dev)
    sigma = response_std(out.Xi.abs2(), wave.w)[..., dof]
    return torch.autograd.grad(sigma.sum(), th)[0]


def north_star_grid(n_designs: int) -> np.ndarray:
    """(n, 2) [plan-radius scale, draft scale] on the near-square +-10%
    grid of ``bench.py::north_star``."""
    n_d = int(np.sqrt(n_designs))
    while n_designs % n_d != 0:
        n_d -= 1
    n_p = n_designs // n_d

    def axis(n):
        return np.linspace(0.9, 1.1, n) if n > 1 else np.array([1.0])

    dd, pp = np.meshgrid(axis(n_d), axis(n_p))
    return np.stack([pp.ravel(), dd.ravel()], axis=1)


def _volturnus(nw: int, dtype, dev):
    """The north star's design, RNA, sea state (JONSWAP Hs 8 m / Tp 12 s on
    ``linspace(0.05, 2.95, nw)``) and undisplaced mooring stiffness."""
    import yaml

    with open(VOLTURNUS_S) as f:
        design = yaml.safe_load(f)
    members = build_member_set(design, dev, dtype)
    rna = build_rna(design)
    depth = float(design["mooring"]["water_depth"])
    env = Env(Hs=8.0, Tp=12.0, depth=depth)
    w = torch.as_tensor(np.linspace(0.05, 2.95, nw), device=dev).to(dtype)
    wave = WaveState(w=w, k=wave_number(w, depth), zeta=torch.sqrt(jonswap(w, 8.0, 12.0)))
    moor = parse_mooring(design["mooring"], dev, dtype,
                         yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0))
    C_moor = mooring_stiffness(moor, torch.zeros(6, dtype=dtype, device=dev))
    return design, members, rna, env, wave, C_moor


def stage_north_star_bem(nw: int = 200, nw_bem: int = 48, dtype=torch.float64, device=None,
                         return_diagnostics: bool = False):
    """BEM coefficients of the nominal VolturnUS-S hull for the north star
    (``bench.py::_volturn_setup``, with the panel solve on the device).

    Meshes the potMod members at ``dz_max=3, da_max=2``, solves them at
    ``nw_bem`` frequencies over ``linspace(0.05, 2.95, nw_bem)`` (depth
    200 m, heading 0) with kernels K3/K4 on CUDA, interpolates A, B, F to
    the sweep's ``nw`` frequencies and stages them (:func:`stage_bem`).
    Returns (A, B, F Cx) on ``device`` in ``dtype`` (and the panel solve's
    diagnostics with ``return_diagnostics``)."""
    from raft_tpu_torch.hydro.bem_io import interp_to_grid
    from raft_tpu_torch.hydro.mesh import mesh_design
    from raft_tpu_torch.hydro.torch_bem import solve_bem_any

    dev = resolve_device(device)
    design, _members, _rna, env, wave, _C = _volturnus(nw, dtype, dev)
    w = np.linspace(0.05, 2.95, nw)
    w_bem = np.linspace(w[0], w[-1], nw_bem)
    panels = mesh_design(design, dz_max=3.0, da_max=2.0)
    A_c, B_c, F_c, diag = solve_bem_any(panels, w_bem, rho=float(env.rho), g=float(env.g),
                                        beta=0.0, depth=env.depth, mode="jax", dtype=dtype,
                                        device=dev, return_diagnostics=True)
    staged = stage_bem((interp_to_grid(w_bem, A_c, w), interp_to_grid(w_bem, B_c, w),
                        interp_to_grid(w_bem, F_c, w)), wave)
    return (staged, diag) if return_diagnostics else staged


def sweep_north_star(n_designs: int = 1000, nw: int = 200, chunk: int = 250,
                     n_iter: int = 40, dtype=torch.float64, device=None, bem=None,
                     lanes=None) -> dict:
    """The north star: 1,000 VolturnUS-S plan-radius x draft variants x
    ``nw`` frequencies (``bench.py::north_star``).

    JONSWAP Hs 8 m / Tp 12 s on ``linspace(0.05, 2.95, nw)``, undisplaced
    mooring stiffness, the ``while`` loop at ``n_iter``; each chunk of
    lanes is one batched :func:`forward_response` with the std dev reduced
    on the device.  ``bem``: a staged (A, B, F) tuple, as
    :func:`stage_north_star_bem` returns for the nominal hull, added to
    every lane (the approximation ``bench.py`` documents) after a cast to
    ``dtype``; None runs strip theory alone.  ``lanes`` (indices into the
    grid) runs a subset.
    Returns per-lane ``std`` (n, 6), ``n_iter`` (n,), ``converged`` (n,) and
    ``scales`` (n, 2) as tensors on the device.
    """
    dev = resolve_device(device)
    _design, members, rna, env, wave, C_moor = _volturnus(nw, dtype, dev)
    if bem is not None:
        A, B, F = bem
        bem = (A.to(dtype), B.to(dtype), Cx(F.re.to(dtype), F.im.to(dtype)))
    draft = make_stretch_draft(members)
    plan = make_scale_plan(members)

    grid = north_star_grid(n_designs)
    if lanes is not None:
        grid = grid[lanes]
    scales = torch.as_tensor(grid, device=dev).to(dtype)
    stds, iters, convs = [], [], []
    for lo in range(0, scales.shape[0], chunk):
        th = scales[lo:lo + chunk]
        m = plan(draft(members, th[:, 1]), th[:, 0])
        out = forward_response(m, rna, env, wave, C_moor, bem=bem, n_iter=n_iter,
                               method="while", dtype=dtype, device=dev)
        stds.append(response_std(out.Xi.abs2(), wave.w))
        iters.append(out.n_iter)
        convs.append(out.converged)
    return {"std": torch.cat(stds), "n_iter": torch.cat(iters),
            "converged": torch.cat(convs), "scales": scales}
