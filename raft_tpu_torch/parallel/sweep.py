"""Design-batch and sea-state-batch forward pipeline, the DLC table, the
variant and mixed-design sweeps and the north-star variant sweep (port of
``raft_tpu.parallel.sweep``: ``scale_diameters``, ``forward_response``,
``response_std``, ``stage_bem``, ``grad_response_std``,
``make_wave_states``, ``sweep_sea_states``, ``spread_sea_state``,
``mixed_sea_state``, ``directional_response``, ``sweep``,
``sweep_designs``).

A design batch is a MemberSet with a leading axis (and, for mixed designs,
the per-lane Env, RNA, wave and mooring of ``model.stage_designs``); a
sea-state batch is a WaveState whose ``zeta`` (and ``beta``) carry a
leading case axis.
``forward_response`` runs statics, strip hydrodynamics and the batched
drag-linearized fixed point for every lane at once (the job ``jax.vmap``
does in the JAX package).  :func:`sweep_north_star` is ``bench.py::north_star``'s
workload: VolturnUS-S plan-radius x draft variants x 200 frequencies, in
chunks through the dispatch-ahead pipeline, with the std dev reduced on the
device.  The caller may add the nominal hull's BEM coefficients to every
lane (:func:`stage_north_star_bem` solves them with the host C++ panel
solver, as ``bench.py`` does, or on the device); without them it is the
same sweep on the strip-theory path alone.

The batch operations around the solve follow the JAX package: ``chunk`` and
``pipeline_depth`` run chunks through
:func:`raft_tpu_torch.parallel.pipeline.run_pipelined` (CUDA streams on
the card) with the durable chunk store of
:mod:`raft_tpu_torch.resilience.checkpoint` under ``RAFT_TPU_CKPT``;
``health`` and ``escalate`` give every lane a ``(converged, finite,
n_iter)`` verdict (the first two reduced on the device) and re-solve
failed lanes through the escalation ladder
(:mod:`raft_tpu_torch.resilience.ladder`); the spans and metrics go to
:mod:`raft_tpu_torch.obs`.

``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``, one rank per
device: :func:`make_mesh`,
:func:`raft_tpu_torch.parallel.multihost.global_mesh`) shards over ranks.
The design, case and turbine axes are pure data parallelism: each rank
solves its own block of lanes with no collective inside, and one all-gather
at the end gives every rank the whole result.  The frequency axis
(:func:`forward_response_freq_sharded`, and the second dimension of
:func:`forward_response_dp_sp`) couples its shards through the drag
linearization's spectral moment and the convergence test: one SUM and one
MAX all-reduce per fixed-point iteration (``solve_dynamics(axis=...)``).
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

from raft_tpu_torch.build.members import build_member_set, build_rna
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.device import require_on, resolve_device, to_device
from raft_tpu_torch.core.types import Env, MemberSet, RNA, WaveState
from raft_tpu_torch.core.waves import jonswap, spreading_weights, wave_number
from raft_tpu_torch.hydro.strip import node_kinematics, strip_added_mass, strip_excitation
from raft_tpu_torch.mooring.system import mooring_stiffness, parse_mooring
from raft_tpu_torch.obs.trace import span
from raft_tpu_torch.parallel import multihost as _mh
from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
from raft_tpu_torch.solve.dynamics import LinearCoeffs, RAOResult, solve_dynamics
from raft_tpu_torch.statics import assemble_statics

Tensor = torch.Tensor

#: the north star's platform, read as a data file
VOLTURNUS_S = Path(__file__).resolve().parents[2] / "raft_tpu" / "designs" / "VolturnUS-S.yaml"


def make_mesh(n_devices: int | None = None, axis: str = "designs", device=None):
    """A 1-D ``DeviceMesh`` named ``axis`` over the world, for the
    data-parallel ``mesh=`` options.

    In a process that has joined no world (:func:`raft_tpu_torch.parallel.
    multihost.init_multihost`) it joins a world of one first: a local port,
    NCCL on the card (``device=None``, raising without CUDA), Gloo for
    ``device="cpu"``; so ``sweep(..., mesh=make_mesh())`` runs on one card as
    the JAX package's runs on one device.  ``n_devices``, when given, must
    be the world's size (a rank is a device)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if not dist.is_initialized():
        _mh.init_multihost(f"127.0.0.1:{_mh.free_port()}", 1, 0, device=dev)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the world has {world} ranks "
                         f"(one device each)")
    return _mh.check_mesh(_mh.global_mesh((axis,)), "make_mesh", dev)


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


def _t(a, dtype, dev) -> Tensor:
    """Host array -> tensor on ``dev`` in ``dtype`` (one copy)."""
    return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)


def _bem_device_layout(bem, dtype, dev):
    """Host layout (A[..., 6, 6, nw], B[..., 6, 6, nw], F[..., 6, nw]
    complex) -> frequency-leading (A[..., nw, 6, 6], B[..., nw, 6, 6],
    F_re[..., nw, 6], F_im[..., nw, 6]) on ``dev`` in ``dtype``, the
    excitation not yet zeta-scaled; a leading axis is a design batch's
    lanes."""
    A_bem, B_bem, F_bem = bem
    Fb = np.moveaxis(np.asarray(F_bem), -1, -2)          # (..., nw, 6) complex, host
    return (_t(np.moveaxis(np.asarray(A_bem), -1, -3), dtype, dev),
            _t(np.moveaxis(np.asarray(B_bem), -1, -3), dtype, dev),
            _t(Fb.real, dtype, dev), _t(Fb.imag, dtype, dev))


def _interp_rows_host(bgrid, F_all, betas_np) -> np.ndarray:
    """(B,) headings -> (B, 6, nw) complex excitation rows off a staged
    heading grid, on the host."""
    from raft_tpu_torch.model import interp_heading_excitation

    return np.stack([interp_heading_excitation(np.asarray(bgrid), F_all, float(b))
                     for b in betas_np])


def _rows_device_layout(F_rows, dtype, dev):
    """(B, 6, nw) complex host rows -> (F_re[B, nw, 6], F_im[B, nw, 6])."""
    Fb = np.moveaxis(F_rows, -1, 1)
    return _t(Fb.real, dtype, dev), _t(Fb.imag, dtype, dev)


def _stage_heading_rows(bem, betas_eval, dtype, dev):
    """A ``Model.calcBEM(headings=...)`` heading grid (betas, F_all[nb, 6,
    nw], A[6, 6, nw], B[6, 6, nw]) for per-case headings ``betas_eval``
    (B,): the excitation interpolated to each heading on the host, then
    (A[nw, 6, 6], B[nw, 6, 6], F_re[B, nw, 6], F_im[B, nw, 6]) on ``dev``,
    not yet zeta-scaled.  The one staging rule of :func:`sweep_sea_states`
    and the co-design losses.  Unlike the JAX package, the port does not
    stage these rows through the staging cache: a hit (hashing ``F_all``
    and reading an npz) costs more than the interpolation it skips."""
    bgrid, F_all, A_h, B_h = bem
    F_rows = _interp_rows_host(bgrid, F_all, np.asarray(betas_eval))
    return (_t(np.moveaxis(np.asarray(A_h), -1, 0), dtype, dev),
            _t(np.moveaxis(np.asarray(B_h), -1, 0), dtype, dev),
            *_rows_device_layout(F_rows, dtype, dev))


def _stage_zeta(staged, zeta: Tensor):
    """(A, B, F_re, F_im) -> (A, B, F Cx) with the excitation on the
    spectral-amplitude basis (zeta = sqrt(S)) of the Morison path; a
    ``zeta`` with a case axis (B, nw) scales a shared (nw, 6) excitation
    into one per case."""
    A, B, F_re, F_im = staged
    z = zeta[..., None]
    return A, B, Cx(z * F_re, z * F_im)


def stage_bem(bem, wave: WaveState):
    """Host-layout BEM coefficients -> frequency-leading device tensors.

    ``bem``: (A[6, 6, nw], B[6, 6, nw], F[6, nw] complex) per unit wave
    amplitude, numpy (the panel solver's / WAMIT reader's layout).
    Returns (A[nw, 6, 6], B[nw, 6, 6], F Cx[nw, 6]) on the wave's device in
    its dtype, with the excitation scaled onto the spectral-amplitude basis
    (zeta = sqrt(S)) of the Morison path."""
    return _stage_zeta(_bem_device_layout(bem, wave.zeta.dtype, wave.zeta.device), wave.zeta)


def forward_response(members: MemberSet, rna: RNA, env: Env, wave: WaveState,
                     C_moor: Tensor, bem=None, n_iter: int = 25,
                     method: str = "scan", remat: bool = False, relax: float = 0.8,
                     tik: float = 0.0, dtype=torch.float64, device=None,
                     axis=None) -> RAOResult:
    """Design (batch) -> RAO solve: statics, strip hydro, drag fixed point.

    Three kinds of lanes, each the job ``jax.vmap`` does in the JAX package:

    * ``members`` with a leading design axis and one shared (nw,) wave
      (variants of one design, e.g. :func:`sweep`);
    * one design and a ``wave`` with a leading case axis (``zeta`` (B, nw),
      ``beta`` (B,) or None, as :func:`make_wave_states` builds it; ``w``
      and ``k`` one grid, (nw,) or rows of it, at the design's one depth):
      each sea state a lane with its own heading and drag linearization;
    * a design batch (``model.stage_designs``): ``members`` with a lane
      axis, Env and RNA fields (B,) tensors, ``k``, ``zeta`` and
      ``freq_mask`` (B, nw) over one shared grid ``w``, ``C_moor``
      (B, 6, 6) and ``bem`` (B, nw, ...): each lane keeps its own water
      depth and wavenumbers.

    ``bem``: optional pre-staged ``(A, B, F)`` with A, B (..., nw, 6, 6)
    and F a Cx (..., nw, 6) on the spectral-amplitude basis; the potMod
    members then leave the Morison added mass and excitation.
    ``method="scan"`` (the default, with ``remat``) is the
    reverse-differentiable loop: it always runs ``n_iter`` steps, so keep
    the cap tight for gradient work; ``"while"`` exits early.  Inputs must
    already lie on ``device`` in ``dtype``.  ``axis``: the wave (and
    ``bem``) hold this rank's shard of a frequency grid sharded over
    ``axis`` (``solve_dynamics(axis=...)``): the JAX package's
    ``_local_freq_solve``.

    Spans: ``forward`` around the whole, with ``statics``, ``strip`` (the
    strip hydro: kinematics, added mass, excitation) and ``dynamics``
    (:func:`~raft_tpu_torch.solve.dynamics.solve_dynamics`) inside.
    """
    dev = resolve_device(device)
    require_on(dev, dtype, node_r=members.node_r, w=wave.w, zeta=wave.zeta, C_moor=C_moor)
    nw = wave.w.shape[-1]
    if wave.w.ndim > 1:
        wave = dataclasses.replace(wave, w=wave.w.reshape(-1, nw)[0])
    if wave.zeta.ndim > 1 and members.node_r.ndim == 2:
        # sea-state lanes of one design: one depth, so one row of wavenumbers
        wave = dataclasses.replace(wave, k=wave.k.reshape(-1, nw)[0])
    if wave.beta is not None:
        env = dataclasses.replace(env, beta=wave.beta)
    exclude = bem is not None
    with span("forward"):
        with span("statics"):
            stat = assemble_statics(members, rna, env)
        with span("strip"):
            kin = node_kinematics(members, wave, env)
            A = strip_added_mass(members, env, exclude_potmod=exclude)
            F = strip_excitation(members, kin, env, exclude_potmod=exclude)
        if bem is not None:
            F = F + bem[2]
        MA = stat.M_struc + A
        M = MA[..., None, :, :].expand(*F.re.shape[:-2], nw, 6, 6)
        B = torch.zeros_like(M)
        if bem is not None:
            M = M + bem[0]
            B = B + bem[1]
        lin = LinearCoeffs(M=M, B=B, C=stat.C_struc + stat.C_hydro + C_moor, F=F)
        return solve_dynamics(members, kin, wave, env, lin, n_iter=n_iter, relax=relax,
                              method=method, remat=remat, tik=tik, axis=axis)


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


# ------------------------------------------------------ sharded solves


def _refuse_grad(what: str, *inputs) -> None:
    """The sharded entry points solve without autograd (their psum carries
    it, :func:`raft_tpu_torch.core.collectives.psum`, but the gathered
    results do not): refuse inputs that require grad rather than return
    results detached from them."""
    from raft_tpu_torch.parallel.pipeline import tensors

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors(inputs)):
        raise ValueError(f"{what} returns gathered results without gradient history; call "
                         f"forward_response(..., axis=...) on this rank's shard to "
                         f"differentiate through the sharded solve")


def _freq_specs(wave: WaveState, bem, dim: str):
    """Shard specs of a wave and a staged bem over the frequency dimension
    ``dim`` (a heading on the wave is replicated)."""
    f = (dim,)
    wave_spec = WaveState(w=f, k=f, zeta=f, beta=None, freq_mask=f)
    bem_spec = None if bem is None else (f, f, Cx(f, f))
    return wave_spec, bem_spec


def _gather_rao(out: RAOResult, mesh, freq_dim: str | None, lane_dim: str | None,
                lanes: bool) -> RAOResult:
    """Every rank's whole RAOResult: the frequency blocks gathered over
    ``freq_dim``, then (with ``lanes``) the lane blocks over ``lane_dim``."""
    def full(t, freq):
        if freq and freq_dim is not None:
            t = _mh.all_gather(t, (mesh, freq_dim), dim=t.ndim - 2)
        if lanes and lane_dim is not None:
            t = _mh.all_gather(t, (mesh, lane_dim), dim=0)
        return t

    return RAOResult(Xi=Cx(full(out.Xi.re, True), full(out.Xi.im, True)),
                     n_iter=full(out.n_iter, False), converged=full(out.converged, False),
                     B_drag=full(out.B_drag, False),
                     F_drag=Cx(full(out.F_drag.re, True), full(out.F_drag.im, True)),
                     err_hist=None if out.err_hist is None else full(out.err_hist, False))


def forward_response_freq_sharded(members: MemberSet, rna: RNA, env: Env, wave: WaveState,
                                  C_moor: Tensor, mesh, bem=None, n_iter: int = 40,
                                  method: str = "while", dtype=torch.float64,
                                  device=None) -> RAOResult:
    """The RAO solve of one design with its frequency grid sharded over a
    1-D mesh (sequence parallelism).

    Each rank evaluates its own bins' kinematics, excitation and 6x6
    solves (K1 on the card); the two quantities that couple bins, the drag
    linearization's spectral moment and the convergence error, complete
    with one SUM and one MAX all-reduce over the mesh per fixed-point
    iteration, so every rank runs the same iterations.  Equal to
    :func:`forward_response` up to the order of the frequency sum.
    ``bem``: staged (A[nw, 6, 6], B[nw, 6, 6], F Cx[nw, 6]) (:func:`stage_bem`).
    Requires ``len(wave.w)`` divisible by the mesh's size.  Every rank
    returns the whole RAOResult (the frequency blocks all-gathered);
    inputs that require grad are refused (:func:`_refuse_grad`)."""
    dev = resolve_device(device)
    _mh.check_mesh(mesh, "forward_response_freq_sharded", dev)
    if mesh.ndim != 1:
        raise ValueError(f"forward_response_freq_sharded expects a 1-D mesh; got shape "
                         f"{tuple(mesh.shape)} with axes {mesh.mesh_dim_names}")
    _refuse_grad("forward_response_freq_sharded", members, rna, env, wave, C_moor, bem)
    dim = mesh.mesh_dim_names[0]
    n_dev, nw = mesh.size(), int(wave.w.shape[-1])
    if nw % n_dev != 0:
        raise ValueError(f"nw={nw} not divisible by {n_dev} devices")
    wave_l, bem_l = _mh.stage_global((wave, bem), mesh, _freq_specs(wave, bem, dim))
    with torch.no_grad():
        out = forward_response(members, rna, env, wave_l, C_moor, bem=bem_l, n_iter=n_iter,
                               method=method, dtype=dtype, device=dev, axis=(mesh, dim))
        return _gather_rao(out, mesh, dim, None, lanes=False)


def forward_response_dp_sp(members: MemberSet, rna: RNA, env: Env, wave: WaveState,
                           C_moor: Tensor, thetas, mesh, apply_fn=scale_diameters, bem=None,
                           n_iter: int = 40, method: str = "while", dtype=torch.float64,
                           device=None) -> RAOResult:
    """Design x frequency parallelism over a 2-D mesh.

    ``mesh.mesh_dim_names[0]`` is the design axis (each row of ranks owns a
    block of ``thetas``; no collective), ``[1]`` the frequency axis (each
    column owns a block of the grid; the spectral moment and the
    convergence test complete over it per iteration, as in
    :func:`forward_response_freq_sharded`).  Each rank solves its design
    lanes (``apply_fn(members, theta)`` per row) on its frequency block at
    once.  Requires ``len(thetas)`` divisible by the design axis and
    ``len(wave.w)`` by the frequency axis; ``bem`` must be the STAGED tuple
    of :func:`stage_bem` (A[nw, 6, 6], B, F Cx[nw, 6]).  Every rank returns
    the whole RAOResult with a leading design axis."""
    if bem is not None and not isinstance(bem[2], Cx):
        raise ValueError(
            "forward_response_dp_sp expects the STAGED bem tuple from stage_bem(bem_raw, wave) "
            "— (A[nw,6,6], B[nw,6,6], F Cx[nw,6]) — got F of type "
            f"{type(bem[2]).__name__}; pass the raw (A[6,6,nw], B, F complex) host tuple "
            "through stage_bem first")
    dev = resolve_device(device)
    _mh.check_mesh(mesh, "forward_response_dp_sp", dev)
    if mesh.ndim != 2:
        raise ValueError(f"forward_response_dp_sp needs a 2-D mesh (design x frequency axes); "
                         f"got shape {tuple(mesh.shape)} with axes {mesh.mesh_dim_names}")
    th = torch.as_tensor(thetas, device=dev).to(dtype)
    _refuse_grad("forward_response_dp_sp", members, rna, env, wave, C_moor, th, bem)
    axis_d, axis_f = mesh.mesh_dim_names
    n_d, n_f = mesh.shape
    B, nw = int(th.shape[0]), int(wave.w.shape[-1])
    if B % n_d != 0:
        raise ValueError(f"design batch {B} not divisible by {n_d} (axis {axis_d!r})")
    if nw % n_f != 0:
        raise ValueError(f"nw={nw} not divisible by {n_f} (axis {axis_f!r})")
    wave_spec, bem_spec = _freq_specs(wave, bem, axis_f)
    th_l, wave_l, bem_l = _mh.stage_global((th, wave, bem), mesh, ((axis_d,), wave_spec,
                                                                   bem_spec))
    with torch.no_grad():
        m = _apply_lanes(apply_fn, members, th_l)
        out = forward_response(m, rna, env, wave_l, C_moor, bem=bem_l, n_iter=n_iter,
                               method=method, dtype=dtype, device=dev, axis=(mesh, axis_f))
        return _gather_rao(out, mesh, axis_f, axis_d, lanes=True)


_LANES_MSG = "{n} lanes not divisible by {size} devices"


def _gather_lanes(outs, mesh):
    """Every rank's whole lane axis of each output tensor (one all-gather
    each over the mesh's dimension)."""
    return tuple(_mh.all_gather(o, (mesh, mesh.mesh_dim_names[0]), dim=0) for o in outs)


# ------------------------------------------------------ sea-state batches


def make_wave_states(w, cases, depth, g: float = 9.81, dtype=torch.float64,
                     device=None) -> WaveState:
    """Sea-state rows -> one WaveState with a leading case axis.

    ``cases``: (B, 2) rows [Hs, Tp] or (B, 3) rows [Hs, Tp, beta] (heading
    in rad), e.g. a design-load-case table.  ``zeta`` (B, nw) holds each
    row's JONSWAP amplitudes, ``beta`` (B,) the headings of 3-column rows
    (else None); ``w`` and ``k`` are the one grid broadcast to (B, nw)."""
    dev = resolve_device(device)
    w = _t(np.asarray(w, dtype=float), dtype, dev)
    cases = np.asarray(cases, dtype=float)
    if cases.ndim == 1:              # one flat row: [Hs, Tp] or [Hs, Tp, beta]
        cases = cases[None, :]
    if cases.ndim != 2 or cases.shape[-1] not in (2, 3):
        raise ValueError(f"cases rows must be [Hs, Tp] or [Hs, Tp, beta]; got shape "
                         f"{cases.shape}")
    k = wave_number(w, depth, g=g)
    zeta = torch.stack([torch.sqrt(jonswap(w, float(Hs), float(Tp))) for Hs, Tp in cases[:, :2]])
    B = zeta.shape[0]
    return WaveState(w=w.expand(B, -1), k=k.expand(B, -1), zeta=zeta,
                     beta=_t(cases[:, 2], dtype, dev) if cases.shape[-1] == 3 else None)


def spread_sea_state(w, Hs, Tp, depth, beta0: float = 0.0, n_dir: int = 7, s: float = 2.0,
                     g: float = 9.81, dtype=torch.float64, device=None) -> WaveState:
    """A short-crested sea as a WaveState with one lane per direction: the
    JONSWAP energy split over ``n_dir`` directions by the cos^2s spreading
    function (:func:`raft_tpu_torch.core.waves.spreading_weights`) about
    ``beta0``, lane j at heading ``beta0 + offset_j`` with amplitude
    ``sqrt(weight_j) zeta``, so the lanes' variances sum to the
    long-crested total.  For :func:`directional_response`."""
    dev = resolve_device(device)
    offsets, wts = spreading_weights(n_dir=n_dir, s=s)
    w = _t(np.asarray(w, dtype=float), dtype, dev)
    k = wave_number(w, depth, g=g)
    zeta = torch.sqrt(jonswap(w, float(Hs), float(Tp)))
    n = len(offsets)
    return WaveState(w=w.expand(n, -1), k=k.expand(n, -1),
                     zeta=torch.sqrt(_t(wts, dtype, dev))[:, None] * zeta[None, :],
                     beta=beta0 + _t(offsets, dtype, dev))


def mixed_sea_state(w, components, depth, g: float = 9.81, dtype=torch.float64,
                    device=None) -> WaveState:
    """A multi-component sea (e.g. wind sea + swell): rows [Hs, Tp, beta],
    each an independent JONSWAP component with its own heading, one lane
    each, for :func:`directional_response` (the total variance is the lane
    sum)."""
    comps = np.asarray(components, dtype=float)
    if comps.ndim != 2 or comps.shape[1] != 3:
        raise ValueError(f"components must be rows of [Hs, Tp, beta]; got shape {comps.shape}")
    return make_wave_states(w, comps, depth, g=g, dtype=dtype, device=device)


def _bem_mode(bem, betas_case) -> str:
    """Classify and validate the ``bem`` argument of the batched sea-state
    APIs: ``"none"``, the raw single-heading ``"raw"`` tuple, or the staged
    heading ``"grid"``."""
    if bem is None:
        return "none"
    if len(bem) == 4:
        return "grid"
    if betas_case is not None:
        raise ValueError(
            "cases vary the wave heading but bem is a single-heading (A, B, F) tuple; pass the "
            "staged heading grid (betas, F_all, A, B) from Model.calcBEM(headings=...) so each "
            "case gets its own BEM excitation")
    if isinstance(bem[2], Cx):
        raise ValueError(
            "sweep_sea_states expects the raw host (A[6,6,nw], B, F complex) tuple or the "
            "staged heading grid from Model.calcBEM(headings=...), not the stage_bem output "
            "(F is a Cx): batched sea states re-stage per case, so pass the pre-staging layout")
    return "raw"


def _make_dlc_case_fn(members, rna, env, C_moor, staged, n_iter, relax: float = 0.8,
                      tik: float = 0.0, health: bool = False, dtype=torch.float64,
                      device=None):
    """The DLC solve of every case at once: ``(waves, F_re, F_im) ->
    (|Xi|^2 (B, nw, 6), sigma_nacelle (B,), iterations (B,))``, each case a
    lane of :func:`forward_response` (the JAX package vmaps its per-case
    function instead).  The zeta scaling of the staged excitation
    (``F_re``/``F_im`` (nw, 6) shared or (B, nw, 6) per case) is the only
    sea-state-dependent staging, so it happens per lane here.  With
    ``health`` the tuple gains each lane's ``converged`` and ``finite``
    (all of its |Xi|^2 finite), both reduced on the device."""
    from raft_tpu_torch.parallel.optimize import nacelle_accel_std

    def run(waves, F_re, F_im):
        b = (_stage_zeta((staged[0], staged[1], F_re, F_im), waves.zeta)
             if staged is not None else None)
        out = forward_response(members, rna, env, waves, C_moor, bem=b, n_iter=n_iter,
                               relax=relax, tik=tik, dtype=dtype, device=device)
        abs2 = out.Xi.abs2()
        res = (abs2, nacelle_accel_std(out.Xi, waves, rna), out.n_iter)
        if health:
            return res + (out.converged, _lane_finite(abs2))
        return res

    return run


def _lane_finite(abs2: Tensor) -> Tensor:
    """Per lane: every entry of its (nw, 6) spectra finite (on the device)."""
    return torch.isfinite(abs2).flatten(-2).all(-1)


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _case_slice(waves: WaveState, sl: slice) -> WaveState:
    """The cases ``sl`` of a sea-state batch (views)."""
    return WaveState(w=waves.w[sl], k=waves.k[sl], zeta=waves.zeta[sl],
                     beta=None if waves.beta is None else waves.beta[sl],
                     freq_mask=None if waves.freq_mask is None else waves.freq_mask[sl])


def _stage_cases_global(waves: WaveState, F_re, F_im, per_case: bool, mesh):
    """This rank's block of a DLC table's cases (views), and of their
    excitation rows when each case has its own (``per_case``); the case
    count divisible by the mesh's size."""
    sl = _mh.lane_block(mesh, int(waves.zeta.shape[0]), "sweep_sea_states", _LANES_MSG)
    if per_case:
        F_re, F_im = F_re[sl], F_im[sl]
    return _case_slice(waves, sl), F_re, F_im


def sweep_sea_states(members: MemberSet, rna: RNA, env: Env, waves: WaveState, C_moor: Tensor,
                     bem=None, n_iter: int = 25, mesh=None, chunk: int | None = None,
                     pipeline_depth: int | None = None, health: bool = False,
                     escalate: bool = True, dtype=torch.float64, device=None) -> dict:
    """One design x a batch of sea states in one batched solve: the
    design-load-case (DLC) table of a WEIS outer loop.

    ``waves``: a WaveState with a case axis (:func:`make_wave_states`), all
    cases on one frequency grid (checked).  Each case is a lane with its
    own kinematics, excitation and drag-linearized fixed point (scan
    driver, ``n_iter`` steps), and with ``waves.beta`` its own heading.
    ``bem``: None, the raw host tuple (A[6, 6, nw], B, F[6, nw] complex)
    for cases that share one heading, or the staged heading grid (betas,
    F_all[nb, 6, nw], A, B) of ``Model.calcBEM(headings=...)``, interpolated
    on the host to each case's heading.  Returns numpy arrays, as the JAX
    package: ``"std dev"`` (B, 6), ``"nacelle accel std dev"`` (B,),
    ``"iterations"`` (B,) and ``"Xi_abs2"`` (B, nw, 6).

    ``chunk``: split the case table into ``chunk``-sized sub-batches (the
    case count divisible by ``chunk``) run through the dispatch-ahead
    pipeline (:func:`raft_tpu_torch.parallel.pipeline.run_pipelined`): on
    the card chunk ``k+1``'s host staging (the heading interpolation of its
    excitation rows and their copy from pinned memory, on a copy stream)
    overlaps chunk ``k``'s solve, and a heading grid's per-chunk excitation
    is donated (``RAFT_TPU_DONATE=0`` opts out).  Results match the
    unchunked call to float eps (the same per-lane arithmetic in batches of
    another size), and the dict gains a ``"pipeline"`` stats block (and
    ``"checkpoint"`` with ``RAFT_TPU_CKPT`` armed: every fetched chunk is
    stored and a re-run resumes at the first missing one).
    ``pipeline_depth`` overrides the dispatch-ahead window (default
    ``RAFT_TPU_PIPELINE_DEPTH`` or 2).  ``chunk`` with ``mesh`` raises
    ``ValueError``.

    ``health=True``: every case lane gets a ``(converged, finite,
    n_iter)`` verdict (the first two reduced on the device), failed lanes
    are quarantined instead of poisoning the batch and, with ``escalate``
    (the default), re-solved alone through the escalation ladder
    (:mod:`raft_tpu_torch.resilience.ladder`).  The result gains per-lane
    ``"converged"``/``"finite"`` arrays and a ``"health"`` block
    (quarantined, salvaged, rungs used); salvaged lanes are patched in
    place, unsalvaged ones stay NaN but are reported.  Off (the default)
    the call returns exactly what it always did.

    ``mesh``: a 1-D ``DeviceMesh`` (:func:`make_mesh`); the case axis is
    pure data parallelism: each rank solves its block of cases (the case
    count divisible by the mesh's size), with no collective inside, and one
    all-gather gives every rank the whole result.  With ``health`` every
    rank quarantines and salvages the gathered lanes identically (the
    salvage solves one case alone on the host's orders, no collective)."""
    if chunk is not None and mesh is not None:
        raise ValueError(
            "chunked (pipelined) sweep_sea_states does not compose with a mesh: chunking bounds "
            "one device's memory while a mesh shards the case axis — pick one")
    dev = resolve_device(device)
    if mesh is not None:
        _mh.check_mesh(mesh, "sweep_sea_states", dev)
    w_rows = waves.w.reshape(-1, waves.w.shape[-1])
    if not bool((w_rows == w_rows[0]).all()):
        raise ValueError("sweep_sea_states requires one shared frequency grid across cases "
                         "(make_wave_states builds one)")
    B = int(waves.zeta.shape[0])
    betas_case = None if waves.beta is None else _host(waves.beta)
    if chunk is not None:
        return _sweep_sea_states_chunked(members, rna, env, waves, C_moor, bem, n_iter,
                                         int(chunk), pipeline_depth, B, betas_case, health,
                                         escalate, dtype, dev)
    mode = _bem_mode(bem, betas_case)
    staged = F_re = F_im = None
    if mode == "grid":
        betas_eval = betas_case if betas_case is not None else np.full(B, float(env.beta))
        A_dev, B_dev, F_re, F_im = _stage_heading_rows(bem, betas_eval, dtype, dev)
        staged = (A_dev, B_dev)
    elif mode == "raw":
        A_dev, B_dev, F_re, F_im = _bem_device_layout(bem, dtype, dev)
        staged = (A_dev, B_dev)
    run = _make_dlc_case_fn(members, rna, env, C_moor, staged, n_iter, health=health,
                            dtype=dtype, device=dev)
    with torch.no_grad():
        if mesh is None:
            outs = run(waves, F_re, F_im)
        else:
            outs = _gather_lanes(run(*_stage_cases_global(waves, F_re, F_im, mode == "grid",
                                                          mesh)), mesh)
        abs2, a_nac, iters = outs[:3]
        sigma = response_std(abs2, w_rows[0])
    res = {"std dev": _host(sigma), "nacelle accel std dev": _host(a_nac),
           "iterations": _host(iters), "Xi_abs2": _host(abs2)}
    if not health:
        return res
    if mode == "grid":
        lane_F = lambda i: (F_re[i:i + 1], F_im[i:i + 1])          # noqa: E731
    else:
        lane_F = lambda i: (F_re, F_im)                            # noqa: E731
    solve_lane = _dlc_lane_solver(members, rna, env, C_moor, staged, waves, lane_F, dtype, dev)
    return _dlc_health_finish(res, _host(outs[3]), _host(outs[4]), w_rows[0], solve_lane,
                              n_iter, escalate)


def _dlc_lane_solver(members, rna, env, C_moor, staged, waves, lane_F, dtype, dev):
    """The escalation ladder's ``solve_lane`` over a DLC table: ONE case
    re-solved alone with a rung's knobs, through the same batched function
    as the sweep (:func:`_make_dlc_case_fn` on a one-lane table, so a
    salvage solve cannot drift from the batch solve).  ``lane_F(idx)``
    supplies the lane's excitation (its staged row in grid mode, the
    shared pair in raw mode, None without BEM).  One function per rung,
    built once under a lock (concurrent salvages share it), as the JAX
    package keeps one executable per rung."""
    rung_fns: dict = {}
    rung_lock = threading.Lock()

    def solve_lane(idx, n_iter_r, relax_r, tik_r):
        wv = _case_slice(waves, slice(idx, idx + 1))
        F_re_i, F_im_i = lane_F(idx)
        with rung_lock:
            run1 = rung_fns.get((n_iter_r, relax_r, tik_r))
            if run1 is None:
                run1 = _make_dlc_case_fn(members, rna, env, C_moor, staged, n_iter_r,
                                         relax=relax_r, tik=tik_r, health=True, dtype=dtype,
                                         device=dev)
                rung_fns[(n_iter_r, relax_r, tik_r)] = run1
        with torch.no_grad():
            abs2_i, a_i, it_i, conv_i, fin_i = run1(wv, F_re_i, F_im_i)
        return ((_host(abs2_i[0]), _host(a_i[0]), _host(it_i[0])),
                bool(conv_i[0]), bool(fin_i[0]), int(it_i[0]))

    return solve_lane


def _health_finish(res, conv, finite, payload_keys, solve_lane, n_iter, escalate,
                   std_from=None, extra=None):
    """Shared host-side health tail for every sweep path (design variants,
    design batches and sea states, chunked and unchunked): salvaged lanes
    are patched in place into the ``payload_keys`` result arrays (the
    ladder payload, in ``solve_lane``'s order), ``"std dev"`` is re-derived
    from the patched spectra when ``std_from=(key, w)`` (on ``w``'s
    device, as the sweep derived it), and per-lane verdict arrays plus the
    ``health`` block are attached.  The healthy common case attaches the
    verdicts and returns — no copies, no recompute."""
    from raft_tpu_torch.resilience import health as _health
    from raft_tpu_torch.resilience import ladder as _ladder

    conv = np.asarray(conv).astype(bool).reshape(-1)
    finite = np.asarray(finite).astype(bool).reshape(-1)
    host_arrays = [res[k] for k in payload_keys]
    if not len(_health.failed_lanes(conv, finite, host_values=host_arrays)):
        res["converged"] = conv
        res["finite"] = finite
        res["health"] = _health.summarize([], len(conv), extra=extra)
        return res
    payload = [np.array(res[k]) for k in payload_keys]
    iters = payload[payload_keys.index("iterations")]
    records, conv, finite = _ladder.quarantine_and_salvage(
        payload, conv, finite, solve_lane, n_iter, escalate=escalate, iters=iters)
    for k, a in zip(payload_keys, payload):
        res[k] = a
    if std_from is not None:
        key, w = std_from
        with torch.no_grad():
            res["std dev"] = _host(response_std(torch.as_tensor(res[key], device=w.device), w))
    res["converged"] = conv
    res["finite"] = finite
    res["health"] = _health.summarize(records, len(conv), extra=extra)
    return res


def _dlc_health_finish(res, conv, finite, w, solve_lane, n_iter, escalate, extra=None):
    """Sea-state-sweep instantiation of :func:`_health_finish`."""
    return _health_finish(res, conv, finite, ["Xi_abs2", "nacelle accel std dev", "iterations"],
                          solve_lane, n_iter, escalate, std_from=("Xi_abs2", w), extra=extra)


def _sweep_sea_states_chunked(members, rna, env, waves, C_moor, bem, n_iter, chunk,
                              pipeline_depth, B, betas_case, health, escalate, dtype, dev):
    """Pipelined chunks of the DLC table (see :func:`sweep_sea_states`
    ``chunk=``): each chunk's host staging overlapped with the card's
    compute, a heading grid's excitation donated; with ``RAFT_TPU_CKPT``
    armed every fetched chunk is stored and a re-run resumes at the first
    missing chunk."""
    from raft_tpu_torch.parallel import pipeline as _pipe
    from raft_tpu_torch.resilience import checkpoint as _ckpt

    if chunk < 1 or B % chunk != 0:
        raise ValueError(f"{B} sea states not divisible by chunk={chunk}")
    mode = _bem_mode(bem, betas_case)
    grid_mode = mode == "grid"
    staged = F_re_all = F_im_all = betas_eval = None
    if grid_mode:
        betas_eval = betas_case if betas_case is not None else np.full(B, float(env.beta))
        # the coefficient layout once; the per-chunk host work is the
        # heading interpolation of that chunk's excitation rows
        staged = (_t(np.moveaxis(np.asarray(bem[2]), -1, 0), dtype, dev),
                  _t(np.moveaxis(np.asarray(bem[3]), -1, 0), dtype, dev))
    elif mode == "raw":
        A_dev, B_dev, F_re_all, F_im_all = _bem_device_layout(bem, dtype, dev)
        staged = (A_dev, B_dev)
    run = _make_dlc_case_fn(members, rna, env, C_moor, staged, n_iter, health=health,
                            dtype=dtype, device=dev)

    def fn(wv, F_re, F_im):
        with torch.no_grad():
            return run(wv, F_re, F_im)

    def stage(k):
        sl = slice(k * chunk, (k + 1) * chunk)
        wv = _case_slice(waves, sl)
        if grid_mode:
            # fresh tensors every chunk, copied from pinned memory (on the
            # card: the copy stream), so the excitation can be donated
            rows = np.moveaxis(_interp_rows_host(bem[0], bem[1], betas_eval[sl]), -1, 1)
            return (wv, to_device(rows.real, dtype, dev),
                    to_device(rows.imag, dtype, dev))
        return (wv, F_re_all, F_im_all)

    # donation: the per-case excitation's real part, freshly staged every
    # chunk (the JAX package aliases it to the Xi_abs2 output)
    donate = grid_mode and _pipe.donation_enabled()
    extra = ("n_iter", n_iter, "F_ax", 0 if grid_mode else None, "chunk", chunk,
             "health", bool(health))
    store = None
    if _ckpt.enabled():
        # stored results depend on the input VALUES: fold the whole table
        # and the excitation the staging reads into the key
        data_leaves = [waves.w, waves.k, waves.zeta]
        if waves.beta is not None:
            data_leaves.append(waves.beta)
        if grid_mode:
            data_leaves += [np.asarray(bem[0]), np.asarray(bem[1])]
        elif staged is not None:
            data_leaves += [F_re_all, F_im_all]
        nw = int(waves.w.shape[-1])
        store = _ckpt.store_for(
            "sweep_sea_states",
            (_case_slice(waves, slice(0, chunk)),
             ("F", (chunk, nw, 6) if grid_mode else None, str(dtype))),
            consts=(members, rna, env, C_moor, staged or ()),
            extra=(*extra, "data_sha", _ckpt.content_hash(data_leaves)),
            n_chunks=B // chunk, device=dev)
    results, stats = _pipe.run_pipelined(fn, range(B // chunk), depth=pipeline_depth,
                                         stage=stage, donate_argnums=(1,) if donate else (),
                                         ckpt=store, device=dev)
    abs2 = np.concatenate([r[0] for r in results])
    a_nac = np.concatenate([np.atleast_1d(r[1]) for r in results])
    iters = np.concatenate([np.atleast_1d(r[2]) for r in results])
    w0 = waves.w.reshape(-1, waves.w.shape[-1])[0]
    with torch.no_grad():
        sigma = response_std(torch.as_tensor(abs2, device=dev), w0)
    res = {"std dev": _host(sigma), "nacelle accel std dev": a_nac, "iterations": iters,
           "Xi_abs2": abs2, "pipeline": stats.to_dict()}
    if store is not None:
        res["checkpoint"] = store.to_dict()
    if not health:
        return res
    conv = np.concatenate([np.atleast_1d(r[3]) for r in results])
    finite = np.concatenate([np.atleast_1d(r[4]) for r in results])
    if grid_mode:
        def lane_F(i):
            return _rows_device_layout(_interp_rows_host(bem[0], bem[1], betas_eval[i:i + 1]),
                                       dtype, dev)
    else:
        lane_F = lambda i: (F_re_all, F_im_all)                    # noqa: E731
    solve_lane = _dlc_lane_solver(members, rna, env, C_moor, staged, waves, lane_F, dtype, dev)
    return _dlc_health_finish(res, conv, finite, w0, solve_lane, n_iter, escalate)


def directional_response(members: MemberSet, rna: RNA, env: Env, waves_dir: WaveState,
                         C_moor: Tensor, bem=None, n_iter: int = 25, mesh=None,
                         dtype=torch.float64, device=None) -> dict:
    """Response statistics in a directionally spread (or multi-component)
    sea: the lanes of ``waves_dir`` (:func:`spread_sea_state`,
    :func:`mixed_sea_state`) are independent linear components, solved as a
    DLC table by :func:`sweep_sea_states` (each with its own drag
    linearization), and their variances add:
    ``sigma_total^2 = sum_j sigma_j^2``.  ``mesh`` shards the directions as
    :func:`sweep_sea_states` shards cases.  Returns ``{"std dev": (6,),
    "nacelle accel std dev": float, "per direction": the sweep's dict}``."""
    per = sweep_sea_states(members, rna, env, waves_dir, C_moor, bem=bem, n_iter=n_iter,
                           mesh=mesh, dtype=dtype, device=device)
    return {"std dev": np.sqrt((per["std dev"] ** 2).sum(axis=0)),
            "nacelle accel std dev": float(np.sqrt((per["nacelle accel std dev"] ** 2).sum())),
            "per direction": per}


# ---------------------------------------------------- design-variant batches


def _apply_lanes(apply_fn, members: MemberSet, thetas: Tensor) -> MemberSet:
    """``apply_fn(members, theta)`` of each row of ``thetas`` as one
    MemberSet with a leading lane axis: ``torch.func.vmap`` over the
    variant map, where the JAX package vmaps the whole forward pipeline
    (the pipeline itself takes the lane axis directly)."""
    names = [f.name for f in dataclasses.fields(members)]

    def one(theta):
        m = apply_fn(members, theta)
        return tuple(getattr(m, n) for n in names)

    fields = torch.func.vmap(one)(thetas)
    return MemberSet(**dict(zip(names, fields)))


def _stage_variants_global(thetas: Tensor, mesh) -> Tensor:
    """This rank's block of :func:`sweep`'s variants (a view), their count
    divisible by the mesh's size."""
    return thetas[_mh.lane_block(mesh, int(thetas.shape[0]), "sweep", _LANES_MSG)]


def sweep(members: MemberSet, rna: RNA, env: Env, wave: WaveState, C_moor: Tensor, thetas,
          apply_fn=scale_diameters, mesh=None, n_iter: int = 25, return_xi: bool = True,
          health: bool = False, escalate: bool = True, dtype=torch.float64,
          device=None) -> dict:
    """A batch of variants of one staged design in one batched solve.

    ``thetas``: (B, ...) design parameters; ``apply_fn(members, theta)``
    makes each variant (mapped over the rows, :func:`_apply_lanes`).  Each
    variant is a lane of :func:`forward_response` (scan driver, ``n_iter``
    steps), with the design's RNA, environment, wave and mooring shared.
    Returns numpy arrays, as the JAX package: ``"std dev"`` (B, 6),
    ``"iterations"`` (B,) and, with ``return_xi``, ``"Xi_abs2"`` (B, nw, 6);
    ``return_xi=False`` reduces the std dev on the device, so only the
    (B, 6) statistics and the iteration counts leave it.

    ``health=True``: the lane-health contract of :func:`sweep_sea_states`
    (per-lane verdicts, ``finite`` reduced on the device over the full
    spectra even with ``return_xi=False``, quarantine, salvage through the
    escalation ladder with ``escalate``, a ``"health"`` block).  ``mesh``:
    a 1-D ``DeviceMesh`` (:func:`make_mesh`); each rank solves its block of
    the variants (their count divisible by the mesh's size) with no
    collective inside, one all-gather gives every rank the whole result,
    and with ``health`` every rank salvages the gathered lanes identically.
    The JAX package compiles this solve through its executable registry;
    eager PyTorch has no program to compile (the registry of the port keeps
    the kernel libraries, :mod:`raft_tpu_torch.cache.aot`), so the batched
    solve runs directly."""
    dev = resolve_device(device)
    th = torch.as_tensor(thetas, device=dev).to(dtype)
    th_l = th
    if mesh is not None:
        _mh.check_mesh(mesh, "sweep", dev)
        th_l = _stage_variants_global(th, mesh)
    with torch.no_grad():
        m = _apply_lanes(apply_fn, members, th_l)
        out = forward_response(m, rna, env, wave, C_moor, n_iter=n_iter, dtype=dtype, device=dev)
        abs2 = out.Xi.abs2()
        outs = (response_std(abs2, wave.w), out.n_iter, abs2 if return_xi else None,
                out.converged if health else None, _lane_finite(abs2) if health else None)
        if mesh is not None:
            outs = tuple(None if o is None else _gather_lanes((o,), mesh)[0] for o in outs)
    sigma, iters, abs2, conv, finite = outs
    res = {"std dev": _host(sigma), "iterations": _host(iters)}
    if return_xi:
        res["Xi_abs2"] = _host(abs2)
    if not health:
        return res

    def solve_lane(idx, n_iter_r, relax_r, tik_r):
        with torch.no_grad():
            m1 = _apply_lanes(apply_fn, members, th[idx:idx + 1])
            o = forward_response(m1, rna, env, wave, C_moor, n_iter=n_iter_r, relax=relax_r,
                                 tik=tik_r, dtype=dtype, device=dev)
            a2 = o.Xi.abs2()
            stat = a2 if return_xi else response_std(a2, wave.w)
            fin = _lane_finite(a2)
        return ((_host(stat[0]), _host(o.n_iter[0])), bool(o.converged[0]), bool(fin[0]),
                int(o.n_iter[0]))

    return _health_finish(
        res, _host(conv), _host(finite),
        ["Xi_abs2", "iterations"] if return_xi else ["std dev", "iterations"],
        solve_lane, n_iter, escalate, std_from=("Xi_abs2", wave.w) if return_xi else None)


def _sig_label(sig) -> str:
    """Stable short label of a bucket signature for metric and span names
    ("16x64x128" = segments x nodes x nw)."""
    return f"{sig.segments}x{sig.nodes}x{sig.nw}"


def _record_bucket_metrics(_obs, batch, B, dispatch_s) -> None:
    """Per-bucket registry feed of one :func:`_sweep_designs_bucket`
    dispatch: the latency histogram (one per bucket signature) and the
    lane counter."""
    label = _sig_label(batch.sig)
    _obs.metrics.histogram(f"sweep_designs.dispatch_s[{label}]").observe(dispatch_s)
    _obs.metrics.counter("sweep_designs.lanes").inc(B)


def _lane_slice(args, sl: slice):
    """The lanes ``sl`` of a design bucket's solve arguments (members,
    rna, env, wave, C_moor, bem), as views: every per-lane tensor is cut
    on its leading axis, the shared grid ``wave.w`` is kept."""
    members, rna, env, wave, C_moor, bem = args

    def lanes(obj, keep=()):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name)[sl] for f in dataclasses.fields(obj)
            if f.name not in keep and isinstance(getattr(obj, f.name), torch.Tensor)
            and getattr(obj, f.name).ndim})

    if bem is not None:
        bem = (bem[0][sl], bem[1][sl], Cx(bem[2].re[sl], bem[2].im[sl]))
    return (lanes(members), lanes(rna), lanes(env), lanes(wave, keep=("w",)), C_moor[sl], bem)


def _stage_bucket_global(args, mesh):
    """This rank's block of a bucket's lanes (views of every per-lane
    tensor), the lane count divisible by the mesh's size."""
    return _lane_slice(args, _mh.lane_block(
        mesh, int(args[0].seg_l.shape[0]), "sweep_designs",
        "bucket lane count {n} is not divisible by mesh axis {dim!r} size {size} — pad the "
        "design batch or use a divisor-sized mesh"))


def _dispatch_sharded_bucket(one, args, mesh):
    """One bucket with its design axis sharded over the 1-D ``mesh``: each
    rank solves its own lane block (no collective; the lanes are
    independent) and the outputs are gathered, so every rank holds them
    whole."""
    return _gather_lanes(one(*_stage_bucket_global(args, mesh)), mesh)


def _sweep_designs_bucket(batch, n_iter: int, return_xi: bool, dtype, dev, health: bool = False,
                          escalate: bool = True, chunk: int | None = None,
                          pipeline_depth: int | None = None, mesh=None) -> dict:
    """One shape bucket's stacked designs (a ``model.DesignBatch``) as one
    batched :func:`forward_response`: every per-design tensor carries the
    lane axis (the JAX package vmaps its per-design function over them).
    Returns numpy: ``"std dev"`` (B, 6), ``"iterations"`` (B,) and, with
    ``return_xi``, ``"Xi_abs2"`` (B, nw_pad, 6).

    ``chunk``: the lanes in sub-batches through the dispatch-ahead
    pipeline, the chunk rounded down to a divisor of the bucket's lane
    count (bucket sizes emerge from the design mix); the result gains
    ``"pipeline"`` (and ``"checkpoint"`` under ``RAFT_TPU_CKPT``).
    ``health``: per-lane verdicts, quarantine and the ladder
    (:func:`_health_finish`); a bad design's lane is salvaged without
    touching its bucket-mates.  ``mesh``: the lanes sharded over a 1-D
    ``DeviceMesh`` (:func:`_dispatch_sharded_bucket`; the span gains
    ``"sharded": True``); salvage runs on the gathered lanes.  The span
    ``sweep_designs/bucket`` times each bucket through its results on the
    host."""
    from raft_tpu_torch import obs as _obs
    from raft_tpu_torch.parallel import pipeline as _pipe
    from raft_tpu_torch.resilience import checkpoint as _ckpt

    B = len(batch.fnames)
    C_moor = (batch.C_moor if batch.C_moor is not None
              else torch.zeros((B, 6, 6), dtype=dtype, device=dev))
    args = (batch.members, batch.rna, batch.env, batch.wave, C_moor, batch.bem)

    def one(members, rna, env, wave, C, bem, n=n_iter, relax=0.8, tik=0.0):
        with torch.no_grad():
            out = forward_response(members, rna, env, wave, C, bem=bem, n_iter=n, relax=relax,
                                   tik=tik, dtype=dtype, device=dev)
            abs2 = out.Xi.abs2()
            stat = abs2 if return_xi else response_std(abs2, wave.w)
            if health:
                return stat, out.n_iter, out.converged, _lane_finite(abs2)
            return stat, out.n_iter

    label = _sig_label(batch.sig)
    pipe_stats = store = None
    if chunk is not None:
        chunk = max(d for d in range(1, min(int(chunk), B) + 1) if B % d == 0)
        if _ckpt.enabled():
            # the stored results depend on every staged design's values
            store = _ckpt.store_for(
                "sweep_designs", _lane_slice(args, slice(0, chunk)),
                extra=("n_iter", n_iter, "return_xi", bool(return_xi), "health", bool(health),
                       "chunk", chunk, "sig", label,
                       "data_sha", _ckpt.content_hash(list(_pipe.tensors(args)))),
                n_chunks=B // chunk, device=dev)
        with _obs.trace.span("sweep_designs/bucket",
                             attrs={"sig": label, "lanes": B, "chunk": chunk}):
            t0 = time.perf_counter()
            results, pipe_stats = _pipe.run_pipelined(
                one, range(B // chunk), depth=pipeline_depth,
                stage=lambda k: _lane_slice(args, slice(k * chunk, (k + 1) * chunk)),
                ckpt=store, device=dev)
            dispatch_s = time.perf_counter() - t0
        outs = tuple(np.concatenate([np.atleast_1d(r[j]) for r in results])
                     for j in range(len(results[0])))
        with torch.no_grad():
            sigma = (_host(response_std(torch.as_tensor(outs[0], device=dev), batch.wave.w))
                     if return_xi else outs[0])
    else:
        attrs = {"sig": label, "lanes": B, **({} if mesh is None else {"sharded": True})}
        with _obs.trace.span("sweep_designs/bucket", attrs=attrs):
            t0 = time.perf_counter()
            outs_dev = one(*args) if mesh is None else _dispatch_sharded_bucket(one, args, mesh)
            with torch.no_grad():
                sigma = _host(response_std(outs_dev[0], batch.wave.w) if return_xi
                              else outs_dev[0])
            outs = tuple(_host(o) for o in outs_dev)
            dispatch_s = time.perf_counter() - t0
        del outs_dev
    _record_bucket_metrics(_obs, batch, B, dispatch_s)
    res = {"std dev": sigma, "iterations": outs[1]}
    if return_xi:
        res["Xi_abs2"] = outs[0]
    if pipe_stats is not None:
        res["pipeline"] = pipe_stats.to_dict()
        if store is not None:
            res["checkpoint"] = store.to_dict()
    if not health:
        return res

    def solve_lane(idx, n_iter_r, relax_r, tik_r):
        stat, it, conv_i, fin_i = one(*_lane_slice(args, slice(idx, idx + 1)), n=n_iter_r,
                                      relax=relax_r, tik=tik_r)
        return ((_host(stat[0]), _host(it[0])), bool(conv_i[0]), bool(fin_i[0]), int(it[0]))

    return _health_finish(
        res, outs[2], outs[3],
        ["Xi_abs2", "iterations"] if return_xi else ["std dev", "iterations"],
        solve_lane, n_iter, escalate,
        std_from=("Xi_abs2", batch.wave.w) if return_xi else None)


def sweep_designs(fnames=None, nw: int = 100, Hs: float = 8.0, Tp: float = 12.0,
                  w_min: float = 0.05, w_max: float = 2.95, with_mooring: bool = True,
                  bems=None, staged: dict | None = None, n_iter: int = 25,
                  return_xi: bool = True, health: bool = False, escalate: bool = True,
                  chunk: int | None = None, pipeline_depth: int | None = None, mesh=None,
                  dtype=torch.float64, device=None) -> dict:
    """A mixed batch of different platform designs, one batched solve per
    shape bucket.

    The designs (YAML paths or dicts) are bucketized into a small ladder of
    padded shape classes (:mod:`raft_tpu_torch.build.buckets`, override by
    ``RAFT_TPU_BUCKETS``) and staged lane-leading per bucket
    (:func:`raft_tpu_torch.model.stage_designs`: per-design water depth,
    mooring stiffness, masked member padding, zero-response frequency
    padding); each bucket then solves as one :func:`forward_response`
    (scan driver, ``n_iter`` steps).  ``staged``: a prebuilt
    ``stage_designs`` result (the staging arguments are then ignored);
    ``bems``: optional per-design raw BEM tuples, staged padded.
    ``chunk``: each bucket's lanes in ``chunk``-sized sub-batches through
    the dispatch-ahead pipeline (:func:`_sweep_designs_bucket`);
    ``pipeline_depth`` without ``chunk`` is accepted and ignored, as in
    the JAX package.  ``health=True``: the lane-health contract per lane
    (see :func:`sweep_sea_states`).  ``mesh``: a 1-D ``DeviceMesh``
    (:func:`make_mesh`, :func:`raft_tpu_torch.parallel.multihost.
    global_mesh`): every rank stages the whole batch, solves its block of
    each bucket's lanes (each bucket's lane count divisible by the mesh's
    size) and gathers the rest, so every rank returns the whole result;
    with ``health`` every rank salvages the gathered lanes identically.
    ``mesh`` with ``chunk`` raises ``ValueError``.

    Returns numpy arrays in the caller's original design order:
    ``"designs"``, ``"std dev"`` (D, 6), ``"iterations"`` (D,),
    ``"Xi_abs2"`` (D, nw, 6) trimmed to the physical bins (with
    ``return_xi``), a ``"buckets"`` block (ladder, signatures, lane
    counts, promotions of this staging), ``"pipeline"`` and
    ``"checkpoint"`` blocks per bucket signature when chunked, and the
    per-lane ``"converged"``/``"finite"`` and a merged ``"health"`` block
    (lanes in the caller's order) with ``health``.  Each bucket runs
    inside the span ``sweep_designs/bucket`` and feeds the
    ``sweep_designs.*`` metrics; with ``RAFT_TPU_OBS`` armed the call ends
    in :func:`raft_tpu_torch.obs.maybe_publish`.  The JAX package compiles
    each bucket through its executable registry and feeds the dispatch's
    whole-program cost to its performance ledger; eager PyTorch has neither
    a program to compile nor a whole-program cost, so the dispatch feeds
    only its ``dispatch_s`` histogram, and the per-kernel ledger
    (:mod:`raft_tpu_torch.obs.ledger`) times K1's launches inside it."""
    from raft_tpu_torch import obs as _obs
    from raft_tpu_torch.build import buckets as _buckets
    from raft_tpu_torch.model import stage_designs

    if mesh is not None and chunk is not None:
        raise ValueError("sweep_designs: mesh= and chunk= both split the design axis (mesh over "
                         "devices, chunk over pipelined dispatches) — pass one or the other")
    dev = resolve_device(device)
    if mesh is not None:
        _mh.check_mesh(mesh, "sweep_designs", dev)
    if staged is None:
        if fnames is None:
            raise ValueError("sweep_designs needs a design list (fnames) or a prebuilt staged= "
                             "dict")
        staged = stage_designs(fnames, nw=nw, Hs=Hs, Tp=Tp, w_min=w_min, w_max=w_max,
                               with_mooring=with_mooring, bems=bems, dtype=dtype, device=dev)
    elif bems is not None:
        raise ValueError("bems cannot be applied to a prebuilt staged= dict (staging already "
                         "fixed each batch's BEM layout): pass bems to stage_designs (or to "
                         "sweep_designs with fnames)")
    batches = list(staged.values())
    if not batches:
        raise ValueError("no designs staged")
    D = sum(len(b.fnames) for b in batches)
    nw_phys = batches[0].nw
    per_bucket = [_sweep_designs_bucket(b, n_iter, return_xi, dtype, dev, health=health,
                                        escalate=escalate, chunk=chunk,
                                        pipeline_depth=pipeline_depth, mesh=mesh)
                  for b in batches]

    def scatter(key, trim_nw=False):
        first = per_bucket[0][key]
        out = np.zeros((D,) + first.shape[1:], dtype=first.dtype)
        for b, res in zip(batches, per_bucket):
            out[np.asarray(b.indices)] = res[key]
        if trim_nw and out.ndim >= 3:
            out = out[:, :nw_phys]
        return out

    names = [None] * D
    for b in batches:
        for i, fn in zip(b.indices, b.fnames):
            names[i] = fn
    result = {"designs": names, "std dev": scatter("std dev"),
              "iterations": scatter("iterations")}
    if return_xi:
        result["Xi_abs2"] = scatter("Xi_abs2", trim_nw=True)
    result["buckets"] = {
        "ladder": _buckets.ladder_salt()[1],
        "n_designs": D,
        "n_buckets": len(batches),
        "signatures": [{"segments": b.sig.segments, "nodes": b.sig.nodes, "nw": b.sig.nw,
                        "designs": len(b.fnames)} for b in batches],
        # this staging's promotions, not the process-wide counter
        "promotions": sum(b.promotions for b in batches),
    }
    for key in ("pipeline", "checkpoint"):
        blocks = {str(tuple(b.sig)): res[key] for b, res in zip(batches, per_bucket)
                  if key in res}
        if blocks:
            result[key] = blocks
    if health:
        result["converged"] = scatter("converged")
        result["finite"] = scatter("finite")
        merged_rungs: dict = {}
        quarantined, unsalvaged, salvaged = [], [], 0
        for b, res in zip(batches, per_bucket):
            h = res["health"]
            idx = list(b.indices)
            quarantined += [idx[i] for i in h["quarantined"]]
            unsalvaged += [idx[i] for i in h["unsalvaged"]]
            salvaged += h["salvaged"]
            for r, n in h["rungs_used"].items():
                merged_rungs[r] = merged_rungs.get(r, 0) + n
        result["health"] = {
            "lanes": D,
            "n_quarantined": len(quarantined),
            "quarantined": sorted(quarantined),
            "salvaged": salvaged,
            "unsalvaged": sorted(unsalvaged),
            "rungs_used": merged_rungs,
            "per_bucket": {str(tuple(b.sig)): res["health"]
                           for b, res in zip(batches, per_bucket)},
        }
    _obs.maybe_publish("sweep_designs")
    return result


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


def _volturnus_design() -> dict:
    import yaml

    with open(VOLTURNUS_S) as f:
        return yaml.safe_load(f)


def _north_star_wave(nw: int, depth: float, dtype, dev) -> WaveState:
    w = torch.as_tensor(np.linspace(0.05, 2.95, nw), device=dev).to(dtype)
    return WaveState(w=w, k=wave_number(w, depth), zeta=torch.sqrt(jonswap(w, 8.0, 12.0)))


def _volturnus(nw: int, dtype, dev):
    """The north star's design, RNA, sea state (JONSWAP Hs 8 m / Tp 12 s on
    ``linspace(0.05, 2.95, nw)``) and undisplaced mooring stiffness."""
    design = _volturnus_design()
    members = build_member_set(design, dev, dtype)
    rna = build_rna(design)
    depth = float(design["mooring"]["water_depth"])
    env = Env(Hs=8.0, Tp=12.0, depth=depth)
    wave = _north_star_wave(nw, depth, dtype, dev)
    moor = parse_mooring(design["mooring"], dev, dtype,
                         yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0))
    C_moor = mooring_stiffness(moor, torch.zeros(6, dtype=dtype, device=dev))
    return design, members, rna, env, wave, C_moor


def stage_north_star_bem(nw: int = 200, nw_bem: int = 48, mode: str = "native",
                         cache: bool = True, dtype=torch.float64, device=None,
                         return_diagnostics: bool = False, precision: str | None = None):
    """BEM coefficients of the nominal VolturnUS-S hull for the north star,
    staged as ``bench.py::_volturn_setup`` stages them.

    Meshes the potMod members at ``dz_max=3, da_max=2`` (850 panels),
    solves them at ``nw_bem`` frequencies over ``linspace(0.05, 2.95,
    nw_bem)`` (depth 200 m, heading 0), interpolates A, B, F to the sweep's
    ``nw`` frequencies and stages them on ``device`` in ``dtype``
    (:func:`stage_bem`).  ``mode="native"`` (the default, as ``bench.py``)
    solves on the host with the C++ solver in f64 on every core, torch
    untouched until the staging;
    ``mode="jax"`` solves on ``device`` in ``dtype`` with kernels K3/K4 on
    CUDA, its assembly in bfloat16 when ``precision`` (None reads
    ``RAFT_TPU_BEM_PRECISION``) resolves to ``bf16`` and ``dtype`` is
    float32.  ``cache``: the solvers' on-disk result cache.
    Returns (A, B, F Cx) (and, with ``return_diagnostics``, the solve's
    diagnostics with the host-layout coefficients at the ``nw_bem``
    frequencies under ``"coeffs"``: (w_bem, A, B, F))."""
    from raft_tpu_torch.hydro.bem_io import interp_to_grid
    from raft_tpu_torch.hydro.mesh import mesh_design
    from raft_tpu_torch.hydro.torch_bem import solve_bem_any

    if mode not in ("native", "jax"):
        raise ValueError(f"mode {mode!r}: expected 'native' or 'jax'")
    dev = resolve_device(device)
    design = _volturnus_design()
    depth = float(design["mooring"]["water_depth"])
    env = Env(Hs=8.0, Tp=12.0, depth=depth)
    w = np.linspace(0.05, 2.95, nw)
    w_bem = np.linspace(w[0], w[-1], nw_bem)
    panels = mesh_design(design, dz_max=3.0, da_max=2.0)
    A_c, B_c, F_c, diag = solve_bem_any(panels, w_bem, rho=float(env.rho), g=float(env.g),
                                        beta=0.0, depth=depth, mode=mode, cache=cache,
                                        dtype=dtype, device=dev, return_diagnostics=True,
                                        precision=precision)
    staged = stage_bem((interp_to_grid(w_bem, A_c, w), interp_to_grid(w_bem, B_c, w),
                        interp_to_grid(w_bem, F_c, w)), _north_star_wave(nw, depth, dtype, dev))
    if not return_diagnostics:
        return staged
    return staged, {**diag, "coeffs": (w_bem, A_c, B_c, F_c)}


def sweep_north_star(n_designs: int = 1000, nw: int = 200, chunk: int = 250,
                     n_iter: int = 40, dtype=torch.float64, device=None, bem=None,
                     lanes=None, pipeline_depth: int | None = None, health: bool = False,
                     ckpt: bool = False) -> dict:
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

    The chunks run through the dispatch-ahead pipeline
    (:func:`raft_tpu_torch.parallel.pipeline.run_pipelined`, ``bench.py``'s
    ``run_all``): each chunk's (chunk, 2) scale table is copied from pinned
    memory on a copy stream while the previous chunk solves, and only the
    statistics come back.  The ``while`` loop synchronises the host once
    per iteration, so a chunk's solve blocks the host and the pipeline
    hides little under it.  ``pipeline_depth`` overrides the window
    (default ``RAFT_TPU_PIPELINE_DEPTH`` or 2).  ``ckpt=True`` stores each
    fetched chunk when ``RAFT_TPU_CKPT`` is set (``bench.py``'s validating
    pass; a re-run resumes at the first missing chunk).  ``health=True``
    is ``bench.py``'s tail: with ``RAFT_TPU_STRICT`` on (the default) a
    lane that did not converge finite raises, the ``resilience`` block in
    the message; off, failed lanes are quarantined and salvaged through
    the escalation ladder, each rung a single-lane ``while`` solve, and
    the block is returned under ``"resilience"``.  With any of the three
    the result gains the ``"pipeline"`` block (and ``"checkpoint"`` when
    a store was used); without them it is what it always was.  The span
    ``rebuild`` times the per-call set-up before the chunks (design,
    mooring stiffness, the BEM cast, the draft and plan warps, the grid).
    """
    from raft_tpu_torch.parallel import pipeline as _pipe
    from raft_tpu_torch.resilience import checkpoint as _ckpt

    dev = resolve_device(device)
    with span("rebuild"):
        _design, members, rna, env, wave, C_moor = _volturnus(nw, dtype, dev)
        if bem is not None:
            A, B, F = bem
            bem = (A.to(dtype), B.to(dtype), Cx(F.re.to(dtype), F.im.to(dtype)))
        draft = make_stretch_draft(members)
        plan = make_scale_plan(members)

        grid = north_star_grid(n_designs)
        if lanes is not None:
            grid = grid[lanes]
    n = grid.shape[0]

    def solve(th, n_it=n_iter, relax=0.8, tik=0.0):
        with torch.no_grad():
            m = plan(draft(members, th[:, 1]), th[:, 0])
            out = forward_response(m, rna, env, wave, C_moor, bem=bem, n_iter=n_it,
                                   method="while", relax=relax, tik=tik, dtype=dtype,
                                   device=dev)
            return response_std(out.Xi.abs2(), wave.w), out.converged, out.n_iter

    store = None
    if ckpt and _ckpt.enabled():
        store = _ckpt.store_for(
            "sweep_north_star", (f"{dtype}", (min(chunk, n), 2)),
            consts=(members, rna, env, wave, C_moor, bem or ()),
            extra=("n_iter", n_iter, "method", "while", "chunk", chunk,
                   "data_sha", _ckpt.content_hash([grid])),
            n_chunks=-(-n // chunk), device=dev)
    results, stats = _pipe.run_pipelined(
        solve, [grid[lo:lo + chunk] for lo in range(0, n, chunk)], depth=pipeline_depth,
        stage=lambda c: (to_device(c, dtype, dev),), ckpt=store, device=dev)
    sig = np.concatenate([r[0] for r in results])
    conv = np.concatenate([r[1] for r in results])
    itr = np.concatenate([r[2] for r in results])
    out = {"std": torch.as_tensor(sig, device=dev), "n_iter": torch.as_tensor(itr, device=dev),
           "converged": torch.as_tensor(conv, device=dev),
           "scales": torch.as_tensor(grid, device=dev).to(dtype)}
    if pipeline_depth is None and not health and not ckpt:
        return out
    out["pipeline"] = stats.to_dict()
    if store is not None:
        out["checkpoint"] = store.to_dict()
    if health:
        out.update(_north_star_health(solve, grid, sig, conv, itr, n_iter, stats, store,
                                      dtype, dev))
    return out


def _north_star_health(solve, grid, sig, conv, itr, n_iter, stats, store, dtype, dev) -> dict:
    """``bench.py::north_star``'s health tail: strict mode raises on any
    lane that did not converge finite; otherwise failed lanes are
    quarantined and salvaged, each rung one single-lane ``while`` solve,
    and the patched statistics come back with the ``resilience`` block."""
    from raft_tpu_torch.resilience import health as _health
    from raft_tpu_torch.resilience import ladder as _ladder

    def solve_lane(idx, n_iter_r, relax_r, tik_r):
        s_i, c_i, i_i = solve(to_device(grid[idx:idx + 1], dtype, dev), n_iter_r,
                              relax_r, tik_r)
        s_h = _host(s_i[0])
        return ((s_h, _host(i_i[0])), bool(c_i[0]), bool(np.isfinite(s_h).all()),
                int(i_i[0]))

    strict = _health.strict()
    sig, itr = np.array(sig), np.array(itr)
    records, conv, _fin = _ladder.quarantine_and_salvage(
        [sig, itr], conv, None, solve_lane, n_iter, escalate=not strict, iters=itr)
    n = len(conv)
    resil = _health.summarize(records, n, extra={
        "strict": strict,
        "chunks_resumed": stats.chunks_resumed,
        "chunks_computed": stats.chunks_computed,
        "ckpt_corrupt": stats.ckpt_corrupt,
        **({"checkpoint": store.to_dict()} if store is not None else {}),
    })
    n_conv = int(conv.sum())
    if strict and (n_conv != n or not np.isfinite(sig).all()):
        raise RuntimeError(
            f"only {n_conv}/{n} design lanes converged finite (strict mode; "
            f"RAFT_TPU_STRICT=0 quarantines + salvages instead): resilience={json.dumps(resil)}")
    return {"std": torch.as_tensor(sig, device=dev), "n_iter": torch.as_tensor(itr, device=dev),
            "converged": torch.as_tensor(conv, device=dev), "resilience": resil}
