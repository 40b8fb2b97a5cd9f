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
chunks, with the std dev reduced on the device.  The caller may add the
nominal hull's BEM coefficients to every lane (:func:`stage_north_star_bem`
solves them with the host C++ panel solver, as ``bench.py`` does, or on the
device); without them it is the same sweep on the strip-theory path alone.
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
from raft_tpu_torch.core.waves import jonswap, spreading_weights, wave_number
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
    and the co-design losses."""
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
                     tik: float = 0.0, dtype=torch.float64, device=None) -> RAOResult:
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
    already lie on ``device`` in ``dtype``.
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
    stat = assemble_statics(members, rna, env)
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


# ------------------------------------------------------ sea-state batches

#: the ROADMAP item that holds the JAX package's multi-device, pipelined and
#: lane-health options of the batched sweeps
_OPERATIONS_ITEM = "ROADMAP.md, queue 1, item 7"


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
                      tik: float = 0.0, dtype=torch.float64, device=None):
    """The DLC solve of every case at once: ``(waves, F_re, F_im) ->
    (|Xi|^2 (B, nw, 6), sigma_nacelle (B,), iterations (B,))``, each case a
    lane of :func:`forward_response` (the JAX package vmaps its per-case
    function instead).  The zeta scaling of the staged excitation
    (``F_re``/``F_im`` (nw, 6) shared or (B, nw, 6) per case) is the only
    sea-state-dependent staging, so it happens per lane here."""
    from raft_tpu_torch.parallel.optimize import nacelle_accel_std

    def run(waves, F_re, F_im):
        b = (_stage_zeta((staged[0], staged[1], F_re, F_im), waves.zeta)
             if staged is not None else None)
        out = forward_response(members, rna, env, waves, C_moor, bem=b, n_iter=n_iter,
                               relax=relax, tik=tik, dtype=dtype, device=device)
        return out.Xi.abs2(), nacelle_accel_std(out.Xi, waves, rna), out.n_iter

    return run


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


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

    Not ported: ``mesh`` (sharding over devices), ``chunk`` /
    ``pipeline_depth`` (pipelined chunks) and ``health`` / ``escalate``
    (lane quarantine and the escalation ladder) raise
    ``NotImplementedError`` (ROADMAP.md, queue 1, item 7)."""
    for name, given in (("mesh", mesh is not None), ("chunk", chunk is not None),
                        ("pipeline_depth", pipeline_depth is not None),
                        ("health", bool(health))):
        if given:
            raise NotImplementedError(
                f"sweep_sea_states({name}=...): multi-device sharding, pipelined chunks and "
                f"lane health (with escalate) come with {_OPERATIONS_ITEM}")
    dev = resolve_device(device)
    w_rows = waves.w.reshape(-1, waves.w.shape[-1])
    if not bool((w_rows == w_rows[0]).all()):
        raise ValueError("sweep_sea_states requires one shared frequency grid across cases "
                         "(make_wave_states builds one)")
    B = int(waves.zeta.shape[0])
    betas_case = None if waves.beta is None else _host(waves.beta)
    mode = _bem_mode(bem, betas_case)
    staged = F_re = F_im = None
    if mode == "grid":
        betas_eval = betas_case if betas_case is not None else np.full(B, float(env.beta))
        A_dev, B_dev, F_re, F_im = _stage_heading_rows(bem, betas_eval, dtype, dev)
        staged = (A_dev, B_dev)
    elif mode == "raw":
        A_dev, B_dev, F_re, F_im = _bem_device_layout(bem, dtype, dev)
        staged = (A_dev, B_dev)
    run = _make_dlc_case_fn(members, rna, env, C_moor, staged, n_iter, dtype=dtype, device=dev)
    with torch.no_grad():
        abs2, a_nac, iters = run(waves, F_re, F_im)
        sigma = response_std(abs2, w_rows[0])
    return {"std dev": _host(sigma), "nacelle accel std dev": _host(a_nac),
            "iterations": _host(iters), "Xi_abs2": _host(abs2)}


def directional_response(members: MemberSet, rna: RNA, env: Env, waves_dir: WaveState,
                         C_moor: Tensor, bem=None, n_iter: int = 25, mesh=None,
                         dtype=torch.float64, device=None) -> dict:
    """Response statistics in a directionally spread (or multi-component)
    sea: the lanes of ``waves_dir`` (:func:`spread_sea_state`,
    :func:`mixed_sea_state`) are independent linear components, solved as a
    DLC table by :func:`sweep_sea_states` (each with its own drag
    linearization), and their variances add:
    ``sigma_total^2 = sum_j sigma_j^2``.  Returns ``{"std dev": (6,),
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

    Not ported: ``mesh`` (sharding over devices) and ``health`` /
    ``escalate`` (lane quarantine and the escalation ladder) raise
    ``NotImplementedError`` (ROADMAP.md, queue 1, item 7); nor the AOT
    executable registry and the ``obs`` spans around the call: the batched
    solve runs directly."""
    for name, given in (("mesh", mesh is not None), ("health", bool(health))):
        if given:
            raise NotImplementedError(
                f"sweep({name}=...): multi-device sharding and lane health (with escalate) "
                f"come with {_OPERATIONS_ITEM}")
    dev = resolve_device(device)
    th = torch.as_tensor(thetas, device=dev).to(dtype)
    with torch.no_grad():
        m = _apply_lanes(apply_fn, members, th)
        out = forward_response(m, rna, env, wave, C_moor, n_iter=n_iter, dtype=dtype, device=dev)
        abs2 = out.Xi.abs2()
        sigma = response_std(abs2, wave.w)
    res = {"std dev": _host(sigma), "iterations": _host(out.n_iter)}
    if return_xi:
        res["Xi_abs2"] = _host(abs2)
    return res


def _sweep_designs_bucket(batch, n_iter: int, return_xi: bool, dtype, dev) -> dict:
    """One shape bucket's stacked designs (a ``model.DesignBatch``) as one
    batched :func:`forward_response`: every per-design tensor carries the
    lane axis (the JAX package vmaps its per-design function over them).
    Returns numpy: ``"std dev"`` (B, 6), ``"iterations"`` (B,) and, with
    ``return_xi``, ``"Xi_abs2"`` (B, nw_pad, 6)."""
    B = len(batch.fnames)
    C_moor = (batch.C_moor if batch.C_moor is not None
              else torch.zeros((B, 6, 6), dtype=dtype, device=dev))
    with torch.no_grad():
        out = forward_response(batch.members, batch.rna, batch.env, batch.wave, C_moor,
                               bem=batch.bem, n_iter=n_iter, dtype=dtype, device=dev)
        abs2 = out.Xi.abs2()
        sigma = response_std(abs2, batch.wave.w)
    res = {"std dev": _host(sigma), "iterations": _host(out.n_iter)}
    if return_xi:
        res["Xi_abs2"] = _host(abs2)
    return res


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

    Returns numpy arrays in the caller's original design order:
    ``"designs"``, ``"std dev"`` (D, 6), ``"iterations"`` (D,),
    ``"Xi_abs2"`` (D, nw, 6) trimmed to the physical bins (with
    ``return_xi``), and a ``"buckets"`` block (ladder, signatures, lane
    counts, promotions of this staging).

    Not ported (ROADMAP.md, queue 1, item 7): ``chunk`` /
    ``pipeline_depth`` (pipelined chunks), ``mesh`` (sharding over
    devices) and ``health`` / ``escalate`` raise ``NotImplementedError``;
    the AOT executable registry and the ``obs`` spans, ledger and
    publication around each bucket are left out: the batched solve runs
    directly."""
    from raft_tpu_torch.build import buckets as _buckets
    from raft_tpu_torch.model import stage_designs

    for name, given in (("chunk", chunk is not None),
                        ("pipeline_depth", pipeline_depth is not None),
                        ("mesh", mesh is not None), ("health", bool(health))):
        if given:
            raise NotImplementedError(
                f"sweep_designs({name}=...): pipelined chunks, multi-device sharding and lane "
                f"health (with escalate) come with {_OPERATIONS_ITEM}")
    dev = resolve_device(device)
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
    per_bucket = [_sweep_designs_bucket(b, n_iter, return_xi, dtype, dev) for b in batches]

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
