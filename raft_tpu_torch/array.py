"""Multi-turbine arrays: FOWTs stacked on a leading turbine axis (port of
``raft_tpu.array``).

Each turbine's padded MemberSet and RNA are stacked on a leading axis, and
the whole pipeline (statics, strip hydro, drag-linearized RAO fixed point)
runs once over that axis, where the JAX package vmaps it; each fixed-point
iteration solves every turbine's frequencies in one launch of kernel K1.

Turbines are hydrodynamically independent (no wave interaction between
hulls), each with its own mooring system, all in one incident wave field.
A turbine at plan position (x, y) sees the incident wave with phase lag
``exp(-i k (x cos beta + y sin beta))``; the phase multiplies the wave
kinematics at its strip nodes (and its BEM excitation), so excitation and
drag linearization inherit it.  The 6N-DOF system is block-diagonal, and
its response is the stacked per-turbine response.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.build.members import build_rna, member_arrays, member_set_from_arrays
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.types import RNA, Env, WaveState
from raft_tpu_torch.core.waves import jonswap, wave_number
from raft_tpu_torch.hydro.strip import (
    StripKin, current_mean_force, node_kinematics, strip_added_mass, strip_excitation,
)
from raft_tpu_torch.mooring.system import (
    fairlead_tensions, mooring_stiffness, parse_mooring, solve_equilibrium, stack_systems,
    tension_jacobian,
)
from raft_tpu_torch.parallel import multihost as _mh
from raft_tpu_torch.parallel.sweep import _gather_rao, stage_bem
from raft_tpu_torch.solve.dynamics import LinearCoeffs, solve_dynamics
from raft_tpu_torch.solve.eigen import diagonal_estimates, eigen_with_bem_batched, solve_eigen
from raft_tpu_torch.statics import assemble_statics


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def stack_fowts(designs: list, dtype=torch.float64, device=None):
    """Each design's member set at the shared (largest) padding, stacked on
    the host and copied once, and the RNAs as (nT,) tensors.  Returns
    (members, rna) with a leading turbine axis on every field."""
    dev = resolve_device(device)
    base = [member_arrays(d) for d in designs]
    S = max(a["seg_mask"].shape[0] for a in base)
    N = max(a["node_mask"].shape[0] for a in base)
    arrays = [member_arrays(d, pad_segments=S, pad_nodes=N) for d in designs]
    members = member_set_from_arrays({k: np.stack([a[k] for a in arrays]) for k in arrays[0]},
                                     dev, dtype)
    rnas = [build_rna(d) for d in designs]
    rna = RNA(**{f.name: torch.as_tensor(np.array([getattr(r, f.name) for r in rnas]),
                                         device=dev).to(dtype)
                 for f in dataclasses.fields(RNA)})
    return members, rna


def _moor_solve_batch(sys_b, F_b, C_b):
    """Equilibrium, stiffness and tensions of a stacked mooring system,
    each one batched call over the turbine axis: (r6_eq (nT, 6), residuals
    (nT,), C_moor (nT, 6, 6), tensions (nT, nl))."""
    r6, res = solve_equilibrium(sys_b, F_b, C_b)
    return r6, res, mooring_stiffness(sys_b, r6), fairlead_tensions(sys_b, r6)


def _phase_kin(kin: StripKin, ph: Cx) -> StripKin:
    """Node wave kinematics times each turbine's per-frequency phase factor
    ``ph`` (nT, nw)."""
    ph3 = Cx(ph.re[..., None, :, None], ph.im[..., None, :, None])
    ph2 = Cx(ph.re[..., None, :], ph.im[..., None, :])
    return StripKin(u=kin.u * ph3, ud=kin.ud * ph3, pDyn=kin.pDyn * ph2)


def _turbines(obj, sl: slice):
    """The turbines ``sl`` of a turbine-leading dataclass (MemberSet,
    StripKin, LinearCoeffs, Cx): every tensor field cut on its leading
    axis, as views."""
    if sl == slice(None):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj[sl] if obj.ndim else obj
    return dataclasses.replace(obj, **{
        f.name: _turbines(getattr(obj, f.name), sl) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        or dataclasses.is_dataclass(getattr(obj, f.name))})


class ArrayModel:
    """N mooring-coupled FOWTs analyzed as one stacked batch (nDOF = 6N).

    ``designs``: one design dict (replicated ``nT`` times) or a list of
    design dicts.  ``positions``: (nT, 2) plan coordinates of each
    turbine's PRP (default all zero, co-located).  ``BEM``: None (strip
    theory), ``"native"``, ``"jax"`` or ``"auto"`` (one panel solve of the
    shared hull, as ``Model.calcBEM``; identical designs only), or a
    precomputed (A[6, 6, nw], B[6, 6, nw], F[6, nw]) tuple.  Runs on
    ``device`` (the card by default) in ``dtype``.
    """

    def __init__(self, designs, positions=None, w=None, depth: float | None = None,
                 nT: int | None = None, BEM=None, dtype=torch.float64, device=None):
        if isinstance(designs, dict):
            if nT is None:
                nT = len(positions) if positions is not None else 1
            designs = [designs] * nT
        self.designs = list(designs)
        if BEM is not None and any(d is not self.designs[0] for d in self.designs):
            raise NotImplementedError(
                "BEM in arrays requires identical turbine designs (shared coefficients); "
                "mixed-design arrays run strip theory only")
        if isinstance(BEM, str) and BEM not in ("native", "jax", "auto"):
            raise ValueError(f"BEM={BEM!r}: expected 'native', 'jax', 'auto', or a "
                             "precomputed (A, B, F) tuple")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.bem_mode = BEM if isinstance(BEM, str) else None
        self.bem = BEM if not isinstance(BEM, str) else None
        self.bem_diagnostics: dict | None = None
        self._bem_staged = None
        self._bem_headings = None        # staged heading grid (calcBEM)
        self.nT = len(self.designs)
        if positions is None:
            positions = np.zeros((self.nT, 2))
        self.positions = np.asarray(positions, dtype=float).reshape(self.nT, 2)
        self.members, self.rna = stack_fowts(self.designs, dtype, self.device)
        self.moor = [self._parse_moor(d) for d in self.designs]
        if depth is None:
            m0 = self.designs[0].get("mooring")
            depth = float(m0.get("water_depth", 300.0)) if m0 else 300.0
        self.depth = float(depth)
        if w is None:
            w = np.arange(0.05, 3.0, 0.05)
        self.w = self._t(np.asarray(w, dtype=float))
        self.env = Env(depth=self.depth)
        self.wave: WaveState | None = None
        self.statics = None
        self.kin = None
        self.A_morison = None
        self.F_morison = None
        self.C_moor0 = None
        self.C_moor = None
        self.r6_eq = None
        self.rao = None
        self.eigen = None
        self.results: dict = {}

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _parse_moor(self, design: dict):
        mo = design.get("mooring")
        ys = float(design.get("turbine", {}).get("yaw_stiffness", 0.0))
        return parse_mooring(mo, self.device, self.dtype, yaw_stiffness=ys) if mo else None

    def addFOWT(self, design: dict, position=(0.0, 0.0)):
        """Append one turbine and rebuild the stacked axes; invalidates the
        computed state (call ``setEnv`` / ``calcSystemProps`` again)."""
        if self.bem is not None and design is not self.designs[0]:
            raise NotImplementedError("BEM arrays require identical turbine designs")
        self.designs.append(design)
        self.nT = len(self.designs)
        self.positions = np.vstack([self.positions, np.asarray(position, dtype=float)])
        self.members, self.rna = stack_fowts(self.designs, self.dtype, self.device)
        self.moor.append(self._parse_moor(design))
        self.wave = None
        self.statics = None
        self.kin = None
        self.rao = None
        self._bem_staged = None
        self.results = {}
        return self

    # ---------------------------------------------------------------- env

    def setEnv(self, Hs=8.0, Tp=12.0, V=10.0, beta=0.0, Fthrust=0.0,
               current=0.0, current_heading=0.0, current_exp=0.0):
        """Sea state, wind thrust and current, shared by every turbine; each
        turbine's incident phase lag follows from its position.  With a
        heading grid staged by ``calcBEM(headings=...)`` the excitation is
        re-staged for ``beta`` by interpolation, without a new solve."""
        # validate before mutating: a heading outside the staged grid must
        # leave the model as it was
        F_beta = None
        if self._bem_headings is not None and self.bem is not None:
            from raft_tpu_torch.model import interp_heading_excitation

            F_beta = interp_heading_excitation(self._bem_headings[0], self._bem_headings[1],
                                               float(beta))
        self.env = Env(Hs=float(Hs), Tp=float(Tp), V=float(V), beta=float(beta),
                       depth=self.depth, current=float(current),
                       current_heading=float(current_heading), current_exp=float(current_exp))
        k = wave_number(self.w, self.depth)
        self.wave = WaveState(w=self.w, k=k, zeta=torch.sqrt(jonswap(self.w, Hs, Tp)))
        d_along = self.positions[:, 0] * np.cos(beta) + self.positions[:, 1] * np.sin(beta)
        self.phases = Cx.expi(-self._t(d_along)[:, None] * k[None, :])     # (nT, nw)
        self.Fthrust = float(Fthrust)
        hubs = _np(self.rna.hHub).reshape(self.nT)
        self.f6Ext = self._t(np.stack([[self.Fthrust, 0, 0, 0, self.Fthrust * h, 0]
                                       for h in hubs]))
        # kinematics, excitation and the phased BEM staging are stale
        self.kin = None
        self.F_morison = None
        self._bem_staged = None
        if F_beta is not None:
            # A, B are heading-independent: only the excitation changes
            self.bem = (self._bem_headings[2], self._bem_headings[3], F_beta)
        return self

    # ------------------------------------------------------------- statics

    def calcBEM(self, dz_max: float = 3.0, da_max: float = 2.0, irr: bool = False,
                headings=None, cache: bool = True):
        """One panel solve of the shared hull, staged to every turbine (cf.
        ``Model.calcBEM``: the host C++ solver, or the card's K3/K4 route, in
        float32 with the bf16 assembly under ``RAFT_TPU_BEM_PRECISION=bf16``).
        ``headings``: optional heading grid [rad]; later ``setEnv(beta=...)``
        calls re-stage the excitation by interpolation."""
        from raft_tpu_torch.hydro.mesh import mesh_design, mesh_lid
        from raft_tpu_torch.hydro.torch_bem import model_solve_dtype, solve_bem_any
        from raft_tpu_torch.model import solve_bem_heading_grid

        panels = mesh_design(self.designs[0], dz_max=dz_max, da_max=da_max)
        if len(panels) == 0:
            return None
        lid = mesh_lid(self.designs[0], da_max=da_max) if irr else None
        solve = dict(rho=float(self.env.rho), g=float(self.env.g), depth=self.depth, lid=lid,
                     mode=self.bem_mode, cache=cache, dtype=model_solve_dtype(self.dtype),
                     device=self.device, return_diagnostics=True)
        w = _np(self.w)
        if headings is not None:
            self._bem_headings, self.bem, self.bem_diagnostics = solve_bem_heading_grid(
                panels, w, headings=headings, beta=float(self.env.beta), **solve)
        else:
            A, B, F, self.bem_diagnostics = solve_bem_any(panels, w, beta=float(self.env.beta),
                                                          **solve)
            self.bem = (A, B, F)
            self._bem_headings = None
        return self.bem

    def calcSystemProps(self):
        """Statics, strip hydro (phased per turbine), the phased BEM staging
        and the undisplaced mooring stiffness of every turbine."""
        if self.wave is None:
            self.setEnv()
        if self.bem_mode is not None and self.bem is None:
            self.calcBEM()
        exclude = self.bem is not None
        env, wave = self.env, self.wave
        self.statics = assemble_statics(self.members, self.rna, env)
        self.kin = _phase_kin(node_kinematics(self.members, wave, env), self.phases)
        self.A_morison = strip_added_mass(self.members, env, exclude_potmod=exclude)
        self.F_morison = strip_excitation(self.members, self.kin, env, exclude_potmod=exclude)
        if self.bem is not None:
            A_b, B_b, F_cx = stage_bem(self.bem, wave)          # F zeta-scaled
            ph = self.phases
            F_t = Cx(ph.re[:, :, None] * F_cx.re[None] - ph.im[:, :, None] * F_cx.im[None],
                     ph.re[:, :, None] * F_cx.im[None] + ph.im[:, :, None] * F_cx.re[None])
            self._bem_staged = (A_b, B_b, F_t)
        if self._moor_batchable():
            self.C_moor0 = mooring_stiffness(stack_systems(self.moor), self._zeros(self.nT, 6))
        else:
            self.C_moor0 = torch.stack([
                mooring_stiffness(mo, self._zeros(6)) if mo is not None else self._zeros(6, 6)
                for mo in self.moor])
        self.C_moor = self.C_moor0
        self.results["properties"] = {
            "n turbines": self.nT,
            "nDOF": 6 * self.nT,
            "total mass": _np(self.statics.mass),
            "displacement": _np(self.statics.V),
            "total CG": _np(self.statics.rCG),
        }
        return self

    # --------------------------------------------------------------- eigen

    def solveEigen(self, n_pass: int = 3):
        """The block-diagonal 6N eigenproblem as N 6x6 problems in one
        batched solve.  With BEM staged, each turbine's assembly takes the
        shared A_bem at each mode's own natural frequency (cf.
        ``Model.solveEigen``)."""
        if self.statics is None:
            self.calcSystemProps()
        M_tot = self.statics.M_struc + self.A_morison
        C_tot = self.statics.C_struc + self.statics.C_hydro + self.C_moor0
        if self.bem is None:
            eig = solve_eigen(M_tot, C_tot)
            est = diagonal_estimates(M_tot, C_tot)
        else:
            A_w = self._t(np.moveaxis(np.asarray(self.bem[0]), -1, 0))     # (nw, 6, 6)
            eig, est = eigen_with_bem_batched(M_tot, C_tot, A_w, self.w, n_pass=n_pass)
        self.eigen = eig
        fns = _np(eig.fns)                                              # (nT, 6)
        self.results["eigen"] = {
            "frequencies": fns,
            "periods": 1.0 / np.maximum(fns, 1e-12),
            "modes": _np(eig.modes),
            "estimates": _np(est),
        }
        return self

    # ------------------------------------------------------------- mooring

    def calcMooringAndOffsets(self):
        """Mean offsets and the mooring linearized about them: one batched
        Newton over the turbine axis when every turbine's mooring has one
        line count (:meth:`_moor_batchable`), else turbine by turbine."""
        if self.statics is None:
            self.calcSystemProps()
        s = self.statics
        f6Ext = self.f6Ext
        if abs(self.env.current) > 0:
            f6Ext = f6Ext + current_mean_force(self.members, self.env)
        if self._moor_batchable():
            r6s, res, Cs, Ts = _moor_solve_batch(stack_systems(self.moor),
                                                 s.W_struc + s.W_hydro + f6Ext,
                                                 s.C_struc + s.C_hydro)
            res = _np(res)
            Ts = list(Ts)
        else:
            r6s, Cs, Ts, res = [], [], [], []
            for i, mo in enumerate(self.moor):
                if mo is None:
                    r6s.append(self._zeros(6))
                    Cs.append(self._zeros(6, 6))
                    Ts.append(self._zeros(0))
                    res.append(0.0)
                    continue
                r6, r = solve_equilibrium(mo, s.W_struc[i] + s.W_hydro[i] + f6Ext[i],
                                          s.C_struc[i] + s.C_hydro[i])
                r6s.append(r6)
                Cs.append(mooring_stiffness(mo, r6))
                Ts.append(fairlead_tensions(mo, r6))
                res.append(float(r))
            r6s, Cs, res = torch.stack(r6s), torch.stack(Cs), np.asarray(res)
        self.r6_eq = r6s
        self.C_moor = Cs
        self.results["means"] = {
            "platform offset": _np(self.r6_eq),                      # (nT, 6)
            "equilibrium residual": res,
            "fairlead tensions": [_np(t) for t in Ts],
        }
        return self

    def _moor_batchable(self) -> bool:
        """True when every turbine has a mooring system of one line count,
        so the equilibrium solve batches over the turbine axis."""
        if not self.moor or any(mo is None for mo in self.moor):
            return False
        n0 = tuple(self.moor[0].r_anchor.shape)
        return all(tuple(mo.r_anchor.shape) == n0 for mo in self.moor[1:])

    # ------------------------------------------------------------ dynamics

    def solveDynamics(self, nIter: int = 40, tol: float = 0.01, method="while", mesh=None,
                      history: bool = False):
        """RAO solve of every turbine at once: one batched fixed point over
        the turbine axis (each iteration one K1 launch for all turbines and
        frequencies).  ``history=True`` records each turbine's convergence
        error per iteration.  ``mesh``: a 1-D ``DeviceMesh``
        (``parallel.sweep.make_mesh``); the turbine axis is pure data
        parallelism: each rank solves its block of turbines (``nT`` a
        multiple of the mesh's size) with no collective inside, and one
        all-gather gives every rank the whole farm's result."""
        sl = slice(None)
        if mesh is not None:
            _mh.check_mesh(mesh, "ArrayModel.solveDynamics", self.device)
            sl = _mh.lane_block(mesh, self.nT, "ArrayModel.solveDynamics",
                                "nT={n} not a multiple of the {size}-device mesh")
        if self.statics is None or self.kin is None:
            self.calcSystemProps()
        if self.C_moor is None:
            self.C_moor = self.C_moor0
        nw = self.w.shape[0]
        s = self.statics
        M = (s.M_struc + self.A_morison)[:, None].expand(self.nT, nw, 6, 6)
        B = torch.zeros_like(M)
        F = self.F_morison
        if self._bem_staged is not None:
            A_b, B_b, F_t = self._bem_staged
            M, B, F = M + A_b, B + B_b, F + F_t
        lin = LinearCoeffs(M=M, B=B, C=s.C_struc + s.C_hydro + self.C_moor, F=F)
        members, kin, lin = (_turbines(x, sl) for x in (self.members, self.kin, lin))
        self.rao = solve_dynamics(members, kin, self.wave, self.env, lin, n_iter=nIter,
                                  tol=tol, method=method, history=history)
        if mesh is not None:
            with torch.no_grad():
                self.rao = _gather_rao(self.rao, mesh, None, mesh.mesh_dim_names[0],
                                       lanes=True)
        Xi_c = self.rao.Xi.to_complex()                            # (nT, nw, 6)
        amp = np.abs(Xi_c)
        zeta = np.maximum(_np(self.wave.zeta), 1e-12)
        dw = float(self.w[1] - self.w[0]) if nw > 1 else 1.0
        self.results["response"] = {
            "w": _np(self.w),
            "Xi": np.transpose(Xi_c, (1, 0, 2)).reshape(nw, 6 * self.nT),
            "Xi per turbine": Xi_c,
            "RAO magnitude": amp / zeta[None, :, None],
            "std dev": np.sqrt((amp**2).sum(axis=1) * dw),           # (nT, 6)
            "converged": _np(self.rao.converged),
            "iterations": _np(self.rao.n_iter),
        }
        if self.rao.err_hist is not None:
            self.results["response"]["iteration error history"] = _np(self.rao.err_hist)
        return self

    # ------------------------------------------------------------- outputs

    def calcOutputs(self):
        """Per-turbine nacelle acceleration and constraint margins."""
        if self.rao is None:
            raise RuntimeError("run solveDynamics first")
        w = _np(self.w)
        resp = self.results["response"]
        Xi = resp["Xi per turbine"]                                    # (nT, nw, 6)
        hubs = _np(self.rna.hHub).reshape(self.nT)
        a_nac = -(w[None, :] ** 2) * (Xi[:, :, 0] + Xi[:, :, 4] * hubs[:, None])
        zeta = np.maximum(_np(self.wave.zeta), 1e-12)
        resp["nacelle acceleration"] = a_nac
        resp["nacelle acceleration RAO"] = np.abs(a_nac) / zeta
        dw = float(w[1] - w[0]) if len(w) > 1 else 1.0
        cons = {}
        if self.r6_eq is not None and "means" in self.results:
            margins = []
            for t, mo in enumerate(self.moor):
                if mo is None:
                    margins.append(np.nan)        # no lines -> no slack constraint
                    continue
                J = _np(tension_jacobian(mo, self.r6_eq[t]))           # (nl, 6)
                sig_T = np.sqrt((np.abs(Xi[t] @ J.T) ** 2).sum(axis=0) * dw)
                T_mean = np.asarray(self.results["means"]["fairlead tensions"][t])
                margins.append(float((T_mean - 3.0 * sig_T).min()))
            cons["slack line margin"] = np.asarray(margins)               # (nT,)
        sig_p = np.asarray(resp["std dev"])[:, 4]
        static_p = (np.abs(_np(self.r6_eq)[:, 4]) if self.r6_eq is not None
                    else np.zeros(self.nT))
        cons["dynamic pitch"] = np.rad2deg(static_p + 3.0 * sig_p)      # (nT,)
        cons["dynamic pitch limit"] = 10.0
        self.results["constraints"] = cons
        return self.results

    def print_report(self):
        """Per-turbine summary report."""
        print(f"=== raft_tpu_torch array report: {self.nT} turbines, nDOF {6 * self.nT} ===")
        p = self.results.get("properties", {})
        for t in range(self.nT):
            x, y = self.positions[t]
            print(f"  turbine {t}: position ({x:.1f}, {y:.1f}) m")
            if "total mass" in p:
                print(f"    mass {p['total mass'][t]:14.4g} kg   "
                      f"displacement {p['displacement'][t]:12.4g} m^3")
            if "eigen" in self.results:
                T = self.results["eigen"]["periods"][t]
                print("    periods [s]:", " ".join(f"{x:8.2f}" for x in T))
            if "means" in self.results:
                r6 = self.results["means"]["platform offset"][t]
                print(f"    mean offset: surge {r6[0]:.2f} m, heave {r6[2]:.2f} m, "
                      f"pitch {np.rad2deg(r6[4]):.2f} deg")
            if "response" in self.results:
                s = self.results["response"]["std dev"][t]
                print("    response std dev:", " ".join(f"{x:9.4g}" for x in s))
        print("=" * 40)

    def plot(self, ax=None, hideGrid: bool = False, n_ring: int = 24):
        """Wireframes of every turbine at its plan position (host numpy
        copies of the stacked members).  Returns the axes."""
        import matplotlib.pyplot as plt

        from raft_tpu_torch.model import plot_member_wireframe

        if ax is None:
            fig = plt.figure(figsize=(9, 9))
            ax = fig.add_subplot(projection="3d")
        for t in range(self.nT):
            m_t = dataclasses.replace(self.members, **{
                f.name: getattr(self.members, f.name)[t]
                for f in dataclasses.fields(self.members)
                if getattr(self.members, f.name) is not None})
            plot_member_wireframe(ax, m_t, offset=self.positions[t], n_ring=n_ring)
        if hideGrid:
            ax.set_axis_off()
        return ax

    def plot_raos(self, axes=None):
        """2 x 3 grid of per-DOF RAO magnitude curves, one line per turbine
        (the layout of :meth:`raft_tpu_torch.model.Model.plot_raos`,
        :func:`raft_tpu_torch.model.plot_rao_grid`)."""
        from raft_tpu_torch.model import plot_rao_grid

        if "response" not in self.results:
            raise RuntimeError("run solveDynamics() before plot_raos()")
        resp = self.results["response"]
        return plot_rao_grid(np.asarray(resp["w"]), np.asarray(resp["RAO magnitude"]),
                             axes=axes)
