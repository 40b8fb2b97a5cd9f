"""Model facade of the port (counterpart of ``raft_tpu.model``).

``Model`` runs one mooring-coupled floating wind turbine analysis:
``setEnv`` -> ``calcSystemProps`` (with ``calcBEM`` when BEM is asked for)
-> ``solveEigen`` -> ``calcMooringAndOffsets`` -> ``solveDynamics`` ->
``calcOutputs``, with the same ``results`` dict keys as the JAX package.
Hydrodynamics are strip theory (Morison), plus potential-flow (BEM)
coefficients for the potMod members when ``BEM`` is given: ``"native"``,
``"jax"`` or ``"auto"`` (the JAX package's mode names) mesh those members
and solve them with the host C++ panel solver
(:mod:`raft_tpu_torch.hydro.native_bem`, f64) or the on-device panel BEM
(:mod:`raft_tpu_torch.hydro.torch_bem`, kernels K3/K4 on the card, in
``dtype``); ``"auto"`` takes the card's route on CUDA and the native one
on the CPU (``torch_bem.resolved_mode``).  A precomputed ``(A, B, F)``
tuple is used as given.  Every other numeric step runs on ``device`` (the
card by default) in ``dtype``.  ``Model(..., nTurbines=N)`` returns an
:class:`~raft_tpu_torch.array.ArrayModel`.

The staging of the batch entry points lives here too, as in the JAX
package: :func:`stage_design_base` (one design to the forward pipeline's
inputs) and :func:`stage_designs` (a mixed design list into shape buckets,
each a :class:`DesignBatch` stacked lane-leading).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.build.members import build_member_set, build_rna, member_set_from_arrays
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.types import RNA, Env, WaveState
from raft_tpu_torch.core.waves import jonswap, wave_number
from raft_tpu_torch.hydro.strip import (
    current_mean_force, node_kinematics, strip_added_mass, strip_excitation,
)
from raft_tpu_torch.mooring.system import (
    fairlead_tensions, mooring_arrays, mooring_force, mooring_from_arrays, mooring_stiffness,
    parse_mooring, solve_equilibrium, tension_jacobian,
)
from raft_tpu_torch.parallel.sweep import _bem_device_layout, _stage_zeta, stage_bem
from raft_tpu_torch.solve.dynamics import LinearCoeffs, solve_dynamics
from raft_tpu_torch.solve.eigen import diagonal_estimates, eigen_with_bem, solve_eigen
from raft_tpu_torch.statics import assemble_statics

DOF_NAMES = ("surge", "sway", "heave", "roll", "pitch", "yaw")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class Model:
    """One floating wind turbine analysis (cf. ``raft_tpu.model.Model``).

    ``design``: the parsed YAML dict; ``w``: frequency grid (default
    ``arange(0.05, 3, 0.05)``); ``depth``: water-depth override; ``BEM``:
    None (strip theory only), ``"native"`` (host C++ panel solve),
    ``"jax"`` (on-device panel solve) or ``"auto"`` (either, by device and
    ``RAFT_TPU_BEM``), each run at ``calcSystemProps``, or a precomputed
    (A[6, 6, nw], B[6, 6, nw], F[6, nw]) tuple.  ``pad_segments`` /
    ``pad_nodes`` pad the member arrays (masked rows).  ``nTurbines`` other
    than 1 returns an :class:`~raft_tpu_torch.array.ArrayModel` of that many
    turbines at ``positions`` ((nT, 2) plan coordinates; default
    ``design["array"]["positions"]``, else all at the origin).
    """

    def __new__(cls, design: dict = None, w=None, depth: float | None = None,
                nTurbines: int = 1, BEM=None, positions=None,
                pad_segments: int | None = None, pad_nodes: int | None = None,
                dtype=torch.float64, device=None):
        if nTurbines != 1:
            from raft_tpu_torch.array import ArrayModel

            if positions is None:
                positions = (design or {}).get("array", {}).get("positions")
            return ArrayModel(design, positions=positions, w=w, depth=depth, nT=nTurbines,
                              BEM=BEM, dtype=dtype, device=device)
        return super().__new__(cls)

    def __init__(self, design: dict, w=None, depth: float | None = None,
                 nTurbines: int = 1, BEM=None, positions=None,
                 pad_segments: int | None = None, pad_nodes: int | None = None,
                 dtype=torch.float64, device=None):
        if positions is not None:
            raise ValueError("positions is only meaningful with nTurbines > 1")
        if isinstance(BEM, str) and BEM not in ("native", "jax", "auto"):
            raise ValueError(f"BEM={BEM!r}: expected 'native', 'jax', 'auto', or a "
                             "precomputed (A, B, F) tuple")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.design = design
        self.members = build_member_set(design, self.device, dtype, pad_segments=pad_segments,
                                         pad_nodes=pad_nodes)
        self.rna = build_rna(design)
        moor = design.get("mooring")
        yaw_stiff = float(design.get("turbine", {}).get("yaw_stiffness", 0.0))
        self.moor = (parse_mooring(moor, self.device, dtype, yaw_stiffness=yaw_stiff)
                     if moor else None)
        if depth is None:
            depth = float(moor.get("water_depth", 300.0)) if moor else 300.0
        self.depth = float(depth)
        if w is None:
            w = np.arange(0.05, 3.0, 0.05)
        self.w = self._t(np.asarray(w, dtype=float))
        self.env = Env(depth=self.depth)
        self.wave: WaveState | None = None
        self.bem_mode = BEM if isinstance(BEM, str) else None
        self.bem = BEM if not isinstance(BEM, str) else None
        self._bem_headings = None        # staged heading grid (calcBEM)
        self.bem_diagnostics: dict | None = None
        self.statics = None
        self.A_morison = None
        self.F_morison = None
        self.kin = None
        self.C_moor0 = None
        self.F_moor0 = None
        self.C_moor = None
        self.F_moor = None
        self.r6_eq = None
        self.rao = None
        self.eigen = None
        self.results: dict = {}

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # ---------------------------------------------------------------- env

    def setEnv(self, Hs=8.0, Tp=12.0, V=10.0, beta=0.0, Fthrust=0.0,
               current=0.0, current_heading=0.0, current_exp=0.0):
        """Sea state, wind thrust and an optional steady current.  With a
        heading grid staged by ``calcBEM(headings=...)`` the BEM excitation
        is re-staged for ``beta`` by interpolation, without a new solve."""
        # validate before mutating: a heading outside the staged grid must
        # leave the model as it was
        F_beta = None
        if self._bem_headings is not None and self.bem is not None:
            betas, F_all, _A, _B = self._bem_headings
            F_beta = interp_heading_excitation(betas, F_all, float(beta))
        self.env = Env(Hs=float(Hs), Tp=float(Tp), V=float(V), beta=float(beta),
                       depth=self.depth, current=float(current),
                       current_heading=float(current_heading),
                       current_exp=float(current_exp))
        S = jonswap(self.w, Hs, Tp)
        self.wave = WaveState(w=self.w, k=wave_number(self.w, self.depth), zeta=torch.sqrt(S))
        self.Fthrust = float(Fthrust)
        hHub = float(self.rna.hHub)
        self.f6Ext = self._t([self.Fthrust, 0.0, 0.0, 0.0, self.Fthrust * hHub, 0.0])
        self.kin = None
        self.F_morison = None
        if F_beta is not None:
            # A, B are heading-independent: only the excitation changes
            self.bem = (self._bem_headings[2], self._bem_headings[3], F_beta)

    # ------------------------------------------------------------- statics

    def calcBEM(self, dz_max: float = 3.0, da_max: float = 2.0,
                out_dir: str | None = None, irr: bool = False, headings=None,
                cache: bool = True):
        """Mesh the potMod members and solve them with the panel BEM of
        ``BEM`` (the host C++ solver, or the on-device solve on the model's
        device in its dtype; ``torch_bem.solve_bem_any``).  Under
        ``RAFT_TPU_BEM_PRECISION=bf16`` the on-device solve runs in float32
        with the bf16 assembly, as the JAX package's Model solves
        (``torch_bem.model_solve_dtype``).

        ``irr=True`` adds interior waterplane lid panels (irregular-frequency
        removal).  ``headings``: optional heading grid [rad]; the excitation
        is solved for every heading at once and later ``setEnv(beta=...)``
        calls re-stage it by interpolation.  Writes HullMesh.pnl and
        platform.gdf when ``out_dir`` is given.  ``cache``: the solver's
        on-disk result cache.  Returns the (A, B, F) tuple (host numpy), or
        None when the design has no potMod member."""
        from raft_tpu_torch.hydro.mesh import mesh_design, mesh_lid, write_gdf, write_pnl
        from raft_tpu_torch.hydro.torch_bem import model_solve_dtype, solve_bem_any

        panels = mesh_design(self.design, dz_max=dz_max, da_max=da_max)
        if len(panels) == 0:
            return None
        if out_dir is not None:
            import os

            os.makedirs(out_dir, exist_ok=True)
            write_pnl(os.path.join(out_dir, "HullMesh.pnl"), panels)
            write_gdf(os.path.join(out_dir, "platform.gdf"), panels)
        lid = mesh_lid(self.design, da_max=da_max) if irr else None
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
        """Statics + strip-theory hydro (+ BEM) + undisplaced mooring
        stiffness."""
        if self.wave is None:
            self.setEnv()
        if self.bem_mode is not None and self.bem is None:
            self.calcBEM()
        exclude = self.bem is not None
        self.statics = assemble_statics(self.members, self.rna, self.env)
        self.kin = node_kinematics(self.members, self.wave, self.env)
        self.A_morison = strip_added_mass(self.members, self.env, exclude_potmod=exclude)
        self.F_morison = strip_excitation(self.members, self.kin, self.env,
                                          exclude_potmod=exclude)
        if self.moor is not None:
            z6 = self._zeros(6)
            self.C_moor0 = mooring_stiffness(self.moor, z6)
            self.F_moor0 = mooring_force(self.moor, z6)
        else:
            self.C_moor0 = self._zeros(6, 6)
            self.F_moor0 = self._zeros(6)
        self.C_moor = self.C_moor0
        self.F_moor = self.F_moor0
        self.results["properties"] = self._properties()
        return self

    def _properties(self) -> dict:
        s = self.statics
        return {
            "total mass": float(s.mass),
            "total CG": _np(s.rCG),
            "substructure mass": float(s.m_sub),
            "substructure CG": _np(s.rCG_sub),
            "shell mass": float(s.m_shell),
            "ballast mass": float(s.m_ballast),
            "tower mass": float(s.m_tower),
            "tower CG": _np(s.rCG_tower),
            "displacement": float(s.V),
            "center of buoyancy": _np(s.rCB),
            "waterplane area": float(s.AWP),
            "metacentric height": float(s.zMeta - s.rCG[2]),
            "metacenter z": float(s.zMeta),
            "roll inertia at subCG": float(s.I44),
            "pitch inertia at subCG": float(s.I55),
            "yaw inertia at centerline": float(s.I66),
            "buoyancy (pgV)": float(self.env.rho * self.env.g * s.V),
            "C_stiffness": _np(s.C_hydro + s.C_struc),
        }

    # ------------------------------------------------------------- mooring

    def calcMooringAndOffsets(self):
        """Mean offset + linearized mooring about it."""
        if self.statics is None:
            self.calcSystemProps()
        if self.moor is None:
            self.r6_eq = self._zeros(6)
            self.results["means"] = {"platform offset": np.zeros(6)}
            return self
        s = self.statics
        F_const = s.W_struc + s.W_hydro + self.f6Ext
        if abs(self.env.current) > 0:
            F_const = F_const + current_mean_force(self.members, self.env)
        C_body = s.C_struc + s.C_hydro
        self.r6_eq, res = solve_equilibrium(self.moor, F_const, C_body)
        self.C_moor = mooring_stiffness(self.moor, self.r6_eq)
        self.F_moor = mooring_force(self.moor, self.r6_eq)
        T_mean = fairlead_tensions(self.moor, self.r6_eq)
        self.results["means"] = {
            "platform offset": _np(self.r6_eq),
            "equilibrium residual": float(res),
            "mooring force": _np(self.F_moor),
            "fairlead tensions": _np(T_mean),
        }
        return self

    def solveStatics(self):
        """Alias of :meth:`calcMooringAndOffsets`."""
        return self.calcMooringAndOffsets()

    # --------------------------------------------------------------- eigen

    def solveEigen(self, n_pass: int = 3):
        """Natural frequencies and modes about the undisplaced mooring, plus
        the per-DOF diagonal estimates.  With BEM coefficients staged, the
        added mass is taken at each mode's own natural frequency by an
        ``n_pass``-step fixed point."""
        if self.statics is None:
            self.calcSystemProps()
        M_base = self.statics.M_struc + self.A_morison
        C_tot = self.statics.C_struc + self.statics.C_hydro + self.C_moor0
        if self.bem is None:
            self.eigen = solve_eigen(M_base, C_tot)
            est = diagonal_estimates(M_base, C_tot)
        else:
            A_w = self._t(np.moveaxis(np.asarray(self.bem[0]), -1, 0))   # (nw, 6, 6)
            self.eigen, est = eigen_with_bem(M_base, C_tot, A_w, self.w, n_pass=n_pass)
        fns = _np(self.eigen.fns)
        self.results["eigen"] = {
            "frequencies": fns,
            "periods": 1.0 / np.maximum(fns, 1e-12),
            "modes": _np(self.eigen.modes),
            "estimates": _np(est),
        }
        return self

    # ------------------------------------------------------------ dynamics

    def _linear_coeffs(self) -> LinearCoeffs:
        nw = self.w.shape[0]
        s = self.statics
        M = (s.M_struc + self.A_morison).expand(nw, 6, 6)
        B = torch.zeros_like(M)
        F = self.F_morison
        if self.bem is not None:
            A_bem, B_bem, F_bem = stage_bem(self.bem, self.wave)
            M, B, F = M + A_bem, B + B_bem, F + F_bem
        return LinearCoeffs(M=M, B=B, C=s.C_struc + s.C_hydro + self.C_moor, F=F)

    def solveDynamics(self, nIter: int = 40, tol: float = 0.01, method="while",
                      history: bool = False):
        """RAO fixed-point solve: the ``while`` loop (early exit) or the
        ``scan`` loop (exactly ``nIter`` steps, reverse-differentiable)."""
        if self.statics is None or self.kin is None:
            self.calcSystemProps()
        self.rao = solve_dynamics(self.members, self.kin, self.wave, self.env,
                                  self._linear_coeffs(), n_iter=nIter, tol=tol,
                                  method=method, history=history)
        Xi = self.rao.Xi
        w = _np(self.w)
        zeta = np.maximum(_np(self.wave.zeta), 1e-12)
        dw = float(w[1] - w[0]) if len(w) > 1 else 1.0
        amp = _np(Xi.abs())
        self.results["response"] = {
            "w": w,
            "Xi": Xi.to_complex(),
            "RAO magnitude": amp / zeta[:, None],
            "std dev": np.sqrt((amp**2).sum(axis=0) * dw),
            "converged": bool(self.rao.converged),
            "iterations": int(self.rao.n_iter),
        }
        if self.rao.err_hist is not None:
            self.results["response"]["iteration error history"] = _np(self.rao.err_hist)
        return self

    # ------------------------------------------------------------- outputs

    def calcOutputs(self):
        """Derived outputs: nacelle acceleration, fairlead tension RAOs and
        the constraint margins."""
        if self.rao is None:
            raise RuntimeError("run solveDynamics first")
        w = _np(self.w)
        Xi = self.rao.Xi.to_complex()
        hHub = float(self.rna.hHub)
        a_nac = -(w**2) * (Xi[:, 0] + Xi[:, 4] * hHub)
        zeta = np.maximum(_np(self.wave.zeta), 1e-12)
        dw = float(w[1] - w[0]) if len(w) > 1 else 1.0
        resp = self.results["response"]
        resp["nacelle acceleration"] = a_nac
        resp["nacelle acceleration RAO"] = np.abs(a_nac) / zeta
        resp["nacelle acceleration std dev"] = float(np.sqrt((np.abs(a_nac) ** 2).sum() * dw))
        if self.moor is not None and self.r6_eq is not None:
            J = _np(tension_jacobian(self.moor, self.r6_eq))
            T_amp = Xi @ J.T
            resp["fairlead tension amplitude"] = np.abs(T_amp)
            resp["fairlead tension RAO"] = np.abs(T_amp) / zeta[:, None]
            resp["fairlead tension std dev"] = np.sqrt((np.abs(T_amp) ** 2).sum(axis=0) * dw)
        cons = {}
        if "fairlead tension std dev" in resp:
            T_mean = np.asarray(self.results["means"]["fairlead tensions"])
            cons["slack line margin"] = float((T_mean - 3.0 * resp["fairlead tension std dev"]).min())
        sig_p = float(resp["std dev"][4])
        static_p = float(self.r6_eq[4]) if self.r6_eq is not None else 0.0
        cons["dynamic pitch"] = float(np.rad2deg(abs(static_p) + 3.0 * sig_p))
        cons["dynamic pitch limit"] = 10.0
        self.results["constraints"] = cons
        return self.results

    def airgap(self, points, deck_z: float):
        """Relative wave elevation and air-gap margin at deck points.

        Linear deck-clearance check: the relative elevation at plan point
        p = (x, y) is the incident elevation minus the structure's vertical
        motion there, ``eta_rel(w) = zeta e^{-i k (x cos beta + y sin beta)}
        - u_z(p, w)`` with ``u_z = Xi_heave + Xi_roll y - Xi_pitch x``
        (small-angle rigid body).  The 3-sigma air gap is ``deck_z +
        z_offset - 3 sigma_rel``; negative means waves can reach the deck.

        ``points``: (np, 2) plan coordinates [m]; ``deck_z``: underside of
        the deck above SWL [m].  Returns per-point sigma and margins (host
        numpy) and stores them under ``results["airgap"]``."""
        if self.rao is None:
            raise RuntimeError("run solveDynamics first")
        pts = np.atleast_2d(np.asarray(points, dtype=float))
        if pts.ndim != 2 or pts.shape[-1] != 2:
            raise ValueError(f"points must be (np, 2) plan coordinates [x, y]; got shape "
                             f"{pts.shape}")
        w = _np(self.w)
        k = _np(self.wave.k)
        zeta = _np(self.wave.zeta)
        beta = float(self.env.beta)
        Xi = self.rao.Xi.to_complex()                               # (nw, 6)
        dw = float(w[1] - w[0]) if len(w) > 1 else 1.0
        phase_lag = np.exp(-1j * k[None, :] * (
            pts[:, 0, None] * np.cos(beta) + pts[:, 1, None] * np.sin(beta)))   # (np, nw)
        eta = zeta[None, :] * phase_lag
        u_z = Xi[None, :, 2] + Xi[None, :, 3] * pts[:, 1, None] - Xi[None, :, 4] * pts[:, 0, None]
        sigma = np.sqrt((np.abs(eta - u_z) ** 2).sum(axis=1) * dw)          # (np,)
        z_off = np.zeros(len(pts))
        if self.r6_eq is not None:
            r6 = _np(self.r6_eq)
            z_off = r6[2] + r6[3] * pts[:, 1] - r6[4] * pts[:, 0]
        out = {"points": pts, "sigma rel elevation": sigma,
               "margin 3 sigma": deck_z + z_off - 3.0 * sigma, "deck_z": float(deck_z)}
        self.results["airgap"] = out
        return out

    # ---------------------------------------------------------------- plot

    def plot(self, ax=None, hideGrid: bool = False, n_ring: int = 24):
        """3D wireframe of the members (end rings and longitudinal edges of
        each segment) and the mooring lines' catenary profiles at the mean
        offset (undisplaced before ``calcMooringAndOffsets``).  matplotlib
        draws host numpy copies of the model's tensors.  Returns the axes."""
        import matplotlib.pyplot as plt

        from raft_tpu_torch.mooring.system import fairlead_positions, line_states

        if ax is None:
            fig = plt.figure(figsize=(8, 8))
            ax = fig.add_subplot(projection="3d")
        plot_member_wireframe(ax, self.members, n_ring=n_ring)
        if self.moor is not None:
            r6 = self.r6_eq if self.r6_eq is not None else self._zeros(6)
            rf = _np(fairlead_positions(self.moor, r6))
            ra = _np(self.moor.r_anchor)
            st = line_states(self.moor, r6)
            for i in range(rf.shape[0]):
                self._plot_line(ax, ra[i], rf[i], st, i)
        if hideGrid:
            ax.set_axis_off()
        return ax

    def plot_raos(self, axes=None):
        """2 x 3 grid of RAO magnitude curves |Xi| / zeta per DOF against
        frequency, from the converged solve (run ``solveDynamics`` first).
        Returns the axes array."""
        if "response" not in self.results:
            raise RuntimeError("run solveDynamics() before plot_raos()")
        resp = self.results["response"]
        return plot_rao_grid(np.asarray(resp["w"]), np.asarray(resp["RAO magnitude"])[None],
                             axes=axes)

    def _plot_line(self, ax, ra, rf, st, i):
        """Line ``i``'s catenary profile from its anchor ``ra`` to its
        fairlead ``rf``, from its fairlead tensions (H, V) in ``st``."""
        H, V = float(st.H[i]), float(st.V[i])
        L, w = float(self.moor.props.L[i]), float(self.moor.props.w[i])
        s = np.linspace(0, L, 50)
        Vv = np.maximum(V - w * (L - s), 0.0)
        T = np.sqrt(H**2 + Vv**2)
        dx = np.where(Vv > 0, H / T, 1.0)
        dz = np.where(Vv > 0, Vv / T, 0.0)
        x = np.concatenate([[0], np.cumsum(dx[:-1] * np.diff(s))])
        z = np.concatenate([[0], np.cumsum(dz[:-1] * np.diff(s))])
        # the horizontal run scaled to end at the fairlead
        u = (rf[:2] - ra[:2]) / max(np.hypot(*(rf[:2] - ra[:2])), 1e-9)
        scale = np.hypot(*(rf[:2] - ra[:2])) / max(x[-1], 1e-9)
        pts = ra[None, :] + np.concatenate([x[:, None] * scale * u[None, :], z[:, None]], axis=1)
        ax.plot(*pts.T, "b-", lw=0.8)

    def print_report(self):
        """Human-readable property/results report."""
        p = self.results.get("properties", {})
        print("=== raft_tpu_torch analysis report ===")
        for key in ("total mass", "substructure mass", "shell mass", "ballast mass",
                    "tower mass", "displacement", "buoyancy (pgV)", "waterplane area",
                    "metacentric height"):
            if key in p:
                print(f"  {key:<22} {p[key]:14.4g}")
        for key in ("total CG", "substructure CG", "center of buoyancy"):
            if key in p:
                v = p[key]
                print(f"  {key:<22} [{v[0]:9.3f} {v[1]:9.3f} {v[2]:9.3f}]")
        if "eigen" in self.results:
            print("  natural frequencies [Hz] (surge..yaw):")
            print("   ", " ".join(f"{f:8.5f}" for f in self.results["eigen"]["frequencies"]))
            print("  natural periods [s]:")
            print("   ", " ".join(f"{t:8.2f}" for t in self.results["eigen"]["periods"]))
        if "means" in self.results:
            r6 = self.results["means"]["platform offset"]
            print(f"  mean offsets: surge {r6[0]:.2f} m, sway {r6[1]:.2f} m, "
                  f"heave {r6[2]:.2f} m, pitch {np.rad2deg(r6[4]):.2f} deg")
        if "response" in self.results:
            r = self.results["response"]
            print("  response std dev (surge..yaw):")
            print("   ", " ".join(f"{x:9.4g}" for x in r["std dev"]))
            if "nacelle acceleration std dev" in r:
                print(f"  nacelle accel std dev: {r['nacelle acceleration std dev']:.3f} m/s^2")
        if "constraints" in self.results:
            c = self.results["constraints"]
            if "slack line margin" in c:
                print(f"  slack line margin (T - 3 sigma): {c['slack line margin']:.4g} N")
            print(f"  dynamic pitch (|static| + 3 sigma): {c['dynamic pitch']:.2f} deg "
                  f"(limit {c['dynamic pitch limit']:.0f})")
        print("======================================")


def plot_rao_grid(w, rao, axes=None, labels=None):
    """2 x 3 grid of per-DOF RAO magnitude curves, one line per leading-axis
    entry (the turbines of an array; one model passes ``rao[None]``), the
    layout of both ``Model.plot_raos`` and ``ArrayModel.plot_raos``.

    ``w``: (nw,) [rad/s]; ``rao``: (nT, nw, 6) magnitudes.  Returns the
    axes array."""
    import matplotlib.pyplot as plt

    f_hz = np.asarray(w) / (2.0 * np.pi)
    rao = np.asarray(rao)
    nT = rao.shape[0]
    if axes is None:
        _, axes = plt.subplots(2, 3, figsize=(12, 6), sharex=True)
    dof = ("surge [m/m]", "sway [m/m]", "heave [m/m]", "roll [rad/m]", "pitch [rad/m]",
           "yaw [rad/m]")
    flat = np.asarray(axes).ravel()
    if flat.size < 6:
        raise ValueError(f"plot_rao_grid needs 6 axes (one per DOF), got {flat.size}")
    for i, ax in enumerate(flat[:6]):
        for t in range(nT):
            lbl = labels[t] if labels is not None else f"T{t}" if nT > 1 else None
            ax.plot(f_hz, rao[t, :, i], label=lbl if i == 0 else None)
        ax.set_ylabel(dof[i])
        ax.grid(True, alpha=0.3)
        if i >= 3:
            ax.set_xlabel("frequency [Hz]")
    if nT > 1 or labels is not None:
        flat[0].legend(fontsize=7)
    return axes


def plot_member_wireframe(ax, m, offset=(0.0, 0.0), n_ring: int = 24):
    """Wireframe of a MemberSet's segments (caps and padding left out) on a
    3D axes, shifted by the plan ``offset``: end rings and longitudinal
    edges of each segment, circular or rectangular."""
    keep = _np(m.seg_mask & ~m.seg_is_cap)
    off = np.array([offset[0], offset[1], 0.0])
    rA = _np(m.seg_rA)[keep] + off
    q = _np(m.seg_q)[keep]
    R = _np(m.seg_R)[keep]
    L = _np(m.seg_l)[keep]
    dA = _np(m.seg_dA)[keep]
    dB = _np(m.seg_dB)[keep]
    circ = _np(m.seg_circ)[keep]
    th = np.linspace(0, 2 * np.pi, n_ring + 1)
    for i in range(len(rA)):
        rB_i = rA[i] + q[i] * L[i]
        p1, p2 = R[i][:, 0], R[i][:, 1]
        if circ[i]:
            ring = np.outer(np.cos(th), p1) + np.outer(np.sin(th), p2)
            ringA = rA[i] + 0.5 * dA[i, 0] * ring
            ringB = rB_i + 0.5 * dB[i, 0] * ring
        else:
            sq = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1], [1, 1]]) * 0.5
            ringA = rA[i] + sq[:, :1] * dA[i, 0] * p1 + sq[:, 1:] * dA[i, 1] * p2
            ringB = rB_i + sq[:, :1] * dB[i, 0] * p1 + sq[:, 1:] * dB[i, 1] * p2
        ax.plot(*ringA.T, "k-", lw=0.6)
        ax.plot(*ringB.T, "k-", lw=0.6)
        step = max(1, len(ringA) // 8)
        for j in range(0, len(ringA), step):
            ax.plot(*np.stack([ringA[j], ringB[j]]).T, "k-", lw=0.4)


def solve_bem_heading_grid(panels, w, rho, g, depth, lid, headings, beta, mode=None,
                           return_diagnostics: bool = False, **solve):
    """Solve the radiation once and the diffraction for a whole heading
    grid, and stage the excitation at the current heading ``beta``: the
    staging shared by :meth:`Model.calcBEM` and ``ArrayModel.calcBEM``
    (port of ``raft_tpu.model.solve_bem_heading_grid``).

    Returns ``(bem_headings, bem)``: ``bem_headings = (betas, F_all[nb, 6,
    nw], A, B)``, the grid a later ``setEnv`` re-stages from, and ``bem``
    the (A, B, F[6, nw]) tuple at ``beta``.  ``mode`` routes the solver
    (:func:`raft_tpu_torch.hydro.torch_bem.solve_bem_any`, which also takes
    the port's ``solve`` keywords: ``cache``, ``dtype``, ``device``,
    ``precision``, ``nthreads``).  A heading outside the grid
    raises before the panel solve.  With ``return_diagnostics`` the
    solver's diagnostics come third."""
    from raft_tpu_torch.hydro.torch_bem import solve_bem_any

    betas = np.sort(np.asarray(headings, dtype=float))
    if not (betas[0] - 1e-9 <= beta <= betas[-1] + 1e-9):
        raise ValueError(
            f"current heading {beta:.3f} rad outside the requested grid "
            f"[{betas[0]:.3f}, {betas[-1]:.3f}]: include it or setEnv first")
    A, B, F_all, diag = solve_bem_any(panels, np.asarray(w), rho=rho, g=g, beta=betas,
                                      depth=depth, lid=lid, mode=mode, return_diagnostics=True,
                                      **solve)
    out = (betas, F_all, A, B), (A, B, interp_heading_excitation(betas, F_all, beta))
    return out + (diag,) if return_diagnostics else out


def interp_heading_excitation(betas, F_all, beta: float) -> np.ndarray:
    """Excitation F[6, nw] at heading ``beta`` from a staged heading grid
    (linear in heading between the two bracketing slices)."""
    betas = np.asarray(betas)
    if beta < betas[0] - 1e-6 or beta > betas[-1] + 1e-6:
        raise ValueError(f"heading {beta:.3f} rad outside staged grid "
                         f"[{betas[0]:.3f}, {betas[-1]:.3f}]")
    beta = float(np.clip(beta, betas[0], betas[-1]))
    if len(betas) == 1:
        return np.asarray(F_all[0])
    j = int(np.clip(np.searchsorted(betas, beta), 1, len(betas) - 1))
    t = float(np.clip((beta - betas[j - 1]) / (betas[j] - betas[j - 1]), 0.0, 1.0))
    return (1.0 - t) * np.asarray(F_all[j - 1]) + t * np.asarray(F_all[j])


def load_design(fname) -> dict:
    """Parse a design YAML path, or pass a dict through unchanged."""
    if isinstance(fname, dict):
        return fname
    import yaml

    with open(fname) as f:
        return yaml.safe_load(f)


def _staged_wave(nw: int, w_min: float, w_max: float, depth, Hs: float, Tp: float,
                 nw_pad: int | None = None, dtype=torch.float64, device=None) -> WaveState:
    """The one staged-grid recipe of :func:`stage_design_base` and
    :func:`stage_designs`: ``nw`` JONSWAP bins on [w_min, w_max], plus, when
    ``nw_pad`` exceeds ``nw``, bucket padding that extends the grid past
    ``w_max`` at the same spacing with ``zeta = 0`` and a ``freq_mask``
    marking the physical bins (the padded bins then carry exactly zero
    response through the solve; see :mod:`raft_tpu_torch.build.buckets`).
    ``depth``: a float, or a (B, 1) tensor for a design batch's
    wavenumbers (``k`` (B, nw)).  Runs on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    nw = int(nw)
    nw_p = nw if nw_pad is None else int(nw_pad)
    if nw_p < nw:
        raise ValueError(f"nw_pad={nw_p} smaller than nw={nw}")
    if nw_p > nw and nw < 2:
        raise ValueError("frequency padding needs nw >= 2 to fix the spacing")
    w_host = np.linspace(w_min, w_max, nw)
    if nw_p > nw:
        dw = w_host[1] - w_host[0]
        w_host = np.concatenate([w_host, w_host[-1] + dw * np.arange(1, nw_p - nw + 1)])
    w = torch.as_tensor(w_host, device=dev).to(dtype)
    zeta = torch.sqrt(jonswap(w, Hs, Tp))
    mask = None
    if nw_p > nw:
        mask = torch.as_tensor(np.arange(nw_p) < nw, device=dev)
        zeta = zeta * mask                    # exact zeros at padded bins
    return WaveState(w=w, k=wave_number(w, depth), zeta=zeta, freq_mask=mask)


@dataclasses.dataclass
class _HostStage:
    """One design's staging on the host: padded member arrays, bucket
    class, RNA, water depth and mooring arrays (None without mooring)."""

    members: dict
    sig: object
    rna: RNA
    depth: float
    moor: dict | None


def _stage_host(design: dict, nw: int, with_mooring: bool, bucket) -> _HostStage:
    """The host half of the one per-design staging recipe shared by
    :func:`stage_design_base` and :func:`stage_designs`.  ``bucket``:
    ``None`` exact shapes, ``True`` bucketize, or an explicit
    :class:`~raft_tpu_torch.build.buckets.BucketSig` (self-healing
    promotion applies)."""
    from raft_tpu_torch.build import buckets as _buckets
    from raft_tpu_torch.build.members import member_arrays

    sig = None
    if bucket is None:
        arrays = member_arrays(design)
    elif isinstance(bucket, _buckets.BucketSig):
        arrays, sig = _buckets.bucketed_member_arrays(design, bucket)
    else:
        arrays, sig = _buckets.bucketed_member_arrays(design, nw=nw)
    moor = None
    if with_mooring:
        moor = mooring_arrays(design["mooring"], yaw_stiffness=design["turbine"]["yaw_stiffness"])
    return _HostStage(members=arrays, sig=sig, rna=build_rna(design),
                      depth=float(design["mooring"]["water_depth"]), moor=moor)


def _batched_stiffness(moors: list, dtype, dev) -> torch.Tensor:
    """Undisplaced mooring stiffness of every lane, (B, 6, 6): the lanes
    are grouped by line count, each group stacked on the host, copied once
    and linearized in one batched call."""
    C = torch.empty((len(moors), 6, 6), dtype=dtype, device=dev)
    groups: dict = {}
    for i, mo in enumerate(moors):
        groups.setdefault(mo["r_anchor"].shape, []).append(i)
    for idx in groups.values():
        stacked = {key: np.stack([moors[i][key] for i in idx]) for key in moors[idx[0]]}
        sys_b = mooring_from_arrays(stacked, dev, dtype)
        C[torch.as_tensor(idx, device=dev)] = mooring_stiffness(
            sys_b, torch.zeros((len(idx), 6), dtype=dtype, device=dev))
    return C


def stage_design_base(fname, nw: int, Hs: float, Tp: float, w_min: float, w_max: float,
                      with_mooring: bool = True, bucket=None, dtype=torch.float64, device=None):
    """One design (YAML path or dict) staged to the forward pipeline's
    inputs: ``(design, members, rna, env, wave, C_moor)`` on ``device`` (the
    card by default) in ``dtype``.

    ``with_mooring=False`` skips the mooring parse and stiffness (``C_moor``
    is then None).  ``bucket``: ``None`` (default) builds the design at its
    exact shapes; ``True`` rounds the member axes and the frequency grid up
    to their shape-bucket classes
    (:func:`raft_tpu_torch.build.buckets.bucketize`); an explicit
    :class:`~raft_tpu_torch.build.buckets.BucketSig` pins the class
    (self-healing promotion applies)."""
    dev = resolve_device(device)
    design = load_design(fname)
    h = _stage_host(design, nw, with_mooring, bucket)
    members, wave, C_moor = _stage_device(h, nw, Hs, Tp, w_min, w_max, dtype, dev)
    return design, members, h.rna, Env(Hs=Hs, Tp=Tp, depth=h.depth), wave, C_moor


def _stage_device(h: _HostStage, nw: int, Hs: float, Tp: float, w_min: float, w_max: float,
                  dtype, dev):
    """The device half of one design's staging, shared by
    :func:`stage_design_base` and the serving daemon's lane staging
    (``serve/solver.py::SolverCore.stage_lane``), so a served lane cannot
    drift from a solo staging: the member arrays copied to ``dev``, the
    (bucket-padded) wave grid and the undisplaced mooring stiffness (None
    without mooring).  Returns ``(members, wave, C_moor)``."""
    wave = _staged_wave(nw, w_min, w_max, h.depth, Hs, Tp,
                        nw_pad=None if h.sig is None else h.sig.nw, dtype=dtype, device=dev)
    C_moor = None
    if h.moor is not None:
        C_moor = mooring_stiffness(mooring_from_arrays(h.moor, dev, dtype),
                                   torch.zeros(6, dtype=dtype, device=dev))
    return member_set_from_arrays(h.members, dev, dtype), wave, C_moor


@dataclasses.dataclass
class DesignBatch:
    """One shape bucket's staged designs, stacked lane-leading.

    ``members`` has a leading lane axis of length ``len(fnames)``, ``rna``
    and ``env`` (B,) tensor fields, ``wave`` ``k``/``zeta``/``freq_mask``
    (B, nw_pad) over one shared grid ``w``, ``C_moor`` (B, 6, 6) (None
    without mooring) and ``bem`` (A[B, nw, 6, 6], B[...], F Cx[B, nw, 6])
    or None: one batched :func:`~raft_tpu_torch.parallel.sweep.
    forward_response` solves the whole bucket.  ``indices`` maps lanes back
    to positions in the caller's design list; ``nw`` is the physical
    (unpadded) bin count; ``promotions`` the class promotions this batch's
    staging performed."""

    sig: object
    fnames: list
    indices: list
    members: object
    rna: RNA
    env: Env
    wave: WaveState
    C_moor: object
    bem: object = None
    nw: int = 0
    promotions: int = 0


def _stack_trees(trees, dtype, dev):
    """Dataclasses of host scalars (RNA, Env) -> one of the same type with
    each field a (B,) tensor on ``dev``, copied once."""
    cls = type(trees[0])
    return cls(**{f.name: torch.as_tensor(np.array([getattr(t, f.name) for t in trees],
                                                   dtype=float), device=dev).to(dtype)
                  for f in dataclasses.fields(cls)})


def stage_designs(fnames, nw: int, Hs: float, Tp: float, w_min: float, w_max: float,
                  with_mooring: bool = True, bems=None, dtype=torch.float64,
                  device=None) -> dict:
    """Stage a mixed design list into shape buckets, stacked lane-leading.

    Each design (YAML path or dict) is bucketized
    (:func:`raft_tpu_torch.build.buckets.bucketize`, honoring
    ``RAFT_TPU_BUCKETS``) and built padded to its class on the host
    (self-healing promotion included), with its own water depth, mooring
    and padded frequency grid, by the recipe of :func:`stage_design_base`.
    The designs are grouped by :class:`~raft_tpu_torch.build.buckets.
    BucketSig`; each group is stacked on the host and copied to ``device``
    (the card by default) once, its mooring stiffness linearized in one
    batched call per line count.  Returns ``{sig: DesignBatch}``.

    ``bems``: optional per-design raw BEM tuples (``A[6, 6, nw]``,
    ``B[6, 6, nw]``, ``F[6, nw]`` complex, on the physical grid), all
    designs or none: zero-padded on the bucket grid, staged
    frequency-leading, the excitation zeta-scaled (zero at padded bins)."""
    from raft_tpu_torch.build import buckets as _buckets

    dev = resolve_device(device)
    fnames = list(fnames)
    if bems is not None:
        bems = list(bems)
        if len(bems) != len(fnames):
            raise ValueError(f"bems has {len(bems)} entries for {len(fnames)} designs")
        if any(b is None for b in bems):
            raise ValueError("bems must cover every design or be None: a bucket mixing BEM and "
                             "strip-only lanes would need two different programs")
    rows: dict = {}
    promo: dict = {}
    for i, fn in enumerate(fnames):
        p0 = _buckets.promotion_count()
        h = _stage_host(load_design(fn), nw, with_mooring, bucket=True)
        rows.setdefault(h.sig, []).append((i, fn, h))
        promo[h.sig] = promo.get(h.sig, 0) + (_buckets.promotion_count() - p0)

    out: dict = {}
    for sig, group in rows.items():
        idx, names, hs = zip(*group)
        depth = np.array([h.depth for h in hs])
        members = member_set_from_arrays(
            {key: np.stack([h.members[key] for h in hs]) for key in hs[0].members}, dev, dtype)
        env = _stack_trees([Env(Hs=Hs, Tp=Tp, depth=d) for d in depth], dtype, dev)
        wave = _staged_wave(nw, w_min, w_max, env.depth[:, None], Hs, Tp, nw_pad=sig.nw,
                            dtype=dtype, device=dev)
        B = len(hs)
        wave = dataclasses.replace(
            wave, zeta=wave.zeta.expand(B, -1),
            freq_mask=None if wave.freq_mask is None else wave.freq_mask.expand(B, -1))
        C_moor = None if hs[0].moor is None else _batched_stiffness([h.moor for h in hs],
                                                                    dtype, dev)
        bem = None
        if bems is not None:
            bem = _stage_bem_padded([bems[i] for i in idx], wave, nw)
        out[sig] = DesignBatch(sig=sig, fnames=list(names), indices=list(idx), members=members,
                               rna=_stack_trees([h.rna for h in hs], dtype, dev), env=env,
                               wave=wave, C_moor=C_moor, bem=bem, nw=int(nw),
                               promotions=promo[sig])
    return out


def _stage_bem_padded(bems, wave: WaveState, nw: int):
    """A bucket's raw host BEM tuples (one per lane, each A[6, 6, nw],
    B[6, 6, nw], F[6, nw] complex on the physical grid) -> the bucket
    grid's staged device layout (A[B, nw_pad, 6, 6], B[...], F Cx[B,
    nw_pad, 6]).  Padding is the only step owned here: the host arrays are
    zero-padded past the physical bins, stacked, and routed through the
    device-layout and zeta-scaling recipe of
    :func:`raft_tpu_torch.parallel.sweep.stage_bem`, so a bucketed BEM lane
    cannot drift from a solo staging.  The excitation at padded bins is
    exactly zero (zeta is zero there)."""
    nw_p = int(wave.w.shape[-1])
    padded = []
    for bem in bems:
        A_h, B_h, F_h = (np.asarray(x) for x in bem)
        if A_h.shape[-1] != nw:
            raise ValueError(f"BEM arrays carry {A_h.shape[-1]} frequency bins; the staged grid "
                             f"has {nw} physical bins")
        tail = ((0, 0),) * (A_h.ndim - 1) + ((0, nw_p - nw),)
        padded.append((np.pad(A_h, tail), np.pad(B_h, tail),
                       np.pad(F_h, ((0, 0), (0, nw_p - nw)))))
    stacked = tuple(np.stack(x) for x in zip(*padded))
    return _stage_zeta(_bem_device_layout(stacked, wave.zeta.dtype, wave.zeta.device), wave.zeta)


def run_raft(fname_design, fname_env=None, plot: bool = False, w=None,
             dtype=torch.float64, device=None) -> dict:
    """End-to-end analysis (cf. ``raft_tpu.model.run_raft``).

    ``fname_env``: optional environment YAML (``Hs``/``Tp``/``V``/``beta``
    [deg]/``Fthrust``); the design's turbine thrust is the default.
    ``plot`` draws :meth:`Model.plot` at the end."""
    design = load_design(fname_design)
    model = Model(design, w=w, dtype=dtype, device=device)
    turb = design.get("turbine", {})
    envd = load_design(fname_env) if fname_env else {}
    model.setEnv(
        Hs=float(envd.get("Hs", 8.0)),
        Tp=float(envd.get("Tp", 12.0)),
        V=float(envd.get("V", 10.0)),
        beta=float(np.deg2rad(envd.get("beta", 0.0))),
        Fthrust=float(envd.get("Fthrust", turb.get("Fthrust", 0.0))),
    )
    model.calcSystemProps()
    model.solveEigen()
    model.calcMooringAndOffsets()
    model.solveDynamics()
    model.calcOutputs()
    if plot:
        model.plot()
    return model.results
