"""Model facade of the port (counterpart of ``raft_tpu.model``).

``Model`` runs one mooring-coupled floating wind turbine analysis:
``setEnv`` -> ``calcSystemProps`` (with ``calcBEM`` when BEM is asked for)
-> ``solveEigen`` -> ``calcMooringAndOffsets`` -> ``solveDynamics`` ->
``calcOutputs``, with the same ``results`` dict keys as the JAX package.
Hydrodynamics are strip theory (Morison), plus potential-flow (BEM)
coefficients for the potMod members when ``BEM`` is given: ``"jax"`` or
``"auto"`` (the JAX package's mode names) mesh those members and solve
them with the on-device panel BEM (:mod:`raft_tpu_torch.hydro.torch_bem`,
kernels K3/K4 on the card); a precomputed ``(A, B, F)`` tuple is used as
given.  Every numeric step runs on ``device`` (the card by default) in
``dtype``, the BEM solve included.
"""
from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.build.members import build_member_set, build_rna
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.core.types import Env, WaveState
from raft_tpu_torch.core.waves import jonswap, wave_number
from raft_tpu_torch.hydro.strip import (
    current_mean_force, node_kinematics, strip_added_mass, strip_excitation,
)
from raft_tpu_torch.mooring.system import (
    fairlead_tensions, mooring_force, mooring_stiffness, parse_mooring,
    solve_equilibrium, tension_jacobian,
)
from raft_tpu_torch.parallel.sweep import stage_bem
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
    None (strip theory only), ``"jax"`` or ``"auto"`` (on-device panel
    solve at ``calcSystemProps``), or a precomputed (A[6, 6, nw],
    B[6, 6, nw], F[6, nw]) tuple.  ``"native"``, the JAX package's host
    C++ solver, is not ported yet and raises.
    """

    def __init__(self, design: dict, w=None, depth: float | None = None,
                 nTurbines: int = 1, BEM=None, dtype=torch.float64, device=None):
        if nTurbines != 1:
            raise NotImplementedError(
                "nTurbines != 1 (ArrayModel) comes with the scenario-batch slice "
                "(ROADMAP.md, queue 1)")
        if isinstance(BEM, str) and BEM == "native":
            raise NotImplementedError(
                "BEM='native' (the host C++ panel solver, raft_tpu/native/bem.cpp) "
                "comes with a later slice (ROADMAP.md, queue 1, item 1); BEM='jax' "
                "or 'auto' solves the panels on the device")
        if isinstance(BEM, str) and BEM not in ("jax", "auto"):
            raise ValueError(f"BEM={BEM!r}: expected 'jax', 'auto', or a precomputed "
                             "(A, B, F) tuple")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.design = design
        self.members = build_member_set(design, self.device, dtype)
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
                out_dir: str | None = None, irr: bool = False, headings=None):
        """Mesh the potMod members and solve them with the on-device panel
        BEM, on the model's device in its dtype.

        ``irr=True`` adds interior waterplane lid panels (irregular-frequency
        removal).  ``headings``: optional heading grid [rad]; the excitation
        is solved for every heading at once and later ``setEnv(beta=...)``
        calls re-stage it by interpolation.  Writes HullMesh.pnl and
        platform.gdf when ``out_dir`` is given.  Returns the (A, B, F) tuple
        (host numpy), or None when the design has no potMod member."""
        from raft_tpu_torch.hydro.mesh import mesh_design, mesh_lid, write_gdf, write_pnl
        from raft_tpu_torch.hydro.torch_bem import solve_bem_any

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
                     mode=self.bem_mode, dtype=self.dtype, device=self.device,
                     return_diagnostics=True)
        w = _np(self.w)
        if headings is not None:
            beta = float(self.env.beta)
            betas = np.sort(np.asarray(headings, dtype=float))
            if not (betas[0] - 1e-9 <= beta <= betas[-1] + 1e-9):
                raise ValueError(
                    f"current heading {beta:.3f} rad outside the requested grid "
                    f"[{betas[0]:.3f}, {betas[-1]:.3f}]: include it or setEnv first")
            A, B, F_all, self.bem_diagnostics = solve_bem_any(panels, w, beta=betas, **solve)
            self._bem_headings = (betas, F_all, A, B)
            self.bem = (A, B, interp_heading_excitation(betas, F_all, beta))
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
        raise NotImplementedError(
            "airgap comes with the scenario-batch slice (ROADMAP.md, queue 1)")

    def plot(self, *args, **kwargs):
        raise NotImplementedError(
            "plot comes with the Model/CLI slice (ROADMAP.md, queue 1)")

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


def run_raft(fname_design, fname_env=None, plot: bool = False, w=None,
             dtype=torch.float64, device=None) -> dict:
    """End-to-end analysis (cf. ``raft_tpu.model.run_raft``).

    ``fname_env``: optional environment YAML (``Hs``/``Tp``/``V``/``beta``
    [deg]/``Fthrust``); the design's turbine thrust is the default."""
    if plot:
        raise NotImplementedError("plot comes with the Model/CLI slice (ROADMAP.md, queue 1)")
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
    return model.results
