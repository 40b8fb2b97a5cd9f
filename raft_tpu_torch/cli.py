"""Command line of the port: the runRAFT recipe as a console entry
point (the counterpart of ``raft_tpu.cli``, with the same subcommands,
flags, bundled design names and JSON output).

    raft-tpu-torch volturn --bem --json      # analyze, on the card
    raft-tpu-torch sweep oc3 --param draft --lo 0.9 --hi 1.1 -n 100
    raft-tpu-torch dlc volturn --cases cases.csv --bem
    raft-tpu-torch optimize oc3 --params diameter draft --steps 20
    python -m raft_tpu_torch.cli oc3 --device cpu

Every subcommand runs on the card (CUDA) unless ``--device`` names another
torch device; without CUDA the default raises rather than running on the
CPU.  ``--bem`` solves the potMod members with the host C++ panel solver,
as the JAX package's CLI does, unless ``RAFT_TPU_BEM=jax`` sends the solve
to the card's panel BEM (kernels K3/K4; ``RAFT_TPU_BEM_PRECISION=bf16``
then assembles in bfloat16 on a float32 solve, the Model rule of
:func:`raft_tpu_torch.hydro.torch_bem.model_solve_dtype`).

The JAX package's CLI first enables its warm-start cache (the persistent
compile cache and the AOT executable registry).  The port has no AOT
registry (it runs eagerly; the registry belongs to ROADMAP.md queue 1,
item 7.2, the cache slice), so this module enables nothing: the BEM result caches of
:mod:`raft_tpu_torch.hydro.native_bem` and
:func:`raft_tpu_torch.hydro.torch_bem.solve_bem_jax` apply as they do to
any call.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

_BUNDLED = {
    "oc3": "OC3spar.yaml",
    "oc4": "OC4semi.yaml",
    "oc4_2": "OC4semi_2.yaml",
    "volturn": "VolturnUS-S.yaml",
}
#: the shipped designs, read as data files from the JAX package's tree
DESIGNS = Path(__file__).resolve().parents[1] / "raft_tpu" / "designs"


def _design_path(name: str) -> str:
    if name in _BUNDLED:
        return str(DESIGNS / _BUNDLED[name])
    return name


def _add_device_arg(p):
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card; 'cpu' runs the plain "
                        "PyTorch path)")


def _add_env_args(p):
    p.add_argument("--hs", type=float, default=8.0, help="significant wave height [m]")
    p.add_argument("--tp", type=float, default=12.0, help="peak period [s]")
    p.add_argument("--thrust", type=float, default=None,
                   help="rotor thrust [N] (default: design Fthrust)")
    p.add_argument("--wmin", type=float, default=0.05)
    p.add_argument("--wmax", type=float, default=3.0)
    p.add_argument("--dw", type=float, default=0.05)
    p.add_argument("--current", type=float, default=0.0, help="surface current speed [m/s]")
    p.add_argument("--current-heading", type=float, default=0.0,
                   help="current direction [deg]")
    p.add_argument("--current-exp", type=float, default=0.0,
                   help="power-law shear exponent (1/7 typical; 0 uniform)")
    _add_device_arg(p)


def _bem_route(flag: bool):
    """The Model's ``BEM`` for ``--bem``: None without it; the host solver
    (``"native"``, the JAX package's CLI) unless ``RAFT_TPU_BEM`` names a
    route."""
    if not flag:
        return None
    from raft_tpu_torch.hydro.torch_bem import bem_mode

    mode = bem_mode()
    return "native" if mode == "auto" else mode


def _build_pipeline_inputs(args, headings=None):
    """Shared sweep/optimize/dlc setup: design -> (members, rna, env, wave,
    C_moor, model), through the Model facade so the staged inputs are the
    analyze path's: thrust applied, mean equilibrium solved, mooring
    stiffness linearized about that offset.  With ``args.bem`` the panel
    solve runs too; ``headings`` (rad) stages a heading grid in that one
    solve (``model._bem_headings``)."""
    from raft_tpu_torch.model import Model, load_design

    design = load_design(_design_path(args.design))
    thrust = args.thrust
    if thrust is None:
        thrust = float(design.get("turbine", {}).get("Fthrust", 0.0))
    use_bem = bool(getattr(args, "bem", False))
    model = Model(design, w=np.arange(args.wmin, args.wmax, args.dw), BEM=_bem_route(use_bem),
                  device=args.device)
    env_kw = {}
    if headings is not None:
        # env.beta must lie in the staged grid
        env_kw["beta"] = float(np.asarray(headings, dtype=float)[0])
    if getattr(args, "current", 0.0):
        env_kw.update(current=args.current, current_heading=np.deg2rad(args.current_heading),
                      current_exp=args.current_exp)
    model.setEnv(Hs=args.hs, Tp=args.tp, Fthrust=thrust, **env_kw)
    if use_bem:
        # explicit, so the mesh knobs apply with or without a heading grid
        model.calcBEM(dz_max=getattr(args, "dz_max", 3.0), da_max=getattr(args, "da_max", 2.0),
                      headings=(np.asarray(headings, dtype=float)
                                if headings is not None else None))
    model.calcSystemProps()
    model.calcMooringAndOffsets()
    return model.members, model.rna, model.env, model.wave, model.C_moor, model


def _param_fn(members, names):
    """Composite ``apply_fn`` over the named geometry knobs (one theta entry
    per knob)."""
    import torch

    from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
    from raft_tpu_torch.parallel.sweep import scale_diameters

    fns = []
    for n in names:
        if n == "diameter":
            fns.append(scale_diameters)
        elif n == "draft":
            fns.append(make_stretch_draft(members))
        elif n == "plan":
            fns.append(make_scale_plan(members))
        else:
            raise SystemExit(f"unknown parameter {n!r} (diameter/draft/plan)")

    def apply(m, theta):
        theta = torch.atleast_1d(theta)
        for i, f in enumerate(fns):
            m = f(m, theta[i])
        return m

    return apply


def main_sweep(argv):
    p = argparse.ArgumentParser(prog="raft-tpu-torch sweep",
                                description="batched design-variant sweep")
    p.add_argument("design")
    p.add_argument("--param", default="diameter", choices=["diameter", "draft", "plan"])
    p.add_argument("--lo", type=float, default=0.9)
    p.add_argument("--hi", type=float, default=1.1)
    p.add_argument("-n", type=int, default=64, help="number of variants")
    _add_env_args(p)
    args = p.parse_args(argv)

    from raft_tpu_torch.parallel.sweep import sweep

    members, rna, env, wave, C_moor, _ = _build_pipeline_inputs(args)
    apply = _param_fn(members, [args.param])
    thetas = np.linspace(args.lo, args.hi, args.n)
    out = sweep(members, rna, env, wave, C_moor, thetas, apply_fn=apply, device=args.device)
    rows = {"param": args.param, "theta": thetas.tolist(), "std dev": out["std dev"].tolist(),
            "iterations": out["iterations"].tolist()}
    print(json.dumps(rows))
    return rows


def _read_cases(path: str) -> np.ndarray:
    """The DLC table: rows ``Hs,Tp[,beta_deg]``; blank lines, ``#``
    comments and non-numeric header lines before the first row skipped;
    the headings returned in rad."""
    rows = []
    with open(path) as f:
        for lineno, ln in enumerate(f, 1):
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            try:
                rows.append([float(x) for x in ln.replace(",", " ").split()])
            except ValueError:
                if not rows:              # header lines before the first numeric row
                    continue
                raise SystemExit(f"{path}:{lineno}: non-numeric case row {ln!r} (rows are "
                                 f"'Hs,Tp' or 'Hs,Tp,beta_deg')")
    if not rows:
        raise SystemExit(f"{path}: no numeric case rows found")
    ncol = {len(r) for r in rows}
    if ncol not in ({2}, {3}):
        raise SystemExit(f"--cases rows must all be 'Hs,Tp' or all 'Hs,Tp,beta_deg'; got "
                         f"column counts {sorted(ncol)}")
    cases = np.asarray(rows, dtype=float)
    if cases.shape[1] == 3:
        cases[:, 2] = np.deg2rad(cases[:, 2])
    return cases


def main_dlc(argv):
    p = argparse.ArgumentParser(
        prog="raft-tpu-torch dlc",
        description="design-load-case table: one design x many sea states (Hs, Tp[, heading]) "
                    "in one batched solve")
    p.add_argument("design")
    p.add_argument("--cases", required=True,
                   help="CSV file of rows 'Hs,Tp[,beta_deg]' (lines starting with # and "
                        "non-numeric header lines are skipped)")
    p.add_argument("--bem", action="store_true",
                   help="run the BEM solver once (native, or the card's with RAFT_TPU_BEM=jax), "
                        "staging a heading grid over the table's unique headings (per-case "
                        "excitation interpolated to its own heading)")
    p.add_argument("--thrust", type=float, default=None,
                   help="rotor thrust [N] (default: design Fthrust)")
    p.add_argument("--dz-max", type=float, default=3.0, help="BEM mesh: max panel height [m]")
    p.add_argument("--da-max", type=float, default=2.0,
                   help="BEM mesh: max panel azimuthal width [m]")
    p.add_argument("--wmin", type=float, default=0.05)
    p.add_argument("--wmax", type=float, default=3.0)
    p.add_argument("--dw", type=float, default=0.05)
    _add_device_arg(p)
    args = p.parse_args(argv)
    cases = _read_cases(args.cases)

    from raft_tpu_torch.parallel.sweep import make_wave_states, sweep_sea_states

    # the shared setup, staging the mooring and statics at the table's most severe case
    ea = argparse.Namespace(
        design=args.design, thrust=args.thrust, bem=args.bem, dz_max=args.dz_max,
        da_max=args.da_max, hs=float(cases[:, 0].max()),
        tp=float(cases[cases[:, 0].argmax(), 1]), wmin=args.wmin, wmax=args.wmax, dw=args.dw,
        device=args.device)
    headings = np.unique(cases[:, 2]) if cases.shape[1] == 3 else None
    members, rna, env, wave, C_moor, model = _build_pipeline_inputs(
        ea, headings=headings if args.bem else None)
    bem = None
    if args.bem:
        # the heading grid when the table has headings, else the one-heading solve
        bem = model._bem_headings if headings is not None else model.bem
    waves = make_wave_states(wave.w.cpu().numpy(), cases, float(env.depth), device=args.device)
    out = sweep_sea_states(members, rna, env, waves, C_moor, bem=bem, device=args.device)
    result = {
        "cases": cases.tolist(),
        "columns": ["Hs", "Tp"] + (["beta_rad"] if cases.shape[1] == 3 else []),
        "std dev": out["std dev"].tolist(),
        "nacelle accel std dev": out["nacelle accel std dev"].tolist(),
        "iterations": out["iterations"].tolist(),
    }
    print(json.dumps(result))
    return result


def main_optimize(argv):
    p = argparse.ArgumentParser(prog="raft-tpu-torch optimize",
                                description="gradient co-design: minimize nacelle-acceleration "
                                            "std dev")
    p.add_argument("design")
    p.add_argument("--params", nargs="+", default=["diameter"],
                   help="geometry knobs: diameter / draft / plan")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--lo", type=float, default=0.85)
    p.add_argument("--hi", type=float, default=1.2)
    _add_env_args(p)
    args = p.parse_args(argv)

    from raft_tpu_torch.parallel.optimize import optimize_design

    members, rna, env, wave, C_moor, _ = _build_pipeline_inputs(args)
    apply = _param_fn(members, args.params)
    res = optimize_design(members, rna, env, wave, C_moor, theta0=np.ones(len(args.params)),
                          apply_fn=apply, steps=args.steps, learning_rate=args.lr,
                          bounds=(args.lo, args.hi), device=args.device)
    out = {"params": args.params, "theta": np.atleast_1d(res.theta).tolist(),
           "objective": res.objective, "history": res.history.tolist()}
    print(json.dumps(out))
    return out


def _analyze_parser():
    p = argparse.ArgumentParser(
        description="raft_tpu_torch frequency-domain analysis",
        epilog="subcommands: 'raft-tpu-torch sweep ...' (batched design-variant sweep), "
               "'raft-tpu-torch dlc ...' (sea-state/heading case table), and "
               "'raft-tpu-torch optimize ...' (gradient co-design); see "
               "'raft-tpu-torch <subcommand> --help'.")
    p.add_argument("design", help="design YAML path or bundled name: " + "/".join(_BUNDLED))
    p.add_argument("--hs", type=float, default=8.0, help="significant wave height [m]")
    p.add_argument("--tp", type=float, default=12.0, help="peak period [s]")
    p.add_argument("--wind", type=float, default=10.0, help="wind speed [m/s]")
    p.add_argument("--beta", type=float, default=0.0, help="wave heading [deg]")
    p.add_argument("--thrust", type=float, default=None,
                   help="rotor thrust [N] (default: design Fthrust)")
    p.add_argument("--current", type=float, default=0.0, help="surface current speed [m/s]")
    p.add_argument("--current-heading", type=float, default=0.0,
                   help="current direction [deg]")
    p.add_argument("--current-exp", type=float, default=0.0,
                   help="power-law shear exponent (1/7 typical; 0 uniform)")
    p.add_argument("--wmin", type=float, default=0.05)
    p.add_argument("--wmax", type=float, default=3.0)
    p.add_argument("--dw", type=float, default=0.05)
    p.add_argument("--bem", action="store_true",
                   help="run the BEM solver for potMod members (native, or the card's with "
                        "RAFT_TPU_BEM=jax)")
    p.add_argument("--irr", action="store_true",
                   help="irregular-frequency removal (waterplane lid) in the BEM solve")
    p.add_argument("--n-turbines", type=int, default=1,
                   help="analyze N identical turbines as an array (nDOF = 6N)")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--json", action="store_true", help="print results as JSON")
    _add_device_arg(p)
    return p


def _clean(o):
    """Results -> JSON-ready values: arrays to lists, complex ones as
    magnitudes."""
    if isinstance(o, dict):
        return {k: _clean(v) for k, v in o.items()}
    if isinstance(o, np.ndarray):
        return o.tolist() if not np.iscomplexobj(o) else np.abs(o).tolist()
    return o


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # subcommand dispatch; a design file named like a subcommand still wins,
    # because an existing path is analyzed
    if argv and argv[0] in ("sweep", "optimize", "dlc") and not os.path.isfile(argv[0]):
        return {"sweep": main_sweep, "optimize": main_optimize,
                "dlc": main_dlc}[argv[0]](argv[1:])
    args = _analyze_parser().parse_args(argv)

    from raft_tpu_torch.model import Model, load_design

    design = load_design(_design_path(args.design))
    thrust = args.thrust
    if thrust is None:
        thrust = float(design.get("turbine", {}).get("Fthrust", 0.0))
    model = Model(design, w=np.arange(args.wmin, args.wmax, args.dw), BEM=_bem_route(args.bem),
                  nTurbines=args.n_turbines, device=args.device)
    model.setEnv(Hs=args.hs, Tp=args.tp, V=args.wind, beta=np.deg2rad(args.beta),
                 Fthrust=thrust, current=args.current,
                 current_heading=np.deg2rad(args.current_heading), current_exp=args.current_exp)
    if args.bem and args.irr:
        model.calcBEM(irr=True)
    model.calcSystemProps()
    model.solveEigen()
    model.calcMooringAndOffsets()
    model.solveDynamics()
    results = model.calcOutputs()

    if args.json:
        print(json.dumps(_clean(results), default=str))
    else:
        model.print_report()
    if args.plot:
        import matplotlib

        # only savefig() here: Agg, unless pyplot is loaded already or the
        # user chose a backend
        if "matplotlib.pyplot" not in sys.modules and "MPLBACKEND" not in os.environ:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        model.plot()
        plt.savefig("raft_tpu_platform.png", dpi=120)
        print("wrote raft_tpu_platform.png")
        model.plot_raos()
        plt.savefig("raft_tpu_raos.png", dpi=120)
        print("wrote raft_tpu_raos.png")
    return results


def entry_point():
    """Console-script wrapper: the script's exit status is 0 after
    :func:`main` returns its results."""
    main()
    return 0


if __name__ == "__main__":
    entry_point()
