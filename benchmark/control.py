#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --calls <n> [--out chiprun_out/readings.json]

Sets the cell up once, then for each seed makes ``--calls`` calls of the
timed path on that seed's traffic and reads the compared numbers against
the plain reference (the program's lower readings).  For each control seed
it also puts the reference, computed one precision below the
configuration's, in the program's place on the same traffic (the control's
upper readings).  The benchmark's own runs never run the control."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def readings(name: str, seeds, control_seeds, calls: int, device=None, root=None) -> dict:
    import importlib

    import numpy as np

    from benchmark.harness import runner, spec

    root = spec.ROOT if root is None else root
    cell = spec.cell(name, root)
    if device is None:
        runner.require_devices(int(cell.entry["chips"]))
        device = "cuda"
    runner.check_designs(cell.config, root)
    mod = importlib.import_module(f"benchmark.drivers.{cell.params['driver']}")
    drv = mod.Driver(cell, seeds[0], device)
    drv.setup()
    out = {"workload": name, "calls": calls, "program": {}, "control": {}, "detail": {}}
    for seed in seeds:
        drv.seed = int(seed)
        drv.rng = np.random.default_rng([drv.seed, 0])
        drv.outputs.clear()
        for i in range(calls):
            drv.call(drv.next_inputs(i))
        out["program"][str(seed)] = {c.name: c.value for c in drv.check()}
        detail = {"program": drv.detail}
        if seed in control_seeds:
            out["control"][str(seed)] = {c.name: c.value for c in drv.control()}
            detail["control"] = drv.detail
        out["detail"][str(seed)] = detail
        print(json.dumps({"seed": seed, "program": out["program"][str(seed)],
                          "control": out["control"].get(str(seed)), "detail": detail}),
              flush=True)
    names = sorted({k for r in out["program"].values() for k in r})
    out["lower"] = {k: max(r[k] for r in out["program"].values()) for k in names}
    out["upper"] = {k: min(r[k] for r in out["control"].values()) for k in names
                    if out["control"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE.parent))
    from benchmark.run import pin_program_env

    pin_program_env()
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    res = readings(args.workload, seeds, ctrl, args.calls)
    res["seconds"] = time.perf_counter() - T_START
    print(json.dumps({"lower": res["lower"], "upper": res["upper"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
