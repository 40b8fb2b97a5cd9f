"""One run of one cell: set-up, the measured window (or the traced calls),
the output check against the plain reference, and the result line.

The result is the last line of standard output, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object."""
from __future__ import annotations

import hashlib
import importlib
import json
import sys
import time

import numpy as np

from . import isolation, spec
from .profile import CALL, SYNC

class NoDevice(RuntimeError):
    pass


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def check_designs(config: dict, root=spec.ROOT) -> None:
    """The frozen design copies are the files the program's entries read."""
    for d in config.get("designs", []):
        mod = importlib.import_module(d["program_module"])
        prog = getattr(mod, d["program_attr"])
        if "program_file" in d:
            prog = prog / d["program_file"]
        if _sha(root / d["frozen"]) != _sha(prog):
            raise RuntimeError(f"{d['frozen']} differs from the program's {prog}")


def require_devices(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")


def host_probe() -> float:
    """Seconds that a fixed piece of pure-Python work takes: the host's
    speed at that moment, read beside a run's numbers (a host-bound cell
    moves with it)."""
    t = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i * i % 7
    return time.perf_counter() - t


def end_to_end(cell, calls: list, window_s: float, setup_s: float, root=spec.ROOT) -> dict:
    """Each end-to-end metric of the cell from the window's calls: ``rate``
    (units over the window), ``time_per`` (the window over the units),
    ``percentile`` (of the calls' walls) or ``setup``."""
    out = {}
    units = sum(c["units"] for c in calls)
    for m in cell.end_to_end:
        kind = spec.end_to_end_kind(m["name"], root)
        k = kind["kind"]
        if k == "setup":
            v = setup_s
        elif k == "rate":
            v = units / window_s
        elif k == "time_per":
            v = window_s / units
        elif k == "percentile":
            v = float(np.percentile([c["wall"] for c in calls], 100 * kind["q"]))
        else:
            raise ValueError(f"end_to_end/{m['name']}.json: unknown kind {k!r}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _window(drv, seconds: float):
    """Calls until ``seconds`` have passed; each call due when the last one
    returned (a closed loop), timed from then to its result on the host."""
    calls = []
    t0 = time.perf_counter()
    i = 0
    while True:
        inputs = drv.next_inputs(i)
        due = time.perf_counter()
        res = drv.call(inputs)
        end = time.perf_counter()
        calls.append({**res, "wall": end - due})
        i += 1
        if end - t0 >= seconds:
            return calls, end - t0


def _traced(drv, n_calls: int):
    """``n_calls`` calls under ``torch.profiler`` (host and device), each in
    a ``bench/call`` range, the harness's synchronisation in ``bench/sync``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import profile as prof_mod

    calls = []
    inputs = [drv.next_inputs(i) for i in range(n_calls)]
    drv.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for inp in inputs:
            due = time.perf_counter()
            with record_function(CALL):
                res = drv.call(inp)
                with record_function(SYNC):
                    drv.sync()
            calls.append({**res, "wall": time.perf_counter() - due})
    return calls, prof_mod.from_profiler(prof)


def layer_metrics(cell, p, drv, n_calls: int) -> dict:
    """Each per-layer metric of the cell from its reader
    (``layer_metrics/<stem>.py``, ``read(ctx)``); a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    import torch

    kind = torch.cuda.get_device_name(0) if drv.device.type == "cuda" else "cpu"
    ctx = {"profile": p, "n_calls": n_calls, "counters": drv.counters(), "cell": cell,
           "device_kind": kind}
    for m in cell.per_layer:
        stem, _, tag = m["name"].partition(".")
        reader = importlib.import_module(f"benchmark.layer_metrics.{stem}")
        v = reader.read(ctx, tag)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float, device=None,
        root=spec.ROOT, out=sys.stdout, err=sys.stderr) -> dict:
    """One run of the cell ``name``; ``t_start`` is the process's start on
    ``time.perf_counter``'s clock.  ``device`` None takes the card and
    refuses to run without one; the tests pass the CPU."""
    cell = spec.cell(name, root)
    chips = int(cell.entry["chips"])
    if device is None:
        require_devices(chips)
        device = "cuda"
    check_designs(cell.config, root)
    mod = importlib.import_module(f"benchmark.drivers.{cell.params['driver']}")
    drv = mod.Driver(cell, seed, device)
    drv.setup()
    host = {"probe_before_s": host_probe()}
    drv.sync()
    setup_s = time.perf_counter() - t_start
    if trace:
        calls, p = _traced(drv, int(cell.params["trace_calls"]))
    else:
        calls, window_s = _window(drv, seconds)
    dev = device_info(chips) if drv.device.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if trace:
        from . import profile as prof_mod

        metrics = layer_metrics(cell, p, drv, len(calls))
        dev.update(busy_s=prof_mod.busy_s(p), window_s=p.window_s)
        breakdown = {"device_ops": prof_mod.device_ops(p), "idle_gaps": prof_mod.idle_gaps(p)}
    else:
        metrics = end_to_end(cell, calls, window_s, setup_s, root)
    host["probe_after_s"] = host_probe()
    drv.release()
    checks = drv.check()
    found = isolation.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        raise SystemExit(3)
    result = {"correct": all(c.ok for c in checks), "attempted": len(calls),
              "failed": sum(1 for c in calls if not c["ok"]), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["host"] = host
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    print("host " + " ".join(f"{k} {v!r}" for k, v in host.items()), file=err)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result
