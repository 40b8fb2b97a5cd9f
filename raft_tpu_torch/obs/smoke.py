"""Obs smoke: the observability layer end to end, across processes (port of
``raft_tpu.obs.smoke``).

``python -m raft_tpu_torch.obs [--device cpu] [--nw N] [--dir D]`` runs a
small mixed-design :func:`~raft_tpu_torch.parallel.sweep.sweep_designs`
stream (OC3spar, VolturnUS-S and OC4semi: two shape buckets) in two fresh
child processes on one cache root, first with ``RAFT_TPU_OBS`` off, then
armed with a sink directory, and checks:

* the armed child published a valid JSONL event log (every line parses;
  meta, span and metrics records; no corrupt line);
* its Chrome trace loads and follows the trace-event schema (``ph``,
  ``ts``, ``dur``, ``pid``, ``tid`` on every complete event, every track
  named by a metadata event), and its events nest by time containment on
  each thread, which Perfetto's slice view relies on;
* the metrics carry one ``sweep_designs.dispatch_s[...]`` latency
  histogram per bucket signature with its p50 and p99, and the Prometheus
  file is written;
* the unarmed child published nothing;
* overhead: the armed child's solve leg (best of 3 after a warm pass)
  gives at least 1 / :data:`OVERHEAD_FACTOR` of the unarmed child's
  solves/s.

The children run on ``--device`` (the card by default; without CUDA the
smoke exits 2 unless given ``--device cpu``) in float64, and report their
K1 launches.  Prints one JSON line; exit 0 when every check holds, else 1.
``python -m raft_tpu_torch.obs child`` is the per-process payload.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

#: the armed child's solves/s may lag the unarmed child's by at most this
#: factor.  Generous on purpose: the timed leg is short, so the constant
#: cost of an armed call (one debounced publish of three sink files) weighs
#: on the ratio; the check is there to catch an instrumentation cost that
#: grows with the lanes, not to pin that constant.
OVERHEAD_FACTOR = 2.0
N_ITER = 8
#: seconds a child may take (start-up included)
CHILD_TIMEOUT = 600.0


def _child(argv) -> None:
    p = argparse.ArgumentParser(prog="raft_tpu_torch.obs child")
    p.add_argument("--nw", type=int, default=32)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    from raft_tpu_torch import cache, obs
    from raft_tpu_torch.build.smoke import design_paths, stage_kw
    from raft_tpu_torch.core import cuda6, cuda_drag
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.model import stage_designs
    from raft_tpu_torch.parallel.sweep import sweep_designs

    cache.enable()                      # RAFT_TPU_TORCH_CACHE_DIR from the parent
    dev = resolve_device(args.device)
    fnames = design_paths()
    k1 = cuda6.LAUNCHES["fused"]
    staged = stage_designs(fnames, device=dev, **stage_kw(args.nw))
    # a warm pass first (the kernel library opened, the allocator filled);
    # the timed leg below measures the solve alone
    sweep_designs(staged=staged, n_iter=N_ITER, return_xi=False, device=dev)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = sweep_designs(staged=staged, n_iter=N_ITER, return_xi=False, device=dev)
        best = min(best, time.perf_counter() - t0)

    solves = len(fnames) * args.nw
    # forced: the per-sweep publishes above are debounced, and the child's
    # final snapshot must be complete
    published = obs.maybe_publish("smoke", force=True)
    print(json.dumps({
        "armed": obs.enabled(),
        "device": str(dev),
        "n_designs": len(fnames),
        "n_buckets": out["buckets"]["n_buckets"],
        "signatures": out["buckets"]["signatures"],
        "solves_per_s": solves / best,
        "timed_leg_s": best,
        "k1_launches": cuda6.LAUNCHES["fused"] - k1,
        "published": published,
    }))


def validate_chrome_trace(path: str) -> dict:
    """Load a Chrome trace file and check its schema and nesting.

    Every event but the thread-name metadata (``ph == "M"``) must be a
    complete event (``ph == "X"``) with integer ``ts``, ``dur``, ``pid``
    and ``tid`` and a name; every track must be named; within one ``tid``
    the events must nest by time containment (a child's ``[ts, ts + dur]``
    inside its parent's)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    all_events = doc.get("traceEvents")
    assert isinstance(all_events, list) and all_events, "traceEvents missing or empty"
    meta = [ev for ev in all_events if ev.get("ph") == "M"]
    events = [ev for ev in all_events if ev.get("ph") != "M"]
    for ev in meta:
        assert ev.get("name") == "thread_name" and "name" in ev.get("args", {}), \
            f"malformed metadata event: {ev}"
    for ev in events:
        for field in ("name", "ph", "ts", "dur", "pid", "tid"):
            assert field in ev, f"event missing {field!r}: {ev}"
        assert ev["ph"] == "X", f"unexpected phase {ev['ph']!r}"
        for field in ("ts", "dur", "pid", "tid"):
            assert isinstance(ev[field], int), f"non-integer {field}"
    assert {ev["tid"] for ev in events} <= {ev["tid"] for ev in meta}, \
        "a track without its thread_name metadata event"
    bad_nesting = 0
    by_tid: dict = {}
    for ev in events:
        by_tid.setdefault(ev["tid"], []).append(ev)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []          # end times of the open intervals
        for ev in evs:
            while stack and stack[-1] <= ev["ts"]:
                stack.pop()
            if stack and ev["ts"] + ev["dur"] > stack[-1]:
                bad_nesting += 1
            stack.append(ev["ts"] + ev["dur"])
    assert bad_nesting == 0, f"{bad_nesting} events violate nesting"
    return {"events": len(events), "tracks": len(by_tid)}


def smoke(argv) -> int:
    p = argparse.ArgumentParser(prog="raft_tpu_torch.obs")
    p.add_argument("--nw", type=int, default=32, help="frequency bins")
    p.add_argument("--device", default=None, help="the children's device (default: the card)")
    p.add_argument("--dir", default=None,
                   help="work directory (default: a fresh temporary one, removed after)")
    args = p.parse_args(argv)

    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.core import cuda6, cuda_drag
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.evidence import run_child
    from raft_tpu_torch.obs.export import read_jsonl

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"raft_tpu_torch.obs: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        aot.prepare([cuda6.SPEC, cuda_drag.SPEC])
    work = args.dir or tempfile.mkdtemp(prefix="raft_tpu_torch_obs_smoke_")
    cache_dir, obs_dir = os.path.join(work, "cache"), os.path.join(work, "obs")
    child_args = ["child", "--nw", str(args.nw)] + (["--device", args.device]
                                                    if args.device else [])
    env = {"RAFT_TPU_TORCH_CACHE_DIR": cache_dir, "RAFT_TPU_BUCKETS": None}
    try:
        off = run_child("raft_tpu_torch.obs", child_args, CHILD_TIMEOUT, "obs child off",
                        {**env, "RAFT_TPU_OBS": None})
        on = run_child("raft_tpu_torch.obs", child_args, CHILD_TIMEOUT, "obs child on",
                       {**env, "RAFT_TPU_OBS": obs_dir})
        assert on["published"], "the armed child published nothing"
        events, corrupt = read_jsonl(on["published"]["jsonl"])
        kinds = {e.get("type") for e in events}
        spans = [e for e in events if e.get("type") == "span"]
        metrics_evs = [e for e in events if e.get("type") == "metrics"]
        hists = (metrics_evs[-1] if metrics_evs else {}).get("histograms", {})
        per_bucket = {k: v for k, v in hists.items()
                      if k.startswith("sweep_designs.dispatch_s[")}
        quantiles_ok = all(isinstance(h.get("p50"), float) and isinstance(h.get("p99"), float)
                           and h.get("count", 0) >= 1 for h in per_bucket.values())
        trace_info = validate_chrome_trace(on["published"]["chrome_trace"])
        checks = {
            "jsonl_valid": (corrupt == 0 and {"meta", "span", "metrics"} <= kinds
                            and len(spans) >= 3),
            "chrome_trace_valid": trace_info["events"] >= 3,
            "per_bucket_histograms": len(per_bucket) == on["n_buckets"] and quantiles_ok,
            "prom_written": os.path.exists(on["published"]["prom"]),
            "overhead_bounded": on["solves_per_s"] * OVERHEAD_FACTOR >= off["solves_per_s"],
            "unarmed_published_nothing": off["published"] is None,
        }
    except (AssertionError, RuntimeError) as e:
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"[-3000:]}))
        return 1
    finally:
        if args.dir is None:
            shutil.rmtree(work, ignore_errors=True)
    ok = all(checks.values())
    print(json.dumps({
        "ok": ok, **checks,
        "device": str(dev), "nw": args.nw,
        "n_buckets": on["n_buckets"],
        "jsonl_events": len(events),
        "chrome_trace": trace_info,
        "dispatch_histograms": {k: {q: v[q] for q in ("count", "p50", "p99")}
                                for k, v in sorted(per_bucket.items())},
        "solves_per_s_obs_off": off["solves_per_s"],
        "solves_per_s_obs_on": on["solves_per_s"],
        "timed_leg_s": {"off": off["timed_leg_s"], "on": on["timed_leg_s"]},
        "k1_launches": {"off": off["k1_launches"], "on": on["k1_launches"]},
        "child_wall_s": {"off": off["wall_s"], "on": on["wall_s"]},
    }))
    return 0 if ok else 1


def main() -> int:
    argv = sys.argv[1:]
    if argv and argv[0] == "child":
        _child(argv[1:])
        return 0
    return smoke(argv)
