"""Serve-smoke: cross-process proof of the resident solver service (port
of ``raft_tpu.serve.smoke``).

``python -m raft_tpu_torch.serve smoke [--device cpu] [--keep]`` solves
the stream's lanes alone in this process first (:func:`solver.solve_solo`
through the same padded path, on the same device: the reference, and on
the card the step that builds or loads kernel K1's library), then spawns
the real daemon in a child process twice and proves, over the real
socket:

* a mixed 3-design request stream (OC3 spar, OC4 semi, VolturnUS-S,
  varied sea states, two shape buckets under the stock ladder) is
  answered, every row bit-identical to its solo row;
* neither child builds a kernel library (``compiles`` 0 at ready and after
  the stream: both load what ``raft_tpu_torch/_build/`` holds);
* SIGTERM is graceful (rc 0, socket unlinked), and a restarted child
  serves the same stream bit-identically;
* the restarted child runs with ``RAFT_TPU_OBS`` armed (the first runs
  unarmed) and proves the request-scoped observability layer across
  processes: the exported JSONL is zero-corrupt and carries one complete
  span tree per served request (``request/server`` + ``stage`` /
  ``queue_wait`` / ``solve`` under one trace id), the Chrome trace keeps
  per-track time containment, the Prometheus text carries the serve
  counters, the ``stats`` op's windowed p50/p99 agree with the
  client-observed latencies, SIGTERM leaves a populated flight-recorder
  dump, and the armed stream's wall time stays within twice the unarmed
  one's (plus 0.5 s).

The JAX smoke's "compiles == n_buckets" cold check has no counterpart
(the port compiles no program per bucket: both children load the same
built libraries, so ``compiles`` is 0 in each), nor has its warm-restart
speed check (a ready-time comparison would measure noise).  Each child
enables the cache, so its kernels' launches are timed into the per-kernel
ledger under the cache root, flushed at shutdown.  The children's device comes only from ``--device`` (the card by
default); their environment forces nothing.

The stream runs at the smoke's small configuration (16 w, 12 iterations,
4 lanes, 40 ms).  :func:`serve_args`, :func:`spawn_daemon` and
:func:`solo_reference` take ``full_width=True`` for the daemon's own
defaults (100 w, 25 iterations, 8 lanes, 25 ms), as ``chip_smoke.py``
runs them on the card.

Prints one JSON line; rc 0 iff all checks hold.
"""
from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

#: the mixed stream: (design alias, Hs, Tp) — 3 designs x 3 sea states,
#: landing in 2 buckets under the stock ladder
STREAM = [(d, 6.0 + 0.5 * (i % 3), 10.0 + 0.5 * (i % 2))
          for i, d in enumerate(["oc3", "oc4", "volturnus"] * 3)]

NW = 16
N_ITER = 12
BATCH_MAX = 4
DEADLINE_MS = 40.0
WARM = "oc3,oc4,volturnus"

#: the repository root: children run ``python -m raft_tpu_torch.serve`` there
ROOT = Path(__file__).resolve().parents[2]


def serve_args(device: str | None, full_width: bool = False) -> list:
    """The daemon flags of the smoke's configuration, or with
    ``full_width`` of the daemon's defaults (no width flags at all)."""
    args = [] if full_width else ["--nw", str(NW), "--n-iter", str(N_ITER), "--deadline-ms",
                                  str(DEADLINE_MS), "--batch-max", str(BATCH_MAX)]
    return args + ["--warm", WARM] + (["--device", device] if device else [])


def child_env(obs_dir: str | None = None) -> dict:
    """A daemon child's environment: this one, minus the knobs that would
    change its configuration or batching; ``RAFT_TPU_OBS`` set only when
    ``obs_dir`` is given.  Nothing here picks the device."""
    env = dict(os.environ)
    for k in ("RAFT_TPU_BUCKETS", "RAFT_TPU_SERVE_BATCH_DEADLINE_MS",
              "RAFT_TPU_SERVE_BATCH_MAX", "RAFT_TPU_OBS_FLUSH_MS", "RAFT_TPU_FAULT_INJECT",
              "RAFT_TPU_OBS"):
        env.pop(k, None)
    if obs_dir is not None:
        env["RAFT_TPU_OBS"] = obs_dir
    return env


def _read_ready_line(proc, timeout_s: float) -> str:
    """First non-blank stdout line of the daemon child, read in a helper
    thread so the deadline is real (a bare ``readline()`` blocks forever
    on a hung child)."""
    box: list = []

    def reader():
        while True:
            line = proc.stdout.readline()
            if not line:            # EOF: child died without a line
                return
            if line.strip():
                box.append(line)
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout_s)
    if box:
        return box[0]
    if t.is_alive():                # hung child: kill, then fail loud
        proc.kill()
        proc.wait(10.0)
        raise RuntimeError(f"daemon printed no ready line in {timeout_s}s")
    raise RuntimeError(f"daemon died before ready (rc={proc.wait(10.0)})")


def spawn_daemon(sock: str, stderr_path: str, device: str | None,
                 obs_dir: str | None = None, timeout_s: float = 300.0,
                 full_width: bool = False):
    """One daemon child at :func:`serve_args`' configuration, blocking until its
    ready line; returns ``(proc, ready)``.  stderr goes to a file (a
    chatty child must never block on an undrained pipe); its tail is read
    back on failure."""
    stderr_f = open(stderr_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch.serve", "daemon", "--socket", sock,
         *serve_args(device, full_width)],
        stdout=subprocess.PIPE, stderr=stderr_f, text=True, env=child_env(obs_dir), cwd=ROOT)
    stderr_f.close()                 # the child holds its own handle
    t0 = time.perf_counter()
    try:
        line = _read_ready_line(proc, timeout_s)
    except RuntimeError as e:
        try:
            with open(stderr_path) as f:
                tail = f.read()[-2000:]
        except OSError:
            tail = "<stderr unavailable>"
        raise RuntimeError(f"{e}\n--- daemon stderr tail ---\n{tail}")
    ready = json.loads(line)
    if not ready.get("ready"):
        raise RuntimeError(f"unexpected daemon line: {line!r}")
    ready["spawn_to_ready_s"] = round(time.perf_counter() - t0, 3)
    return proc, ready


def drive_stream(sock: str, stream=STREAM):
    """Submit the stream open-loop, collect responses and the final server
    stats; returns ``(rows, stats response, info)`` where ``rows`` are
    ``(std_dev, iterations)`` per request and ``info`` carries the stream
    wall time, the client-side latencies and every response's trace id."""
    from raft_tpu_torch.serve.client import SolveClient

    with SolveClient(sock, connect_timeout=30.0) as cl:
        t0 = time.perf_counter()
        submit_t = []
        futs = []
        for d, Hs, Tp in stream:
            submit_t.append(time.perf_counter())
            futs.append(cl.submit({"op": "solve", "design": d, "Hs": Hs, "Tp": Tp}))
        rows, traces, lat = [], [], []
        for i, f in enumerate(futs):
            r = f.result(300.0)
            lat.append(time.perf_counter() - submit_t[i])
            if not r.get("ok"):
                raise RuntimeError(f"request failed: {r.get('error')}")
            row = r["results"][0]
            rows.append((row["std_dev"], row["iterations"]))
            traces.append(r.get("trace"))
        wall_s = time.perf_counter() - t0
        stats = cl.stats()
    return rows, stats, {"wall_s": wall_s, "latencies_s": lat, "traces": traces}


def stop_daemon(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(60.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10.0)
        return -9
    return proc.returncode


def solo_reference(device: str | None, stream=STREAM, full_width: bool = False):
    """Solo rows of ``stream`` computed in this process through the same
    padded batch path, at :func:`serve_args`' configuration on ``device``:
    the parity reference of the daemon children (and of the fleet smoke)."""
    from raft_tpu_torch.serve import protocol
    from raft_tpu_torch.serve.config import ServeConfig
    from raft_tpu_torch.serve.solver import SolverCore, solve_solo

    cfg = (ServeConfig(device=device) if full_width else
           ServeConfig(batch_deadline_s=DEADLINE_MS / 1e3, batch_max=BATCH_MAX, nw=NW,
                       n_iter=N_ITER, device=device))
    core = SolverCore(cfg)
    rows = []
    for d, Hs, Tp in stream:
        design, _label = protocol.resolve_design(d)
        r = solve_solo(core, design, Hs, Tp)
        rows.append((r["std_dev"], r["iterations"]))
    return rows


def check_chrome_trace(path: str) -> int:
    """Per-track time containment of a Chrome trace file: on every track
    the complete events nest or follow each other (the invariant a
    Perfetto load relies on).  Returns the number of complete events;
    raises ``AssertionError`` on a violation."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by_tid: dict = {}
    for e in events:
        assert e["dur"] >= 0, e
        by_tid.setdefault(e["tid"], []).append((e["ts"], -e["dur"], e["name"]))
    for tid, evs in by_tid.items():
        stack: list = []
        for ts, neg_dur, name in sorted(evs):
            end = ts - neg_dur
            while stack and ts >= stack[-1]:
                stack.pop()
            assert not stack or end <= stack[-1], f"track {tid}: {name} crosses its parent"
            stack.append(end)
    return len(events)


def check_obs_leg(obs_dir: str, traces, info, stats) -> dict:
    """The armed daemon's observability proof: zero-corrupt JSONL with one
    complete span tree per served request, a contained Chrome trace, the
    serve counters in the Prometheus text, a populated flight-recorder
    dump from the SIGTERM path, and windowed stats p50/p99 consistent
    with the client-observed latencies."""
    from raft_tpu_torch.obs.export import read_jsonl

    out: dict = {}
    logs = sorted(glob.glob(os.path.join(obs_dir, "obs-serve-*.jsonl")))
    out["armed_jsonl_published"] = bool(logs)
    spans_by_trace: dict = {}
    corrupt = 0
    for path in logs:
        events, bad = read_jsonl(path)
        corrupt += bad
        for ev in events:
            if ev.get("type") == "span" and ev.get("trace"):
                spans_by_trace.setdefault(ev["trace"], set()).add(ev["name"])
    out["armed_jsonl_zero_corrupt"] = bool(logs) and corrupt == 0
    need = {"request/server", "request/server/stage", "request/server/queue_wait",
            "request/server/solve"}
    trees = sum(1 for t in traces if t and need <= spans_by_trace.get(t, set()))
    out["per_request_span_trees"] = trees == len(traces) != 0
    out["span_trees_complete"] = trees
    chrome = sorted(glob.glob(os.path.join(obs_dir, "trace-serve-*.json")))
    out["chrome_trace_events"] = check_chrome_trace(chrome[-1]) if chrome else 0
    out["chrome_trace_contained"] = out["chrome_trace_events"] > 0
    prom = sorted(glob.glob(os.path.join(obs_dir, "metrics-serve-*.prom")))
    prom_text = Path(prom[-1]).read_text() if prom else ""
    out["prometheus_serve_counters"] = all(
        name in prom_text for name in ("serve_batches", "serve_lanes"))
    dumps = sorted(glob.glob(os.path.join(obs_dir, "flight-serve-*.jsonl")))
    flight_reqs = 0
    if dumps:
        events, bad = read_jsonl(dumps[-1])
        corrupt += bad
        flight_reqs = sum(1 for ev in events
                          if ev.get("type") == "request" and ev.get("outcome") == "ok")
    out["flight_dump_on_sigterm"] = flight_reqs >= len(traces)
    out["flight_requests"] = flight_reqs
    tel = stats.get("telemetry", {})
    lat = tel.get("latency", {})
    client_max = max(info["latencies_s"])
    out["telemetry_window_counts_stream"] = lat.get("count") == len(traces)
    out["telemetry_quantiles_consistent"] = (
        0.0 < lat.get("p50", 0.0) <= lat.get("p99", 0.0)
        # windowed quantiles report a log-bucket upper edge (5 buckets per
        # decade: at most 10^(1/5) ~ 1.585x above the true value), and the
        # true server-side latency is <= the client-observed one
        and lat.get("p99", 1e9) <= client_max * 1.585 + 0.05
        and lat.get("error_rate") == 0.0)
    out["server_window_p50_s"] = lat.get("p50")
    out["server_window_p99_s"] = lat.get("p99")
    out["client_max_latency_s"] = round(client_max, 4)
    out["queue_wait_windows"] = len(tel.get("queue_wait", {}))
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="raft_tpu_torch.serve smoke")
    p.add_argument("--device", default=None,
                   help="torch device of the daemons and the reference (default: the card)")
    p.add_argument("--keep", action="store_true", help="keep the temporary directory")
    args = p.parse_args(argv)
    from raft_tpu_torch.core.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"raft_tpu_torch.serve smoke: {e}", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="raft_tpu_torch_serve_smoke_")
    obs_dir = os.path.join(tmp, "obs")
    sock1 = os.path.join(tmp, "serve1.sock")
    sock2 = os.path.join(tmp, "serve2.sock")
    try:
        # ---- the in-process reference (on the card: K1's library built
        # or loaded here, so neither child builds it) ----
        solo_rows = solo_reference(args.device)

        # ---- first daemon: serve, graceful SIGTERM (obs off: the
        # unarmed side of the overhead guard) ----
        proc1, ready1 = spawn_daemon(sock1, os.path.join(tmp, "daemon1.err"), args.device)
        rows1, full1, info1 = drive_stream(sock1)
        stats1 = full1["solver"]
        rc1 = stop_daemon(proc1)
        sock1_gone = not os.path.exists(sock1)

        # ---- restarted daemon, the obs layer armed ----
        proc2, ready2 = spawn_daemon(sock2, os.path.join(tmp, "daemon2.err"), args.device,
                                     obs_dir=obs_dir)
        rows2, full2, info2 = drive_stream(sock2)
        stats2 = full2["solver"]
        rc2 = stop_daemon(proc2)

        n_buckets = len(stats1["buckets"])
        checks = {
            "three_designs_two_buckets": n_buckets == 2,
            "responses_match_solo_bitwise": rows1 == solo_rows,
            "sigterm_graceful_rc0": rc1 == 0,
            "socket_unlinked": sock1_gone,
            "zero_compiles_both_children": (
                ready1["compiles_at_ready"] == ready2["compiles_at_ready"] == 0
                and stats1["compiles"] == stats2["compiles"] == 0),
            "restart_bitwise_identical": rows2 == rows1,
            "restart_rc0": rc2 == 0,
            # the instrumentation must not cost the serving loop real wall
            "armed_within_overhead_guard": info2["wall_s"] <= 2.0 * info1["wall_s"] + 0.5,
        }
        obs_checks = check_obs_leg(obs_dir, info2["traces"], info2, full2)
        checks.update({k: v for k, v in obs_checks.items() if isinstance(v, bool)})
        ok = all(checks.values())
        print(json.dumps({
            "ok": ok,
            **checks,
            **{k: v for k, v in obs_checks.items() if not isinstance(v, bool)},
            "device": ready1["device"],
            "n_requests": len(STREAM),
            "n_buckets": n_buckets,
            "ready_s": [ready1["ready_s"], ready2["ready_s"]],
            "compiles_at_ready": [ready1["compiles_at_ready"], ready2["compiles_at_ready"]],
            "stream_wall_unarmed_s": round(info1["wall_s"], 3),
            "stream_wall_armed_s": round(info2["wall_s"], 3),
            "bucket_stats": stats1["buckets"],
            "wall_s": round(time.perf_counter() - t_all, 2),
            **({"dir": tmp} if args.keep else {}),
        }))
        return 0 if ok else 1
    finally:
        if not args.keep:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":                                # pragma: no cover
    sys.exit(main())
