"""The port's solver daemon over a real socket, on the CPU: concurrent
clients, stats and refresh, a partial batch failure poisoning its whole
request, graceful shutdown, request-scoped traces across threads, exact
queue waits on a virtual clock, the SLO windows, and one run of
``python -m raft_tpu_torch.serve smoke --device cpu`` in a child process
(the cross-process proof: two daemon children, SIGTERM drain and restart,
bit-identical rows, the obs sinks)."""
import bisect
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from raft_tpu_torch.cli import DESIGNS
from raft_tpu_torch.serve.batcher import Lane
from raft_tpu_torch.serve.config import ServeConfig

ROOT = Path(__file__).resolve().parents[1]
OC4 = str(DESIGNS / "OC4semi.yaml")
SIZE = dict(nw=8, w_min=0.3, w_max=2.1, n_iter=8, escalate=False, device="cpu")


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeConn:
    def __init__(self):
        self.sent = []

    def send(self, obj):
        self.sent.append(obj)
        return True


@pytest.fixture(autouse=True)
def _cache_disabled_after():
    """The daemon's entry (``serve.__main__._daemon``) enables the port's
    cache for its process; each test disables it again, so a later test in
    the same process resolves its own cache root."""
    yield
    from raft_tpu_torch import cache

    cache.disable()


@pytest.fixture()
def server(tmp_path):
    from raft_tpu_torch.serve.server import SolverServer

    cfg = ServeConfig(batch_deadline_s=0.02, batch_max=3,
                      socket_path=str(tmp_path / "serve.sock"), **SIZE)
    srv = SolverServer(cfg)
    srv.start()
    yield srv
    srv.stop()


def test_two_clients_concurrent_submit(server):
    from raft_tpu_torch.serve.client import SolveClient

    sock = server.socket_path
    results = {}
    errors = []

    def client_run(name, Hs):
        try:
            with SolveClient(sock) as cl:
                futs = [cl.submit({"op": "solve", "design": "oc3", "Hs": Hs + 0.5 * j,
                                   "Tp": 10.0}) for j in range(3)]
                dlc = cl.submit({"op": "dlc", "design": "oc3",
                                 "cases": [[Hs, 10.0], [Hs + 1.0, 12.0]]})
                results[name] = [f.result(180.0) for f in futs] + [dlc.result(180.0)]
        except Exception as e:          # surfaced by the join below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    t1 = threading.Thread(target=client_run, args=("c1", 6.0))
    t2 = threading.Thread(target=client_run, args=("c2", 8.0))
    t1.start()
    t2.start()
    t1.join(300)
    t2.join(300)
    assert not errors, errors
    assert set(results) == {"c1", "c2"}
    for rs in results.values():
        for r in rs[:3]:
            assert r["ok"], r
            assert len(r["results"]) == 1 and r["results"][0]["converged"]
        dlc = rs[3]
        assert dlc["ok"] and len(dlc["results"]) == 2 and len(dlc["t_queue_s"]) == 2
    # distinct sea states give distinct rows (no cross-request mixing)
    assert results["c1"][0]["results"][0]["std_dev"] != results["c2"][0]["results"][0]["std_dev"]


def test_served_rows_equal_solo_rows(server):
    """A dlc and a sweep request's rows, batched among each other, equal
    each lane's solo row bit for bit."""
    from raft_tpu_torch.serve import protocol
    from raft_tpu_torch.serve.client import SolveClient
    from raft_tpu_torch.serve.solver import solve_solo

    cases = [[6.0, 10.0], [7.0, 11.0], [8.0, 12.0], [9.0, 13.0]]
    with SolveClient(server.socket_path) as cl:
        f_dlc = cl.submit({"op": "dlc", "design": "volturnus", "cases": cases})
        f_sw = cl.submit({"op": "sweep", "designs": ["oc3", "oc4", "volturnus"],
                          "Hs": 6.0, "Tp": 10.0})
        dlc, sw = f_dlc.result(180.0), f_sw.result(180.0)
    assert dlc["ok"] and sw["ok"]
    volt, _ = protocol.resolve_design("volturnus")
    for row, (Hs, Tp) in zip(dlc["results"], cases):
        assert row["std_dev"] == solve_solo(server.core, volt, Hs, Tp)["std_dev"]
    for row, alias in zip(sw["results"], ["oc3", "oc4", "volturnus"]):
        assert row["std_dev"] == solve_solo(server.core, protocol.resolve_design(alias)[0],
                                            6.0, 10.0)["std_dev"]


def test_server_stats_refresh_and_bad_request(server):
    from raft_tpu_torch.serve.client import SolveClient

    with SolveClient(server.socket_path) as cl:
        assert cl.ping()["ok"]
        r = cl.solve("oc3", 6.0, 10.0)
        assert r["ok"]
        st = cl.stats()
        assert st["ok"] and st["solver"]["buckets"]
        assert st["solver"]["batch_max"] == 3 and st["solver"]["compiles"] == 0
        # malformed request: error response, connection stays usable
        bad = cl.call({"op": "solve", "design": "mystery", "Hs": 6, "Tp": 10})
        assert not bad["ok"] and "mystery" in bad["error"]["detail"]
        assert cl.ping()["ok"]
        rf = cl.call({"op": "refresh", "deadline_ms": 5, "batch_max": 2})
        assert rf["ok"] and rf["batch_max"] == 2 and rf["staged_lanes_dropped"] >= 1
        assert rf["executables_evicted"] >= 0
        assert server.batcher.batch_max == 2
        assert server.core.config.batch_max == 2
        r2 = cl.solve("oc3", 6.0, 10.0)      # the new capacity still solves
        assert r2["ok"]


def test_partial_batch_failure_poisons_whole_request(server, monkeypatch):
    """A sweep spanning two buckets where one bucket's batch fails answers
    ok:false, never ok:true with null rows for the failed lanes."""
    from raft_tpu_torch.serve import server as server_mod
    from raft_tpu_torch.serve.client import SolveClient

    real = server_mod.solve_batch
    oc4_sig = server.core.stage_lane(OC4, 6.0, 10.0)[0]

    def flaky(core, sig, lanes):
        if sig == oc4_sig:
            raise RuntimeError("injected bucket failure")
        return real(core, sig, lanes)

    monkeypatch.setattr(server_mod, "solve_batch", flaky)
    with SolveClient(server.socket_path) as cl:
        r = cl.call({"op": "sweep", "designs": ["oc3", "oc4"], "Hs": 6.0, "Tp": 10.0},
                    timeout=180.0)
        assert not r["ok"]
        assert "injected bucket failure" in r["error"]["detail"]
        ok = cl.solve("oc3", 6.0, 10.0, timeout=180.0)
        assert ok["ok"] and ok["results"][0]["converged"]
    assert server.flight.counts()["errors"] >= 1
    bad = [rec for rec in server.flight.snapshot() if rec["outcome"].startswith("error:")]
    assert bad and bad[0]["op"] == "sweep"
    assert server.telemetry()["error_budget"]["errors"] >= 1


def test_refresh_rejects_malformed_values(server):
    from raft_tpu_torch.serve.client import SolveClient

    with SolveClient(server.socket_path) as cl:
        r = cl.call({"op": "refresh", "deadline_ms": "abc"})
        assert not r["ok"] and r["error"]["class"] == "ValueError"
        r2 = cl.call({"op": "refresh", "batch_max": 0})
        assert not r2["ok"]
        assert cl.ping()["ok"]
        assert server.batcher.batch_max == 3


def test_shutdown_op_drains(tmp_path):
    from raft_tpu_torch.serve.client import SolveClient
    from raft_tpu_torch.serve.server import SolverServer

    cfg = ServeConfig(batch_deadline_s=0.02, batch_max=2, socket_path=str(tmp_path / "s.sock"),
                      **SIZE)
    srv = SolverServer(cfg)
    srv.start()
    with SolveClient(cfg.socket_path) as cl:
        fut = cl.submit({"op": "solve", "design": "oc3", "Hs": 6.0, "Tp": 10.0})
        assert cl.shutdown()["ok"]
        r = fut.result(180.0)            # the queued request is answered
        assert r["ok"] and r["results"][0]["converged"]
    assert srv.wait(60.0)
    deadline = time.monotonic() + 10.0
    while os.path.exists(cfg.socket_path) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not os.path.exists(cfg.socket_path)


def test_request_trace_tree_spans_client_reader_solver(server, tmp_path):
    """One request's spans, recorded on the client reader thread, the
    server's connection reader and the solver loop, share one trace id,
    form one path tree, and the exported Chrome trace passes the JAX
    package's Perfetto containment validator."""
    from raft_tpu.obs.smoke import _validate_chrome_trace
    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.serve.client import SolveClient
    from raft_tpu_torch.serve.smoke import check_chrome_trace

    trace.reset()
    with SolveClient(server.socket_path) as cl:
        r = cl.solve("oc3", 6.0, 10.0, timeout=180.0)
    assert r["ok"]
    tid = r["trace"]
    assert tid
    spans = [s for s in trace.spans() if s.trace == tid]
    paths = {s.name for s in spans}
    assert {"request", "request/server", "request/server/stage",
            "request/server/queue_wait", "request/server/solve"} <= paths
    assert len({s.tid for s in spans}) >= 3
    by = {s.name: s for s in spans}
    root = by["request"]
    for name in ("request/server", "request/server/queue_wait", "request/server/solve"):
        s = by[name]
        assert root.t0_us <= s.t0_us
        assert s.t0_us + s.dur_us <= root.t0_us + root.dur_us
    p = tmp_path / "trace.json"
    p.write_text(json.dumps(trace.chrome_trace()))
    assert _validate_chrome_trace(str(p))["events"] >= 5
    assert check_chrome_trace(str(p)) >= 5


def test_queue_wait_exact_under_virtual_clock(tmp_path):
    """Queue wait is exactly batch close minus submit on the batcher's
    clock: the response's t_queue_s, the flight record and the windowed
    SLO quantiles are hand-computable from a virtual schedule."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.serve import server as server_mod

    clk = VirtualClock()
    cfg = ServeConfig(batch_deadline_s=1.0, batch_max=4, nw=8, device="cpu",
                      socket_path=str(tmp_path / "x.sock"))
    srv = server_mod.SolverServer(cfg, clock=clk)   # never started
    conn = _FakeConn()
    clk.t = 5.0
    pend = server_mod._PendingRequest(conn, "r1", 2, clk, op="dlc", trace="t-virt")
    lanes = [Lane(request_id=pend, seq=0, label="a", staged=None, trace="t-virt", t_submit=6.0),
             Lane(request_id=pend, seq=1, label="b", staged=None, trace="t-virt", t_submit=6.5)]
    clk.t = 7.25
    srv._deliver(lanes, [{"lane": 0}, {"lane": 1}], 7.25)
    resp = conn.sent[0]
    assert resp["ok"] and resp["trace"] == "t-virt"
    assert resp["t_queue_s"] == [1.25, 0.75]
    assert resp["t_total_s"] == 2.25
    rec = srv.flight.snapshot()[0]
    assert rec["queue_wait_s"] == [1.25, 0.75]
    assert rec["outcome"] == "ok" and rec["trace"] == "t-virt"
    win = srv._slo_latency.window(now=clk.t)
    edges = metrics.Histogram.edges
    expect = edges[bisect.bisect_left(edges, 2.25)]
    assert win["count"] == 1
    assert win["p50"] == win["p99"] == pytest.approx(expect, rel=1e-5)
    tel = srv.telemetry()
    assert tel["error_budget"] == {"requests": 1, "errors": 0, "error_rate": 0.0}
    assert tel["latency"]["count"] == 1
    assert tel["flight"]["recorded"] == 1


def test_fail_batch_answers_once_per_request(tmp_path):
    """_fail_batch poisons each request once its last lane lands: the error
    frame goes out once and the error budget counts it."""
    from raft_tpu_torch.serve import server as server_mod

    clk = VirtualClock()
    srv = server_mod.SolverServer(ServeConfig(device="cpu", socket_path=str(tmp_path / "f")),
                                  clock=clk)
    conn = _FakeConn()
    pend = server_mod._PendingRequest(conn, "r9", 2, clk, op="sweep", trace="t-f")
    lanes = [Lane(request_id=pend, seq=i, label="x", staged=None, trace="t-f")
             for i in range(2)]
    srv._fail_batch(lanes[:1], RuntimeError("first bucket"))
    assert conn.sent == []                 # one lane still owed
    srv._deliver(lanes[1:], [{"lane": 1}], 0.0)
    assert len(conn.sent) == 1 and not conn.sent[0]["ok"]
    assert "first bucket" in conn.sent[0]["error"]["detail"]
    assert srv.telemetry()["error_budget"] == {"requests": 1, "errors": 1, "error_rate": 1.0}


def test_stats_op_returns_telemetry_block(server):
    from raft_tpu_torch.serve.client import SolveClient

    with SolveClient(server.socket_path) as cl:
        assert cl.solve("oc3", 6.0, 10.0, timeout=180.0)["ok"]
        st = cl.stats()
    tel = st["telemetry"]
    assert {"uptime_s", "window_s", "latency", "queue_wait", "occupancy", "queue_depth",
            "error_budget", "compiles", "flight", "ledger", "cache_enabled"} <= set(tel)
    assert "kernel_builds" not in tel and tel["compiles"] == 0
    assert {"dir", "pending", "n_entries"} <= set(tel["ledger"])
    lat = tel["latency"]
    assert lat["count"] >= 1 and 0 < lat["p50"] <= lat["p99"]
    assert lat["error_rate"] == 0.0
    assert tel["error_budget"]["requests"] >= 1
    assert tel["queue_wait"]
    for w in tel["queue_wait"].values():
        assert {"count", "p50", "p99", "error_rate"} <= set(w)
    assert tel["flight"]["recorded"] >= 1


def test_reset_telemetry_is_a_window_boundary(tmp_path):
    from raft_tpu_torch.serve import server as server_mod

    clk = VirtualClock()
    srv = server_mod.SolverServer(ServeConfig(device="cpu", socket_path=str(tmp_path / "y")),
                                  clock=clk)
    srv._slo_latency.observe(0.1, now=0.0)
    with srv._lock:
        srv._req_done = 5
    srv.reset_telemetry()
    assert srv._slo_latency.window(now=0.0)["count"] == 0
    assert srv.telemetry()["error_budget"]["requests"] == 0


def test_warmup_solves_one_batch_per_bucket(tmp_path):
    from raft_tpu_torch.serve.server import SolverServer

    srv = SolverServer(ServeConfig(batch_max=2, socket_path=str(tmp_path / "w"), **SIZE))
    info = srv.warmup(["oc3", "oc4", "volturnus"])
    assert len(info) == 2 and all(v == {"lanes": 1, "capacity": 2} for v in info.values())
    assert sum(b["batches"] for b in srv.core.stats()["buckets"].values()) == 2


def test_loadgen_schedule_and_quantile_match_jax():
    from raft_tpu.serve import loadgen as jloadgen
    from raft_tpu_torch.serve import loadgen

    a = [loadgen.schedule(i, 50.0) for i in range(40)]
    assert a == [jloadgen.schedule(i, 50.0) for i in range(40)]
    assert {d for d, *_ in a} == set(loadgen.DEFAULT_DESIGNS)
    assert a[0][3] == 0.0 and a[10][3] == pytest.approx(0.2)
    assert [loadgen.schedule(i, 400.0, n_hs=2, n_tp=1) for i in range(48)] == \
        [jloadgen.schedule(i, 400.0, n_hs=2, n_tp=1) for i in range(48)]
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    for q in (0.0, 0.5, 0.99):
        assert loadgen.quantile(xs, q) == jloadgen.quantile(xs, q)
    assert loadgen.quantile([7.0], 0.99) == 7.0


def test_loadgen_open_loop_and_sequential(server):
    from raft_tpu_torch.serve import loadgen
    from raft_tpu_torch.serve.client import SolveClient

    with SolveClient(server.socket_path) as cl:
        summ, resps = loadgen.run_open_loop(cl, 6, rate=200.0, n_hs=2, n_tp=1)
        seq = loadgen.run_sequential(cl, 6, rate=200.0, n_hs=2, n_tp=1)
    assert summ["n_requests"] == seq["n_requests"] == 6 and len(resps) == 6
    assert summ["mode"] == "open_loop" and seq["mode"] == "sequential"
    assert 0 < summ["latency_p50_s"] <= summ["latency_p99_s"]
    assert summ["solves_per_s"] > 0 and seq["solves_per_s"] > 0


@pytest.mark.parametrize("full_width", [True, False])
def test_daemon_flags_and_smoke_widths(monkeypatch, full_width):
    """The daemon's unset width flags leave ``ServeConfig``'s defaults (the
    JAX daemon's) in force, so a full-width child gets no width flags; the
    smoke's small configuration reaches the config flag by flag; the
    daemon serves float64 only (no ``--dtype``)."""
    from raft_tpu_torch.serve import __main__ as serve_main
    from raft_tpu_torch.serve import server as server_mod
    from raft_tpu_torch.serve import smoke

    for k in ("RAFT_TPU_SERVE_BATCH_DEADLINE_MS", "RAFT_TPU_SERVE_BATCH_MAX",
              "RAFT_TPU_SERVE_SOCKET"):
        monkeypatch.delenv(k, raising=False)
    seen = []

    def refuse(cfg, socket_path=None):
        seen.append(cfg)
        raise RuntimeError("stop before serving")

    monkeypatch.setattr(server_mod, "SolverServer", refuse)
    args = smoke.serve_args("cpu", full_width)
    assert ("--nw" in args) is not full_width and args[-2:] == ["--device", "cpu"]
    assert serve_main._daemon(args) == 2
    want = (ServeConfig.from_env(device="cpu") if full_width else
            ServeConfig.from_env(device="cpu", nw=smoke.NW, n_iter=smoke.N_ITER,
                                 batch_max=smoke.BATCH_MAX,
                                 batch_deadline_s=smoke.DEADLINE_MS / 1e3))
    assert seen == [want]
    assert (want.nw, want.n_iter, want.batch_max) == ((100, 25, 8) if full_width else (16, 12, 4))
    assert want.dtype == torch.float64
    with pytest.raises(SystemExit):
        serve_main._daemon(["--dtype", "float32", "--device", "cpu"])


def test_serve_smoke_child_process_cpu():
    """``python -m raft_tpu_torch.serve smoke --device cpu``: the
    cross-process proof passes and prints one JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.serve", "smoke",
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True and out["device"] == "cpu"
    assert out["compiles_at_ready"] == [0, 0]
    assert out["responses_match_solo_bitwise"] and out["restart_bitwise_identical"]
    assert out["per_request_span_trees"] and out["flight_dump_on_sigterm"]
