"""The port's fault-tolerant serving fleet: config snapshot,
deterministic routing/admission on a virtual clock, failover resubmission
with bit-identical rows and trace continuity, shed-then-recover, the
supervisor's restart-storm bound, and the client's typed failures (the
tests of ``tests/test_fleet.py``, against ``raft_tpu_torch.serve``).

The robustness contract under test:

* routing is a pure function of replica state — bucket affinity by
  design label, least-loaded (ties -> lowest index) on a miss, re-pin
  when the pinned replica is down or saturated;
* admission is deterministic: capacity (``queue_max x healthy``) and the
  windowed error budget shed with the typed ``Overloaded`` frame, and
  the budget recovers as the window slides (virtual clock);
* a request orphaned by a replica death is resubmitted to a survivor
  and answered EXACTLY once, with the original trace id and rows
  bit-identical to an uninterrupted run (solves are pure);
* the supervisor restarts dead children at most ``restart_max`` times
  per ``restart_window_s`` sliding window, visibly suppressed beyond.

The cross-process half (real daemon children, SIGKILL mid-stream,
restarts with zero kernel builds) is ``python -m raft_tpu_torch.serve
fleet-smoke``; these tests pin the same machinery deterministically
in-process.  The re-admission test drives ``probe_once`` on scripted
links and the injectable clock, with no sleeps and no reader race.
"""
import os
import socket
import threading
import time

import pytest

from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.resilience import faults
from raft_tpu_torch.serve import protocol
from raft_tpu_torch.serve.client import (ServeConnectionLost, ServeTimeout,
                                         SolveClient)
from raft_tpu_torch.serve.fleet import Fleet, FleetConfig
from raft_tpu_torch.serve.router import FleetRouter


class VirtualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _counter(name):
    return obs_metrics.counter(f"fleet.{name}").value


def _mk_router(tmp_path, clock=None, replicas=2, injector=None, **cfg_kw):
    """A router over nonexistent replica sockets (the unit tests drive
    its state directly; nothing is started unless the test says so)."""
    cfg_kw.setdefault("probe_interval_s", 0.0)
    cfg = FleetConfig(replicas=replicas, **cfg_kw)
    paths = [str(tmp_path / f"r{i}.sock") for i in range(replicas)]
    return FleetRouter(cfg, paths, socket_path=str(tmp_path / "front.sock"),
                       clock=clock or VirtualClock(), injector=injector,
                       sleep=lambda s: None)


def _mark_up(router, *idxs):
    class _NullLink:
        def send(self, obj):
            return True

        def close(self):
            pass

    for i in idxs:
        st = router._replicas[i]
        st.healthy = True
        st.link = _NullLink()


# --------------------------------------------------------------------------
# FleetConfig: env snapshot, overrides, loud failures
# --------------------------------------------------------------------------
def test_fleet_config_defaults_and_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("RAFT_TPU_FLEET_"):
            monkeypatch.delenv(k)
    cfg = FleetConfig.from_env()
    assert (cfg.replicas, cfg.queue_max) == (2, 32)
    assert cfg.probe_interval_s == pytest.approx(0.5)
    monkeypatch.setenv("RAFT_TPU_FLEET_REPLICAS", "4")
    monkeypatch.setenv("RAFT_TPU_FLEET_PROBE_MS", "250")
    monkeypatch.setenv("RAFT_TPU_FLEET_QUEUE_MAX", "7")
    monkeypatch.setenv("RAFT_TPU_FLEET_SHED_ERROR_RATE", "0.25")
    monkeypatch.setenv("RAFT_TPU_FLEET_RESTART_MAX", "5")
    monkeypatch.setenv("RAFT_TPU_FLEET_SOCKET", "/tmp/fleet-test.sock")
    cfg = FleetConfig.from_env()
    assert cfg.replicas == 4
    assert cfg.probe_interval_s == pytest.approx(0.25)
    assert cfg.queue_max == 7
    assert cfg.shed_error_rate == pytest.approx(0.25)
    assert cfg.restart_max == 5
    assert cfg.socket_path == "/tmp/fleet-test.sock"
    # explicit overrides (CLI flags, fixtures) win over the environment
    assert FleetConfig.from_env(replicas=1).replicas == 1


def test_fleet_config_malformed_is_loud(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FLEET_REPLICAS", "two")
    with pytest.raises(ValueError, match="RAFT_TPU_FLEET_REPLICAS"):
        FleetConfig.from_env()
    monkeypatch.delenv("RAFT_TPU_FLEET_REPLICAS")
    monkeypatch.setenv("RAFT_TPU_FLEET_SHED_ERROR_RATE", "1.5")
    with pytest.raises(ValueError, match="SHED_ERROR_RATE"):
        FleetConfig.from_env()
    monkeypatch.delenv("RAFT_TPU_FLEET_SHED_ERROR_RATE")
    with pytest.raises(ValueError, match="REPLICAS"):
        FleetConfig.from_env(replicas=0)


# --------------------------------------------------------------------------
# counted replica faults (the chaos hand the router/smoke drive)
# --------------------------------------------------------------------------
def test_replica_fault_kinds_counted(monkeypatch):
    assert {"kill_replica", "stall_replica",
            "refuse_connect"} <= faults.KINDS
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT",
                       "kill_replica:2,stall_replica:1,refuse_connect:1")
    faults.reset_counts()
    try:
        assert faults.consume("kill_replica")
        assert faults.consume("kill_replica")
        assert not faults.consume("kill_replica")   # exactly K
        assert faults.consume("stall_replica")
        assert not faults.consume("stall_replica")
        assert faults.consume("refuse_connect")
        assert not faults.consume("refuse_connect")
    finally:
        faults.reset_counts()


def test_unknown_fault_kind_warns(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "explode_rack:1")
    with pytest.warns(UserWarning, match="explode_rack"):
        assert faults.specs() == {}


# --------------------------------------------------------------------------
# routing: affinity + least-loaded, pure function of replica state
# --------------------------------------------------------------------------
def test_pick_least_loaded_then_affinity_pins(tmp_path):
    r = _mk_router(tmp_path)
    _mark_up(r, 0, 1)
    with r._lock:
        assert r._pick_locked("OC3spar").idx == 0     # tie -> lowest idx
        r._replicas[0].inflight = 3
        assert r._pick_locked("OC4semi").idx == 1     # least loaded
        # the pin follows even when loads later invert
        r._replicas[1].inflight = 9
        assert r._pick_locked("OC4semi").idx == 1
    assert r.telemetry()["affinity"] == {"OC3spar": 0, "OC4semi": 1}


def test_pick_repins_on_saturation_and_death(tmp_path):
    r = _mk_router(tmp_path, queue_max=2)
    _mark_up(r, 0, 1)
    with r._lock:
        assert r._pick_locked("OC3spar").idx == 0
        r._replicas[0].inflight = 2                   # == queue_max
        assert r._pick_locked("OC3spar").idx == 1     # saturated -> re-pin
        assert r._affinity["OC3spar"] == 1
        r._replicas[1].healthy = False                # pinned replica dies
        r._replicas[0].inflight = 0
        assert r._pick_locked("OC3spar").idx == 0
        r._replicas[0].healthy = False
        assert r._pick_locked("OC3spar") is None      # nobody left


# --------------------------------------------------------------------------
# admission: capacity + windowed error budget on a virtual clock
# --------------------------------------------------------------------------
def test_admission_capacity_and_recovery(tmp_path):
    clk = VirtualClock()
    r = _mk_router(tmp_path, clock=clk, queue_max=2)
    assert "no healthy replica" in r._admit()
    _mark_up(r, 0, 1)
    assert r._admit() is None
    r._replicas[0].inflight = 2
    r._replicas[1].inflight = 2                       # 4 == 2 x 2 healthy
    assert "capacity" in r._admit()
    r._replicas[1].inflight = 1
    assert r._admit() is None                         # headroom again
    r._replicas[1].healthy = False                    # 3 > 2 x 1 healthy
    assert "capacity" in r._admit()


def test_admission_error_budget_sheds_then_recovers(tmp_path):
    clk = VirtualClock(t=100.0)
    r = _mk_router(tmp_path, clock=clk, shed_error_rate=0.5,
                   shed_min_events=8)
    _mark_up(r, 0)
    # 7 errors: below min events, the budget must NOT latch shut
    for _ in range(7):
        r._slo.error(now=clk.t)
    assert r._admit() is None
    r._slo.error(now=clk.t)                           # 8th: rate 1.0 > 0.5
    reason = r._admit()
    assert reason is not None and "error budget" in reason
    # successes dilute the windowed rate back under the threshold
    for _ in range(9):
        r._slo.observe(0.01, now=clk.t)
    assert r._admit() is None
    # ... and a slid window forgets entirely (shed-then-recover)
    for _ in range(16):
        r._slo.error(now=clk.t)
    assert "error budget" in r._admit()
    clk.t += 2 * r.slo_window_s
    assert r._admit() is None


def test_overloaded_response_is_typed():
    resp = protocol.overloaded_response("req-1", 50.0, detail="capacity")
    assert resp["ok"] is False and resp["shed"] is True
    assert resp["id"] == "req-1"
    assert resp["retry_after_ms"] == 50.0
    assert resp["error"]["class"] == "Overloaded"
    assert "capacity" in resp["error"]["detail"]


# --------------------------------------------------------------------------
# forward deadline: an expired in-flight request fails over (virtual clock)
# --------------------------------------------------------------------------
def test_probe_once_expires_overdue_forwards(tmp_path):
    clk = VirtualClock()
    r = _mk_router(tmp_path, clock=clk, request_timeout_s=5.0,
                   resubmit_retries=1, resubmit_backoff_s=0.0)
    # a stalled-but-pingable replica: heartbeats pass, the frame never
    # comes back — exactly the hole the forward deadline exists to plug
    r._probe = lambda st: True

    class _Conn:
        def __init__(self):
            self.sent = []

        def send(self, obj):
            self.sent.append(obj)
            return True

    _mark_up(r, 0)
    conn = _Conn()
    r._dispatch(conn, {"op": "solve", "id": "x", "trace": "t-1",
                       "lanes": [("d", "OC3spar", 6.0, 10.0)]},
                {"op": "solve", "id": "x", "design": "oc3",
                 "Hs": 6.0, "Tp": 10.0})
    assert r._replicas[0].inflight == 1
    c_to = _counter("timeouts")
    c_re = _counter("resubmitted")
    clk.t = 4.0
    assert r.probe_once()["expired"] == 0             # not overdue yet
    clk.t = 6.0
    summary = r.probe_once()
    assert summary["expired"] == 1
    assert _counter("timeouts") - c_to == 1
    # the replica is still in rotation, so the expired forward is
    # RESUBMITTED (re-registered, resubmits bumped), not failed
    assert _counter("resubmitted") - c_re == 1
    assert conn.sent == []
    (fwd,) = r._replicas[0].outstanding.values()
    assert fwd.resubmits == 1
    # now the only replica is gone too: the ladder exhausts and the
    # client is answered LOUDLY with a typed error frame, never dropped
    with r._lock:
        r._replicas[0].healthy = False
        r._replicas[0].link = None
    clk.t = 12.0
    assert r.probe_once()["expired"] == 1
    assert len(conn.sent) == 1
    assert conn.sent[0]["ok"] is False and conn.sent[0]["id"] == "x"
    assert r._replicas[0].outstanding == {}


# --------------------------------------------------------------------------
# scripted replicas: live failover, trace continuity, shed-then-recover
# --------------------------------------------------------------------------
class FakeReplica:
    """Scripted stand-in for a daemon child: answers the admission ping,
    then echoes solve frames with a deterministic per-replica payload.
    ``hold()`` parks responses (a busy replica); ``die()`` is a real
    mid-stream death — path unlinked, accepted streams torn down — which
    is what makes the router's link reader see EOF (closing only the
    listener would leave kernel-backlogged connects alive)."""

    def __init__(self, path, tag):
        self.path = path
        self.tag = tag
        self.seen = []                       # (fid, trace) per solve frame
        self._release = threading.Event()
        self._release.set()
        self._conns = []
        self._ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._ls.bind(path)
        self._ls.listen(8)
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._ls.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                obj = protocol.recv_msg(conn)
                if obj.get("op") in ("ping", "stats", "refresh"):
                    protocol.send_msg(conn, {"id": obj.get("id"),
                                             "ok": True, "op": obj["op"]})
                    continue
                self.seen.append((obj.get("id"), obj.get("trace")))
                self._release.wait(30.0)
                protocol.send_msg(conn, {
                    "id": obj.get("id"), "ok": True, "op": "solve",
                    "results": [{"design": obj.get("design"),
                                 "std_dev": [self.tag] * 6}]})
        except (protocol.PeerClosed, protocol.ProtocolError, OSError):
            pass

    def hold(self):
        self._release.clear()

    def release(self):
        self._release.set()

    def die(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        self._ls.close()


@pytest.fixture()
def fake_fleet(tmp_path):
    """A started router over two scripted replicas (no probe thread; the
    tests drive health sweeps explicitly)."""
    cfg = FleetConfig(replicas=2, probe_interval_s=0.0,
                      resubmit_backoff_s=0.0)
    paths = [str(tmp_path / "fr0.sock"), str(tmp_path / "fr1.sock")]
    reps = [FakeReplica(paths[i], tag=float(i)) for i in range(2)]
    router = FleetRouter(cfg, paths,
                         socket_path=str(tmp_path / "front.sock"))
    router.start()
    yield router, reps
    router.stop()
    for rep in reps:
        rep.die()


def test_routed_end_to_end_with_affinity_split(fake_fleet):
    router, reps = fake_fleet
    with SolveClient(router.socket_path) as cl:
        for rep in reps:
            rep.hold()
        # dispatch is sequential on the client's conn reader, so the
        # second label sees the first's in-flight and splits off — but
        # only release once BOTH frames have landed on a replica, else
        # the first relay drains the in-flight count mid-routing
        f_a = cl.submit({"op": "solve", "design": "oc3",
                         "Hs": 6.0, "Tp": 10.0})
        f_b = cl.submit({"op": "solve", "design": "oc4",
                         "Hs": 6.0, "Tp": 10.0})
        deadline = time.monotonic() + 5.0
        while (len(reps[0].seen) + len(reps[1].seen) < 2
               and time.monotonic() < deadline):
            time.sleep(0.005)
        for rep in reps:
            rep.release()
        ra, rb = f_a.result(10.0), f_b.result(10.0)
    assert (ra["replica"], rb["replica"]) == (0, 1)
    assert ra["results"][0]["std_dev"] == [0.0] * 6
    assert rb["results"][0]["std_dev"] == [1.0] * 6
    tel = router.telemetry()
    assert tel["affinity"] == {"OC3spar": 0, "OC4semi": 1}
    assert tel["replicas"][0]["heat"] == {"OC3spar": 1}


def test_failover_answers_once_with_original_trace(fake_fleet):
    router, reps = fake_fleet
    c0 = {k: _counter(k) for k in ("failover", "resubmitted", "relayed")}
    with SolveClient(router.socket_path) as cl:
        # pin the label to replica 0, then kill it with the request in
        # flight: the link EOF must fail the request over to replica 1
        reps[0].hold()
        fut = cl.submit({"op": "solve", "design": "oc3",
                         "Hs": 6.0, "Tp": 10.0, "trace": "t-abc"})
        deadline = time.monotonic() + 5.0
        while (not reps[0].seen) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert reps[0].seen, "request never reached replica 0"
        reps[0].die()
        resp = fut.result(10.0)
    assert resp["ok"] is True
    assert resp["replica"] == 1
    assert resp["resubmits"] == 1
    # exactly once: replica 0 never answered, replica 1 answered once
    assert [t for _, t in reps[1].seen] == ["t-abc"]   # trace continuity
    assert _counter("failover") - c0["failover"] == 1
    assert _counter("resubmitted") - c0["resubmitted"] == 1
    assert _counter("relayed") - c0["relayed"] == 1
    # the dead replica is out of rotation until re-admitted
    assert router.telemetry()["healthy"] == 1


def test_shed_then_recover_under_load_step(tmp_path):
    cfg = FleetConfig(replicas=1, probe_interval_s=0.0, queue_max=1,
                      resubmit_backoff_s=0.0)
    path = str(tmp_path / "sr0.sock")
    rep = FakeReplica(path, tag=7.0)
    router = FleetRouter(cfg, [path],
                         socket_path=str(tmp_path / "front.sock"))
    router.start()
    try:
        c0 = _counter("shed")
        with SolveClient(router.socket_path) as cl:
            rep.hold()                     # wedge the replica mid-request
            first = cl.submit({"op": "solve", "design": "oc3",
                               "Hs": 6.0, "Tp": 10.0})
            burst = [cl.submit({"op": "solve", "design": "oc3",
                                "Hs": 6.0 + i, "Tp": 10.0})
                     for i in range(3)]
            shed = [f.result(10.0) for f in burst]
            # the step over capacity sheds DETERMINISTICALLY: typed
            # frames with a retry hint, nothing queued unboundedly
            assert all(r["ok"] is False and r["shed"] is True
                       and r["error"]["class"] == "Overloaded"
                       and r["retry_after_ms"] > 0 for r in shed)
            assert _counter("shed") - c0 == 3
            rep.release()                  # load step passes
            assert first.result(10.0)["ok"] is True
            redo = [cl.call({"op": "solve", "design": "oc3",
                             "Hs": 6.0 + i, "Tp": 10.0}, timeout=10.0)
                    for i in range(3)]
            assert all(r["ok"] for r in redo)   # degrade, never lose
    finally:
        router.stop()
        rep.die()


def test_dead_replica_readmitted_by_probe(tmp_path):
    """A replica that fails its heartbeat is marked down, its in-flight
    forward fails over to the survivor, admission stays refused while it
    is unreachable, and the next passing probe re-admits it.  Driven by
    ``probe_once`` on scripted links and the virtual clock: no sleeps, and
    no link reader racing the probe for the same state flip."""
    import socket as _socket

    clk = VirtualClock()
    r = _mk_router(tmp_path, clock=clk, resubmit_retries=1, resubmit_backoff_s=0.0)
    _mark_up(r, 0, 1)
    alive = {0: True, 1: True}
    r._probe = lambda st: alive[st.idx]
    peers = []

    def connect(st):
        if not alive[st.idx]:
            raise ConnectionRefusedError(f"replica {st.idx} is down")
        a, b = _socket.socketpair()
        peers.append(b)
        return a

    r._connect_link = connect

    class _Conn:
        def __init__(self):
            self.sent = []

        def send(self, obj):
            self.sent.append(obj)
            return True

    conn = _Conn()
    c_fail = _counter("failover")
    r._dispatch(conn, {"op": "solve", "id": "x", "trace": "t-r",
                       "lanes": [("d", "OC3spar", 6.0, 10.0)]},
                {"op": "solve", "id": "x", "design": "oc3", "Hs": 6.0, "Tp": 10.0})
    assert list(r._replicas[0].outstanding) and not r._replicas[1].outstanding
    try:
        alive[0] = False                       # the replica dies
        clk.t = 1.0
        assert r.probe_once() == {"expired": 0, "failed": [0], "admitted": []}
        assert r.telemetry()["healthy"] == 1
        assert _counter("failover") - c_fail == 1
        (fwd,) = r._replicas[1].outstanding.values()      # failed over
        assert fwd.resubmits == 1 and fwd.trace == "t-r"
        clk.t = 2.0                            # still down: not re-admitted
        assert r.probe_once() == {"expired": 0, "failed": [], "admitted": []}
        alive[0] = True                        # back on its original socket
        clk.t = 3.0
        assert r.probe_once() == {"expired": 0, "failed": [], "admitted": [0]}
        tel = r.telemetry()
        assert tel["healthy"] == 2
        assert tel["replicas"][0]["admissions"] == 1
        assert conn.sent == []                 # nothing answered twice
    finally:
        r.stop()
        for p in peers:
            p.close()


def test_refuse_connect_blocks_readmission(fake_fleet, monkeypatch):
    router, reps = fake_fleet
    reps[0].die()
    router.probe_once()
    reps[0] = FakeReplica(router._replicas[0].socket_path, tag=0.5)
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "refuse_connect:3")
    faults.reset_counts()
    try:
        # all 3 connect attempts of the admission ladder are refused:
        # the replica stays OUT of rotation (never half-admitted)
        assert router.probe_once()["admitted"] == []
        assert router.telemetry()["healthy"] == 1
    finally:
        monkeypatch.delenv("RAFT_TPU_FAULT_INJECT")
        faults.reset_counts()
    assert router.probe_once()["admitted"] == [0]


# --------------------------------------------------------------------------
# real solver: bit-identical rows across replicas and across a failover
# --------------------------------------------------------------------------
def test_failover_rows_bit_identical_real_solver(tmp_path, monkeypatch):
    """Rows are BIT-identical whichever replica solves the lane, and a
    failover mid-flight (stalled forward -> replica failed -> resubmitted
    to the survivor) answers with those same bits."""
    from raft_tpu_torch.serve.config import ServeConfig
    from raft_tpu_torch.serve.server import SolverServer

    servers = []
    for i in range(2):
        cfg = ServeConfig(batch_deadline_s=0.02, batch_max=2, nw=8,
                          w_min=0.3, w_max=2.1, n_iter=8, escalate=False,
                          device="cpu", socket_path=str(tmp_path / f"sv{i}.sock"))
        srv = SolverServer(cfg)
        srv.start()
        servers.append(srv)
    fcfg = FleetConfig(replicas=2, probe_interval_s=0.0,
                       resubmit_backoff_s=0.0)
    router = FleetRouter(fcfg, [s.socket_path for s in servers],
                         socket_path=str(tmp_path / "front.sock"))
    router.start()
    try:
        with SolveClient(router.socket_path) as cl:
            req = {"op": "solve", "design": "oc3", "Hs": 6.0, "Tp": 10.0}
            ref = cl.call(dict(req), timeout=120.0)
            assert ref["ok"] and ref["replica"] == 0
            rows_ref = ref["results"][0]["std_dev"]
            # same lane, forced onto the OTHER replica: same bits
            with router._lock:
                router._affinity["OC3spar"] = 1
            other = cl.call(dict(req), timeout=120.0)
            assert other["ok"] and other["replica"] == 1
            assert other["results"][0]["std_dev"] == rows_ref
            # failover leg: the forward to replica 0 is withheld
            # (stall_replica), then the replica is failed under it —
            # the resubmission lands on replica 1, bits unchanged
            with router._lock:
                router._affinity["OC3spar"] = 0
            monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "stall_replica:1")
            faults.reset_counts()
            try:
                fut = cl.submit(dict(req))
                deadline = time.monotonic() + 5.0
                while (not router._replicas[0].outstanding
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                assert router._replicas[0].outstanding
            finally:
                monkeypatch.delenv("RAFT_TPU_FAULT_INJECT")
                faults.reset_counts()
            router._fail_replica(router._replicas[0], "test kill")
            resp = fut.result(120.0)
            assert resp["ok"] is True
            assert resp["replica"] == 1
            assert resp["resubmits"] == 1
            assert resp["results"][0]["std_dev"] == rows_ref
    finally:
        router.stop()
        for s in servers:
            s.stop()


# --------------------------------------------------------------------------
# supervisor: restart-storm bound on a virtual clock
# --------------------------------------------------------------------------
class _DeadHandle:
    """A child that exits the instant it is spawned (crash loop)."""

    def poll(self):
        return 1

    def terminate(self):
        pass

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 1


class _AliveHandle(_DeadHandle):
    def poll(self):
        return None


def _mk_fleet(tmp_path, spawn, **cfg_kw):
    cfg_kw.setdefault("probe_interval_s", 0.0)
    cfg = FleetConfig(replicas=1,
                      socket_path=str(tmp_path / "front.sock"), **cfg_kw)
    return Fleet(cfg, spawn_fn=spawn, run_dir=str(tmp_path / "run"),
                 clock=VirtualClock())


def test_restart_storm_is_bounded_per_window(tmp_path):
    spawns = []

    def spawn(idx, path):
        spawns.append(path)
        return _DeadHandle(), {"ready": True, "compiles_at_ready": 0}

    fleet = _mk_fleet(tmp_path, spawn, restart_max=3, restart_window_s=30.0)
    c_restart, c_supp = _counter("restart"), _counter("restart_suppressed")
    rep = fleet._replicas[0]
    rep.handle = _DeadHandle()                # "died" before any sweep
    assert fleet._babysit_once(now=0.0) == [0]
    assert fleet._babysit_once(now=1.0) == [0]
    assert fleet._babysit_once(now=2.0) == [0]
    # window full: the crash loop is suppressed, visibly, exactly once
    assert fleet._babysit_once(now=3.0) == []
    assert fleet._babysit_once(now=4.0) == []
    assert rep.suppressed is True
    assert rep.restarts == 3
    assert _counter("restart") - c_restart == 3
    assert _counter("restart_suppressed") - c_supp == 1
    assert fleet.telemetry()["supervisor"]["replicas"][0]["suppressed"]
    # the SLIDING window re-arms the budget once the old restarts age out
    assert fleet._babysit_once(now=33.5) == [0]
    assert rep.suppressed is False
    assert rep.restarts == 4
    assert len(spawns) == 4
    # every respawn kept the replica's ORIGINAL socket path (identity
    # is the index; the router's routing table never changes shape)
    assert set(spawns) == {rep.socket_path}


def test_babysit_leaves_live_children_alone(tmp_path):
    calls = []

    def spawn(idx, path):
        calls.append(idx)
        return _AliveHandle(), {"ready": True}

    fleet = _mk_fleet(tmp_path, spawn)
    fleet._spawn(fleet._replicas[0])
    assert calls == [0]
    assert fleet._babysit_once(now=0.0) == []
    assert fleet._babysit_once(now=10.0) == []
    assert calls == [0]                       # no gratuitous respawn
    assert fleet._replicas[0].restarts == 0


def test_failed_respawn_consumes_budget_and_retries(tmp_path):
    attempts = []

    def spawn(idx, path):
        attempts.append(idx)
        raise RuntimeError("ready line never came")

    fleet = _mk_fleet(tmp_path, spawn, restart_max=2, restart_window_s=30.0)
    rep = fleet._replicas[0]
    rep.handle = _DeadHandle()
    assert fleet._babysit_once(now=0.0) == []     # spawn raised
    assert rep.handle is None                     # retried next sweep...
    assert fleet._babysit_once(now=1.0) == []
    assert fleet._babysit_once(now=2.0) == []     # ...within the budget
    assert len(attempts) == 2
    assert rep.suppressed is True


# --------------------------------------------------------------------------
# client deadlines (the failure typing the router's failover keys on)
# --------------------------------------------------------------------------
def _silent_server(tmp_path, name="silent.sock"):
    """Accepts and reads but never answers (a wedged daemon)."""
    path = str(tmp_path / name)
    ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    ls.bind(path)
    ls.listen(4)
    conns = []

    def accept():
        while True:
            try:
                c, _ = ls.accept()
            except OSError:
                return
            conns.append(c)

    threading.Thread(target=accept, daemon=True).start()
    return path, ls, conns


def test_client_read_deadline_types_serve_timeout(tmp_path):
    path, ls, conns = _silent_server(tmp_path)
    try:
        with SolveClient(path, read_timeout=0.2) as cl:
            fut = cl.submit({"op": "ping"})
            with pytest.raises(ServeTimeout):
                fut.result(5.0)
    finally:
        ls.close()
        for c in conns:
            c.close()


def test_client_connection_loss_fails_pending(tmp_path):
    path, ls, conns = _silent_server(tmp_path, "dying.sock")
    cl = SolveClient(path)
    try:
        fut = cl.submit({"op": "ping"})
        deadline = time.monotonic() + 5.0
        while not conns and time.monotonic() < deadline:
            time.sleep(0.005)
        for c in conns:                      # the daemon dies mid-request
            c.shutdown(socket.SHUT_RDWR)
            c.close()
        with pytest.raises(ServeConnectionLost):
            fut.result(5.0)
    finally:
        ls.close()
        cl.close()


def test_client_connect_ladder_exhaustion_is_typed(tmp_path):
    with pytest.raises(ServeConnectionLost):
        SolveClient(str(tmp_path / "nowhere.sock"), connect_timeout=0.2,
                    retry_interval=0.05)


# --------------------------------------------------------------------------
# the port's own pieces beside the JAX package's
# --------------------------------------------------------------------------
def test_fleet_config_matches_jax_defaults(monkeypatch):
    import dataclasses

    from raft_tpu.serve.fleet import FleetConfig as JFleetConfig

    for k in list(os.environ):
        if k.startswith("RAFT_TPU_FLEET_"):
            monkeypatch.delenv(k)
    ours, theirs = FleetConfig.from_env(), JFleetConfig.from_env()
    for f in dataclasses.fields(JFleetConfig):
        if f.name != "socket_path":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert "raft_tpu_torch_fleet_" in ours.socket_path != theirs.socket_path


def test_fleet_spawns_port_daemons_with_device(tmp_path, monkeypatch):
    """A replica is ``python -m raft_tpu_torch.serve daemon`` started with
    ``subprocess`` (a new interpreter), with the caller's flags."""
    import subprocess
    import sys

    seen = {}

    class _Proc:
        def __init__(self, argv, **kw):
            seen["argv"], seen["cwd"] = argv, kw.get("cwd")
            import io

            self.stdout = io.StringIO('{"ready": true, "compiles_at_ready": 0}\n')

        def poll(self):
            return None

    monkeypatch.setattr(subprocess, "Popen", _Proc)
    cfg = FleetConfig(replicas=1, probe_interval_s=0.0, socket_path=str(tmp_path / "f.sock"))
    fleet = Fleet(cfg, serve_args=["--device", "cpu", "--nw", "8"], run_dir=str(tmp_path))
    handle, ready = fleet._spawn_daemon_child(0, str(tmp_path / "replica0.sock"))
    assert seen["argv"][:4] == [sys.executable, "-m", "raft_tpu_torch.serve", "daemon"]
    assert seen["argv"][-4:] == ["--device", "cpu", "--nw", "8"]
    assert os.path.isfile(os.path.join(seen["cwd"], "raft_tpu_torch", "serve", "fleet.py"))
    assert ready["compiles_at_ready"] == 0


def test_router_and_fleet_import_no_solver_stack():
    """The router and the supervisor are socket plumbing: importing them
    loads none of the solver stack (the JAX package's do not import
    JAX)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import raft_tpu_torch.serve.router, raft_tpu_torch.serve.fleet\n"
            "import raft_tpu_torch.serve.protocol, raft_tpu_torch.serve.client\n"
            "heavy = ('raft_tpu_torch.parallel', 'raft_tpu_torch.model', "
            "'raft_tpu_torch.core.cuda6', 'raft_tpu_torch.serve.solver', "
            "'raft_tpu_torch.serve.server', 'raft_tpu_torch.mooring')\n"
            "print('HEAVY', sorted(m for m in sys.modules if m.startswith(heavy)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "HEAVY []" in proc.stdout, proc.stdout
