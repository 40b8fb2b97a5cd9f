"""Front-end failover router of the serving fleet (port of
``raft_tpu.serve.router``, the same rules).

One router process speaks the existing length-prefixed JSON protocol
(:mod:`raft_tpu_torch.serve.protocol`) on its own AF_UNIX socket and fans
solve-kind requests out to N replica daemons (each a ``python -m
raft_tpu_torch.serve daemon`` child, babysat by
:class:`raft_tpu_torch.serve.fleet.Fleet`).  The router imports none of
the solver stack: it is pure socket plumbing plus the obs layer, so it
stays responsive while every replica is busy solving.

Routing — bucket affinity, deterministically: the affinity key is the
request's first design label (a design pins its shape bucket, so the
label is a stable proxy for "which bucket executable this request
heats").  The first request for a label pins it to the least-loaded
healthy replica (ties break to the lowest index); subsequent requests
for the same label follow the pin while the pinned replica is healthy
and below its ``queue_max`` in-flight cap, and re-pin by the same
least-loaded rule otherwise.  Two routers fed the same request sequence
route identically.

Degradation contract:

* **replica death** (heartbeat deadline, connection EOF, send failure):
  the replica is marked down, its in-flight forwards are re-submitted to
  survivors through :func:`raft_tpu_torch.resilience.retry.retry_call`'s
  bounded-backoff ladder — idempotent by construction, solves are pure —
  and each recovered response carries a ``resubmits`` count while
  keeping its original ``trace`` id.  Re-admission happens only after a
  passing ``ping`` probe (the supervisor restarts the process; this
  router decides when it is servable again).
* **overload**: deterministic admission control — total in-flight at or
  above ``queue_max`` x healthy replicas, a windowed
  :class:`~raft_tpu_torch.obs.metrics.SlidingHistogram` error rate above the
  shed threshold, or no healthy replica at all — answers immediately
  with the typed ``Overloaded`` error and a ``retry_after_ms`` hint
  (:func:`raft_tpu_torch.serve.protocol.overloaded_response`); nothing queues
  unboundedly.

Fault hooks (:mod:`raft_tpu_torch.resilience.faults`): ``kill_replica:K``
SIGKILLs the replica the router just picked (through the supervisor's
injector) before forwarding, ``stall_replica:K`` registers but withholds
the next K forwards (the forward deadline recovers them), and
``refuse_connect:K`` fails the next K replica connection attempts — all
host-side, all counted, so every failover path is drivable
deterministically.

Observability: per-replica ``fleet.replica_up[i]`` gauges; exact
``fleet.forwarded`` / ``fleet.relayed`` / ``fleet.failover`` /
``fleet.resubmitted`` / ``fleet.shed`` / ``fleet.timeouts`` counters; a
windowed router-latency SLO histogram on the injectable clock; and a
``request/router`` span per relayed response, recorded under the
request's original trace id (trace continuity across failover is a
tested invariant).
"""
from __future__ import annotations

import itertools
import os
import socket
import threading
import time

from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.obs import trace as _trace
from raft_tpu_torch.obs.metrics import SlidingHistogram
from raft_tpu_torch.resilience import faults
from raft_tpu_torch.resilience.retry import RetryExhausted, retry_call
from raft_tpu_torch.serve import protocol

#: counters the telemetry snapshot surfaces (all owned by this process)
_COUNTERS = ("forwarded", "relayed", "failover", "resubmitted", "shed",
             "timeouts", "restart", "restart_suppressed")


class NoHealthyReplica(ConnectionError):
    """Every replica is down (or not yet admitted) — retried through the
    resubmission ladder; exhaustion answers the client with the typed
    error frame."""


class _Conn:
    """One client connection: the socket plus its write lock (relays
    arrive from several link-reader threads and control answers from the
    conn's own reader — frames must not interleave)."""

    def __init__(self, sock):
        self.sock = sock
        self.wlock = threading.Lock()

    def send(self, obj) -> bool:
        try:
            with self.wlock:
                protocol.send_msg(self.sock, obj)
            return True
        except (OSError, ValueError):
            return False          # client went away; its results drop

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _Link:
    """The router's admitted connection to one replica: socket + write
    lock (forwards come from many conn readers and the resubmit path)."""

    def __init__(self, sock):
        self.sock = sock
        self.wlock = threading.Lock()

    def send(self, obj) -> bool:
        try:
            with self.wlock:
                protocol.send_msg(self.sock, obj)
            return True
        except (OSError, ValueError):
            return False

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _ReplicaState:
    """Router-side view of one replica (all fields guarded by the
    router's lock except ``idx``/``socket_path``, frozen at build)."""

    def __init__(self, idx: int, socket_path: str):
        self.idx = idx
        self.socket_path = socket_path
        self.healthy = False
        self.link: _Link | None = None
        self.inflight = 0
        self.heat: dict = {}             # design label -> forwards routed
        self.outstanding: dict = {}      # forward id -> _Forward
        self.admissions = 0              # passed probes (re-admissions)


class _Forward:
    """One client request in flight through the fleet.  Ownership is the
    pop: exactly one path (relay, failover, forward deadline) may pop it
    from a replica's outstanding table, so the client is answered
    exactly once no matter how many replicas die under it."""

    __slots__ = ("conn", "client_id", "payload", "trace", "label", "fid",
                 "resubmits", "t0", "t_ns")

    def __init__(self, conn: _Conn, client_id, payload: dict, trace: str,
                 label: str, fid: str, t0: float, t_ns: int):
        self.conn = conn
        self.client_id = client_id
        self.payload = payload
        self.trace = trace
        self.label = label
        self.fid = fid
        self.resubmits = 0
        self.t0 = t0
        self.t_ns = t_ns


class FleetRouter:
    """See module docstring.  ``config`` is the arm-time
    :class:`~raft_tpu_torch.serve.fleet.FleetConfig` snapshot (never
    re-read on the request path); ``replica_sockets`` fixes
    replica identity (index -> socket path, stable across restarts);
    ``injector`` is the supervisor hook ``kill_replica`` fires through;
    ``clock`` and ``sleep`` are injectable for the deterministic tests."""

    def __init__(self, config, replica_sockets, socket_path: str,
                 clock=time.monotonic, injector=None, on_shutdown=None,
                 sleep=time.sleep, slo_window_s: float = 60.0):
        self.config = config
        self.socket_path = socket_path
        self.clock = clock
        self._injector = injector
        self._on_shutdown = on_shutdown
        self._sleep = sleep
        self._replicas = [_ReplicaState(i, p)
                          for i, p in enumerate(replica_sockets)]
        self._lock = threading.Lock()     # replica states + affinity
        self._affinity: dict = {}         # design label -> replica idx
        self._fids = itertools.count()
        self.slo_window_s = float(slo_window_s)
        self._slo_lock = threading.Lock()
        self._slo = SlidingHistogram("fleet.latency_s",
                                     window_s=self.slo_window_s)
        self._listener = None
        self._threads: list = []
        self._stopping = threading.Event()
        self.t_armed = time.monotonic()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Bind the front socket, admit every reachable replica, start
        the accept loop and (with a positive probe interval) the
        heartbeat loop."""
        try:
            os.unlink(self.socket_path)        # stale socket from a kill
        except FileNotFoundError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        for st in self._replicas:
            self._try_admit(st)
        t_accept = threading.Thread(target=self._accept_loop,
                                    name="fleet-accept", daemon=True)
        self._threads.append(t_accept)
        t_accept.start()
        if self.config.probe_interval_s > 0:
            t_probe = threading.Thread(target=self._probe_loop,
                                       name="fleet-probe", daemon=True)
            self._threads.append(t_probe)
            t_probe.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop intake, fail anything still in flight loudly, close the
        links.  The supervisor stops the replica processes themselves."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:              # pragma: no cover
                pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        orphans = []
        with self._lock:
            for st in self._replicas:
                st.healthy = False
                link, st.link = st.link, None
                if link is not None:
                    link.close()
                orphans.extend(st.outstanding.values())
                st.outstanding.clear()
                st.inflight = 0
        for fwd in orphans:
            fwd.conn.send(protocol.error_response(
                fwd.client_id, ConnectionError("router stopped")))

    def _probe_loop(self) -> None:
        while not self._stopping.wait(self.config.probe_interval_s):
            try:
                self.probe_once()
            except Exception:      # pragma: no cover - heartbeat must
                pass               # survive anything a probe can raise

    # ------------------------------------------------------- accept side
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break                          # listener closed by stop()
            t = threading.Thread(target=self._handle_conn,
                                 args=(_Conn(sock),),
                                 name="fleet-conn", daemon=True)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()

    def _handle_conn(self, conn: _Conn) -> None:
        try:
            while True:
                try:
                    obj = protocol.recv_msg(conn.sock)
                except protocol.PeerClosed:
                    return
                except protocol.ProtocolError as e:
                    if not conn.send(protocol.error_response(None, e)):
                        return
                    continue
                try:
                    req = protocol.parse_request(obj)
                except protocol.ProtocolError as e:
                    conn.send(protocol.error_response(
                        obj.get("id") if isinstance(obj, dict) else None, e))
                    continue
                op = req["op"]
                if op == "ping":
                    with self._lock:
                        n_h = sum(1 for s in self._replicas if s.healthy)
                    conn.send({
                        "id": req["id"], "ok": True, "op": "ping",
                        "router": True, "replicas": len(self._replicas),
                        "healthy": n_h,
                        "uptime_s": round(time.monotonic() - self.t_armed,
                                          3)})
                    continue
                if op == "stats":
                    conn.send({"id": req["id"], "ok": True, "op": "stats",
                               "router": self.telemetry()})
                    continue
                if op == "refresh":
                    conn.send(self._broadcast_refresh(req, obj))
                    continue
                if op == "shutdown":
                    conn.send({"id": req["id"], "ok": True,
                               "op": "shutdown", "router": True})
                    threading.Thread(
                        target=self._on_shutdown or self.stop,
                        name="fleet-shutdown", daemon=True).start()
                    return
                self._dispatch(conn, req, obj)
        finally:
            conn.close()

    # ----------------------------------------------------- request path
    def _dispatch(self, conn: _Conn, req: dict, raw: dict) -> None:
        """Admission-check one solve-kind request, then forward it (or
        shed it with the typed ``Overloaded`` frame)."""
        label = req["lanes"][0][1] if req["lanes"] else ""
        trace = req.get("trace") or _trace.new_trace_id()
        shed_reason = self._admit()
        if shed_reason is not None:
            _metrics.counter("fleet.shed").inc()
            conn.send(protocol.overloaded_response(
                req["id"], self.config.retry_after_ms, detail=shed_reason))
            return
        fwd = _Forward(conn=conn, client_id=req["id"], payload=raw,
                       trace=trace, label=label,
                       fid=f"f{next(self._fids)}", t0=self.clock(),
                       t_ns=time.perf_counter_ns())
        if self._injector is not None and faults.consume("kill_replica"):
            # kill the replica affinity is about to pick: a deterministic
            # mid-stream death right under this request's forward
            with self._lock:
                pick = self._pick_locked(label)
            if pick is not None:
                self._injector.kill(pick.idx)
        try:
            self._forward(fwd)
        except (ConnectionError, OSError):
            self._resubmit(fwd, reason="dispatch-time forward failed")

    def _admit(self) -> str | None:
        """Deterministic admission control; returns the shed reason, or
        None to admit.  Pure function of replica state, the in-flight
        total, and the windowed error budget at the router's clock."""
        now = self.clock()
        cfg = self.config
        with self._lock:
            n_h = sum(1 for s in self._replicas if s.healthy)
            inflight = sum(s.inflight for s in self._replicas)
        if n_h == 0:
            return "no healthy replica"
        if inflight + 1 > cfg.queue_max * n_h:
            return (f"in-flight capacity exhausted "
                    f"({inflight}/{cfg.queue_max * n_h})")
        with self._slo_lock:
            win = self._slo.window(now)
        events = win.get("count", 0) + win.get("errors", 0)
        if (events >= cfg.shed_min_events
                and win.get("error_rate", 0.0) > cfg.shed_error_rate):
            return (f"error budget exhausted (windowed error rate "
                    f"{win['error_rate']:.3f} > {cfg.shed_error_rate})")
        return None

    def _pick_locked(self, label: str):
        """Routing decision (caller holds the lock): bucket affinity by
        design label, least-loaded (ties -> lowest index) on a miss or
        when the pinned replica is down/saturated."""
        healthy = [s for s in self._replicas
                   if s.healthy and s.link is not None]
        if not healthy:
            return None
        idx = self._affinity.get(label)
        if idx is not None:
            aff = self._replicas[idx]
            if (aff.healthy and aff.link is not None
                    and aff.inflight < self.config.queue_max):
                return aff
        pick = min(healthy, key=lambda s: (s.inflight, s.idx))
        if label:
            self._affinity[label] = pick.idx
        return pick

    def _forward(self, fwd: _Forward) -> None:
        """Route one forward to a replica; raises on failure (the
        resubmission ladder is the retry discipline, not this)."""
        with self._lock:
            pick = self._pick_locked(fwd.label)
            if pick is None:
                raise NoHealthyReplica(
                    f"no healthy replica for request {fwd.client_id!r}")
            link = pick.link
            pick.outstanding[fwd.fid] = fwd
            pick.inflight += 1
            pick.heat[fwd.label] = pick.heat.get(fwd.label, 0) + 1
        _metrics.counter("fleet.forwarded").inc()
        if faults.consume("stall_replica"):
            return      # withheld frame: the forward deadline recovers it
        if not link.send({**fwd.payload, "id": fwd.fid,
                          "trace": fwd.trace}):
            with self._lock:
                still = pick.outstanding.pop(fwd.fid, None)
                if still is not None:
                    pick.inflight = max(0, pick.inflight - 1)
            if still is not None:       # not already claimed by failover
                raise ConnectionError(
                    f"send to replica {pick.idx} failed")

    def _resubmit(self, fwd: _Forward, reason: str) -> None:
        """Failover: re-route one orphaned forward through the bounded
        retry ladder (idempotent — solves are pure); ladder exhaustion
        answers the client with the typed error frame."""
        if self._stopping.is_set():
            fwd.conn.send(protocol.error_response(
                fwd.client_id, ConnectionError("router stopping")))
            return
        fwd.resubmits += 1
        cfg = self.config

        def attempt(_i):
            self._forward(fwd)

        try:
            retry_call(
                attempt, retries=cfg.resubmit_retries,
                backoff_s=cfg.resubmit_backoff_s, growth=2.0,
                max_backoff_s=max(cfg.resubmit_backoff_s, 1.0),
                retry_on=(ConnectionError, OSError),
                describe=(f"failover resubmit of request "
                          f"{fwd.client_id!r} ({reason})"),
                sleep=self._sleep)
            _metrics.counter("fleet.resubmitted").inc()
        except RetryExhausted as e:
            with self._slo_lock:
                self._slo.error(now=self.clock())
            fwd.conn.send(protocol.error_response(fwd.client_id, e))

    # -------------------------------------------------------- link side
    def _link_read_loop(self, state: _ReplicaState, link: _Link) -> None:
        try:
            while True:
                obj = protocol.recv_msg(link.sock)
                self._relay(state, obj)
        except (protocol.PeerClosed, protocol.ProtocolError, OSError):
            pass
        if self._stopping.is_set():
            return
        with self._lock:
            current = state.link is link
        if current:                 # a replaced link must not kill its
            self._fail_replica(state, "connection lost")   # successor

    def _relay(self, state: _ReplicaState, obj) -> None:
        """One replica response frame -> the owning client, exactly once
        (the outstanding-table pop is the ownership transfer; late
        frames for timed-out/failed-over forwards drop here)."""
        fid = obj.get("id") if isinstance(obj, dict) else None
        with self._lock:
            fwd = state.outstanding.pop(fid, None)
            if fwd is not None:
                state.inflight = max(0, state.inflight - 1)
        if fwd is None:
            return
        now = self.clock()
        ok = bool(obj.get("ok"))
        with self._slo_lock:
            if ok:
                self._slo.observe(max(0.0, now - fwd.t0), now=now)
            else:
                self._slo.error(now=now)
        out = {**obj, "id": fwd.client_id, "replica": state.idx}
        if fwd.resubmits:
            out["resubmits"] = fwd.resubmits
        if fwd.trace:
            # the router half of the request tree, under the ORIGINAL
            # trace id — failover resubmission must not break the tree
            _trace.record(
                "request/router", fwd.t_ns, time.perf_counter_ns(),
                attrs={"replica": state.idx, "resubmits": fwd.resubmits},
                trace=fwd.trace,
                tid=_trace.synthetic_tid(f"{fwd.trace}#router"),
                track=f"req {fwd.client_id} router")
        # count BEFORE the client-visible send: a caller that observes
        # the response and then snapshots telemetry must see this relay
        _metrics.counter("fleet.relayed").inc()
        fwd.conn.send(out)

    def _fail_replica(self, state: _ReplicaState, reason: str) -> None:
        """Mark one replica down and fail its in-flight forwards over to
        survivors.  Idempotent: concurrent detection paths (link EOF,
        heartbeat, send failure) race to the same state flip, and the
        orphan list is claimed under the lock exactly once."""
        with self._lock:
            link, state.link = state.link, None
            was_healthy, state.healthy = state.healthy, False
            orphans = list(state.outstanding.values())
            state.outstanding.clear()
            state.inflight = 0
        if link is not None:
            link.close()
        if not was_healthy and not orphans:
            return
        _metrics.gauge(f"fleet.replica_up[{state.idx}]").set(0)
        if orphans:
            _metrics.counter("fleet.failover").inc(len(orphans))
        for fwd in orphans:
            self._resubmit(fwd, reason=reason)

    # -------------------------------------------------- probe/admission
    def _connect_link(self, state: _ReplicaState):
        """One bounded connect-and-probe ladder to a replica socket;
        returns the probed socket (deadline already cleared) or raises.
        The ``refuse_connect`` counted fault fires here."""
        cfg = self.config

        def attempt(_i):
            if faults.consume("refuse_connect"):
                raise ConnectionRefusedError(
                    f"fault-injected refuse_connect to replica "
                    f"{state.idx}")
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(cfg.probe_timeout_s)
            try:
                s.connect(state.socket_path)
                protocol.send_msg(s, {"op": "ping",
                                      "id": f"admit-{state.idx}"})
                resp = protocol.recv_msg(s)
                if not (isinstance(resp, dict) and resp.get("ok")):
                    raise ConnectionError(
                        f"replica {state.idx} failed the admission "
                        f"probe: {resp!r}")
                s.settimeout(None)
                return s
            except Exception:
                s.close()
                raise

        return retry_call(
            attempt, retries=2, backoff_s=0.05, growth=2.0,
            max_backoff_s=0.5, deadline_s=2.0 * cfg.probe_timeout_s,
            retry_on=(OSError, ConnectionError),
            describe=f"admit replica {state.idx}", sleep=self._sleep)

    def _try_admit(self, state: _ReplicaState) -> bool:
        """(Re-)admit one down replica: connect + passing ping probe,
        then start its reader and mark it healthy.  Best-effort — an
        unreachable replica just stays down until the next probe tick."""
        try:
            sock = self._connect_link(state)
        except (RetryExhausted, OSError, ConnectionError):
            return False
        link = _Link(sock)
        with self._lock:
            state.link = link
            state.healthy = True
            state.inflight = 0
            state.admissions += 1
        _metrics.gauge(f"fleet.replica_up[{state.idx}]").set(1)
        t = threading.Thread(target=self._link_read_loop,
                             args=(state, link),
                             name=f"fleet-link-{state.idx}", daemon=True)
        self._threads.append(t)
        t.start()
        return True

    def _probe(self, state: _ReplicaState) -> bool:
        """Deadline-bounded heartbeat on a one-shot connection (the
        link's own stream belongs to its reader): a stalled replica
        accepts but never answers, and the deadline catches it."""
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.config.probe_timeout_s)
        try:
            s.connect(state.socket_path)
            protocol.send_msg(s, {"op": "ping",
                                  "id": f"probe-{state.idx}"})
            resp = protocol.recv_msg(s)
            return isinstance(resp, dict) and bool(resp.get("ok"))
        except (OSError, protocol.PeerClosed, protocol.ProtocolError):
            return False
        finally:
            try:
                s.close()
            except OSError:      # pragma: no cover
                pass

    def probe_once(self) -> dict:
        """One health sweep (the probe loop's body; tests call it
        directly on a virtual clock): expire overdue forwards into the
        resubmission ladder, heartbeat healthy replicas, try to re-admit
        down ones."""
        now = self.clock()
        overdue = []
        with self._lock:
            for st in self._replicas:
                for fid in [f for f, w in st.outstanding.items()
                            if now - w.t0 > self.config.request_timeout_s]:
                    overdue.append(st.outstanding.pop(fid))
                    st.inflight = max(0, st.inflight - 1)
        for fwd in overdue:
            _metrics.counter("fleet.timeouts").inc()
            self._resubmit(fwd, reason="forward deadline expired")
        summary = {"expired": len(overdue), "failed": [], "admitted": []}
        for st in self._replicas:
            if self._stopping.is_set():
                break
            with self._lock:
                healthy = st.healthy
            if healthy:
                if not self._probe(st):
                    summary["failed"].append(st.idx)
                    self._fail_replica(st, "heartbeat deadline")
            elif self._try_admit(st):
                summary["admitted"].append(st.idx)
        return summary

    # ---------------------------------------------------- control plane
    def _broadcast_refresh(self, req: dict, raw: dict) -> dict:
        """Forward a ``refresh`` to every healthy replica on one-shot
        connections; aggregate per-replica outcomes."""
        out: dict = {}
        for st in self._replicas:
            with self._lock:
                healthy = st.healthy
            if not healthy:
                out[str(st.idx)] = {"ok": False, "error": "replica down"}
                continue
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.config.probe_timeout_s)
            try:
                s.connect(st.socket_path)
                protocol.send_msg(s, {**raw, "id": f"refresh-{st.idx}"})
                resp = protocol.recv_msg(s)
                out[str(st.idx)] = {"ok": bool(resp.get("ok"))}
            except (OSError, protocol.PeerClosed,
                    protocol.ProtocolError) as e:
                out[str(st.idx)] = {"ok": False, "error": str(e)[-200:]}
            finally:
                try:
                    s.close()
                except OSError:      # pragma: no cover
                    pass
        return {"id": req["id"], "ok": all(v.get("ok") for v in
                                           out.values()),
                "op": "refresh", "replicas": out}

    # -------------------------------------------------------- telemetry
    def reset_telemetry(self) -> None:
        """Measurement-window boundary (a warm pass against a measured
        pass): a fresh SLO window."""
        with self._slo_lock:
            self._slo = SlidingHistogram("fleet.latency_s",
                                         window_s=self.slo_window_s)

    def telemetry(self) -> dict:
        """Live fleet snapshot: per-replica health/in-flight/heat, the
        affinity map, the windowed router latency, and the exact
        failover/shed/restart counters.  Deterministic under a virtual
        clock."""
        now = self.clock()
        with self._lock:
            reps = [{"idx": s.idx, "healthy": s.healthy,
                     "inflight": s.inflight, "admissions": s.admissions,
                     "outstanding": len(s.outstanding),
                     "heat": dict(sorted(s.heat.items()))}
                    for s in self._replicas]
            affinity = dict(sorted(self._affinity.items()))
        with self._slo_lock:
            win = self._slo.window(now)
        return {
            "uptime_s": round(time.monotonic() - self.t_armed, 3),
            "replicas": reps,
            "healthy": sum(1 for r in reps if r["healthy"]),
            "affinity": affinity,
            "latency": win,
            "window_s": self.slo_window_s,
            "counters": {name: _metrics.counter(f"fleet.{name}").value
                         for name in _COUNTERS},
            "admission": {
                "queue_max": self.config.queue_max,
                "shed_error_rate": self.config.shed_error_rate,
                "shed_min_events": self.config.shed_min_events,
                "retry_after_ms": self.config.retry_after_ms,
                "request_timeout_s": self.config.request_timeout_s,
            },
        }
