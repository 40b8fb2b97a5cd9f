"""The resident solver daemon: socket front, batcher middle, warm core
(port of ``raft_tpu.serve.server``).

Thread layout (all state lock-owned or single-writer by construction):

* one ACCEPT thread — listens on the AF_UNIX socket, spawns a reader per
  connection;
* N CONNECTION READER threads — frame/parse/validate requests, stage
  each lane on the device (memoized, see :meth:`~raft_tpu_torch.serve.
  solver.SolverCore.stage_lane` — this is where a lane learns its bucket
  signature), and submit lanes to the :class:`~raft_tpu_torch.serve.
  batcher.MicroBatcher`;
  control ops (``ping``/``stats``/``refresh``/``shutdown``) answer
  inline;
* ONE SOLVER LOOP thread — drains the batcher (deadline-or-capacity
  closes), solves each batch through :func:`~raft_tpu_torch.serve.
  solver.solve_batch` (kernel K1 in every iteration on the card), slices
  rows back to their owning requests, and sends each response the moment
  its last lane lands.

Every CUDA operation of these threads runs on the device's default
stream, so the readers' staging and the loop's solves interleave in
stream order.

Graceful shutdown (``shutdown`` op or SIGTERM via ``python -m
raft_tpu_torch.serve``): stop intake, flush every pending bucket (the
batcher drains closed), answer everything in flight, dump the flight
recorder, flush the per-kernel performance ledger and publish the obs
sinks, then exit — a client that got its request in gets its response
out.

Observability (armed by ``RAFT_TPU_OBS`` like every other subsystem):

* **request-scoped traces** — every solve-kind request runs under ONE
  trace id (client-minted or server-minted): the reader records
  ``request/server/stage`` on its own thread, the solver loop emits
  ``request/server/queue_wait`` / ``request/server/solve`` per lane on
  synthetic per-lane tracks (explicit-endpoint spans: overlapping
  requests never break per-track time containment), and delivery
  closes the ``request/server`` root — one Perfetto-loadable tree per
  request, spanning threads, thread-name metadata included;
* **live SLO windows** — a sliding-window request-latency histogram
  plus per-bucket queue-wait windows on the server's own (injectable)
  clock: the ``stats`` op returns windowed p50/p90/p99, error rate,
  occupancy, queue depth, and the kernel builds of this process —
  deterministic under a virtual clock;
* **flight recorder** — the last-N completed request records (id, op,
  trace, buckets, per-stage timings, outcome), dumped atomically on
  batch failure, ``refresh``, and shutdown;
* the per-bucket ``serve.queue_wait_s[SxNxW]`` cumulative histograms,
  ``serve.batch_occupancy[SxNxW]`` gauges and exact
  ``serve.lanes``/``serve.batches`` counters, and the solver's own
  per-bucket dispatch histograms underneath (``sweep_designs.*``).
"""
from __future__ import annotations

import os
import socket
import threading
import time

from raft_tpu_torch.obs.flight import FlightRecorder
from raft_tpu_torch.obs.metrics import SlidingHistogram
from raft_tpu_torch.serve import protocol
from raft_tpu_torch.serve.batcher import Lane, MicroBatcher
from raft_tpu_torch.serve.config import ServeConfig
from raft_tpu_torch.serve.solver import SolverCore, solve_batch


def _bucket_label(sig) -> str:
    return f"{sig.segments}x{sig.nodes}x{sig.nw}"


class _Conn:
    """One client connection: the socket plus its write lock (responses
    are sent from the solver loop AND control answers from the reader —
    frames must not interleave)."""

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


class _PendingRequest:
    """Fan-in state of one multi-lane request.  Rows are filled by the
    single solver-loop thread only; ``done`` counts under the server's
    requests lock (an error path may also finish a request)."""

    def __init__(self, conn: _Conn, req_id, n_lanes: int, clock,
                 op: str = "solve", trace: str = "",
                 t_recv_ns: int = 0, stage_s: float = 0.0):
        self.conn = conn
        self.id = req_id
        self.op = op
        self.trace = trace
        self.rows = [None] * n_lanes
        self.waits = [0.0] * n_lanes
        self.solve_s = [0.0] * n_lanes
        self.sigs = [""] * n_lanes       # bucket label per lane
        self.remaining = n_lanes
        self.error = None        # first batch failure poisons the request
        self.t0 = clock()
        self.t_recv_ns = t_recv_ns or time.perf_counter_ns()
        self.stage_s = stage_s


class SolverServer:
    """See module docstring.  ``config`` is the arm-time snapshot
    (:meth:`ServeConfig.from_env` — never re-read on the request path);
    ``clock`` is injectable for the deterministic tests.  Constructing a
    server for the card without CUDA raises (the core resolves the
    device)."""

    def __init__(self, config: ServeConfig | None = None,
                 socket_path: str | None = None, clock=time.monotonic,
                 slo_window_s: float = 60.0):
        self.config = config or ServeConfig.from_env()
        self.socket_path = socket_path or self.config.socket_path
        self.clock = clock
        self.core = SolverCore(self.config)
        self.batcher = MicroBatcher(self.config.batch_deadline_s,
                                    self.config.batch_max, clock=clock)
        self._lock = threading.Lock()    # guards _PendingRequest fan-in
        self._threads: list = []
        self._listener = None
        self._stopping = threading.Event()
        self._solver_done = threading.Event()
        self.t_armed = time.monotonic()
        # live SLO state, on the SERVER'S clock (virtual-clock
        # deterministic): one request-latency window, per-bucket
        # queue-wait windows (lazily created under their own lock), a
        # flight recorder, and exact request/error counters
        self.slo_window_s = float(slo_window_s)
        self.flight = FlightRecorder()
        self._slo_latency = SlidingHistogram("serve.latency_s",
                                             window_s=self.slo_window_s)
        self._slo_lock = threading.Lock()
        self._slo_wait: dict = {}        # bucket label -> SlidingHistogram
        self._req_done = 0
        self._req_err = 0

    # ----------------------------------------------------------- warmup
    def warmup(self, designs, Hs: float = 8.0, Tp: float = 12.0) -> dict:
        """Arm the service for a design list before the first client: stage
        one lane per design and solve one padded batch per distinct bucket,
        so every kernel library is built or loaded and the device's first
        work is done ahead of traffic.  Returns per-bucket arming info;
        ``ready_s`` in the daemon's ready line is measured through this."""
        by_sig: dict = {}
        for spec in designs:
            design, label = protocol.resolve_design(spec)
            sig, staged = self.core.stage_lane(design, Hs, Tp)
            by_sig.setdefault(sig, Lane(request_id=None, seq=0, label=label,
                                        staged=staged))
        info = {}
        for sig, lane in by_sig.items():
            _rows, binfo = solve_batch(self.core, sig, [lane])
            info[_bucket_label(sig)] = {"lanes": binfo["lanes"],
                                        "capacity": binfo["capacity"]}
        return info

    # ---------------------------------------------------------- control
    def start(self) -> None:
        """Bind the socket and start the accept + solver threads."""
        path = self.socket_path
        try:
            os.unlink(path)                   # stale socket from a kill
        except FileNotFoundError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(64)
        t_solve = threading.Thread(target=self._solve_loop,
                                   name="serve-solver", daemon=True)
        t_accept = threading.Thread(target=self._accept_loop,
                                    name="serve-accept", daemon=True)
        self._threads += [t_solve, t_accept]
        t_solve.start()
        t_accept.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful drain: stop intake, flush pending batches, answer
        in-flight requests, close the listener."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self.batcher.close()
        self._solver_done.wait(timeout)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        # post-drain telemetry publication: the flight recorder survives
        # the process (SIGTERM included — ``python -m raft_tpu_torch.serve``
        # routes it here), and a final forced obs publish flushes the span
        # ring past the debounce.  Best-effort: telemetry never blocks
        # shutdown.
        try:
            from raft_tpu_torch import obs as _obs

            self.flight.dump(label="serve", reason="shutdown")
            _obs.ledger.flush()
            _obs.maybe_publish("serve", force=True)
        except Exception:              # pragma: no cover - e.g. a full disk, or
            pass                       # a malformed RAFT_TPU_TORCH_ROOFLINE

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the solver loop has drained and exited."""
        return self._solver_done.wait(timeout)

    def serve_forever(self) -> None:
        """``start()`` then block until :meth:`stop` completes (the
        daemon entry point; ``python -m raft_tpu_torch.serve`` wires SIGTERM to
        ``stop``)."""
        self.start()
        self._solver_done.wait()

    # ------------------------------------------------------ accept side
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break                          # listener closed by stop()
            t = threading.Thread(target=self._handle_conn,
                                 args=(_Conn(sock),),
                                 name="serve-conn", daemon=True)
            # bounded bookkeeping in a long-lived daemon: drop handles of
            # connections that already hung up
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
                t_recv_ns = time.perf_counter_ns()
                try:
                    req = protocol.parse_request(obj)
                except protocol.ProtocolError as e:
                    conn.send(protocol.error_response(
                        obj.get("id") if isinstance(obj, dict) else None, e))
                    continue
                if req["op"] in ("ping", "stats", "refresh", "shutdown"):
                    stop = self._control(conn, req, obj)
                    if stop:
                        return
                    continue
                try:
                    self._submit_lanes(conn, req, t_recv_ns)
                except Exception as e:         # staging/validation failure
                    conn.send(protocol.error_response(req["id"], e))
        finally:
            try:
                conn.sock.close()
            except OSError:
                pass

    def _control(self, conn: _Conn, req: dict, raw: dict) -> bool:
        """Answer a control op inline; returns True when the server
        should stop (shutdown)."""
        op = req["op"]
        if op == "ping":
            conn.send({"id": req["id"], "ok": True, "op": "ping",
                       "uptime_s": round(time.monotonic() - self.t_armed, 3)})
            return False
        if op == "stats":
            conn.send({"id": req["id"], "ok": True, "op": "stats",
                       "solver": self.core.stats(),
                       "queue": self.batcher.counters(),
                       "queue_depth": self.batcher.depth(),
                       "telemetry": self.telemetry()})
            return False
        if op == "refresh":
            # operator-carried knob values (NOT an env re-read: the env
            # snapshot stays arm-time; explicit values in the request are
            # a configuration action, like restarting).
            # Validate BEFORE touching anything — a malformed value must
            # answer with an error, never kill the reader thread.
            try:
                new_deadline = raw.get("deadline_ms")
                new_max = raw.get("batch_max")
                if new_deadline is not None:
                    new_deadline = max(0.0, float(new_deadline)) / 1e3
                if new_max is not None:
                    new_max = int(new_max)
                    if new_max < 1:
                        raise ValueError("batch_max must be >= 1")
            except (TypeError, ValueError) as e:
                conn.send(protocol.error_response(req["id"], e))
                return False
            # a refresh is a natural post-mortem boundary: dump the
            # flight tail and flush the ledger BEFORE state turns over
            # (best-effort: telemetry must never fail the control op)
            try:
                from raft_tpu_torch import obs as _obs

                self.flight.dump(label="serve", reason="refresh")
                _obs.ledger.flush()
            except Exception:          # pragma: no cover
                pass
            info = self.core.refresh()
            # fresh SLO windows: refreshed knobs define a new
            # measurement regime, and mixing regimes in one window
            # would misattribute the old deadline's latencies
            self.reset_telemetry()
            if new_deadline is not None:
                self.batcher.set_deadline(new_deadline)
            if new_max is not None:
                import dataclasses

                # config first, then the batcher (both under their own
                # locks): a batch popped during the transition may carry
                # the OLD capacity's lane count — solve_batch pads to
                # max(capacity, lanes), so either interleaving solves.
                self.core.config = dataclasses.replace(
                    self.core.config, batch_max=new_max)
                self.batcher.set_batch_max(new_max)
            conn.send({"id": req["id"], "ok": True, "op": "refresh",
                       **info,
                       "batch_deadline_ms":
                           round(self.batcher.deadline_s * 1e3, 3),
                       "batch_max": self.batcher.batch_max})
            return False
        # shutdown: acknowledge, then drain gracefully.  The reader holds
        # THIS connection open until the solver loop finishes — the
        # requester (or anything sharing its connection) may still be
        # owed responses for queued lanes, and returning now would close
        # the socket underneath them.
        conn.send({"id": req["id"], "ok": True, "op": "shutdown"})
        threading.Thread(target=self.stop, name="serve-stop",
                         daemon=True).start()
        self._solver_done.wait(60.0)
        return True

    def _submit_lanes(self, conn: _Conn, req: dict,
                      t_recv_ns: int = 0) -> None:
        from raft_tpu_torch.obs import trace as _trace

        trace_id = req.get("trace") or _trace.new_trace_id()
        t_recv_ns = t_recv_ns or time.perf_counter_ns()
        lanes = []
        # staging runs on THIS reader thread under the request's trace
        # context: the "request/server/stage" span lands on the reader's
        # own track, carrying the shared trace id
        with _trace.context(_trace.TraceContext(trace=trace_id,
                                                path="request/server")):
            t_stage0 = time.perf_counter_ns()
            with _trace.span("stage", attrs={"op": req["op"],
                                             "lanes": len(req["lanes"])}):
                for seq, (design, label, Hs, Tp) in enumerate(req["lanes"]):
                    sig, staged = self.core.stage_lane(design, Hs, Tp)
                    lanes.append((sig, Lane(request_id=None, seq=seq,
                                            label=label, staged=staged,
                                            trace=trace_id)))
            stage_s = (time.perf_counter_ns() - t_stage0) / 1e9
        pend = _PendingRequest(conn, req["id"], len(lanes), self.clock,
                               op=req["op"], trace=trace_id,
                               t_recv_ns=t_recv_ns, stage_s=stage_s)
        for seq, (sig, lane) in enumerate(lanes):
            lane.request_id = pend
            pend.sigs[seq] = _bucket_label(sig)
        try:
            for sig, lane in lanes:
                lane.t_submit_ns = time.perf_counter_ns()
                self.batcher.submit(sig, lane)
        except RuntimeError as e:              # raced shutdown
            conn.send(protocol.error_response(req["id"], e))

    # ------------------------------------------------------ solver side
    def _wait_window(self, label: str) -> SlidingHistogram:
        """The per-bucket queue-wait SLO window (lazily created; the
        bucket ladder bounds the cardinality by construction)."""
        with self._slo_lock:
            w = self._slo_wait.get(label)
            if w is None:
                w = self._slo_wait[label] = SlidingHistogram(
                    f"serve.queue_wait[{label}]",
                    window_s=self.slo_window_s)
            return w

    def _solve_loop(self) -> None:
        from raft_tpu_torch import obs as _obs

        try:
            while True:
                item = self.batcher.next_batch()
                if item is None:
                    return
                sig, lanes = item
                label = _bucket_label(sig)
                now = self.clock()
                t_close_ns = time.perf_counter_ns()
                wait_win = self._wait_window(label)
                for ln in lanes:
                    # queue wait is measured on the BATCHER'S clock:
                    # close instant minus submit instant, exactly —
                    # deterministic under the virtual-clock tests
                    qw = max(0.0, now - ln.t_submit)
                    _obs.metrics.histogram(
                        f"serve.queue_wait_s[{label}]").observe(qw)
                    wait_win.observe(qw, now=now)
                with _obs.trace.span("serve/batch",
                                     attrs={"sig": label,
                                            "lanes": len(lanes)}):
                    try:
                        rows, info = solve_batch(self.core, sig, lanes)
                    except Exception as e:     # a poisoned batch must not
                        self._record_lane_spans(lanes, label, t_close_ns,
                                                time.perf_counter_ns(),
                                                solved=False)
                        self._fail_batch(lanes, e)   # kill the daemon
                        continue
                t_done_ns = time.perf_counter_ns()
                solve_s = (t_done_ns - t_close_ns) / 1e9
                with self._lock:
                    for ln in lanes:
                        ln.request_id.solve_s[ln.seq] = round(solve_s, 6)
                self._record_lane_spans(lanes, label, t_close_ns, t_done_ns)
                _obs.metrics.gauge(
                    f"serve.batch_occupancy[{label}]").set(info["occupancy"])
                _obs.metrics.counter("serve.batches").inc()
                _obs.metrics.counter("serve.lanes").inc(len(lanes))
                self._deliver(lanes, rows, now)
        finally:
            self._solver_done.set()

    def _record_lane_spans(self, lanes, label: str, t_close_ns: int,
                           t_done_ns: int, solved: bool = True) -> None:
        """Per-lane request-scoped spans, emitted by the solver loop on
        behalf of each lane's request: ``queue_wait`` (submit -> batch
        close) and ``solve`` (close -> materialized), both on a
        synthetic per-lane track so overlapping requests keep per-track
        time containment (the Perfetto invariant)."""
        from raft_tpu_torch.obs import trace as _trace

        for ln in lanes:
            if not ln.trace:
                continue                 # warmup lanes trace nothing
            tid = _trace.synthetic_tid(f"{ln.trace}#{ln.seq}")
            track = f"req {ln.request_id.id} lane {ln.seq}"
            _trace.record("request/server/queue_wait", ln.t_submit_ns,
                          t_close_ns, depth=2, attrs={"sig": label},
                          trace=ln.trace, tid=tid, track=track)
            if solved:
                _trace.record("request/server/solve", t_close_ns,
                              t_done_ns, depth=2, attrs={"sig": label},
                              trace=ln.trace, tid=tid, track=track)

    def _fail_batch(self, lanes, exc) -> None:
        # a failed batch POISONS every request it carried lanes for: the
        # request answers with the error once its last lane lands, even
        # when its other lanes (in other batches) solved fine — a
        # multi-bucket sweep must never get ok:true with null rows
        finished = []
        with self._lock:
            for ln in lanes:
                pend = ln.request_id
                if pend.error is None:
                    pend.error = exc
                pend.remaining -= 1
                if pend.remaining <= 0:
                    finished.append(pend)
        # bookkeeping BEFORE the error frames go out (same contract as
        # _deliver: a client holding its response finds it counted, and
        # the server root span closes before the client's enclosing one)
        t_send_clk = self.clock()
        t_send_ns = time.perf_counter_ns()
        self._finish_records(finished, t_send_clk, t_send_ns)
        for pend in finished:
            pend.conn.send(protocol.error_response(pend.id, pend.error))
        if finished:
            # post-mortem trigger: the ring is dumped the moment a batch
            # poisons real requests (best-effort, atomic)
            self.flight.dump(label="serve", reason="batch_error")

    def _finish_records(self, finished, t_send_clk: float | None = None,
                        t_send_ns: int | None = None) -> None:
        """SLO + flight + trace bookkeeping for requests that just
        finished (ok or poisoned): one flight record each, the request
        latency observed into the sliding window (errors counted into
        the error budget instead), and the ``request/server`` root span
        closed on the request's synthetic track."""
        if not finished:
            return
        from raft_tpu_torch.obs import trace as _trace

        t_send_clk = self.clock() if t_send_clk is None else t_send_clk
        t_send_ns = (time.perf_counter_ns() if t_send_ns is None
                     else t_send_ns)
        for pend in finished:
            ok = pend.error is None
            total_s = max(0.0, t_send_clk - pend.t0)
            if ok:
                self._slo_latency.observe(total_s, now=t_send_clk)
            else:
                self._slo_latency.error(now=t_send_clk)
            with self._lock:
                self._req_done += 1
                if not ok:
                    self._req_err += 1
            if pend.trace:
                _trace.record(
                    "request/server", pend.t_recv_ns, t_send_ns, depth=1,
                    attrs={"op": pend.op, "ok": ok},
                    trace=pend.trace,
                    tid=_trace.synthetic_tid(pend.trace),
                    track=f"req {pend.id}")
            self.flight.record({
                "id": pend.id,
                "op": pend.op,
                "trace": pend.trace,
                "buckets": list(pend.sigs),
                "stage_s": round(pend.stage_s, 6),
                "queue_wait_s": list(pend.waits),
                "solve_s": list(pend.solve_s),
                "total_s": round(total_s, 6),
                "outcome": ("ok" if ok else
                            f"error:{type(pend.error).__name__}"),
            })

    def _deliver(self, lanes, rows, t_close) -> None:
        finished = []
        with self._lock:
            for ln, row in zip(lanes, rows):
                pend = ln.request_id
                pend.rows[ln.seq] = row
                # EXACTLY batch close minus submit, on the batcher's
                # clock: the flight-recorder breakdown and t_queue_s
                # agree with the virtual-clock tests to the last bit
                pend.waits[ln.seq] = round(max(0.0, t_close - ln.t_submit), 6)
                pend.remaining -= 1
                if pend.remaining <= 0:
                    finished.append(pend)
        t_send_clk = self.clock()
        t_send_ns = time.perf_counter_ns()
        # SLO/flight/trace bookkeeping BEFORE the response frames go
        # out: a client that holds its response and immediately asks
        # for stats must find its own request already counted (and the
        # server root span must close before the client's enclosing
        # span does)
        self._finish_records(finished, t_send_clk, t_send_ns)
        for pend in finished:
            if pend.error is not None:     # another batch of this request
                pend.conn.send(            # failed earlier
                    protocol.error_response(pend.id, pend.error))
                continue
            pend.conn.send({
                "id": pend.id,
                "ok": True,
                "results": pend.rows,
                "t_queue_s": pend.waits,
                "t_total_s": round(t_send_clk - pend.t0, 6),
                **({"trace": pend.trace} if pend.trace else {}),
            })

    # -------------------------------------------------------- telemetry
    def reset_telemetry(self) -> None:
        """Measurement-window boundary (the bench's warm pass vs
        measured pass; the ``refresh`` op): fresh SLO windows and a
        zeroed error budget.  The flight recorder keeps its ring — a
        post-mortem wants history across boundaries, not a blank tape."""
        with self._slo_lock:
            self._slo_latency = SlidingHistogram(
                "serve.latency_s", window_s=self.slo_window_s)
            self._slo_wait = {}
        with self._lock:
            self._req_done = 0
            self._req_err = 0

    def telemetry(self) -> dict:
        """The live SLO snapshot the extended ``stats`` op returns:
        windowed request-latency quantiles + error rate, per-bucket
        queue-wait windows, occupancy, queue depth, exact error budget,
        the kernel-library builds of this process, the flight-recorder
        counters, the performance ledger's status and the cache switch.
        All deterministic under a virtual clock."""
        from raft_tpu_torch import obs as _obs
        from raft_tpu_torch.cache import config as _cache_config

        now = self.clock()
        with self._slo_lock:
            waits = {label: w.window(now)
                     for label, w in sorted(self._slo_wait.items())}
        with self._lock:
            done, errs = self._req_done, self._req_err
        solver = self.core.stats()
        return {
            "uptime_s": round(time.monotonic() - self.t_armed, 3),
            "window_s": self.slo_window_s,
            "latency": self._slo_latency.window(now),
            "queue_wait": waits,
            "occupancy": {label: st["mean_occupancy"]
                          for label, st in solver["buckets"].items()},
            "queue_depth": self.batcher.depth(),
            "error_budget": {
                "requests": done,
                "errors": errs,
                "error_rate": round(errs / done, 6) if done else 0.0,
            },
            "compiles": solver["compiles"],
            "flight": self.flight.counts(),
            # lightweight: a polled stats op reads no ledger file
            "ledger": _obs.ledger.stat(),
            "cache_enabled": _cache_config.is_enabled(),
        }
