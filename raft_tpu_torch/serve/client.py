"""Async client of the resident solver service (port of
``raft_tpu.serve.client``).

A :class:`SolveClient` owns one socket connection, a background reader
thread, and a futures table keyed by request id: ``submit`` returns a
:class:`concurrent.futures.Future` immediately (the open-loop load
generator submits at its schedule regardless of completions), ``call``
is the synchronous convenience wrapper.  Responses arrive in whatever
order the server's batches close — the reader resolves each future by
the ``id`` echoed in the response frame.

Failure typing (the fleet router's failover machinery keys on these):

* connect attempts run through :func:`raft_tpu_torch.resilience.retry.
  retry_call` — bounded, backoff-aware, deadline-capped by
  ``connect_timeout`` — and exhaustion raises
  :class:`ServeConnectionLost`;
* with a ``read_timeout``, a request whose response has not arrived
  within the deadline fails its future with :class:`ServeTimeout` (the
  connection stays up: the daemon may just be slow, and other requests'
  frames are still good).  Without one, a dead-but-connected daemon can
  no longer block forever either — reader death fails every pending
  future with :class:`ServeConnectionLost`.

Request tracing: every solve-kind submit carries a ``trace`` id (minted
here via :func:`raft_tpu_torch.obs.trace.new_trace_id` unless the caller set
one), and the client records a ``request`` span — submit to response —
under that id on the request's synthetic track when the response lands.
In-process (the chip smoke's embedded daemon, the tests) that client span is
the ROOT of the same tree the server's ``request/server`` spans nest
under; cross-process each side exports its own half, joined by the
shared trace id.
"""
from __future__ import annotations

import itertools
import select
import socket
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout

from raft_tpu_torch.resilience.retry import RetryExhausted, retry_call
from raft_tpu_torch.serve import protocol

_TRACED_OPS = ("solve", "dlc", "sweep")

#: reader poll granularity while a read deadline is armed (a pure
#: wake-up-and-scan cadence: frames are never truncated by it — the poll
#: is a ``select`` BEFORE the frame read, so no bytes are consumed)
_POLL_S = 0.05


class ServeConnectionLost(ConnectionError):
    """The server connection died (connect ladder exhausted, or the
    stream closed/broke with requests still pending)."""


class ServeTimeout(ConnectionError):
    """A request's response did not arrive within the client's read
    deadline.  The connection itself is still up — solves are pure, so
    the caller may re-submit (the fleet router does, to a survivor)."""


#: backwards-compatible alias (pre-fleet name of the connection-loss
#: failure; external callers may still catch it)
ServerGone = ServeConnectionLost


def _connect(socket_path: str, connect_timeout: float,
             retry_interval: float):
    """One bounded connect ladder through the shared retry discipline;
    returns the connected socket or raises :class:`ServeConnectionLost`."""
    def attempt(_i):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(socket_path)
            return s
        except OSError:
            s.close()
            raise

    tries = max(1, int(connect_timeout / max(retry_interval, 1e-3)) + 1)
    try:
        return retry_call(
            attempt, retries=tries, backoff_s=retry_interval, growth=1.0,
            max_backoff_s=retry_interval, deadline_s=connect_timeout,
            retry_on=(OSError,),
            describe=f"connect solver daemon at {socket_path!r}")
    except RetryExhausted as e:
        raise ServeConnectionLost(
            f"could not reach solver daemon at {socket_path!r} within "
            f"{connect_timeout}s: {e.last}") from e


class SolveClient:
    def __init__(self, socket_path: str, connect_timeout: float = 10.0,
                 retry_interval: float = 0.05,
                 read_timeout: float | None = None):
        """Connect, retrying until ``connect_timeout`` — the standard way
        to wait for a freshly-spawned daemon to bind its socket.
        ``read_timeout`` (seconds, per request) arms the read deadline:
        a response overdue past it fails that request's future with
        :class:`ServeTimeout` while the connection keeps serving the
        rest."""
        self.socket_path = socket_path
        self.read_timeout = read_timeout
        self._sock = _connect(socket_path, connect_timeout, retry_interval)
        self._wlock = threading.Lock()
        self._flock = threading.Lock()
        self._futures: dict = {}
        self._ids = itertools.count()
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name="serve-client-reader",
                                        daemon=True)
        self._reader.start()

    # ------------------------------------------------------------ plumbing
    def _expire_overdue(self) -> None:
        """Fail every pending future whose read deadline has passed (the
        response, if it ever arrives, is dropped by the unknown-id
        path).  Called from the reader between polls."""
        if self.read_timeout is None:
            return
        now_ns = time.perf_counter_ns()
        limit_ns = int(self.read_timeout * 1e9)
        overdue = []
        with self._flock:
            for rid, (fut, t_submit_ns, _tr) in list(self._futures.items()):
                if now_ns - t_submit_ns > limit_ns:
                    overdue.append((rid, self._futures.pop(rid)[0]))
        for rid, fut in overdue:
            fut.set_exception(ServeTimeout(
                f"request {rid!r} got no response within "
                f"{self.read_timeout}s"))

    def _read_loop(self) -> None:
        err: Exception = ServeConnectionLost("connection closed by server")
        try:
            while True:
                if self.read_timeout is not None:
                    # deadline poll BEFORE the frame read: a timeout here
                    # consumes no bytes, so framing can never tear
                    r, _, _ = select.select([self._sock], [], [], _POLL_S)
                    if not r:
                        self._expire_overdue()
                        continue
                obj = protocol.recv_msg(self._sock)
                rid = obj.get("id") if isinstance(obj, dict) else None
                with self._flock:
                    entry = self._futures.pop(rid, None)
                if entry is not None:
                    fut, t_submit_ns, trace_id = entry
                    if trace_id:
                        # the client half of the request tree: submit ->
                        # response, on the request's synthetic track (the
                        # reader thread serves MANY overlapping requests —
                        # recording there would break track containment)
                        from raft_tpu_torch.obs import trace as _trace

                        _trace.record(
                            "request", t_submit_ns, time.perf_counter_ns(),
                            trace=trace_id,
                            tid=_trace.synthetic_tid(trace_id),
                            track=f"req {rid}")
                    fut.set_result(obj)
                # responses for unknown ids (e.g. a server-side error
                # frame with id=None, or one that already timed out) are
                # dropped — nothing waits on them
        except (protocol.PeerClosed, protocol.ProtocolError, OSError) as e:
            if not self._closed:
                err = e if isinstance(e, Exception) else err
        with self._flock:
            pending = [entry[0] for entry in self._futures.values()]
            self._futures.clear()
        for fut in pending:
            fut.set_exception(ServeConnectionLost(str(err)))

    def submit(self, obj: dict) -> Future:
        """Send one request frame; returns the Future of its response.
        Assigns a fresh ``id`` (and, for solve-kind ops, a fresh
        ``trace`` id) unless the caller set them."""
        if "id" not in obj or obj["id"] is None:
            obj = {**obj, "id": f"c{next(self._ids)}"}
        trace_id = obj.get("trace")
        if trace_id is None and obj.get("op") in _TRACED_OPS:
            from raft_tpu_torch.obs import trace as _trace

            trace_id = _trace.new_trace_id()
            obj = {**obj, "trace": trace_id}
        fut: Future = Future()
        with self._flock:
            if self._closed:
                raise ServeConnectionLost("client is closed")
            self._futures[obj["id"]] = (fut, time.perf_counter_ns(),
                                        trace_id or "")
        try:
            with self._wlock:
                protocol.send_msg(self._sock, obj)
        except OSError as e:
            with self._flock:
                self._futures.pop(obj["id"], None)
            raise ServeConnectionLost(f"send failed: {e}") from e
        return fut

    def call(self, obj: dict, timeout: float = 120.0) -> dict:
        """Submit and wait; raises on transport failure (typed:
        :class:`ServeTimeout` on deadline, :class:`ServeConnectionLost`
        on a dead connection), returns the response dict (check ``ok``
        for application-level errors)."""
        fut = self.submit(obj)
        try:
            return fut.result(timeout)
        except _FutTimeout:
            raise ServeTimeout(
                f"request {obj.get('id')!r} got no response within "
                f"{timeout}s") from None

    # ------------------------------------------------------- conveniences
    def ping(self, timeout: float = 10.0) -> dict:
        return self.call({"op": "ping"}, timeout)

    def stats(self, timeout: float = 30.0) -> dict:
        return self.call({"op": "stats"}, timeout)

    def solve(self, design, Hs: float, Tp: float,
              timeout: float = 120.0) -> dict:
        return self.call({"op": "solve", "design": design,
                          "Hs": Hs, "Tp": Tp}, timeout)

    def shutdown(self, timeout: float = 30.0) -> dict:
        return self.call({"op": "shutdown"}, timeout)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
