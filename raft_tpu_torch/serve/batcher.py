"""Deadline-or-capacity micro-batching: the deterministic serve-loop core
(port of ``raft_tpu.serve.batcher``; pure Python, the same rules).

Each shape bucket (a :class:`raft_tpu_torch.build.buckets.BucketSig`) owns a
FIFO of pending lanes.  A bucket's open batch closes when EITHER

* it holds ``batch_max`` lanes (**capacity close** — exactly
  ``batch_max`` oldest lanes pop; any younger lanes stay queued with
  their original arrival times), or
* its OLDEST lane has waited ``batch_deadline_s`` (**deadline close** —
  everything pending pops, up to ``batch_max``).

Determinism contract (pinned by tests/test_torch_serve.py on a virtual
clock):
batch compositions are a pure function of the arrival schedule — the
sequence of ``submit(sig, lane)`` calls with their clock readings — and
the two knobs.  No wall-clock reads hide in the decision logic: the
clock is INJECTED (``time.monotonic`` in the daemon, a manual counter in
tests), ties between simultaneously-closeable
buckets break on (oldest arrival, sorted signature), and the queues are
plain FIFOs.  Because the solver pads every batch to the fixed capacity
anyway (see :mod:`raft_tpu_torch.serve.solver`), composition affects LATENCY
only — results are composition-independent by construction — but a
deterministic composition is what makes the serving bench reproducible
and the batching testable at all.

Thread contract: ``submit`` is called by N connection readers,
``next_batch`` by the single solver loop, ``close`` by the signal
handler — all state behind one lock + condition.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque


@dataclasses.dataclass
class Lane:
    """One unit of solve work: a single (design, sea state) pair owned by
    a request.  ``staged`` carries the memoized bucket-padded lane arrays
    (see :meth:`raft_tpu_torch.serve.solver.SolverCore.stage_lane`); the
    batcher never looks inside it."""

    request_id: object
    seq: int                  # lane index within the owning request
    label: str                # short design label (metrics/logs)
    staged: object            # (members, rna, env, wave, C_moor)
    t_submit: float = 0.0     # batcher clock reading at submit
    trace: str = ""           # request-scoped trace id (obs.trace)
    t_submit_ns: int = 0      # perf_counter_ns at submit (span endpoints)


class MicroBatcher:
    """Deterministic deadline/capacity lane coalescer (see module doc)."""

    def __init__(self, batch_deadline_s: float, batch_max: int,
                 clock=time.monotonic):
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        self.deadline_s = float(batch_deadline_s)
        self.batch_max = int(batch_max)
        self.clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._pending: dict = {}          # sig -> deque[Lane]
        self._closed = False
        self._submitted = 0
        self._popped = 0

    # ------------------------------------------------------------ intake
    def submit(self, sig, lane: Lane) -> None:
        """Enqueue one lane under its bucket signature (FIFO).  Raises
        once the batcher is closed — a request that raced shutdown gets
        an error response instead of vanishing into a dead queue."""
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            lane.t_submit = self.clock()
            self._pending.setdefault(sig, deque()).append(lane)
            self._submitted += 1
            self._nonempty.notify_all()

    def close(self) -> None:
        """Stop intake and wake the solver loop; already-queued lanes
        stay drainable via :meth:`next_batch` (flush-on-close) until the
        queues empty."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()

    def set_deadline(self, deadline_s: float) -> None:
        """Mid-life deadline change (the server's ``refresh`` op), under
        the lock so a concurrent ``next_batch`` decision never reads a
        torn value."""
        with self._lock:
            self.deadline_s = float(deadline_s)
            self._nonempty.notify_all()

    def set_batch_max(self, batch_max: int) -> None:
        """Mid-life capacity change (``refresh``): locked, and the
        waiting solver loop is woken so a now-capacity-closeable bucket
        pops immediately."""
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        with self._lock:
            self.batch_max = int(batch_max)
            self._nonempty.notify_all()

    # --------------------------------------------------------- decisions
    def _ready_sig(self, now: float):
        """The bucket to close at ``now``, or None.  Capacity wins over
        deadline; among closeable buckets the one whose OLDEST lane
        arrived first pops (ties on the sorted signature) — a total
        order, so two runs of one schedule close identical batches.
        After :meth:`close`, any non-empty bucket is closeable (drain)."""
        best = None
        for sig, q in self._pending.items():
            if not q:
                continue
            closeable = (len(q) >= self.batch_max
                         or self._closed
                         or now - q[0].t_submit >= self.deadline_s)
            if not closeable:
                continue
            key = (q[0].t_submit, tuple(sig))
            if best is None or key < best[0]:
                best = (key, sig)
        return None if best is None else best[1]

    def _next_deadline(self):
        """Earliest instant any bucket becomes deadline-closeable, or
        None when everything is empty."""
        t = None
        for q in self._pending.values():
            if q:
                d = q[0].t_submit + self.deadline_s
                t = d if t is None else min(t, d)
        return t

    # ------------------------------------------------------------- drain
    def next_batch(self, timeout: float | None = None):
        """Block until a batch closes; returns ``(sig, [lanes])`` (FIFO
        order, ``len <= batch_max``), or ``None`` when the batcher is
        closed AND drained (the solver loop's exit signal) or the
        optional ``timeout`` expires with nothing closeable."""
        t_wait0 = time.monotonic()
        with self._lock:
            while True:
                now = self.clock()
                sig = self._ready_sig(now)
                if sig is not None:
                    q = self._pending[sig]
                    lanes = [q.popleft()
                             for _ in range(min(len(q), self.batch_max))]
                    if not q:
                        del self._pending[sig]
                    self._popped += len(lanes)
                    return sig, lanes
                if self._closed:          # closed and fully drained
                    return None
                # sleep until the earliest pending deadline (or a submit
                # wakes us); an empty queue set waits for intake only
                nd = self._next_deadline()
                wait = None if nd is None else max(0.0, nd - now)
                if timeout is not None:
                    budget = timeout - (time.monotonic() - t_wait0)
                    if budget <= 0.0:
                        return None
                    wait = budget if wait is None else min(wait, budget)
                if wait is None:
                    # nothing pending: block until a submit/close notifies
                    self._nonempty.wait()
                else:
                    # a deadline is pending.  The sleep is capped at 50 ms
                    # because ``wait`` mixes clock domains when the clock
                    # is virtual (test units vs the real
                    # seconds Condition.wait consumes) — bounded-staleness
                    # re-polling keeps the loop live under any clock.
                    self._nonempty.wait(min(max(wait, 1e-4), 0.05))

    # ------------------------------------------------------------- stats
    def depth(self) -> dict:
        """Pending lane count per bucket (stats op)."""
        with self._lock:
            return {str(tuple(sig)): len(q)
                    for sig, q in self._pending.items() if q}

    def counters(self) -> dict:
        with self._lock:
            return {"submitted": self._submitted, "popped": self._popped,
                    "pending": sum(len(q) for q in self._pending.values())}
