"""Flight recorder: a bounded ring of the last-N completed request
records, dumped atomically when something goes wrong (port of
``raft_tpu.obs.flight``).

The live SLO window (:class:`raft_tpu_torch.obs.metrics.SlidingHistogram`)
answers "how is the service doing"; the flight recorder answers "what
exactly were the last requests it served when it died".  Each record is
one small JSON-safe dict — id, op, trace id, bucket signatures, the
per-stage timing breakdown (staging, per-lane queue wait, solve,
total), and the outcome — appended by the serve delivery path and kept
in a fixed-size ring (a month-long daemon holds exactly ``capacity``
records, never more).

:meth:`FlightRecorder.dump` publishes the ring as one JSONL file via
the atomic tmp + ``os.replace`` write every durable artifact uses:
triggered on batch failure, on graceful shutdown (SIGTERM
included), and on the ``refresh`` op — so a post-mortem always finds
either the previous complete dump or the new one, never a torn file.
Dumping is best-effort by contract: a full disk degrades the
post-mortem, never the serving loop.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque

#: default ring capacity — enough tail to reconstruct the last seconds
#: of a busy daemon, small enough that a dump is always instant
DEFAULT_CAPACITY = 256


class FlightRecorder:
    """See module docstring.  Thread contract: ``record`` is called by
    the solver loop and (on failures) whatever thread noticed; one lock
    guards the ring and the exact counters."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._recorded = 0           # exact, survives the ring wrap
        self._errors = 0

    def record(self, rec: dict) -> None:
        """Append one completed-request record (JSON-safe dict; the
        caller owns the schema — the serve loop records id/op/trace/
        buckets/stage timings/outcome)."""
        with self._lock:
            self._ring.append(dict(rec))
            self._recorded += 1
            if str(rec.get("outcome", "ok")) != "ok":
                self._errors += 1

    def snapshot(self) -> list:
        """The ring's records, oldest first (copies)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def counts(self) -> dict:
        """Exact totals since construction plus the current ring size —
        the ``stats`` op's ``flight`` block."""
        with self._lock:
            return {"capacity": self.capacity, "size": len(self._ring),
                    "recorded": self._recorded, "errors": self._errors}

    def dump(self, path: str | None = None, label: str = "flight",
             reason: str = "") -> str | None:
        """Write the ring as one JSONL file: a meta header line (label,
        pid, reason, exact counters), then one line per record, oldest
        first.  ``path`` overrides the destination; otherwise the file
        lands in the armed ``RAFT_TPU_OBS`` sink directory as
        ``flight-<label>-p<rank>-<pid>.jsonl`` (None when obs is off — a
        recorder without a sink has nowhere to durably dump; the rank salt
        keeps two hosts sharing one sink from clobbering each other).  Atomic, best-effort: returns the
        path written or None."""
        from raft_tpu_torch.obs import export

        if path is None:
            d = export.root()
            if d is None:
                return None
            path = os.path.join(
                d, f"flight-{export.process_tag(label)}.jsonl")
        with self._lock:
            records = [dict(r) for r in self._ring]
            head = {"type": "meta", "label": label, "pid": os.getpid(),
                    "reason": reason, "capacity": self.capacity,
                    "recorded": self._recorded, "errors": self._errors}
        lines = [json.dumps(head)]
        lines += [json.dumps({"type": "request", **r}) for r in records]
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            export._atomic_write(path, "\n".join(lines) + "\n")
        except OSError:              # pragma: no cover - disk full/perms
            return None
        return path
