"""Thread-safe nested span tracing — the measurement half of the
observability layer (:mod:`raft_tpu_torch.obs`; port of
``raft_tpu.obs.trace``).

A *span* is one timed region of host-side work with a nested name
("sweep_designs/bucket/pipeline/fetch"): spans opened while another span
is open on the SAME thread nest under it — the nesting stack lives in
``threading.local`` storage, so two threads (a request-serving daemon)
can trace concurrently without corrupting each other's paths.  Timestamps are monotonic
(``time.perf_counter_ns`` against a process epoch), never wall-clock.

Memory is BOUNDED: the
ordered span log is a ring of the most recent :data:`_SPANS_MAX`
completed spans, while exact per-name ``(count, total seconds)``
aggregates live in a side table capped at :data:`_AGG_MAX` distinct
names (excess names aggregate under ``"<other>"``) — roll-up totals stay
exact long after the ring has wrapped, and a long-lived process can
never grow either without limit.

Exporters: :func:`chrome_trace` renders the ring as Chrome trace-event
JSON (complete ``"ph": "X"`` events plus one ``thread_name`` metadata
event per track; load the file in Perfetto or ``chrome://tracing`` —
children nest by time containment per thread track), and
:func:`rollup` is the machine-readable per-name summary a run report
embeds (:func:`raft_tpu_torch.obs.export.obs_block`).  All host-side: a span never changes what the device computes.
While a ``torch.profiler`` records, every span is also a profiler range
under its full path (:func:`span`), so a profile names the host work
around the device's idle gaps by the program's own spans.

**Trace context (request-scoped tracing).**  A span tree that follows
one *request* crosses threads: the client submits on one, a connection
reader stages on another, the solver loop dispatches on a third.  Three
primitives stitch those fragments into ONE tree:

* :func:`new_trace_id` mints a process-unique request id (pid +
  counter — deterministic, no wall-clock or randomness);
* :func:`current_context` captures this thread's ``(trace id, open
  path)`` as a :class:`TraceContext` token, and ``with context(tok):``
  adopts it on ANY thread — spans opened inside carry the token's trace
  id and nest under its path;
* :func:`record` accepts explicit ``trace``/``tid``/``track`` overrides
  so a coordinator thread (the serve solver loop) can emit spans for
  stages it timed on behalf of a request — e.g. queue wait — onto a
  stable synthetic track (:func:`synthetic_tid`), keeping per-track
  time containment intact even when many requests overlap in time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import os
import sys
import threading
import time
from collections import deque

#: completed-span ring bound (bounded, recent)
_SPANS_MAX = 65536
#: distinct full-path names the exact roll-up tracks before aggregating
#: the rest under _OVERFLOW
_AGG_MAX = 4096
_OVERFLOW = "<other>"

#: process trace epoch — every span timestamp is µs after this instant
_EPOCH_NS = time.perf_counter_ns()

#: tid -> thread name, captured at record time for the Chrome metadata
#: events; bounded like every other buffer (FIFO eviction past the cap)
_TID_NAMES_MAX = 4096

_lock = threading.Lock()
_spans: deque = deque(maxlen=_SPANS_MAX)
_agg: dict = {}                  # full name -> [count, total_seconds]
_tid_names: dict = {}            # tid -> thread name (bounded)
_tls = threading.local()
_trace_ids = itertools.count(1)  # lock-free unique suffix per process


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed span: full nested ``name``, start/duration in µs
    relative to the process trace epoch, and the recording thread.
    ``trace`` groups the spans of one request across threads (empty
    outside any trace context); ``track`` optionally names a synthetic
    Chrome track the span renders on (empty = the recording thread)."""

    name: str
    t0_us: int
    dur_us: int
    tid: int
    depth: int
    attrs: tuple = ()            # ((key, value), ...) — small, hashable
    trace: str = ""
    track: str = ""


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """A portable handle to an open span tree: the trace id plus the
    path spans should nest under.  Capture with :func:`current_context`
    on the owning thread, adopt with :func:`context` on any other."""

    trace: str = ""
    path: str = ""


def new_trace_id() -> str:
    """Mint a process-unique trace id (pid + counter): deterministic —
    no randomness, no wall clock — and unique across the processes of
    one machine, which is all a local request tree needs."""
    return f"{os.getpid():x}-{next(_trace_ids)}"


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_path() -> str:
    """The open span path on THIS thread ("" outside any span)."""
    return "/".join(_stack())


def current_trace() -> str:
    """The trace id adopted on THIS thread ("" outside any context)."""
    return getattr(_tls, "trace", "") or ""


def current_context() -> TraceContext:
    """This thread's trace id + open span path as a portable token."""
    return TraceContext(trace=current_trace(), path=current_path())


@contextlib.contextmanager
def context(ctx: TraceContext):
    """Adopt another thread's trace context: spans opened inside nest
    under ``ctx.path`` and carry ``ctx.trace``.  The thread's previous
    context (stack and trace id) is restored on exit — contexts nest."""
    old_trace = getattr(_tls, "trace", "")
    old_stack = getattr(_tls, "stack", None)
    _tls.trace = ctx.trace
    _tls.stack = [p for p in ctx.path.split("/") if p] if ctx.path else []
    try:
        yield
    finally:
        _tls.trace = old_trace
        _tls.stack = old_stack if old_stack is not None else []


def synthetic_tid(key: str) -> int:
    """A stable 31-bit Chrome track id for ``key`` (a trace id, or
    ``trace#lane``): the serve loop renders request-scoped stages on
    per-request tracks so overlapping requests never break per-track
    time containment.  Deterministic across processes."""
    return int.from_bytes(hashlib.blake2s(key.encode(),
                                          digest_size=4).digest(),
                          "big") & 0x7FFFFFFF


def record(full: str, t0_ns: int, t1_ns: int, depth: int = 0,
           attrs: dict | None = None, trace: str | None = None,
           tid: int | None = None, track: str | None = None) -> None:
    """Record one completed span from explicit monotonic-ns endpoints
    (the :func:`span` context manager's backend; callers that already
    timed a region feed it here rather than timing twice).

    ``trace`` defaults to the recording thread's adopted trace id;
    ``tid`` defaults to the recording thread (pass
    :func:`synthetic_tid` output to place the span on a synthetic
    track, naming it via ``track``) — the serve loop uses both to emit
    request-scoped stages it timed on other threads' behalf."""
    # µs endpoints are BOTH floored against the epoch and the duration is
    # their difference — never an independently-floored (t1-t0).  Floor is
    # monotonic, so a child interval inside its parent's ns interval stays
    # inside in integer µs too: the time-containment invariant Perfetto's
    # slice nesting (and any validator of the trace) relies on cannot be broken
    # by sub-µs rounding.
    t0_us = max(0, (t0_ns - _EPOCH_NS) // 1000)
    end_us = max(t0_us, (t1_ns - _EPOCH_NS) // 1000)
    real_tid = tid is None
    if real_tid:
        tid = threading.get_ident() & 0x7FFFFFFF
    s = Span(
        name=full,
        t0_us=t0_us,
        dur_us=end_us - t0_us,
        tid=tid,
        depth=depth,
        attrs=tuple(sorted(attrs.items())) if attrs is not None else (),
        trace=current_trace() if trace is None else trace,
        track=track or "",
    )
    dt_s = max(0, t1_ns - t0_ns) / 1e9
    with _lock:
        _spans.append(s)
        if real_tid and tid not in _tid_names:
            if len(_tid_names) >= _TID_NAMES_MAX:  # pragma: no cover
                _tid_names.pop(next(iter(_tid_names)))
            _tid_names[tid] = threading.current_thread().name
        key = full if (full in _agg or len(_agg) < _AGG_MAX) else _OVERFLOW
        c = _agg.get(key)
        if c is None:
            c = _agg[key] = [0, 0.0]
        c[0] += 1
        c[1] += dt_s


@contextlib.contextmanager
def span(name: str, attrs: dict | None = None):
    """Time a named region (nested names join with '/', per thread).

    While a ``torch.profiler`` records, the span also opens
    ``torch.profiler.record_function`` under its full nested path, so the
    region is a ``user_annotation`` range on the profiler's clock, beside
    the kernels it launched; otherwise it never enters ``record_function``
    (whose cost, with no profiler, is about a whole span's).  The check
    reads torch only once torch is loaded: a span never loads it.
    ``attrs`` is a small dict of static labels carried into the Chrome
    trace event's ``args`` (chunk index, bucket signature, ...).

    The span records on EVERY exit path (exceptions included), and its
    cost is a few µs of host time: safe on hot host paths.  It times the
    host: around asynchronous CUDA work it measures the enqueue, unless
    the region ends in a synchronise.
    """
    st = _stack()
    full = "/".join([*st, name])
    st.append(name)
    rng = None
    torch = sys.modules.get("torch")
    if torch is not None and torch._C._autograd._profiler_enabled():
        from torch.profiler import record_function

        rng = record_function(full)
        rng.__enter__()
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        if rng is not None:
            rng.__exit__(None, None, None)
        st.pop()
        record(full, t0, t1, depth=len(st), attrs=attrs)


def spans() -> list:
    """The bounded ring of completed spans, oldest first."""
    with _lock:
        return list(_spans)


def rollup() -> dict:
    """Exact per-name ``{"count", "total_s"}`` aggregates since process
    start (or the last :func:`reset`) — unlike the ring, never lossy
    Names past the :data:`_AGG_MAX` cap
    fold into ``"<other>"``."""
    with _lock:
        return {k: {"count": v[0], "total_s": round(v[1], 6)}
                for k, v in sorted(_agg.items())}


def chrome_trace() -> dict:
    """The span ring as a Chrome trace-event JSON object (Perfetto /
    ``chrome://tracing`` loadable).  Complete events (``"ph": "X"``)
    with µs timestamps; one track per recording thread (or synthetic
    request track); the full nested path rides in ``args.path``, the
    request trace id in ``args.trace``, and the event name is the leaf.
    One ``thread_name`` metadata event (``"ph": "M"``) labels every
    track — real threads by their Python thread name, synthetic tracks
    by the recording span's ``track`` string."""
    pid = os.getpid()
    with _lock:
        ring = list(_spans)
        names = dict(_tid_names)
    track_names: dict = {}
    events = []
    for s in ring:
        if s.track:
            track_names[s.tid] = s.track
        elif s.tid not in track_names:
            track_names[s.tid] = names.get(s.tid, f"thread-{s.tid}")
        events.append({
            "name": s.name.rsplit("/", 1)[-1],
            "cat": "raft_tpu",
            "ph": "X",
            "ts": s.t0_us,
            "dur": s.dur_us,
            "pid": pid,
            "tid": s.tid,
            "args": {"path": s.name,
                     **({"trace": s.trace} if s.trace else {}),
                     **dict(s.attrs)},
        })
    meta = [{
        "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
        "args": {"name": name},
    } for tid, name in sorted(track_names.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def reset() -> None:
    """Clear the span ring, the roll-up aggregates, and the track-name
    table (tests, phase boundaries of long-lived processes).  Open
    spans on any thread keep their stacks — only completed-span history
    is dropped."""
    with _lock:
        _spans.clear()
        _agg.clear()
        _tid_names.clear()
