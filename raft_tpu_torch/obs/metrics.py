"""Process-wide metric registry: counters, gauges, and log-bucket
latency histograms — bounded, deterministic, host-side only (port of
``raft_tpu.obs.metrics``; the same names, buckets and quantiles).

Every hot path feeds the same registry (``counter("ckpt.saved")``,
``histogram("pipeline.fetch_s")``, ...), so a daemon, a smoke run or a
tool reads ONE coherent snapshot instead of scraping scattered stats
dicts.  Three deliberate properties:

* **Bounded memory**: a
  histogram is a FIXED array of log-spaced bucket counts (no reservoir,
  no per-observation storage), and the registry caps distinct metric
  names at :data:`_MAX_METRICS` — excess registrations share one
  overflow instance per kind and are counted in ``dropped_names``, so a
  name-cardinality bug degrades a metric, never the process.
* **Deterministic quantiles**: p50/p90/p99 are computed from bucket
  counts alone (rank-walk to a bucket's UPPER edge), so a test can
  hand-build counts and assert the exact quantile — no wall-clock
  randomness.  Values past the top edge saturate to it (quantiles stay
  finite and JSON-safe); the saturation is visible in the overflow
  bucket count.
* **Thread safety**: one module lock guards registration and updates —
  the increments are far off any per-sample hot loop (per chunk / per
  bucket / per cache event, not per lane).

The cumulative :class:`Histogram` answers "since process start"; a
*live* SLO needs "over the last minute".  :class:`SlidingHistogram`
adds that: a ring of per-sub-window bucket counts (plus an error
count), rotated by an explicit ``now`` argument — the clock is the
CALLER'S (the serve loop passes its injectable clock), so windowed
p50/p99 and error rate are exactly reproducible on a virtual clock,
the same determinism contract as the micro-batcher.
"""
from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left

#: registry cap on distinct metric names (bounded-memory contract)
_MAX_METRICS = 1024

#: histogram bucket edges: log-spaced, 5 per decade, 1 µs .. 1000 s —
#: wide enough for a span of anything from a device dispatch to a cold
#: BEM stage, coarse enough (±26%) to stay 46 numbers total
_PER_DECADE = 5
_EDGES: tuple = tuple(
    10.0 ** (-6 + i / _PER_DECADE) for i in range(9 * _PER_DECADE + 1)
)

_lock = threading.Lock()
_metrics: dict = {}              # name -> Counter | Gauge | Histogram | ...
_dropped: list = [0]             # registrations refused past the cap


def _quantile_from_counts(counts, total: int, q: float) -> float:
    """Deterministic rank-walk quantile shared by the cumulative and
    sliding histograms: the smallest bucket upper edge covering rank
    ``ceil(q * total)`` (0.0 when empty; saturates at the top edge)."""
    if total == 0:
        return 0.0
    rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * total))
    c = 0
    for i, n in enumerate(counts):
        c += n
        if c >= rank:
            return _EDGES[min(i, len(_EDGES) - 1)]
    return _EDGES[-1]                # pragma: no cover - unreachable


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "_n")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._n = 0

    def inc(self, n: int = 1) -> None:
        with _lock:
            self._n += int(n)

    @property
    def value(self) -> int:
        return self._n


class Gauge:
    """Last-written value (overlap fraction, solves/s, queue depth)."""

    __slots__ = ("name", "_v")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        with _lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed log-spaced-bucket latency histogram (seconds).

    ``counts[0]`` holds observations ≤ the lowest edge, ``counts[i]``
    (1 ≤ i ≤ len(edges)-1) the half-open bucket (edges[i-1], edges[i]],
    and ``counts[-1]`` everything above the top edge.  Quantiles walk
    the cumulative counts to rank ``max(1, ceil(q·total))`` and return
    that bucket's upper edge — exact, deterministic, saturating at the
    top edge (never infinity).
    """

    __slots__ = ("name", "counts", "total", "sum_s")
    kind = "histogram"
    edges = _EDGES

    def __init__(self, name: str):
        self.name = name
        self.counts = [0] * (len(_EDGES) + 1)
        self.total = 0
        self.sum_s = 0.0

    def observe(self, seconds: float) -> None:
        v = float(seconds)
        if not math.isfinite(v):
            return                       # a NaN latency is a bug upstream
        i = bisect_left(_EDGES, v) if v > _EDGES[0] else 0
        with _lock:
            self.counts[i] += 1
            self.total += 1
            self.sum_s += v

    def quantile(self, q: float) -> float:
        """The smallest bucket upper edge covering rank ``ceil(q·total)``
        (0.0 on an empty histogram)."""
        return _quantile_from_counts(self.counts, self.total, q)

    def to_dict(self) -> dict:
        """Snapshot: count/sum, the standard quantiles, and the NONZERO
        buckets as ``[upper_edge, count]`` pairs (the overflow bucket's
        edge is the string ``"+Inf"`` — JSON has no infinity)."""
        buckets = []
        for i, n in enumerate(self.counts):
            if n:
                edge = ("+Inf" if i >= len(_EDGES)
                        else float(f"{_EDGES[i]:.6g}"))
                buckets.append([edge, n])
        return {
            "count": self.total,
            "sum_s": round(self.sum_s, 6),
            "p50": float(f"{self.quantile(0.50):.6g}"),
            "p90": float(f"{self.quantile(0.90):.6g}"),
            "p99": float(f"{self.quantile(0.99):.6g}"),
            "buckets": buckets,
        }


class SlidingHistogram:
    """Windowed latency histogram + error counter: the live-SLO metric.

    The window of ``window_s`` seconds is a ring of ``n_sub``
    sub-windows, each a fixed bucket-count array (same log-spaced edges
    as :class:`Histogram`) plus an error count.  Every operation takes
    an explicit ``now`` (defaults to ``time.monotonic()``): sub-window
    ``floor(now / sub_s)`` is current, older slots age out of the
    merged view, and a slot is zeroed lazily when its ring position is
    reused — so memory is a FIXED ``n_sub × 47`` ints regardless of
    traffic, and the whole object is exactly reproducible under a
    virtual clock (windowed p50/p99 "match a hand-computable schedule"
    is a testable claim, not a hope).

    ``observe(seconds, now)`` records a success latency; ``error(now)``
    records a failure (errors are counted, not timed); ``window(now)``
    returns the merged snapshot: count, sum, p50/p90/p99, errors, and
    ``error_rate = errors / (count + errors)``.
    """

    __slots__ = ("name", "window_s", "n_sub", "sub_s", "_slots")
    kind = "sliding"
    edges = _EDGES

    def __init__(self, name: str, window_s: float = 60.0, n_sub: int = 12):
        if window_s <= 0 or n_sub < 1:
            raise ValueError(f"window_s must be > 0 and n_sub >= 1, got "
                             f"{window_s}/{n_sub}")
        self.name = name
        self.window_s = float(window_s)
        self.n_sub = int(n_sub)
        self.sub_s = self.window_s / self.n_sub
        # slot: [abs_index, counts list, total, sum_s, errors]
        self._slots = [[-1, [0] * (len(_EDGES) + 1), 0, 0.0, 0]
                       for _ in range(self.n_sub)]

    def _slot(self, now: float):
        """The current sub-window's slot, zeroed if its ring position
        still holds an older sub-window.  Caller holds the lock."""
        idx = int(now // self.sub_s)
        slot = self._slots[idx % self.n_sub]
        if slot[0] != idx:
            slot[0] = idx
            slot[1] = [0] * (len(_EDGES) + 1)
            slot[2] = 0
            slot[3] = 0.0
            slot[4] = 0
        return slot

    def observe(self, seconds: float, now: float | None = None) -> None:
        v = float(seconds)
        if not math.isfinite(v):
            return                       # a NaN latency is a bug upstream
        i = bisect_left(_EDGES, v) if v > _EDGES[0] else 0
        now = time.monotonic() if now is None else now
        with _lock:
            slot = self._slot(now)
            slot[1][i] += 1
            slot[2] += 1
            slot[3] += v

    def error(self, now: float | None = None) -> None:
        """Count one failed request in the current sub-window (errors
        feed the window's error rate, never its latency quantiles)."""
        now = time.monotonic() if now is None else now
        with _lock:
            self._slot(now)[4] += 1

    def window(self, now: float | None = None) -> dict:
        """Merged snapshot over the live sub-windows at ``now``: the
        last ``n_sub`` sub-window indices, current included — a
        deterministic function of the observation schedule."""
        with _lock:
            return self._window_locked(now)

    def _window_locked(self, now: float | None = None) -> dict:
        """:meth:`window` body; caller holds the module lock (the
        registry snapshot merges sliding windows under its own lock)."""
        now = time.monotonic() if now is None else now
        cur = int(now // self.sub_s)
        counts = [0] * (len(_EDGES) + 1)
        total, sum_s, errors = 0, 0.0, 0
        for slot in self._slots:
            if cur - self.n_sub < slot[0] <= cur:
                for i, n in enumerate(slot[1]):
                    counts[i] += n
                total += slot[2]
                sum_s += slot[3]
                errors += slot[4]
        return {
            "window_s": self.window_s,
            "count": total,
            "sum_s": round(sum_s, 6),
            "p50": float(f"{_quantile_from_counts(counts, total, 0.50):.6g}"),
            "p90": float(f"{_quantile_from_counts(counts, total, 0.90):.6g}"),
            "p99": float(f"{_quantile_from_counts(counts, total, 0.99):.6g}"),
            "errors": errors,
            "error_rate": (round(errors / (total + errors), 6)
                           if total + errors else 0.0),
        }

    def to_dict(self) -> dict:
        return self.window()


_OVERFLOW_NAME = "<overflow>"


def sliding(name: str, window_s: float = 60.0,
            n_sub: int = 12) -> SlidingHistogram:
    """Registry-backed :class:`SlidingHistogram` (the window parameters
    apply on first registration; later callers share the instance)."""
    with _lock:
        m = _metrics.get(name)
        if m is not None:
            if not isinstance(m, SlidingHistogram):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested as sliding")
            return m
        if len(_metrics) >= _MAX_METRICS:
            _dropped[0] += 1
            key = f"{_OVERFLOW_NAME}.sliding"
            m = _metrics.get(key)
            if m is None and len(_metrics) < _MAX_METRICS + 4:
                m = _metrics[key] = SlidingHistogram(key)
            return m if m is not None else SlidingHistogram(key)
        m = _metrics[name] = SlidingHistogram(name, window_s, n_sub)
        return m


def _get(name: str, cls):
    with _lock:
        m = _metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested as {cls.kind}")
            return m
        if len(_metrics) >= _MAX_METRICS:
            # bounded-registry contract: degrade to a shared overflow
            # instance per kind, count the refusal, never grow
            _dropped[0] += 1
            key = f"{_OVERFLOW_NAME}.{cls.kind}"
            m = _metrics.get(key)
            if m is None and len(_metrics) < _MAX_METRICS + 3:
                m = _metrics[key] = cls(key)
            return m if m is not None else cls(key)   # pragma: no cover
        m = _metrics[name] = cls(name)
        return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get(name, Histogram)


def snapshot() -> dict:
    """One coherent, JSON-safe view of every registered metric:
    ``{"counters": {...}, "gauges": {...}, "histograms": {...},
    "sliding": {...}}`` (the ``sliding`` key only when any window is
    registered) plus ``dropped_names`` when the registry cap ever
    refused a name."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    sliding_out: dict = {}
    # the whole read happens UNDER the lock (to_dict/quantile only read),
    # excluding concurrent observe()/inc(): the snapshot is coherent —
    # a histogram's bucket sum always equals its count
    with _lock:
        for name, m in sorted(_metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = float(f"{m.value:.6g}")
            elif isinstance(m, SlidingHistogram):
                sliding_out[name] = m._window_locked()
            else:
                out["histograms"][name] = m.to_dict()
        if sliding_out:
            out["sliding"] = sliding_out
        if _dropped[0]:
            out["dropped_names"] = _dropped[0]
    return out


def reset() -> None:
    """Drop every registered metric (tests, phase boundaries)."""
    with _lock:
        _metrics.clear()
        _dropped[0] = 0
