"""Observability sinks: JSONL event log, Chrome trace file, Prometheus
text exposition, and the ``obs`` block a run report embeds (port of
``raft_tpu.obs.export``).

Armed by the ``RAFT_TPU_OBS`` env knob: unset/``off`` disables
everything — the default, and the fast path writes NOTHING; ``1``/``on``
roots the sink directory under the port's cache root's ``obs/``
(``RAFT_TPU_TORCH_CACHE_DIR``, else ``raft_tpu_torch/_build/cache``); any
other value is the sink directory itself.  Host-side by contract: arming
the knob never changes what the device computes.

Publishing is ATOMIC (tmp + ``os.replace``, as the chunk store and the
result caches publish): a kill mid-publish leaves either the previous
complete file or nothing — never a torn artifact.
Reading is corruption-tolerant anyway (:func:`read_jsonl` skips
undecodable lines and reports how many, the ``ChunkStore`` precedent),
so even a log produced by a foreign writer that appends non-atomically
stays loadable after a mid-write kill.

File layout under the sink directory (pid-suffixed so concurrent
processes never clobber each other)::

    obs-<label>-p<rank>-<pid>.jsonl      one JSON object per line: a meta
                                         header, every completed span,
                                         one metric snapshot
    trace-<label>-p<rank>-<pid>.json     Chrome trace-event JSON (Perfetto)
    metrics-<label>-p<rank>-<pid>.prom   Prometheus text exposition

As in the JAX package, a real publish also flushes the per-kernel
performance ledger (:mod:`raft_tpu_torch.obs.ledger`, without waiting for
the card: only the launches already done are folded in), and the ``obs``
block carries the compile counts of the kernel-library registry
(:mod:`raft_tpu_torch.cache.aot`).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.obs import trace as _trace

_OFF = ("", "off", "0", "none", "disabled", "false", "no")

#: knob naming the auto-publish debounce interval (milliseconds); its
#: value is snapshotted ONCE, at the first armed publish decision (the
#: arm-time contract) — the request path never re-reads the environment
FLUSH_ENV = "RAFT_TPU_OBS_FLUSH_MS"
DEFAULT_FLUSH_MS = 1000.0

_flush_lock = threading.Lock()
_flush_interval_s: list = [None]     # snapshot-once seconds
_last_publish: list = [None]         # monotonic stamp of the last publish


def root() -> str | None:
    """The sink directory this process would publish under, or None when
    ``RAFT_TPU_OBS`` is off (the default)."""
    v = os.environ.get("RAFT_TPU_OBS", "").strip()
    if v.lower() in _OFF:
        return None
    if v.lower() in ("1", "on", "true", "yes"):
        from raft_tpu_torch.cache import config

        return os.path.join(str(config.cache_root()), "obs")
    return os.path.abspath(os.path.expanduser(v))


def enabled() -> bool:
    return root() is not None


def flush_interval_s() -> float:
    """The auto-publish debounce interval (seconds), snapshotted from
    ``RAFT_TPU_OBS_FLUSH_MS`` at first use (default 1000 ms).  A publish
    writes three sink files; per-sweep auto-publish on a short timed leg
    would pay that EVERY call — the debounce amortizes it to at most once
    per interval, while forced publishes (phase ends, shutdown) always
    write."""
    with _flush_lock:
        if _flush_interval_s[0] is None:
            raw = os.environ.get(FLUSH_ENV, "").strip()
            try:
                ms = float(raw) if raw else DEFAULT_FLUSH_MS
            except ValueError:
                ms = DEFAULT_FLUSH_MS
            _flush_interval_s[0] = max(0.0, ms) / 1e3
        return _flush_interval_s[0]


def _reset_debounce() -> None:
    """Tests (and ``obs.reset``): forget the interval snapshot and the
    last-publish stamp so each test arms fresh."""
    with _flush_lock:
        _flush_interval_s[0] = None
        _last_publish[0] = None


def _atomic_write(path: str, text: str) -> None:
    """tmp + ``os.replace`` publish (no torn artifact under a durable
    root, ever)."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def process_tag(label: str) -> str:
    """Per-process export-file tag: ``<label>-p<rank>-<pid>``.

    The pid alone is NOT collision-safe across hosts — two hosts sharing
    one export root (a common mount) can draw the same pid and clobber
    each other's files.  The rank of an initialized
    ``torch.distributed`` group is unique per process of a job, and 0
    when undistributed; it is read only when torch is already imported —
    telemetry is never the reason torch loads."""
    idx = 0
    torch = sys.modules.get("torch")
    if torch is not None:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            idx = int(dist.get_rank())
    return f"{label}-p{idx}-{os.getpid()}"


def _jsonl_lines(label: str) -> list:
    lines = [json.dumps({
        "type": "meta", "label": label, "pid": os.getpid(),
        "schema": 1, "unix_time": time.time(),
    })]
    for s in _trace.spans():
        lines.append(json.dumps({
            "type": "span", "name": s.name, "ts_us": s.t0_us,
            "dur_us": s.dur_us, "tid": s.tid, "depth": s.depth,
            **({"trace": s.trace} if s.trace else {}),
            **({"track": s.track} if s.track else {}),
            **({"attrs": dict(s.attrs)} if s.attrs else {}),
        }))
    lines.append(json.dumps({"type": "metrics", **_metrics.snapshot()}))
    return lines


def publish(label: str = "run", directory: str | None = None) -> dict:
    """Write the three sink files for this process's current span ring +
    metric snapshot.  ``directory`` overrides the env-resolved root
    (tests); raises when neither resolves.  Returns the paths written."""
    d = directory or root()
    if d is None:
        raise RuntimeError(
            "obs export is not armed: set RAFT_TPU_OBS (1 = cache root, "
            "or a directory) or pass directory=")
    os.makedirs(d, exist_ok=True)
    tag = process_tag(label)
    paths = {
        "jsonl": os.path.join(d, f"obs-{tag}.jsonl"),
        "chrome_trace": os.path.join(d, f"trace-{tag}.json"),
        "prom": os.path.join(d, f"metrics-{tag}.prom"),
    }
    _atomic_write(paths["jsonl"], "\n".join(_jsonl_lines(label)) + "\n")
    _atomic_write(paths["chrome_trace"], json.dumps(_trace.chrome_trace()))
    _atomic_write(paths["prom"], prometheus_text())
    with _flush_lock:
        _last_publish[0] = time.monotonic()
    return paths


def maybe_publish(label: str = "run", force: bool = False) -> dict | None:
    """:func:`publish` when armed, no-op (None) otherwise — the call the
    instrumented entry points (the sweeps) make unconditionally.  Auto-publishes are DEBOUNCED on a monotonic clock
    (:func:`flush_interval_s`): within the interval of the last publish
    the call is skipped (counted in ``obs.publish_skipped``) so the
    constant per-publish file cost amortizes across a hot sweep loop
    instead of taxing every call.  ``force=True`` bypasses the debounce
    — phase ends (a run's exit, a daemon's drain) always flush a
    complete final snapshot.  Never raises: a full disk must degrade the
    telemetry, not the solve.  Also flushes the performance ledger
    (:mod:`raft_tpu_torch.obs.ledger`) on every real publish, without a
    wait for the card."""
    if not enabled():
        return None
    if not force:
        interval = flush_interval_s()
        with _flush_lock:
            last = _last_publish[0]
        if last is not None and time.monotonic() - last < interval:
            _metrics.counter("obs.publish_skipped").inc()
            return None
    try:
        out = publish(label)
    except OSError:  # pragma: no cover - disk full / permissions
        return None
    try:
        from raft_tpu_torch.obs import ledger as _ledger

        _ledger.flush(sync=False)
    except Exception:  # pragma: no cover - the ledger must not fail a publish
        pass
    return out


def read_jsonl(path: str) -> tuple:
    """Parse a JSONL event log, skipping corrupt lines (a mid-write kill
    by a non-atomic foreign writer truncates the tail; the valid prefix
    must stay loadable, the chunk store's corruption-tolerance rule).
    Returns ``(events, n_corrupt)``."""
    events, corrupt = [], 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                corrupt += 1
                continue
            if isinstance(ev, dict):
                events.append(ev)
            else:
                corrupt += 1
    return events, corrupt


# ------------------------------------------------------- Prometheus ----

def _prom_name(name: str) -> str:
    out = []
    for ch in "raft_tpu_" + name:
        out.append(ch if (ch.isalnum() or ch in "_:") else "_")
    return "".join(out)


def prometheus_text() -> str:
    """The metric snapshot as a Prometheus text exposition (counters,
    gauges, and histograms with cumulative ``_bucket{le=...}`` series —
    the standard scrape format, also consumable by a file exporter)."""
    snap = _metrics.snapshot()
    lines = []
    for name, v in snap["counters"].items():
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} counter", f"{pn} {v}"]
    for name, v in snap["gauges"].items():
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} gauge", f"{pn} {v}"]
    for name, h in snap["histograms"].items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for edge, n in h["buckets"]:
            cum += n
            le = "+Inf" if edge == "+Inf" else repr(float(edge))
            lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
        if not h["buckets"] or h["buckets"][-1][0] != "+Inf":
            lines.append(f'{pn}_bucket{{le="+Inf"}} {h["count"]}')
        lines += [f"{pn}_sum {h['sum_s']}", f"{pn}_count {h['count']}"]
    return "\n".join(lines) + "\n"


# ------------------------------------------------------- run report ----

def obs_block() -> dict:
    """The ``obs`` block a run report embeds: the span roll-up (nested
    names with call counts), the full metric snapshot (histogram
    quantiles included), and the exact per-library build counts of the
    kernel-library registry (:func:`raft_tpu_torch.cache.aot.
    compile_counts`).  JSON-safe by construction."""
    from raft_tpu_torch.cache import aot

    snap = _metrics.snapshot()
    return {
        "spans": _trace.rollup(),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
        **({"sliding": snap["sliding"]} if "sliding" in snap else {}),
        **({"dropped_names": snap["dropped_names"]}
           if "dropped_names" in snap else {}),
        "compiles": aot.compile_counts(),
    }
