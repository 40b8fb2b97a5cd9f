"""Measured-performance ledger: achieved FLOP/s, bytes/s and roofline
fraction per (kernel, bucket, device), persisted under the cache root
(port of ``raft_tpu.obs.ledger``).

The JAX ledger joins each measured dispatch of a registry executable with
XLA's cost analysis of the whole program.  Eager PyTorch has no
whole-program cost analysis, so the port's entries are per KERNEL: while
the cache is enabled (:func:`raft_tpu_torch.cache.enable`), the wrappers
of ``core/cuda6.py`` (K1, K2) and ``core/cuda_bem.py`` (K3, K4) time each
launch with a pair of CUDA events on the launch stream and queue the pair
with the launch's work, counted from its shapes alone (K1 and K2,
:func:`raft_tpu_torch.core.cuda6.work`) or from the data (K3 and K4,
whose region counts are computed on the card before the launch and copied
to pinned host memory without a wait).  The same launch reads the same
work whatever implements it, and ``roofline_fraction`` is the least time
the card could take for that work divided by the measured time: the bound
of PERF.md's kernel table over the ledger's own best time.

``entry`` is the kernel's name as in ``chip_smoke.py``'s ``kernels``
line (``solve6_fused``, ``solve6_plain``, ``bem_rankine``, ``bem_wave``,
``bem_rankine_bf16``, ``bem_wave_bf16``) and ``bucket`` a shape-and-dtype
label.  Per launch:

    achieved_flops_per_s = flops / best_s
    intensity            = flops / bytes_accessed          (flop/byte)
    attainable           = min(peak_flops, intensity * peak_bytes_per_s)
    roofline_fraction    = achieved_flops_per_s / attainable

No host sync on the launch path: completed event pairs are folded in with
``Event.query()`` when the next launch of the same key is recorded; each
key holds at most :data:`MAX_UNRESOLVED` pairs in flight, and a launch
past that is counted in ``ledger.dropped`` and not timed.  Only
:func:`flush` waits for the card (``sync=False``, the obs publish's
form, folds in only what is done).  Aggregates persist CONTENT-KEYED
under ``<root>/ledger/<entry>-<bucket>-<digest>.json``: the digest covers
the entry, the bucket, the device, :func:`~raft_tpu_torch.cache.config.
code_fingerprint` and the launch's work, so a source edit re-keys its
measurements.  A flush merges with what is on disk under an advisory
flock (count and total summed, best the minimum).

The peaks are a table by device kind and the arithmetic's dtype
(:data:`PEAKS`: the H100 SXM data sheet, HBM3 at 3.35 TB/s and the rates
outside the tensor cores; a bf16 entry computes in float32), overridden
by ``RAFT_TPU_TORCH_ROOFLINE`` (``"<flops>:<bytes/s>"``, read once).
Each entry records which peak it used (``peak.source``).  The
``sweep_designs`` dispatch of the JAX package feeds its ledger a
whole-program cost; the port's feeds nothing but its kernels' launches.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import threading

#: H100 SXM peaks (NVIDIA data sheet, the card at 700 W): HBM3 bytes/s
#: and FLOP/s outside the tensor cores, by the arithmetic's dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

#: (device-kind substring, {dtype: peak FLOP/s}, peak bytes/s), checked in
#: order; the CPU row is the JAX package's order-of-magnitude host default
PEAKS: tuple = (
    ("h100", PEAK_FLOPS, HBM_BYTES_PER_S),
    ("cpu", {"float32": 1e11, "float64": 1e11}, 5e10),
)
_DEFAULT_PEAK = (1e11, 5e10)

ROOFLINE_ENV = "RAFT_TPU_TORCH_ROOFLINE"
#: unresolved event pairs a key may hold before a launch is dropped
MAX_UNRESOLVED = 1024

_lock = threading.Lock()
_pending: dict = {}              # digest -> mutable aggregate
_queues: dict = {}               # (entry, bucket, kind, dtype) -> deque of launches
_peak_cache: list = [None]       # snapshot-once peak override


def _peak_model(device_kind: str, dtype: str = "float32") -> dict:
    """``{"flops_per_s", "bytes_per_s", "source"}``: the
    ``RAFT_TPU_TORCH_ROOFLINE`` override when set (read once), else the
    table matched on the device kind and the arithmetic's dtype."""
    with _lock:
        if _peak_cache[0] is None:
            raw = os.environ.get(ROOFLINE_ENV, "").strip()
            if raw:
                try:
                    fs, bs = raw.split(":", 1)
                    _peak_cache[0] = (float(fs), float(bs), "env")
                except ValueError:
                    raise ValueError(f"{ROOFLINE_ENV}={raw!r} is not "
                                     f"'<peak_flops>:<peak_bytes_per_s>'") from None
            else:
                _peak_cache[0] = ()
        override = _peak_cache[0]
    if override:
        return {"flops_per_s": override[0], "bytes_per_s": override[1], "source": override[2]}
    kind = (device_kind or "").lower()
    for sub, flops, bw in PEAKS:
        if sub in kind:
            return {"flops_per_s": flops.get(dtype, flops["float32"]), "bytes_per_s": bw,
                    "source": f"builtin:{sub}"}
    return {"flops_per_s": _DEFAULT_PEAK[0], "bytes_per_s": _DEFAULT_PEAK[1],
            "source": "builtin:default"}


def _reset_peak_cache() -> None:
    """Tests only: forget the snapshot so the next use re-reads the env."""
    with _lock:
        _peak_cache[0] = None


def bound_s(flops: float, bytes_accessed: float, device_kind: str, dtype: str) -> tuple:
    """The least time the card could take for this work and what bounds
    it: ``(seconds, "bytes" or "operations")``."""
    peak = _peak_model(device_kind, dtype)
    t_ops, t_bytes = flops / peak["flops_per_s"], bytes_accessed / peak["bytes_per_s"]
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def armed() -> bool:
    """The ledger times launches while the cache is enabled."""
    from raft_tpu_torch.cache import config

    return config.is_enabled()


def _host_work(work: dict) -> dict:
    """Device counts -> pinned host copies queued on the launch stream (no
    wait); numbers pass through."""
    import torch

    out = {}
    for k, v in work.items():
        if isinstance(v, torch.Tensor):
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            v = host
        out[k] = v
    return out


@contextlib.contextmanager
def launch(entry: str, bucket: str, dtype: str, device, work):
    """Time the kernel launch in the block, when armed and on the card:
    ``work()`` gives ``{"flops", "bytes_accessed"}`` (numbers, or device
    tensors of the counts, computed and copied to the host before the
    start event); ``dtype`` is the arithmetic's.  A block that raises
    records nothing."""
    if device is None or getattr(device, "type", "cpu") != "cuda" or not armed():
        yield
        return
    import torch

    from raft_tpu_torch.obs import metrics

    w = _host_work(work())
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    key = (entry, bucket, torch.cuda.get_device_name(device), dtype)
    with _lock:
        q = _queues.setdefault(key, collections.deque())
        _fold(key, q, wait=False)
        if len(q) >= MAX_UNRESOLVED:
            dropped = True
        else:
            q.append((start, end, w))
            dropped = False
    if dropped:
        metrics.counter("ledger.dropped").inc()


def _fold(key, q, wait: bool) -> None:
    """Fold the completed launches at the head of ``q`` into their
    aggregates (all of them after a wait, with ``wait``); caller holds
    :data:`_lock`."""
    entry, bucket, kind, dtype = key
    while q:
        start, end, w = q[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        q.popleft()
        _add(entry, bucket, kind, dtype, float(w["flops"]), float(w["bytes_accessed"]),
             start.elapsed_time(end) / 1e3)


def _add(entry, bucket, kind, dtype, flops, nbytes, dt_s) -> dict | None:
    """Fold one launch into its aggregate (caller holds :data:`_lock`);
    None when it is unmeasurable."""
    from raft_tpu_torch.cache import config

    if not (dt_s > 0.0 and flops > 0.0 and nbytes > 0.0):
        return None
    topo = ("gpu", kind, 1)
    digest = hashlib.sha256(repr(
        ("ledger", entry, bucket, topo, dtype, config.code_fingerprint(), flops, nbytes)
    ).encode()).hexdigest()[:16]
    agg = _pending.get(digest)
    if agg is None:
        agg = _pending[digest] = {
            "entry": entry, "bucket": bucket, "topology": [str(t) for t in topo],
            "device_kind": kind, "dtype": dtype, "flops": flops, "bytes_accessed": nbytes,
            "count": 0, "total_s": 0.0, "best_s": float("inf")}
    agg["count"] += 1
    agg["total_s"] += dt_s
    agg["best_s"] = min(agg["best_s"], dt_s)
    return agg


def record(entry: str, bucket: str, device_kind: str, dtype: str, flops: float,
           bytes_accessed: float, dt_s: float) -> dict | None:
    """Feed one measured launch directly (tests, and launches timed by
    other means); returns the in-memory aggregate, or None when the
    launch is unmeasurable."""
    with _lock:
        agg = _add(entry, bucket, device_kind, dtype, float(flops), float(bytes_accessed),
                   float(dt_s))
        return None if agg is None else dict(agg)


def fraction(agg: dict) -> float:
    """The unrounded roofline fraction of an aggregate: the least time for
    its work over its best time."""
    peak = _peak_model(agg.get("device_kind", ""), agg.get("dtype", "float32"))
    intensity = agg["flops"] / agg["bytes_accessed"] if agg["bytes_accessed"] else 0.0
    attainable = min(peak["flops_per_s"], intensity * peak["bytes_per_s"])
    return (agg["flops"] / agg["best_s"]) / attainable if attainable > 0 else 0.0


def _derived(agg: dict) -> dict:
    """The persisted form of one aggregate: the raw accounting plus the
    achieved and roofline numbers, computed from ``best_s`` (the mean is
    reported beside it).  Field for field the JAX package's."""
    out = dict(agg)
    best = out["best_s"]
    out["mean_s"] = round(out["total_s"] / max(1, out["count"]), 9)
    out["best_s"] = round(best, 9)
    out["total_s"] = round(out["total_s"], 9)
    peak = _peak_model(out.get("device_kind", ""), out.get("dtype", "float32"))
    achieved_f = out["flops"] / best
    achieved_b = out["bytes_accessed"] / best
    intensity = out["flops"] / out["bytes_accessed"] if out["bytes_accessed"] else 0.0
    attainable = min(peak["flops_per_s"], intensity * peak["bytes_per_s"])
    out.update({
        "achieved_flops_per_s": float(f"{achieved_f:.6g}"),
        "achieved_bytes_per_s": float(f"{achieved_b:.6g}"),
        "intensity_flops_per_byte": float(f"{intensity:.6g}"),
        "peak": {k: (float(f"{v:.6g}") if isinstance(v, float) else v)
                 for k, v in peak.items()},
        "attainable_flops_per_s": float(f"{attainable:.6g}"),
        "roofline_fraction": (float(f"{achieved_f / attainable:.6g}")
                              if attainable > 0 else 0.0),
        "schema": 1,
    })
    return out


def root() -> str | None:
    """The ledger directory (``<cache root>/ledger``), or None when the
    cache is off."""
    from raft_tpu_torch.cache import config

    if not config.is_enabled():
        return None
    try:
        return config.subdir("ledger")
    except config.CacheDisabledError:
        return None


@contextlib.contextmanager
def _merge_lock(d: str):
    """Advisory cross-process lock around the read-merge-write cycle: two
    processes sharing a root must not lose each other's counts."""
    path = os.path.join(d, ".merge.lock")
    try:
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    except OSError:                  # pragma: no cover - permissions
        yield
        return
    try:
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX)
        except (ImportError, OSError):  # pragma: no cover - non-posix
            pass
        yield
    finally:
        os.close(fd)                 # closing releases the flock


def resolve(sync: bool = True) -> None:
    """Fold the queued launches into their aggregates: all of them after a
    wait for each (``sync``), or only those already done."""
    with _lock:
        for key, q in _queues.items():
            _fold(key, q, wait=sync)


def pending() -> list:
    """Copies of the unflushed aggregates (unrounded)."""
    with _lock:
        return [dict(a) for _, a in sorted(_pending.items())]


def flush(sync: bool = True) -> list:
    """Persist every pending aggregate, merged with what is on disk for
    the same digest, atomically per file and under the flock; returns
    the paths written ([] when the cache is off or nothing is pending).
    ``sync`` first waits for the queued launches; ``sync=False`` folds in
    only those already done."""
    d = root()
    if d is None:
        return []
    resolve(sync)
    with _lock:
        batch = dict(_pending)
        _pending.clear()
    if not batch:
        return []
    with _merge_lock(d):
        return _flush_batch(d, batch)


def _flush_batch(d: str, batch: dict) -> list:
    from raft_tpu_torch.obs import export

    paths = []
    for digest, agg in sorted(batch.items()):
        path = os.path.join(d, f"{agg['entry']}-{agg['bucket']}-{digest}.json")
        try:
            with open(path, encoding="utf-8") as f:
                prev = json.load(f)
        except (OSError, json.JSONDecodeError):
            prev = None              # absent or corrupt: start afresh
        if isinstance(prev, dict) and prev.get("count"):
            agg = dict(agg)
            agg["count"] += int(prev.get("count", 0))
            agg["total_s"] += float(prev.get("total_s", 0.0))
            agg["best_s"] = min(agg["best_s"], float(prev.get("best_s", float("inf"))))
        try:
            export._atomic_write(path, json.dumps(_derived(agg), indent=1, sort_keys=True)
                                 + "\n")
        except OSError:              # pragma: no cover - disk full, permissions
            continue
        paths.append(path)
    return paths


def entries() -> list:
    """Every persisted entry (undecodable files skipped), sorted by
    (entry, bucket)."""
    d = root()
    if d is None or not os.path.isdir(d):
        return []
    out = []
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, fname), encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(rec, dict):
            rec["file"] = fname
            out.append(rec)
    return sorted(out, key=lambda r: (r.get("entry", ""), r.get("bucket", "")))


def stat() -> dict:
    """Directory, unflushed aggregates and persisted files, without
    reading any file: what a polled ``stats`` op embeds."""
    d = root()
    n = 0
    if d is not None and os.path.isdir(d):
        n = sum(1 for f in os.listdir(d) if f.endswith(".json"))
    with _lock:
        pending_n = len(_pending)
        queued = sum(len(q) for q in _queues.values())
    return {"dir": d, "pending": pending_n, "n_entries": n, "queued": queued}


def summary() -> dict:
    """Where the ledger lives, what is unflushed, and the persisted
    entries' headline numbers."""
    d = root()
    with _lock:
        pending_n = len(_pending)
    ents = entries()
    return {
        "dir": d,
        "pending": pending_n,
        "n_entries": len(ents),
        "entries": [{
            "entry": e.get("entry"), "bucket": e.get("bucket"), "count": e.get("count"),
            "best_s": e.get("best_s"),
            "achieved_flops_per_s": e.get("achieved_flops_per_s"),
            "roofline_fraction": e.get("roofline_fraction"),
        } for e in ents],
    }


def reset() -> None:
    """Drop the unflushed aggregates and the queued launches (tests, phase
    boundaries)."""
    with _lock:
        _pending.clear()
        _queues.clear()
