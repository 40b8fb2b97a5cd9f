"""Warm-start counters: hits, misses and the seconds the hits saved (port
of ``raft_tpu.cache.stats``).

Each cache layer records its events here, so a run can report its cold and
warm split apart from its solve time (the ``warm_start`` block).  The
port's layers are ``"kernels"`` (the kernel-library registry, the
counterpart of the JAX package's ``"aot"``) and ``"staging"``.  Seconds
spent inside the cache machinery go through
:mod:`raft_tpu_torch.utils.profiling` phases named ``cache/...``.
"""
from __future__ import annotations

import threading
from collections import defaultdict

_lock = threading.Lock()


def _zero() -> dict:
    return {"mem_hits": 0, "disk_hits": 0, "misses": 0, "errors": 0, "saved_s": 0.0}


_layers: dict = defaultdict(_zero)

_EVENT_KEY = {"mem_hit": "mem_hits", "disk_hit": "disk_hits", "miss": "misses",
              "error": "errors"}


def record(layer: str, event: str, saved_s: float = 0.0, category: str | None = None) -> None:
    """Count one cache event: ``layer`` ``"kernels"`` or ``"staging"``;
    ``event`` ``"mem_hit"``, ``"disk_hit"``, ``"miss"`` or ``"error"``;
    ``saved_s`` the wall-clock the hit avoided (the cold time stored with
    the artifact less the load time; negative where the hit cost more than
    the computation it skipped).  With a ``category`` the event is also
    counted under ``"<layer>/<category>"``, so each call site's saving
    reads apart.  Mirrored into the counter ``cache.<layer>.<event>`` of
    :mod:`raft_tpu_torch.obs.metrics`."""
    with _lock:
        for name in (layer, f"{layer}/{category}") if category else (layer,):
            c = _layers[name]
            c[_EVENT_KEY[event]] += 1
            c["saved_s"] += float(saved_s)
    from raft_tpu_torch.obs import metrics

    metrics.counter(f"cache.{layer}.{event}").inc()


def report() -> dict:
    """The ``warm_start`` block: per-layer counters and the enablement
    state."""
    from raft_tpu_torch.cache import config

    with _lock:
        layers = {k: dict(v) for k, v in _layers.items()}
    for c in layers.values():
        c["saved_s"] = round(c["saved_s"], 6)
    return {"enabled": config.is_enabled(), "dir": config.cache_dir(), **layers}


def reset() -> None:
    with _lock:
        _layers.clear()
