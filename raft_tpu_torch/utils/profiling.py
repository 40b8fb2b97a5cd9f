"""Phase timers over the span API (port of ``raft_tpu.utils.profiling``).

``phase`` opens a span of :mod:`raft_tpu_torch.obs.trace`, so every phase
shows in the Chrome trace and the span roll-up, and ``totals`` and
``summary`` read the roll-up.  The cache layers time their loads, saves
and builds in ``cache/...`` phases, and the cache smoke's children report
``totals()`` as their ``phases_s``.

CUDA work is asynchronous: a phase around it would be charged only the
host's enqueue.  ``sync=True`` (the default) ends the phase with
``torch.cuda.synchronize(device)``, where the JAX package blocks on the
arrays the block produced; ``sync=False`` skips the barrier (host-only
phases, hot loops).  Without CUDA, or before CUDA's first use in the
process, there is nothing to wait for and the phase does not initialise
CUDA to find that out.
"""
from __future__ import annotations

import contextlib

from raft_tpu_torch.obs import trace as _trace


def _sync(device) -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, sync: bool = True, device=None):
    """Time a named phase (nested names join with '/', per thread); with
    ``sync``, wait for ``device``'s queued work (the current card when
    None) before the phase closes."""
    with _trace.span(name):
        yield
        if sync:
            _sync(device)


def summary() -> str:
    """A table of the accumulated phase timings."""
    lines = ["phase                                    calls   total [s]   mean [ms]"]
    for name, agg in _trace.rollup().items():
        n, tot = agg["count"], agg["total_s"]
        lines.append(f"{name:<40} {n:>5} {tot:>11.3f} {tot / n * 1e3:>11.2f}")
    return "\n".join(lines)


def totals() -> dict:
    """Accumulated ``{phase: seconds}`` (exact past the span ring's bound:
    read from the roll-up)."""
    return {k: v["total_s"] for k, v in _trace.rollup().items()}


def reset() -> None:
    """Clear the accumulated span history (the totals with it)."""
    _trace.reset()
