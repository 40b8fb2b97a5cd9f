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

:func:`torch_trace` is the counterpart of the JAX package's ``xla_trace``
(renamed as ``jax_bem`` became ``torch_bem``): a ``torch.profiler``
capture of the enclosed block written as a Chrome trace, in which a
``phase(..., jax_trace=True)`` shows as a named range beside the kernels
it launched.
"""
from __future__ import annotations

import contextlib
import os
import time

from raft_tpu_torch.obs import trace as _trace


def _sync(device) -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, sync: bool = True, device=None, jax_trace: bool = False):
    """Time a named phase (nested names join with '/', per thread); with
    ``sync``, wait for ``device``'s queued work (the current card when
    None) before the phase closes.  ``jax_trace=True`` (the JAX package's
    keyword, kept) also marks the block as a ``torch.profiler`` range
    (``obs.trace.span(jax_trace=)``), seen while a profiler runs, e.g.
    under :func:`torch_trace`."""
    with _trace.span(name, jax_trace=jax_trace):
        yield
        if sync:
            _sync(device)


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block, CPU
    activity and, when CUDA is available, the card's, and write it as a
    Chrome trace (``trace-<pid>-<ns>.json``) into ``log_dir`` on exit; the
    counterpart of the JAX package's ``xla_trace``.  Yields the path the
    trace will be written to."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield path
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)


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
