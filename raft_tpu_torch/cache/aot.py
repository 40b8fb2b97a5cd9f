"""The kernel-library registry: build each library once per key, open it
once per process, and count what was really built (the port's counterpart
of ``raft_tpu.cache.aot``, the JAX package's executable registry).

In the port the only code compiled ahead of time is the kernel libraries:
``nvcc`` builds of ``csrc/*.cu`` (:class:`raft_tpu_torch.core.nvcc.Spec`)
and the ``g++`` build of the host panel solver
(:mod:`raft_tpu_torch.hydro.native_bem`).  A library is any object with

* ``tag``: its stable name (``"solve6"``, ``"bem_rankine"``, ...);
* ``key()``: a digest of everything that decides its bits: the source
  hash, the flags, the target (``sm_90a``), the compiler's version, the
  torch and CUDA versions and the card's name (the salts of the JAX
  registry's ``_version_salts`` and ``_topology``, in the port's terms);
* ``path(key)``: its file under ``raft_tpu_torch/_build/`` (git-ignored,
  so a fresh checkout builds them);
* ``job(path)``: the compiler run that writes it
  (:class:`raft_tpu_torch.core.nvcc.Job`), and ``retries``, the attempts a
  failing build gets;
* ``open(path)``: the handle (a ``ctypes.CDLL`` with its signatures).

:func:`library` resolves a library through three layers:

1. the in-process memo of opened handles (``mem_hit``);
2. a file already in ``_build/`` (``disk_hit``; its ``saved_s`` is the
   build seconds stored beside the file, its share of the build run's
   wall, less the seconds to open it);
3. a build (``miss``, counted by ``_record_compile``), one compiler per
   library, started together with the other libraries of ``batch`` that
   are missing.

A file that fails to open is an ``error``: it is deleted and rebuilt once,
and a second failure raises.  Nothing is skipped.

Single flight: the first thread to need a library leads its resolution,
and the others wait for it; a leader that fails hands over to a waiter,
which tries afresh (``raft_tpu/cache/aot.py``'s rule).  So a daemon's
warm-up and its solver loop that reach a wrapper together open each
library once.  :func:`evict_memory` drops memoized handles (the daemon's
``refresh``): the next launch re-resolves from disk when the source is
unchanged, or builds anew when it changed.  A handle that a batch in
flight still holds stays valid (ctypes never unloads a library).

The registry is on whether or not :func:`raft_tpu_torch.cache.enable` was
called: a library is always kept and reused.  Four functions of the JAX
registry are not ported: ``cached_callable``, ``cached_compile``,
``callable_salt`` and ``donation_salt``.  Eager PyTorch traces no program
to key and donates no buffer.  ``artifact_cost`` is replaced by the
kernels' own work counts (``core.cuda6.work``, ``core.cuda_bem``), which
the ledger (:mod:`raft_tpu_torch.obs.ledger`) reads.  The speed
counterpart of an XLA executable, CUDA-graph capture, is ROADMAP.md
queue 4 work.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import Counter, deque

from raft_tpu_torch.cache import stats

# opened handles by tag (one version of a library is resolved at a time)
# and the single-flight table of resolutions in progress, under one lock
_mem: dict = {}                 # tag -> handle
_inflight: dict = {}            # tag -> threading.Event of the resolution
_fresh: set = set()             # (tag, key) built in this process, not yet opened
_mem_lock = threading.Lock()

# tags of libraries really built (every warm layer missed), a bounded
# ring in order, and exact per-tag totals; both move under one lock
_COMPILE_EVENTS_MAX = 4096
_events_lock = threading.Lock()
_compile_events: deque = deque(maxlen=_COMPILE_EVENTS_MAX)
_compile_counts: Counter = Counter()
_open_counts: Counter = Counter()


def _record_compile(tag: str) -> None:
    """Count one real build: the ring and the counter together."""
    with _events_lock:
        _compile_events.append(tag)
        _compile_counts[tag] += 1


def compile_events(tag: str | None = None) -> list:
    """Tags built in this process (not served from a warm layer), in
    order, from a ring of the last :data:`_COMPILE_EVENTS_MAX`; filtered
    to ``tag`` when given.  :func:`compile_count` never saturates."""
    with _events_lock:
        events = list(_compile_events)
    return events if tag is None else [t for t in events if t == tag]


def compile_count(tag: str | None = None) -> int:
    """Exact number of builds since process start (or the last
    :func:`reset_compile_events`): per ``tag``, or in all."""
    with _events_lock:
        if tag is None:
            return sum(_compile_counts.values())
        return _compile_counts.get(tag, 0)


def compile_counts() -> dict:
    """Exact ``{tag: builds}`` since process start (or the last reset)."""
    with _events_lock:
        return dict(_compile_counts)


def open_counts() -> dict:
    """``{tag: opens}``: how often this process opened each library (once,
    and again after an eviction)."""
    with _events_lock:
        return dict(_open_counts)


def reset_compile_events() -> None:
    """Zero the ring and the counters together (window boundaries of a
    long-lived process)."""
    with _events_lock:
        _compile_events.clear()
        _compile_counts.clear()
        _open_counts.clear()


def _build_s_path(path) -> str:
    return os.path.splitext(str(path))[0] + ".json"


def _write_build_s(path, tag: str, key: str, build_s: float) -> None:
    """Store the build's seconds beside the library (atomically)."""
    side = _build_s_path(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(side), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"tag": tag, "key": key, "build_s": build_s}, f)
        os.replace(tmp, side)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _read_build_s(path) -> float:
    try:
        with open(_build_s_path(path)) as f:
            return float(json.load(f)["build_s"])
    except (OSError, ValueError, KeyError, TypeError):
        return 0.0


def _run_compilers(jobs, timeout=None) -> None:
    from raft_tpu_torch.core import nvcc

    nvcc.run_jobs(jobs, timeout=timeout)


#: runs the compiler jobs of a build (tests put a fake one here)
_compile = _run_compilers


def _build(entries) -> None:
    """Build ``entries`` (``(library, key, path)``), one compiler each, all
    started together; a failing run is retried up to the largest
    ``retries`` among them, 2 s apart.  Each built library is a ``miss``
    and a compile event; its build seconds go beside it."""
    from raft_tpu_torch.obs import metrics
    from raft_tpu_torch.resilience import retry
    from raft_tpu_torch.utils import profiling as prof

    tags = ", ".join(lib.tag for lib, _key, _path in entries)
    attempts = max(int(getattr(lib, "retries", 1)) for lib, _key, _path in entries)
    timeout_s = retry.build_timeout_s(max(float(getattr(lib, "timeout_s", 900.0))
                                          for lib, _key, _path in entries))
    t0 = time.perf_counter()
    try:
        with prof.phase("cache/kernels_build", sync=False):
            retry.retry_call(
                lambda attempt: _compile([lib.job(path) for lib, _key, path in entries],
                                         timeout=timeout_s),
                retries=attempts, backoff_s=2.0, retry_on=(retry.SubprocessFailed,),
                describe=f"build of {tags}")
    except retry.RetryExhausted as e:
        last = e.last
        raise RuntimeError(
            f"build of {tags} failed after {e.attempts} attempt(s) ({last.kind}, timeout "
            f"{timeout_s:.0f} s per attempt):\n{last.detail}") from e
    build_s = time.perf_counter() - t0
    metrics.histogram("kernels.build_s").observe(build_s)
    for lib, key, path in entries:
        stats.record("kernels", "miss")
        _record_compile(lib.tag)
        try:
            # libraries built together share the run's wall: their notes
            # sum to it, so the disk hits of a warm process do too
            _write_build_s(path, lib.tag, key, build_s / len(entries))
        except OSError:
            stats.record("kernels", "error")    # a lost note never fails the build
        with _mem_lock:
            _fresh.add((lib.tag, key))


def _discard(path) -> None:
    for p in (str(path), _build_s_path(path)):
        try:
            os.unlink(p)
        except OSError:
            pass


def _claim(tag: str):
    """The memoized handle (a ``mem_hit``), or None once this thread leads
    the resolution of ``tag`` (waiting out another leader first)."""
    while True:
        with _mem_lock:
            hit = _mem.get(tag)
            if hit is not None:
                stats.record("kernels", "mem_hit")
                return hit
            ev = _inflight.get(tag)
            if ev is None:
                _inflight[tag] = threading.Event()
                return None
        ev.wait()


def _release(tag: str, handle=None) -> None:
    with _mem_lock:
        if handle is not None:
            _mem[tag] = handle
        ev = _inflight.pop(tag)
    ev.set()


def _missing(batch, skip: str) -> list:
    """``(library, key, path)`` of each library of ``batch`` (other than
    ``skip``) that no thread resolves or has resolved and whose file is
    missing; claims each for this thread."""
    out = []
    for lib in batch:
        if lib.tag == skip:
            continue
        key = lib.key()
        path = lib.path(key)
        with _mem_lock:
            if lib.tag in _mem or lib.tag in _inflight or os.path.exists(path):
                continue
            _inflight[lib.tag] = threading.Event()
        out.append((lib, key, path))
    return out


def _resolve(lib, batch):
    """Open ``lib`` from disk, or build it first (with the missing
    libraries of ``batch``); a file that fails to open is deleted and
    rebuilt once."""
    from raft_tpu_torch.utils import profiling as prof

    key = lib.key()
    path = lib.path(key)
    for attempt in (0, 1):
        if not os.path.exists(path):
            others = _missing(batch, lib.tag) if attempt == 0 else []
            try:
                _build([(lib, key, path), *others])
            finally:
                for other, _k, _p in others:
                    _release(other.tag)
        t0 = time.perf_counter()
        try:
            with prof.phase("cache/kernels_load", sync=False):
                handle = lib.open(path)
        except (OSError, AttributeError) as e:
            stats.record("kernels", "error")
            _discard(path)
            with _mem_lock:
                _fresh.discard((lib.tag, key))
            if attempt:
                raise RuntimeError(f"library {lib.tag} ({path}) does not open after a "
                                   f"rebuild: {e}") from e
            continue
        load_s = time.perf_counter() - t0
        with _mem_lock:
            was_built = (lib.tag, key) in _fresh
            _fresh.discard((lib.tag, key))
        if not was_built:
            stats.record("kernels", "disk_hit", saved_s=_read_build_s(path) - load_s)
        with _events_lock:
            _open_counts[lib.tag] += 1
        return handle


def library(lib, batch=()):
    """The opened handle of ``lib`` (see the module docstring); on a build,
    the missing libraries of ``batch`` are built in the same run."""
    hit = _claim(lib.tag)
    if hit is not None:
        return hit
    handle = None
    try:
        handle = _resolve(lib, batch)
        return handle
    finally:
        _release(lib.tag, handle)


def prepare(libs) -> None:
    """Build every library of ``libs`` whose file is missing, one compiler
    each, all started together (the libraries are opened later, by
    :func:`library`)."""
    entries = _missing(libs, skip="")
    if not entries:
        return
    try:
        _build(entries)
    finally:
        for lib, _key, _path in entries:
            _release(lib.tag)


def evict_memory(tag: str | None = None) -> int:
    """Drop memoized handles (all, or ``tag``'s) without touching the
    counts or a resolution in progress; returns how many were dropped."""
    with _mem_lock:
        tags = list(_mem) if tag is None else [t for t in _mem if t == tag]
        for t in tags:
            _mem.pop(t, None)
        return len(tags)
