"""Dispatch-ahead chunk executor on CUDA streams: keep the card busy across
chunks (port of ``raft_tpu.parallel.pipeline``).

A chunked sweep run as the blocking loop

.. code-block:: python

   outs = [fetch(fn(stage(c))) for c in chunks]

serializes three things that have no ordering dependency: the host-side
staging of chunk ``k+1`` (slicing, heading interpolation, the host-to-card
copy), the card's compute of chunk ``k`` and the card-to-host fetch of
chunk ``k-1``'s results.  :func:`run_pipelined` overlaps them with a
small dispatch-ahead window: at most ``depth`` chunks are in flight at
once (bounding live device memory to ``depth`` chunks' inputs and
outputs), and the next chunk is staged and dispatched BEFORE the oldest
in-flight result is fetched.

On the card three streams carry a pass:

* ``stage(item)`` runs with a **copy stream** current: host chunks go into
  fresh device tensors from pinned memory with ``non_blocking=True``
  (:func:`raft_tpu_torch.core.device.to_device`), and an event is
  recorded after them;
* the **compute stream** (PyTorch's current stream when the pass starts)
  waits on that event before ``fn`` is dispatched, and every staged
  tensor gets ``record_stream(compute)``, so the caching allocator never
  hands its memory out again while a kernel still reads it.  ``fn``
  launches on the compute stream (kernels K1, K3 and K4 launch on
  PyTorch's current stream) and must not synchronise the host;
* the default fetch waits, on a **fetch stream**, for an event recorded
  on the compute stream right after that chunk's dispatch, copies the
  results into pinned host buffers there and waits for that copy: the
  only blocking step, taken after the next chunk was dispatched, and
  blocked by that chunk's own work only.

CPU tensors run the same loop without streams (the tests' path); CUDA
tensors never take it.

PyTorch has no buffer donation.  ``donate_argnums`` keeps the JAX
package's accounting with the port's meaning: the executor drops its own
references to those staged leaves at dispatch (so their memory returns
to the allocator as soon as ``fn`` lets go of it) and counts their bytes;
after each fetch it counts as ``invalidated_buffers`` the donated leaves
that are gone (a ``weakref``).  A leaf that something still holds stays
visible in the stats instead of being kept silently.

Knobs:

* ``RAFT_TPU_PIPELINE_DEPTH`` — dispatch-ahead window (default 2,
  minimum 1; 1 degenerates to the blocking loop).
* ``RAFT_TPU_DONATE`` — ``0``/``false``/``off``/``no`` turns donation
  off at the call sites that consult :func:`donation_enabled` (default
  on).
"""
from __future__ import annotations

import dataclasses
import os
import time
import weakref
from collections import deque

import torch

from raft_tpu_torch.core.device import resolve_device

DEFAULT_DEPTH = 2


def dispatch_depth(default: int = DEFAULT_DEPTH) -> int:
    """Dispatch-ahead window from ``RAFT_TPU_PIPELINE_DEPTH`` (min 1)."""
    v = os.environ.get("RAFT_TPU_PIPELINE_DEPTH", "").strip()
    if not v:
        return default
    try:
        return max(1, int(v))
    except ValueError:
        import warnings

        warnings.warn(
            f"RAFT_TPU_PIPELINE_DEPTH={v!r} is not an integer; "
            f"using the default depth {default}", stacklevel=2)
        return default


def donation_enabled() -> bool:
    """True unless ``RAFT_TPU_DONATE`` spells an explicit off."""
    return os.environ.get("RAFT_TPU_DONATE", "").strip().lower() not in (
        "0", "false", "off", "no")


def tensors(obj):
    """Every tensor in ``obj``: tensors, dataclasses (``Cx``, ``WaveState``,
    ``MemberSet``, ...), tuples, lists and dicts, depth first."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors(x)


def _host_result(out):
    """CPU outputs as numpy (a tuple stays a tuple)."""
    if isinstance(out, tuple):
        return tuple(_host_result(x) for x in out)
    return out.detach().numpy() if isinstance(out, torch.Tensor) else out


@dataclasses.dataclass
class PipelineStats:
    """Wall-clock accounting of one :func:`run_pipelined` pass.

    ``overlap_fraction`` is the share of host-side work (staging +
    fetching) performed while at least one chunk was in flight on the
    device — the part of the host time the pipeline can hide under
    device compute.  A single chunk (nothing to overlap with) reports 0.
    """

    chunks: int = 0
    depth: int = 0
    max_in_flight: int = 0
    stage_s: float = 0.0
    fetch_s: float = 0.0
    wall_s: float = 0.0
    overlapped_host_s: float = 0.0
    donated_bytes: int = 0
    donated_buffers: int = 0
    invalidated_buffers: int = 0
    # resilience accounting (raft_tpu_torch.resilience): chunks served
    # from the durable checkpoint store vs dispatched to the device,
    # checkpoint writes, corrupt artifacts detected (and recomputed), and
    # injected faults applied by the test harness
    chunks_resumed: int = 0
    chunks_computed: int = 0
    chunks_checkpointed: int = 0
    ckpt_corrupt: int = 0
    faults_injected: int = 0

    @property
    def overlap_fraction(self) -> float:
        host = self.stage_s + self.fetch_s
        return self.overlapped_host_s / host if host > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "chunks": self.chunks,
            "depth": self.depth,
            "max_in_flight": self.max_in_flight,
            "stage_s": round(self.stage_s, 4),
            "fetch_s": round(self.fetch_s, 4),
            "wall_s": round(self.wall_s, 4),
            "overlap_fraction": round(self.overlap_fraction, 3),
            "donated_bytes": int(self.donated_bytes),
            "donated_buffers": int(self.donated_buffers),
            "invalidated_buffers": int(self.invalidated_buffers),
            "chunks_resumed": int(self.chunks_resumed),
            "chunks_computed": int(self.chunks_computed),
            "chunks_checkpointed": int(self.chunks_checkpointed),
            "ckpt_corrupt": int(self.ckpt_corrupt),
            "faults_injected": int(self.faults_injected),
        }


class _Streams:
    """The copy, compute and fetch streams of one pass on a card."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.compute = torch.cuda.current_stream(dev)
        self.copy = torch.cuda.Stream(dev)
        self.fetch = torch.cuda.Stream(dev)
        # whatever the caller queued before the pass (staged constants, a
        # design batch the chunks slice) is ready before the copies read it
        self.copy.wait_stream(self.compute)

    def stage(self, stage, item):
        """``stage(item)`` with the copy stream current; the compute stream
        waits for its copies, and its tensors are marked used there."""
        with torch.cuda.device(self.dev), torch.cuda.stream(self.copy):
            staged = stage(item)
        ready = torch.cuda.Event()
        ready.record(self.copy)
        self.compute.wait_event(ready)
        for t in tensors(staged):
            if t.is_cuda:
                t.record_stream(self.compute)
        return staged

    def dispatched(self) -> torch.cuda.Event:
        """An event after everything queued on the compute stream so far."""
        done = torch.cuda.Event()
        done.record(self.compute)
        return done

    def fetch_pinned(self, out, done: torch.cuda.Event):
        """``out``'s tensors into pinned host buffers on the fetch stream,
        after ``done``; blocks the host until those copies are complete."""
        leaves = out if isinstance(out, tuple) else (out,)
        self.fetch.wait_event(done)
        bufs = []
        with torch.cuda.device(self.dev), torch.cuda.stream(self.fetch):
            for t in leaves:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t.record_stream(self.fetch)
                bufs.append(buf)
        copied = torch.cuda.Event()
        copied.record(self.fetch)
        copied.synchronize()
        arrays = tuple(b.numpy() for b in bufs)
        return arrays if isinstance(out, tuple) else arrays[0]


def run_pipelined(fn, items, *, depth: int | None = None, stage=None,
                  fetch=None, donate_argnums: tuple = (), ckpt=None, device=None):
    """Run ``fetch(fn(stage(item)))`` per item with dispatch-ahead overlap.

    ``fn``
        The per-chunk program: called with the staged value if ``stage``
        returns a single object, or splatted if it returns a tuple.  It
        must not synchronise the host (no ``.item()``, no ``bool()`` of a
        device tensor): its launches queue on the compute stream.
    ``items``
        Host-side chunk descriptors, in order.
    ``stage``
        Staging callback ``item -> staged args`` (slicing, host
        interpolation, :func:`~raft_tpu_torch.core.device.to_device`).  On
        the card it runs with the
        copy stream current while earlier chunks compute.  Default:
        identity.
    ``fetch``
        Result materialization ``out -> host result``.  Default: the
        tensors of ``out`` as numpy arrays (on the card through pinned
        buffers on the fetch stream, after an event recorded behind the
        chunk's own dispatch).  A custom ``fetch`` runs on the host
        thread with the compute stream current.
    ``depth``
        Max chunks in flight (default :func:`dispatch_depth`).
    ``donate_argnums``
        Positions (into the tuple ``stage`` returns) whose tensors the
        executor gives up at dispatch; their bytes are counted and, after
        each fetch, the ones that are gone count as
        ``invalidated_buffers`` (see the module docstring).
    ``ckpt``
        Optional :class:`raft_tpu_torch.resilience.checkpoint.ChunkStore`.
        Every fetched result is persisted (atomic npz + hashed manifest)
        BEFORE the pass moves on, and a chunk already present in the
        store is served from disk instead of staged and dispatched — the
        resume path of a killed sweep.  A corrupt artifact is detected by
        content hash and recomputed (``ckpt_corrupt``).  Chunk indices in
        the store are POSITIONS in ``items``.
    ``device``
        Where the chunks run: None is the card (raises without CUDA), a
        CPU device runs the loop without streams.

    With ``RAFT_TPU_FAULT_INJECT`` armed
    (:mod:`raft_tpu_torch.resilience.faults`), ``nan_chunk`` overwrites a
    fetched result (before any checkpoint write, exactly like a device
    that produced NaNs) and ``kill_after_chunk`` hard-exits after a
    chunk's fetch and checkpoint complete.

    Returns ``(results, PipelineStats)`` with results in item order.
    """
    from raft_tpu_torch import obs as _obs
    from raft_tpu_torch.resilience import faults as _faults

    dev = resolve_device(device)
    streams = _Streams(dev) if dev.type == "cuda" else None
    if depth is None:
        depth = dispatch_depth()
    depth = max(1, int(depth))
    if stage is None:
        stage = lambda item: item                          # noqa: E731
    items = list(items)
    n = len(items)
    stats = PipelineStats(chunks=n, depth=depth)
    faulty = _faults.active()        # one env read per pass, not per chunk
    results = []
    in_flight: deque = deque()   # (index, out, done event, donated weakrefs)
    t_start = time.perf_counter()

    def timed_host(kind, thunk, chunk_idx):
        t0 = time.perf_counter()
        with _obs.trace.span(f"pipeline/{kind}", attrs={"chunk": chunk_idx}):
            out = thunk()
        dt = time.perf_counter() - t0
        if kind == "stage":
            stats.stage_s += dt
        else:
            stats.fetch_s += dt
        _obs.metrics.histogram(f"pipeline.{kind}_s").observe(dt)
        if in_flight:                  # device had work to hide this under
            stats.overlapped_host_s += dt
        return out

    def fetch_one(out, done):
        if fetch is not None:
            return fetch(out)
        if streams is not None:
            return streams.fetch_pinned(out, done)
        return _host_result(out)

    def drain_one():
        k_done, pending, done, donated = in_flight.popleft()
        res = timed_host("fetch", lambda: fetch_one(pending, done), k_done)
        del pending
        if faulty and _faults.chunk_fault("nan_chunk", k_done):
            res = _faults.nan_results(res)
            stats.faults_injected += 1
        results.append(res)
        for ref in donated:
            stats.donated_buffers += 1
            if ref() is None:
                stats.invalidated_buffers += 1
        if ckpt is not None:
            ckpt.save(k_done, res)
            stats.chunks_checkpointed += 1
        if faulty:
            _faults.maybe_kill_after_chunk(k_done)

    for k, item in enumerate(items):
        if ckpt is not None:
            cached = ckpt.load(k)
            if cached is not None:
                # chunks older than k are all in flight or done: drain
                # them first so ``results`` stays in item order (a
                # resume boundary briefly serializes — the durable
                # result is worth the bubble)
                while in_flight:
                    drain_one()
                results.append(cached)
                stats.chunks_resumed += 1
                continue
        if streams is not None:
            staged = timed_host("stage", lambda: streams.stage(stage, item), k)
        else:
            staged = timed_host("stage", lambda: stage(item), k)
        donated = []
        if donate_argnums:
            leaves = [t for i in donate_argnums for t in tensors(staged[i])]
            stats.donated_bytes += sum(t.numel() * t.element_size() for t in leaves)
            donated = [weakref.ref(t) for t in leaves]
            del leaves
        t_disp = time.perf_counter()
        with _obs.trace.span("pipeline/dispatch", attrs={"chunk": k}):
            out = fn(*staged) if isinstance(staged, tuple) else fn(staged)
        # the executor's own references to the staged chunk end here
        staged = None
        done = streams.dispatched() if streams is not None else None
        _obs.metrics.histogram("pipeline.dispatch_s").observe(
            time.perf_counter() - t_disp)
        in_flight.append((k, out, done, donated))
        out = None
        stats.chunks_computed += 1
        stats.max_in_flight = max(stats.max_in_flight, len(in_flight))
        # fetch the oldest result only once the window is full (so the
        # youngest chunk's staging+dispatch happened before the oldest
        # chunk's fetch blocks), then drain after the last dispatch;
        # at most ``depth`` chunks are ever in flight
        while len(in_flight) >= depth or (k == n - 1 and in_flight):
            drain_one()
    # the final item may have been resumed from the store with older
    # chunks still pending — the loop's last-item drain never saw them
    while in_flight:
        drain_one()
    if ckpt is not None:
        stats.ckpt_corrupt = ckpt.corrupt
    stats.wall_s = time.perf_counter() - t_start
    # registry mirror of the per-pass stats (the checkpoint store counts
    # its own saved/resumed/corrupt events — not repeated here)
    _obs.metrics.gauge("pipeline.overlap_fraction").set(stats.overlap_fraction)
    _obs.metrics.counter("pipeline.chunks_computed").inc(stats.chunks_computed)
    _obs.metrics.counter("pipeline.chunks_resumed").inc(stats.chunks_resumed)
    if stats.faults_injected:
        _obs.metrics.counter("pipeline.faults_injected").inc(
            stats.faults_injected)
    return results, stats
