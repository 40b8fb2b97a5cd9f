"""Warm solving core of the resident service: staging memo + padded batch
(port of ``raft_tpu.serve.solver``).

Two jobs, both built to keep the request path free of cold work:

* :meth:`SolverCore.stage_lane` turns one ``(design, Hs, Tp)`` request
  lane into its bucket-padded staged tensors on the configured device by
  the one shared recipe (the host half
  :func:`raft_tpu_torch.model._stage_host`, then the device half
  :func:`raft_tpu_torch.model._stage_device`, the body
  :func:`~raft_tpu_torch.model.stage_design_base` stages through),
  memoized: a stream that asks again for the same design and sea state
  pays the YAML parse, the member build and the mooring linearization
  once per daemon life.  Staging happens in the connection reader thread
  at submit time (it also gives the lane's bucket signature for routing),
  so the solver loop only stacks warm tensors.
* :func:`solve_batch` pads a closed batch to the fixed lane capacity
  (``ServeConfig.batch_max``; unused lanes tile the real ones), stacks the
  staged lanes into a :class:`raft_tpu_torch.model.DesignBatch` with
  ``torch.stack`` along a new lane axis, and solves it through
  :func:`raft_tpu_torch.parallel.sweep.sweep_designs` with the lane-health
  contract on (kernel K1, ``csrc/solve6.cu``, in every iteration on the
  card): a client whose lane goes NaN is quarantined and salvaged through
  the escalation ladder without perturbing its batch-mates.  The rows are
  then sliced back out in request order; nothing leaves the card before.

Why the fixed capacity matters: every occupancy of a bucket solves at one
shape, and every operation on the lane path is independent of the other
lanes at a fixed shape (K1 solves each lane's systems alone; the batched
products and the per-lane reductions never reduce across lanes), so a
lane's result is bit-identical whichever batch it rode in, at whatever
position.  Deadline against capacity closes is then a pure latency
trade-off.

Every CUDA operation of the serving tier runs on the device's default
stream (each thread starts there): the readers' staging and the solver
loop's solves interleave in stream order, and a lane dropped from the
memo is freed only after the kernels queued before the drop.

As the JAX package's core evicts its AOT executables on ``refresh``, the
port's evicts the kernel libraries it holds from the kernel-library
registry (:func:`raft_tpu_torch.cache.aot.evict_memory`: the next launch
re-opens its library from ``raft_tpu_torch/_build/``, or builds it anew
when its source changed), and :meth:`SolverCore.stats` reports
``compiles``, the kernel libraries this process built
(:func:`raft_tpu_torch.cache.aot.compile_count`), and ``kernel_launches``,
its K1/K2 launches.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from collections import OrderedDict

#: staged-lane memo bound: a few hundred distinct (design, sea state) pairs
#: resident before LRU eviction; a lane is a few hundred kB at stock sizes
_MEMO_MAX = 256


def design_key(spec) -> str:
    """Stable identity of a design argument: the path string for YAML
    files, a content hash for inline dicts (two requests carrying equal
    dicts share one staging)."""
    if isinstance(spec, str):
        return spec
    return "sha:" + hashlib.sha256(
        json.dumps(spec, sort_keys=True, default=repr).encode()).hexdigest()[:24]


def compiles() -> int:
    """Kernel and solver libraries this process built (nvcc and g++), the
    total of :func:`raft_tpu_torch.cache.aot.compile_counts`: 0 once
    ``raft_tpu_torch/_build/`` holds them."""
    from raft_tpu_torch.cache import aot

    return aot.compile_count()


def kernel_launches() -> dict:
    """K1/K2 launches of this process per entry (``core.cuda6.LAUNCHES``;
    the plain path on CPU tensors counts none)."""
    from raft_tpu_torch.core import cuda6

    return dict(cuda6.LAUNCHES)


class SolverCore:
    """Resident staging memo + batch solver (see module docstring).

    Thread contract: ``stage_lane`` runs in N connection readers
    concurrently (single-flight per memo key: two clients asking for the
    same cold lane stage it once); ``solve_batch`` runs in the single
    solver loop.  ``refresh`` may run from a control request between
    batches.  The configured device is resolved here: without CUDA a core
    for the card raises (pass ``device="cpu"``)."""

    def __init__(self, config):
        from raft_tpu_torch.core.device import resolve_device

        self.config = config
        self.device = resolve_device(config.device)
        self._lock = threading.Lock()
        self._memo: OrderedDict = OrderedDict()   # key -> (sig, staged)
        self._inflight: dict = {}                 # key -> threading.Event
        self._stats_lock = threading.Lock()
        self._bucket_stats: dict = {}             # sig -> [batches, real_lanes]

    # ---------------------------------------------------------- staging
    def stage_lane(self, design, Hs: float, Tp: float):
        """Memoized lane staging; returns ``(sig, staged)`` where ``staged =
        (members, rna, env, wave, C_moor)`` is bucket-padded, on the
        configured device in float64 (``rna`` and ``env`` with
        0-d tensor fields, ``wave`` over the bucket's padded grid), and
        ``sig`` is the lane's routing signature (any self-healing promotion
        already applied)."""
        key = (design_key(design), float(Hs), float(Tp))
        while True:
            with self._lock:
                hit = self._memo.get(key)
                if hit is not None:
                    self._memo.move_to_end(key)
                    return hit
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    break
            ev.wait()
        try:
            out = self._stage(design, float(Hs), float(Tp))
            with self._lock:
                self._memo[key] = out
                while len(self._memo) > _MEMO_MAX:
                    self._memo.popitem(last=False)
            return out
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()

    def _stage(self, design, Hs: float, Tp: float):
        from raft_tpu_torch.core.types import Env
        from raft_tpu_torch.model import _stage_device, _stage_host, load_design

        cfg, dev = self.config, self.device
        h = _stage_host(load_design(design), cfg.nw, with_mooring=True, bucket=True)
        members, wave, C_moor = _stage_device(h, cfg.nw, Hs, Tp, cfg.w_min, cfg.w_max,
                                              cfg.dtype, dev)
        rna = _scalars(h.rna, cfg.dtype, dev)
        env = _scalars(Env(Hs=Hs, Tp=Tp, depth=h.depth), cfg.dtype, dev)
        return h.sig, (members, rna, env, wave, C_moor)

    # ------------------------------------------------------------ admin
    def refresh(self) -> dict:
        """Drop the staged-lane memo and evict the kernel libraries from the
        registry's memo (the ``refresh`` op): the next request of each lane
        stages it afresh, and the next launch re-opens its library (from
        disk when its source is unchanged, by a new build when it
        changed).  Runs between batches; results in flight are never
        invalidated, and a library a batch in flight holds stays loaded.
        Returns the eviction counts."""
        from raft_tpu_torch.cache import aot

        with self._lock:
            n_lanes = len(self._memo)
            self._memo.clear()
        return {"staged_lanes_dropped": n_lanes, "executables_evicted": aot.evict_memory()}

    def record_batch(self, sig, n_real: int) -> None:
        with self._stats_lock:
            st = self._bucket_stats.setdefault(sig, [0, 0])
            st[0] += 1
            st[1] += n_real

    def reset_stats(self) -> None:
        """Zero the per-bucket batch and occupancy accounting (measurement
        window boundaries: a warm pass against a measured pass)."""
        with self._stats_lock:
            self._bucket_stats.clear()

    def stats(self) -> dict:
        cfg = self.config
        with self._stats_lock:
            per = {
                str(tuple(sig)): {
                    "batches": b,
                    "lanes": r,
                    "mean_occupancy": round(r / (b * cfg.batch_max), 4),
                }
                for sig, (b, r) in self._bucket_stats.items()
            }
        return {
            "batch_max": cfg.batch_max,
            "batch_deadline_ms": round(cfg.batch_deadline_s * 1e3, 3),
            "nw": cfg.nw,
            "n_iter": cfg.n_iter,
            "device": str(self.device),
            "dtype": str(cfg.dtype).removeprefix("torch."),
            "buckets": per,
            "compiles": compiles(),
            "kernel_launches": kernel_launches(),
        }


def _scalars(tree, dtype, dev):
    """A dataclass of host scalars (RNA, Env) -> the same type with 0-d
    tensor fields on ``dev`` (stacked per batch by :func:`_stack_batch`)."""
    import numpy as np
    import torch

    vals = np.array([float(getattr(tree, f.name)) for f in dataclasses.fields(tree)])
    t = torch.as_tensor(vals, device=dev).to(dtype)
    return type(tree)(**{f.name: t[i] for i, f in enumerate(dataclasses.fields(tree))})


def _stack_fields(objs):
    """Dataclasses of one type -> one with every tensor field stacked along
    a new leading lane axis (``None`` fields stay ``None``)."""
    import torch

    first = objs[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(o, f.name) for o in objs])
        for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)})


def _stack_batch(sig, staged_lanes, labels, nw: int):
    """Stack per-lane staged tuples into a :class:`DesignBatch` (the layout
    :func:`~raft_tpu_torch.model.stage_designs` builds, minus the per-batch
    parse: the lanes were staged and memoized one by one).  ``rna`` and
    ``env`` become (B,) tensors, ``wave.k`` / ``zeta`` / ``freq_mask``
    (B, nw_pad) over the first lane's grid ``w`` (one grid per bucket),
    ``C_moor`` (B, 6, 6); every copy stays on the device."""
    import torch

    from raft_tpu_torch.model import DesignBatch

    ms, rnas, envs, waves, cms = zip(*staged_lanes)
    wave = dataclasses.replace(_stack_fields(waves), w=waves[0].w)
    return DesignBatch(
        sig=sig,
        fnames=list(labels),
        indices=list(range(len(labels))),
        members=_stack_fields(ms),
        rna=_stack_fields(rnas),
        env=_stack_fields(envs),
        wave=wave,
        C_moor=None if cms[0] is None else torch.stack(cms),
        nw=int(nw),
    )


def solve_batch(core: SolverCore, sig, lanes):
    """Solve one closed micro-batch; returns ``(rows, info)``.

    ``lanes``: the :class:`~raft_tpu_torch.serve.batcher.Lane` list the
    batcher popped (``1 <= len <= batch_max``), each carrying its memoized
    ``staged`` tuple.  The batch is padded to ``max(batch_max, len)`` lanes
    by tiling the real ones (pad results are discarded), solved via
    ``sweep_designs(health=True)``, and sliced back: ``rows[i]`` is lane
    ``i``'s client-facing result dict.  ``info`` carries the batch-level
    health and occupancy block for metrics and stats."""
    import numpy as np

    from raft_tpu_torch.parallel.sweep import sweep_designs

    cfg = core.config
    B = len(lanes)
    # a refresh may shrink the capacity while an old-capacity batch is
    # already popped: pad to whichever is larger, so every interleaving of
    # the (config, batcher) updates solves
    cap = max(cfg.batch_max, B)
    staged = [ln.staged for ln in lanes]
    labels = [ln.label for ln in lanes]
    # fixed-capacity padding: tile the real lanes cyclically; pad lanes
    # recompute a real lane's physics and are discarded
    for j in range(cap - B):
        staged.append(staged[j % B])
        labels.append(f"<pad:{labels[j % B]}>")
    batch = _stack_batch(sig, staged, labels, cfg.nw)
    out = sweep_designs(staged={sig: batch}, n_iter=cfg.n_iter, return_xi=False, health=True,
                        escalate=cfg.escalate, chunk=cfg.chunk, dtype=cfg.dtype,
                        device=core.device)
    conv = np.asarray(out["converged"]).astype(bool)
    finite = np.asarray(out["finite"]).astype(bool)
    h = out["health"]
    quarantined = set(h["quarantined"])
    unsalvaged = set(h["unsalvaged"])
    rows = []
    for i in range(B):
        rows.append({
            "design": labels[i],
            "std_dev": np.asarray(out["std dev"][i]).tolist(),
            "iterations": int(np.asarray(out["iterations"][i])),
            "converged": bool(conv[i]),
            "finite": bool(finite[i]),
            "quarantined": i in quarantined,
            "salvaged": i in quarantined and i not in unsalvaged,
        })
    core.record_batch(sig, B)
    info = {
        "sig": tuple(sig),
        "lanes": B,
        "capacity": cap,
        "occupancy": B / cap,
        "quarantined_real": sorted(i for i in quarantined if i < B),
        "rungs_used": h.get("rungs_used", {}),
    }
    return rows, info


def solve_solo(core: SolverCore, design, Hs: float, Tp: float):
    """One request solved through the exact batch path, alone: a
    single-lane batch padded to capacity.  The reference the determinism
    checks hold mixed batches to (a lane's row from any batch must be
    bit-identical to its solo row), and the sequential baseline of the
    serving load."""
    from raft_tpu_torch.serve.batcher import Lane

    sig, staged = core.stage_lane(design, Hs, Tp)
    lane = Lane(request_id="solo", seq=0, label=design_key(design)[-24:], staged=staged)
    rows, _info = solve_batch(core, sig, [lane])
    return rows[0]
