"""The runtime audit: per-entry counts of the registered entry points,
held to committed budgets (the port's counterpart of
``raft_tpu.lint.audit``).

The JAX audit traces each entry under ``jax.make_jaxpr`` and walks the
jaxpr.  Eager PyTorch has no jaxpr: the port runs each entry of
:mod:`raft_tpu_torch.lint.registry` **at float32** under a
``TorchDispatchMode`` that sees every aten op dispatched, and reports per
entry (:class:`AuditReport`):

* ``f64_ops``: ops with a float64 or complex128 output.  Budget 0, as the
  JAX audit's ``f64_leaves``: a float32 call that computes in float64
  somewhere has a hard-coded dtype (GL105's hazard at run time);
* ``host_syncs``: ``aten._local_scalar_dense`` (``.item()``, ``bool()``,
  ``float()`` of a tensor), the ops whose output size depends on the data
  (``nonzero``, ``masked_select``, ``unique``, ``equal``, indexing with a
  boolean mask), and, on the
  card, blocking copies between the card and the host.  Counted, not
  forbidden: the ``while`` driver's exit test syncs once an iteration by
  design, and the count goes into the budget with that reason;
* ``rebuilds``: on the second call (same shapes, other values), the kernel
  library builds (``cache/aot.py::compile_count``) and staging misses
  (``cache/stats.py``) it causes.  Budget 0, the counterpart of the JAX
  audit's ``retraces``;
* ``ops``: the aten ops dispatched, the counterpart of ``n_eqns``;
* on the card only: the kernel launches by name (``core/cuda6.py::
  LAUNCHES``, ``core/cuda_bem.py::LAUNCHES``), ``peak_bytes``
  (``torch.cuda.max_memory_allocated`` during the call less what was
  allocated when it began: the call's own high-water mark, whatever the
  process holds) and ``sync_debug``,
  the warnings of ``torch.cuda.set_sync_debug_mode("warn")`` during the
  call.

The budgets (``lint/budgets.json``) have one section per platform
(``"cpu"``, ``"cuda"``) and a tolerance of 0.25: a metric may grow that
fraction (and by more than one) over its budget before the gate fails; a
zero budget admits nothing; a metric far below its budget is a note, not a
failure; an entry or metric without a budget fails.  ``--write-budgets``
refreshes the section of the device it runs on; the ``"cuda"`` section
records the card's name and power limit beside it.

For the sharded entries (those with a ``stage``), :func:`sharded_metrics`
runs each entry's inputs through the staging its API runs with ``mesh=``
(``sweep._stage_variants_global``, ``_stage_cases_global``,
``_stage_bucket_global``) on every rank of a ``cpu_world(2)``, and holds
each rank's staged input bytes to 0.5 x (1 + tolerance) of the whole:
an API that stops splitting an input fails it.  This is the run-time
form of the JAX package's GL403.

:func:`backward_probe` shows that the counting mode and the sync debug
mode see a backward pass that autograd runs on its device thread (on the
card, not the caller's thread), so an entry's budget covers its backward.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
import warnings

DEFAULT_BUDGETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "budgets.json")
#: a metric may grow this fraction over its budget before the gate fails
DEFAULT_TOLERANCE = 0.25
#: the bound of the sharded check: each rank's staged input bytes at most
#: 1/world x (1 + SHARDED_TOLERANCE) of the whole
SHARDED_TOLERANCE = 0.25
SHARDED_WORLD = 2

#: ops that read a value back to the host (or size their output by the
#: data, which reads it back) on the card
_SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2", "unique_dim",
             "unique_consecutive", "equal", "nonzero_static")
_WIDE = ("float64", "complex128")


@dataclasses.dataclass
class AuditReport:
    name: str
    public_api: str
    platform: str
    ops: int
    f64_ops: int
    f64_examples: list
    host_syncs: int
    sync_examples: list
    rebuilds: int
    seconds: float
    ok: bool
    launches: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int | None = None
    sync_debug: int | None = None
    metrics: dict | None = None
    budget_ok: bool | None = None
    budget_notes: list = dataclasses.field(default_factory=list)
    #: the measured call's outputs (not serialised)
    outputs: object = dataclasses.field(default=None, repr=False, compare=False)

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != "outputs"}
        d["seconds"] = round(d["seconds"], 3)
        return d

    def summary(self) -> str:
        state = "ok" if self.ok else "FAIL"
        line = (f"[audit] {self.name}: {state} — {self.ops} ops, f64 ops {self.f64_ops}, "
                f"host syncs {self.host_syncs}, rebuilds {self.rebuilds}")
        if self.platform == "cuda":
            line += (f", launches {self.launches}, peak {self.peak_bytes} B, "
                     f"sync-debug warnings {self.sync_debug}")
        line += f" ({self.seconds:.2f}s)"
        if self.f64_examples:
            line += f"\n[audit]   f64: {self.f64_examples}"
        if self.budget_ok is not None:
            line += f"\n[audit]   budget: {'ok' if self.budget_ok else 'FAIL'}"
            for note in self.budget_notes:
                line += f"\n[audit]     {note}"
        return line


def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _counting_mode():
    """A ``TorchDispatchMode`` counting ops, float64 ops and host syncs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.f64 = self.syncs = 0
            self.f64_examples: list = []
            self.sync_examples: list = []

        def _sync(self, what: str) -> None:
            self.syncs += 1
            if len(self.sync_examples) < 6:
                self.sync_examples.append(what)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.ops += 1
            name = func.__name__.split(".")[0]
            if name in _SYNC_OPS:
                self._sync(name)
            elif name in ("index", "index_put", "index_put_") and len(args) > 1 and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in args[1] or ()):
                self._sync(f"{name} with a boolean mask")
            elif name in ("_to_copy", "copy_") and args:
                if name == "_to_copy":
                    src, dst_dev = args[0], kwargs.get("device", args[0].device)
                else:
                    src, dst_dev = args[1], args[0].device
                dst_type = torch.device(dst_dev).type
                if isinstance(src, torch.Tensor) and src.device.type != dst_type \
                        and "cuda" in (src.device.type, dst_type) \
                        and not kwargs.get("non_blocking", len(args) > 2 and args[2]):
                    self._sync(f"{name} {src.device.type}->{dst_type}")
            if any(str(t.dtype).replace("torch.", "") in _WIDE for t in _tensors(out)):
                self.f64 += 1
                if len(self.f64_examples) < 4:
                    self.f64_examples.append(str(func))
            return out

    return Counter()


def _launch_counts() -> dict:
    from raft_tpu_torch.core import cuda6, cuda_bem

    return {**{f"k1_{k}": v for k, v in cuda6.LAUNCHES.items()},
            **{f"bem_{k}": v for k, v in cuda_bem.LAUNCHES.items()}}


def _rebuild_count() -> int:
    from raft_tpu_torch.cache import aot, stats

    rep = stats.report()
    misses = sum(v.get("misses", 0) for k, v in rep.items()
                 if isinstance(v, dict) and "/" not in k)
    return aot.compile_count() + misses


def audit_entry(entry, device, dtype=None) -> AuditReport:
    """Run one registry entry at ``dtype`` (float32 by default) on
    ``device``: a warming call with ``args``, then the measured call with
    ``args2`` under the counting mode (and, on the card, the sync debug
    mode and the peak-memory counter)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    fn, args, args2 = entry.build(dev, dtype)
    fn(*args)
    base = 0
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    launches0, rebuilds0 = _launch_counts(), _rebuild_count()
    mode = _counting_mode()
    caught: list = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with mode:
                out = fn(*args2)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
    rebuilds = _rebuild_count() - rebuilds0
    launches1 = _launch_counts()
    launches = {k: launches1[k] - launches0[k] for k in launches1
                if launches1[k] != launches0[k]}
    peak = sync_debug = None
    if on_card:
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev)) - base
        sync_debug = sum(1 for c in caught if "synchronizing CUDA operation" in str(c.message))
    return AuditReport(
        name=entry.name, public_api=entry.public_api,
        platform="cuda" if on_card else "cpu", ops=mode.ops, f64_ops=mode.f64,
        f64_examples=mode.f64_examples, host_syncs=mode.syncs,
        sync_examples=mode.sync_examples, rebuilds=rebuilds,
        seconds=time.perf_counter() - t0, ok=(mode.f64 == 0 and rebuilds == 0),
        launches=launches, peak_bytes=peak, sync_debug=sync_debug, outputs=out)


#: the ops the backward probe's hook runs: a multiply, an add, a sum and
#: the host read of ``.item()`` (one host sync)
PROBE_HOOK_OPS, PROBE_HOOK_SYNCS = 4, 1


def backward_probe(device=None, dtype=None) -> dict:
    """Does the counting mode see the backward pass?  On the card, autograd
    runs a backward on a device thread of its own, not the caller's.

    ``val_grad``'s loss (:func:`raft_tpu_torch.lint.registry.
    _entry_val_grad`'s) goes through ``optimize._value_and_grad`` at
    ``dtype`` (float32) on ``device`` under the counting mode and, on the
    card, CUDA's sync debug mode "warn", as :func:`audit_entry` runs an
    entry.  A hook on the loss's input fires inside the backward; it runs
    :data:`PROBE_HOOK_OPS` ops with :data:`PROBE_HOOK_SYNCS` host read and
    reads the mode's counts around them.  Returns whether the hook ran on
    the calling thread, the ops the mode saw in the forward and the
    backward, the ops and syncs it saw inside the hook (against those the
    hook ran), and the host syncs against the sync-debug warnings of the
    whole call (None on the CPU)."""
    import threading

    import torch

    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.lint.registry import _N_ITER, _small_base
    from raft_tpu_torch.parallel.optimize import _make_loss, _value_and_grad, nacelle_accel_std
    from raft_tpu_torch.parallel.sweep import scale_diameters

    dtype = torch.float32 if dtype is None else dtype
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    _, members, rna, env, wave, C_moor = _small_base(dev, dtype)
    loss = _make_loss(members, rna, env, wave, C_moor, nacelle_accel_std, scale_diameters,
                      None, _N_ITER, False, dtype=dtype, device=dev)
    theta = torch.tensor(1.0, dtype=dtype).to(dev)
    _value_and_grad(loss, theta)                # warming call
    if on_card:
        torch.cuda.synchronize(dev)
    mode = _counting_mode()
    seen: dict = {}

    def hook(grad):
        seen["thread"] = threading.get_ident()
        n0, s0 = mode.ops, mode.syncs
        (grad * 2.0 + 1.0).sum().item()
        seen["hook_ops"], seen["hook_syncs"] = mode.ops - n0, mode.syncs - s0

    def probe_loss(th):
        th.register_hook(hook)
        val = loss(th)
        seen["forward_ops"] = mode.ops
        return val

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with mode:
                _value_and_grad(probe_loss, theta)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
    if "thread" not in seen:
        raise RuntimeError("the backward probe's hook never ran")
    return {
        "device": str(dev),
        "hook_on_calling_thread": seen["thread"] == threading.get_ident(),
        "forward_ops": seen["forward_ops"],
        "backward_ops": mode.ops - seen["forward_ops"],
        "hook_ops_seen": seen["hook_ops"], "hook_ops_run": PROBE_HOOK_OPS,
        "hook_syncs_seen": seen["hook_syncs"], "hook_syncs_run": PROBE_HOOK_SYNCS,
        "host_syncs": mode.syncs,
        "sync_debug_warnings": (sum(1 for c in caught if "synchronizing CUDA operation"
                                    in str(c.message)) if on_card else None),
    }


def report_metrics(r: AuditReport) -> dict:
    """The budgeted metrics of one report."""
    m = {"ops": r.ops, "f64_ops": r.f64_ops, "host_syncs": r.host_syncs,
         "rebuilds": r.rebuilds}
    if r.platform == "cuda":
        m["peak_bytes"] = r.peak_bytes
        m.update({f"launches_{k}": v for k, v in r.launches.items()})
    return m


# ----------------------------------------------------------------- budgets

def load_budgets(path: str | None = None) -> dict:
    path = path or DEFAULT_BUDGETS
    if not os.path.exists(path):
        return {"tolerance": DEFAULT_TOLERANCE, "platforms": {}}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    data.setdefault("tolerance", DEFAULT_TOLERANCE)
    data.setdefault("platforms", {})
    return data


def card_label() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    or what stands in for it when the tool does not answer."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() \
            else f"nvidia-smi exit {r.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not run: {type(e).__name__}"


def save_budgets(reports, path: str | None = None) -> str:
    """Merge ``reports``' metrics into the budgets file under their
    platform; other platforms' budgets and ``_``-prefixed keys (reasons)
    survive."""
    path = path or DEFAULT_BUDGETS
    data = load_budgets(path)
    for r in reports:
        plat = data["platforms"].setdefault(r.platform, {})
        fresh = {k: v for k, v in sorted(r.metrics.items())}
        fresh.update({k: v for k, v in plat.get(r.name, {}).items() if k.startswith("_")})
        plat[r.name] = fresh
    if any(r.platform == "cuda" for r in reports):
        data.setdefault("_cards", {})["cuda"] = card_label()
    data["_comment"] = (
        "graftlint runtime budgets of the port: per platform and entry, the counts of "
        "raft_tpu_torch/lint/audit.py at float32; the gate fails when a metric grows "
        "beyond 'tolerance'. Refresh with `python -m raft_tpu_torch.lint --audit "
        "--write-budgets [--device cpu]` and review the diff like any code change.")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def check_budget(name: str, metrics: dict | None, budgets: dict, platform: str) -> tuple:
    """(ok, notes) of one entry's metrics against its committed budget.

    Fails on: no budget for (platform, entry), a budgeted metric this run
    does not measure, or a metric grown beyond the tolerance (any growth of
    a zero budget).  A metric shrunk beyond the tolerance is a note."""
    plat = budgets.get("platforms", {}).get(platform)
    if not plat or name not in plat:
        return False, [f"no committed budget for entry {name!r} on platform {platform!r} "
                       f"— run `python -m raft_tpu_torch.lint --audit --write-budgets`"]
    entry_budget = plat[name]
    tol = float(budgets.get("tolerance", DEFAULT_TOLERANCE))
    ok = True
    notes: list = []
    for metric, bv in sorted(entry_budget.items()):
        if metric.startswith("_"):
            continue
        cur = (metrics or {}).get(metric)
        if cur is None:
            ok = False
            notes.append(f"{metric}: budget {bv} but not measured in this run — the gate "
                         f"cannot verify it")
        elif cur > bv * (1.0 + tol) and (bv == 0 or cur > bv + 1):
            ok = False
            grown = f"+{100.0 * (cur / bv - 1.0):.1f}%" if bv else "from zero"
            notes.append(f"{metric}: {cur} exceeds budget {bv} ({grown}, tolerance "
                         f"{100.0 * tol:.0f}%) — if intended, refresh with --write-budgets")
        elif bv and cur < bv * (1.0 - tol):
            notes.append(f"note: {metric}: {cur} is far below budget {bv} — refresh the "
                         f"budgets to bank the improvement")
    return ok, notes


# ------------------------------------------------------------ sharded check

def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def stage_bytes(entry, mesh) -> tuple[int, int]:
    """(this rank's bytes, the whole's) of ``entry``'s inputs at float32
    on the CPU, staged by the entry's API (``entry.stage``) over ``mesh``."""
    import torch

    _fn, args, _args2 = entry.build(torch.device("cpu"), torch.float32)
    return _nbytes(entry.stage(args, mesh)), _nbytes(args)


def _sharded_rank(rank, mesh, names):
    """One rank of the sharded check: ``{entry: stage_bytes}``."""
    from raft_tpu_torch.lint.registry import get_entries

    return {e.name: stage_bytes(e, mesh) for e in get_entries(names)}


def sharded_metrics(names) -> dict:
    """``{entry: {"sharded_rank_bytes", "unsharded_bytes"}}`` from a
    ``cpu_world(SHARDED_WORLD)``: the largest rank's staged bytes and the
    whole's."""
    from raft_tpu_torch.parallel.spmd import cpu_world

    ranks = cpu_world(SHARDED_WORLD, _sharded_rank, list(names))
    return {n: {"sharded_rank_bytes": max(r[n][0] for r in ranks),
                "unsharded_bytes": ranks[0][n][1]} for n in names}


def check_sharded(name: str, metrics: dict | None) -> tuple:
    """(ok, notes): each rank's staged bytes <= unsharded / world x
    (1 + SHARDED_TOLERANCE).  Missing numbers fail."""
    m = metrics or {}
    rank, whole, n = m.get("sharded_rank_bytes"), m.get("unsharded_bytes"), SHARDED_WORLD
    if not whole or rank is None:
        return False, [f"sharded check: entry {name!r} is sharded=True but no byte counts "
                       f"were measured"]
    bound = whole / n * (1.0 + SHARDED_TOLERANCE)
    if rank > bound:
        return False, [f"sharded_rank_bytes {rank} exceeds unsharded/{n} x "
                       f"{1.0 + SHARDED_TOLERANCE:.2f} = {bound:.0f} (unsharded {whole}): "
                       f"a rank holds (nearly) the whole batch"]
    return True, []


# -------------------------------------------------------------------- runs

def run_audit(names=None, device=None, dtype=None, budget_check: bool = True,
              budgets_path: str | None = None, sharded_check: bool | None = None
              ) -> list[AuditReport]:
    """Audit the named entries (default: all) on ``device`` (``None`` is the
    card, and raises without CUDA; ``"cpu"`` runs here) at float32.  With
    ``budget_check`` every report is held to the committed budgets of its
    platform; a breach or a missing budget marks it ``ok=False``.
    ``sharded_check`` (default: on the CPU only; the check runs on a CPU
    world either way) adds the sharded entries' byte counts."""
    import torch

    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.lint.registry import get_entries

    dev = resolve_device(device)
    entries = get_entries(names)
    dist_was_up = _dist_initialized()
    try:
        reports = [audit_entry(e, dev, dtype) for e in entries]
    finally:
        if not dist_was_up and _dist_initialized():
            torch.distributed.destroy_process_group()
    if sharded_check is None:
        sharded_check = dev.type == "cpu"
    sharded = [e.name for e in entries if e.sharded] if sharded_check else []
    shard = sharded_metrics(sharded) if sharded else {}
    budgets = load_budgets(budgets_path) if budget_check else None
    for r in reports:
        r.metrics = {**report_metrics(r), **shard.get(r.name, {})}
        if r.name in shard:
            sh_ok, sh_notes = check_sharded(r.name, r.metrics)
            r.ok = r.ok and sh_ok
            r.budget_notes.extend(sh_notes)
        if budgets is not None:
            r.budget_ok, notes = check_budget(r.name, r.metrics, budgets, r.platform)
            r.budget_notes.extend(notes)
            r.ok = r.ok and r.budget_ok
    return reports


def _dist_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def write_budgets(names=None, path: str | None = None, device=None) -> tuple:
    """Measure the named entries (default: all) on ``device`` and merge
    them into the budgets file.  Returns (path, reports)."""
    reports = run_audit(names, device=device, budget_check=False)
    return save_budgets(reports, path), reports
