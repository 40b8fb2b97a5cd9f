"""Deterministic fault injection for the resilience test harness (port of
``raft_tpu.resilience.faults``: the same spec parser and all seven fault
names; the port's chunk pipeline, checkpoint store and subprocess wrapper
hook up the first four, the three router faults wait for the serving
daemon).

A long-running chunked sweep fails in a handful of stereotyped ways — a
lane of the batch diverges or goes NaN, the process is preempted between
chunks, a checkpoint artifact is corrupted on disk, a native toolchain
subprocess hangs.  Reproducing any of these against real hardware is
flaky by definition, so the resilience machinery carries its own
injection points, armed by one environment variable:

``RAFT_TPU_FAULT_INJECT``
    Comma-separated fault specs, each ``name`` or ``name:arg``:

    * ``nan_chunk:K`` — the fetched host results of chunk ``K`` are
      overwritten with NaN (float leaves only; convergence flags are left
      alone, mimicking a device that silently produced NaNs).  Applied in
      :func:`raft_tpu_torch.parallel.pipeline.run_pipelined` at fetch time,
      BEFORE any checkpoint write — downstream quarantine must catch it
      exactly as it would a real one.
    * ``kill_after_chunk:K`` — the process exits hard
      (``os._exit(KILL_EXIT)``) right after chunk ``K``'s result is
      fetched (and checkpointed, when a store is active): the
      preemption/OOM-kill simulation for the resume path.
    * ``corrupt_ckpt:K`` — chunk ``K``'s checkpoint npz gets one byte
      flipped immediately after its atomic write
      (:meth:`raft_tpu_torch.resilience.checkpoint.ChunkStore.save`): the
      bit-rot simulation for the content-hash detection path.
    * ``hang_subprocess[:N]`` — subprocess launches through
      :func:`raft_tpu_torch.resilience.retry.checked_subprocess` (and the
      kernel and solver builds) sleep past
      their timeout instead of running; with ``:N`` only the first ``N``
      launches in this process hang (so a bounded retry can be seen to
      salvage the call).
    * ``kill_replica[:K]`` — the serving fleet's router
      (``serve/router.py``) SIGKILLs the replica it just picked
      for the next ``K`` dispatches, BEFORE forwarding the request: the
      replica-death simulation for the failover-resubmission path (the
      request must still be answered, by a survivor).
    * ``stall_replica[:K]`` — the router registers the next ``K``
      forwarded requests but silently withholds the frames (the replica
      never sees them): the wedged-replica simulation for the
      forward-deadline / resubmission path.
    * ``refuse_connect[:K]`` — the router's next ``K`` replica connection
      attempts raise ``ConnectionRefusedError`` before touching the
      socket: the crash-during-restart simulation for the bounded
      reconnect ladder and the re-admission probe.

All injection points are HOST-side (fetch results, file writes,
subprocess spawns, router-side socket plumbing): arming a fault never
changes what a kernel computes.
"""
from __future__ import annotations

import os
import threading

import numpy as np

#: exit code of a ``kill_after_chunk`` hard exit (distinct from common
#: shells/python codes so the smoke can assert the kill really fired)
KILL_EXIT = 77

#: every fault kind an armed spec may name (the docstring above is the
#: contract; a misspelled kind must warn as loudly as a malformed arg —
#: a harness silently arming nothing "passes" every resilience check)
KINDS = frozenset({
    "nan_chunk", "kill_after_chunk", "corrupt_ckpt", "hang_subprocess",
    "kill_replica", "stall_replica", "refuse_connect",
})

# per-process consumption counters for counted faults (hang_subprocess:N);
# locked so ``name:N`` fires exactly N times even under concurrent
# subprocess launches
_counts: dict = {}
_counts_lock = threading.Lock()


def specs() -> dict:
    """Parse ``RAFT_TPU_FAULT_INJECT`` fresh (tests flip it in-process).

    Returns ``{name: [arg, ...]}`` with ``arg`` an int or None.  Malformed
    entries (non-integer arg) are ignored with a warning rather than
    killing the run a fault harness exists to protect.
    """
    raw = os.environ.get("RAFT_TPU_FAULT_INJECT", "").strip()
    out: dict = {}
    if not raw:
        return out
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, arg = part.partition(":")
        if name not in KINDS:
            import warnings

            warnings.warn(
                f"RAFT_TPU_FAULT_INJECT spec {part!r} names an unknown "
                f"fault kind (have {sorted(KINDS)}); ignoring it",
                stacklevel=2)
            continue
        if arg:
            try:
                arg_i = int(arg)
            except ValueError:
                import warnings

                warnings.warn(
                    f"RAFT_TPU_FAULT_INJECT spec {part!r} has a "
                    f"non-integer argument; ignoring it", stacklevel=2)
                continue
            out.setdefault(name, []).append(arg_i)
        else:
            out.setdefault(name, []).append(None)
    return out


def active() -> bool:
    """True when any fault spec is armed (one env read; the pipeline
    checks this once per pass so an unarmed process pays nothing)."""
    return bool(os.environ.get("RAFT_TPU_FAULT_INJECT", "").strip())


def chunk_fault(name: str, k: int) -> bool:
    """Does an armed ``name`` spec target chunk ``k``?  An argument-less
    spec targets every chunk."""
    args = specs().get(name)
    if not args:
        return False
    return any(a is None or a == int(k) for a in args)


def consume(name: str) -> bool:
    """Counted fault check: ``name`` fires always, ``name:N`` fires for
    the first ``N`` calls in this process (then stays quiet)."""
    args = specs().get(name)
    if not args:
        return False
    n = args[0]
    if n is None:
        return True
    with _counts_lock:          # check-then-act atomically: exactly N fires
        used = _counts.get(name, 0)
        if used < n:
            _counts[name] = used + 1
            return True
    return False


def reset_counts() -> None:
    """Forget counted-fault consumption (tests)."""
    with _counts_lock:
        _counts.clear()


def nan_results(result):
    """NaN-out the float leaves of a fetched chunk result (ints/bools —
    iteration counts, convergence flags — pass through untouched, the
    signature of a device that silently produced NaNs)."""
    def one(leaf):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating):
            return np.full_like(a, np.nan)
        return leaf

    if isinstance(result, tuple):
        return tuple(one(x) for x in result)
    return one(result)


def maybe_kill_after_chunk(k: int) -> None:
    """Hard-exit the process if ``kill_after_chunk:k`` is armed.  Called
    after chunk ``k``'s fetch (and checkpoint write) completes —
    ``os._exit`` skips interpreter teardown, exactly like a preemption."""
    if chunk_fault("kill_after_chunk", k):
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(KILL_EXIT)


def maybe_corrupt_file(name: str, k: int, path: str) -> bool:
    """Flip one mid-file byte of ``path`` if ``name:k`` is armed (the
    checkpoint store calls this right after its atomic write).  Returns
    True when the corruption was applied."""
    if not chunk_fault(name, k):
        return False
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return False
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    return True
