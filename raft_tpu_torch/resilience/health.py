"""Per-lane health verdicts: no lane fails silently, no lane poisons a batch
(port of ``raft_tpu.resilience.health``).

A batched sweep used to have exactly two outcomes: every lane converged
finite, or one ``assert`` threw the whole batch away.  The resilience
contract replaces that with a per-lane verdict — ``(converged, finite,
n_iter)``, the first two computed on the device inside the batched sweep
(``finite`` over the full response spectra, which in ``return_xi=False``
mode never cross to host) — and a host-side quarantine step that
separates failed lanes from healthy ones instead of aborting.

Quarantined lanes go through the escalation ladder
(:mod:`raft_tpu_torch.resilience.ladder`); whatever the outcome, every lane
ends with a :class:`LaneHealth` record and the batch-level
:func:`summarize` block that the north star returns as its ``resilience``
key — degradation is visible, never silent.

``RAFT_TPU_STRICT`` (default ON — unset means strict) preserves the old
all-or-nothing contract at the call sites that had it (the north star):
strict mode reports the same structured block, then fails loudly.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


def strict() -> bool:
    """The all-or-nothing gate: True unless ``RAFT_TPU_STRICT`` spells an
    explicit off.  Strict is the DEFAULT (and stays the default in CI):
    degradation-tolerant behavior is an opt-in, never a surprise."""
    v = os.environ.get("RAFT_TPU_STRICT", "").strip().lower()
    if not v:
        return True
    return v not in ("0", "false", "off", "no")


@dataclasses.dataclass
class LaneHealth:
    """Final verdict for one batch lane.

    ``converged``/``finite``/``n_iter`` reflect the lane's LAST solve —
    the original batch solve for healthy lanes, the successful (or final
    failed) ladder rung for quarantined ones.  ``rung`` names the ladder
    rung that salvaged the lane (None when the lane never needed one, or
    nothing salvaged it)."""

    index: int
    converged: bool
    finite: bool
    n_iter: int
    quarantined: bool = False
    salvaged: bool = False
    rung: str | None = None


def failed_lanes(converged, finite=None, host_values=()) -> np.ndarray:
    """Indices of lanes whose verdict is bad: not converged, device-side
    non-finite, or non-finite in any of the fetched ``host_values``
    arrays (leading axis = lane) — the last check catches anything that
    went bad AFTER the device verdict (fetch-path corruption, injected
    faults), so quarantine can never be talked out of by a stale flag."""
    ok = np.asarray(converged).astype(bool).reshape(-1).copy()
    if finite is not None:
        ok &= np.asarray(finite).astype(bool).reshape(-1)
    for v in host_values:
        a = np.asarray(v)
        a = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(-1, 1)
        ok &= np.isfinite(a).all(axis=1)
    return np.where(~ok)[0]


def summarize(records, n_lanes: int, extra: dict | None = None) -> dict:
    """The batch-level ``resilience`` block (north star / sweep result):
    who was quarantined, who was salvaged and by which rung, who stayed
    bad — plus any caller extras (checkpoint counters, strictness)."""
    records = list(records)
    rungs_used: dict = {}
    for r in records:
        if r.salvaged and r.rung:
            rungs_used[r.rung] = rungs_used.get(r.rung, 0) + 1
    out = {
        "lanes": int(n_lanes),
        "n_quarantined": len(records),
        "quarantined": [int(r.index) for r in records],
        "salvaged": sum(1 for r in records if r.salvaged),
        "unsalvaged": [int(r.index) for r in records if not r.salvaged],
        "rungs_used": rungs_used,
    }
    if extra:
        out.update(extra)
    return out
