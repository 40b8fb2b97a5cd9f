"""Escalation ladder: quarantined lanes get progressively tougher solves
(port of ``raft_tpu.resilience.ladder``).

A lane that fails the batch solve is not thrown away — it is re-solved
alone, walking a ladder of increasingly conservative solver settings
until one converges finite (or the ladder is exhausted and the lane is
reported unsalvaged):

1. ``n_iter_x4`` — same solver, 4x the iteration budget: the common case
   of a slow-but-convergent fixed point that simply hit the batch cap.
2. ``relax_0.5`` — halve the under-relaxation (and keep the larger
   budget): damps the oscillatory divergence mode of the drag
   linearization on resonant/extreme cases.
3. ``relax_0.25`` — quarter relaxation, 6x budget: the heavily damped
   crawl for stiffly coupled lanes.
4. ``tikhonov`` — diagonal-loaded (Tikhonov-regularized) fused solve
   (``solve_dynamics(tik=1e-6)``) at half relaxation: trades a bounded,
   reported bias for solvability when the impedance itself is nearly
   singular at some frequency.

(The reference tree this grew from has a single fixed-point scheme; an
alternative-accelerator rung slots in here if one lands — the ladder is
data, not control flow.)

Every rung is its own single-lane solve, built once per rung by the
sweep's ``solve_lane`` (the JAX package compiles one executable per
rung), so the healthy batch never sees a rung.  Rungs run one lane at a
time: quarantine is rare by construction.  On the card each rung's
fixed-point iterations go through kernel K1 like the batch's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from raft_tpu_torch.resilience.health import LaneHealth


@dataclasses.dataclass(frozen=True)
class Rung:
    name: str
    n_iter_mul: int          # multiplier on the sweep's iteration budget
    relax: float | None      # None = keep the caller's relaxation
    tik: float = 0.0         # diagonal-loading strength (0 = plain solve)


#: the default ladder, mildest first (see module docstring)
RUNGS: tuple = (
    Rung("n_iter_x4", 4, None),
    Rung("relax_0.5", 4, 0.5),
    Rung("relax_0.25", 6, 0.25),
    Rung("tikhonov", 6, 0.5, 1e-6),
)

DEFAULT_RELAX = 0.8          # solve_dynamics' own default


def rung_knobs(rung: Rung, base_n_iter: int,
               default_relax: float = DEFAULT_RELAX) -> tuple:
    """(n_iter, relax, tik) a rung resolves to for a given base budget."""
    n_iter = max(int(base_n_iter) * rung.n_iter_mul, int(base_n_iter) + 1)
    relax = default_relax if rung.relax is None else rung.relax
    return n_iter, relax, rung.tik


def escalate_lanes(lanes, solve_lane, base_n_iter: int,
                   rungs=RUNGS, default_relax: float = DEFAULT_RELAX):
    """Walk each quarantined lane up the ladder.

    ``solve_lane(index, n_iter, relax, tik)`` re-solves ONE lane with the
    given knobs and returns ``(payload, converged, finite, n_iter_used)``
    — payload a tuple of host arrays in the sweep's own result layout,
    the flags/count host scalars.  A lane is salvaged by the first rung
    whose result is converged and finite (device flags AND a host
    finiteness sweep over the payload — a rung may converge to NaN on
    NaN inputs, which must not count as salvage).

    Returns ``(records, salvaged)``: one :class:`LaneHealth` per lane in
    input order, and ``{index: payload}`` for the lanes a rung rescued.
    """
    from raft_tpu_torch import obs as _obs

    records = []
    salvaged = {}
    for idx in np.asarray(lanes).reshape(-1):
        idx = int(idx)
        rec = LaneHealth(index=idx, converged=False, finite=False,
                         n_iter=0, quarantined=True)
        for rung in rungs:
            n_iter, relax, tik = rung_knobs(rung, base_n_iter, default_relax)
            _obs.metrics.counter(f"resilience.rung[{rung.name}]").inc()
            payload, conv, fin, used = solve_lane(idx, n_iter, relax, tik)
            rec.converged = bool(conv)
            rec.finite = bool(fin)
            rec.n_iter = int(used)
            host_ok = all(np.isfinite(np.asarray(p)).all() for p in payload)
            if rec.converged and rec.finite and host_ok:
                rec.salvaged = True
                rec.rung = rung.name
                salvaged[idx] = payload
                break
        records.append(rec)
    return records, salvaged


def quarantine_and_salvage(arrays, conv, finite, solve_lane,
                           base_n_iter: int, escalate: bool = True,
                           iters=None):
    """The host-side quarantine step every resilient sweep shares.

    ``arrays``: writable host arrays (leading axis = lane), in the SAME
    order as the payload tuples ``solve_lane`` returns — salvaged
    payloads are patched into them in place.  ``conv``/``finite``: the
    device-side verdict arrays (``finite`` may be None when the sweep
    had no device finite flag); copies are returned with salvaged lanes
    flipped healthy.  ``iters`` (optional, per-lane) stamps the records
    of lanes that were quarantined but not escalated.

    Returns ``(records, conv, finite)`` — one :class:`LaneHealth` per
    quarantined lane (empty when the batch was healthy).
    """
    from raft_tpu_torch import obs as _obs
    from raft_tpu_torch.resilience.health import failed_lanes

    conv = np.array(conv).astype(bool).reshape(-1)
    finite = (np.ones_like(conv) if finite is None
              else np.array(finite).astype(bool).reshape(-1))
    bad = failed_lanes(conv, finite, host_values=arrays)
    if not len(bad):
        return [], conv, finite
    _obs.metrics.counter("resilience.quarantined").inc(len(bad))
    if not escalate:
        it = np.zeros(len(conv), dtype=int) if iters is None else np.asarray(iters)
        # the record's finite verdict folds the host sweep in: a lane
        # whose fetched arrays are NaN must not read finite=True just
        # because the device flag (or a finite=None caller) said so
        host_fin = [all(np.isfinite(np.asarray(a[i])).all() for a in arrays)
                    for i in bad]
        records = [LaneHealth(index=int(i), converged=bool(conv[i]),
                              finite=bool(finite[i]) and bool(hf),
                              n_iter=int(it[i]), quarantined=True)
                   for i, hf in zip(bad, host_fin)]
        return records, conv, finite
    records, salvaged = escalate_lanes(bad, solve_lane, base_n_iter)
    _obs.metrics.counter("resilience.salvaged").inc(len(salvaged))
    _obs.metrics.counter("resilience.unsalvaged").inc(
        len(bad) - len(salvaged))
    for idx, payload in salvaged.items():
        for arr, val in zip(arrays, payload):
            arr[idx] = val
        conv[idx] = True
        finite[idx] = True
    return records, conv, finite
