"""Shape-bucket ladder: mixed designs -> a handful of padded shape classes
(port of ``raft_tpu.build.buckets``).

Each design has its own member/segment/node counts.  Rounding each shape
axis up to a small ladder of size classes (masked padding does the rest)
puts any design into one of a few padded signatures, so a mixed batch of
different platforms solves as one batched :func:`~raft_tpu_torch.parallel.
sweep.forward_response` per bucket (:func:`~raft_tpu_torch.parallel.sweep.
sweep_designs`).

Three bucketed axes:

* ``segments`` / ``nodes``: the :class:`~raft_tpu_torch.core.types.MemberSet`
  axes, padded by :func:`~raft_tpu_torch.build.members.member_arrays`
  (``seg_mask`` / ``node_mask`` gate every padded row out of statics,
  hydrostatics and the Morison sums);
* ``nw``: the frequency-grid length.  Padded bins extend the grid beyond
  ``w_max`` at the same spacing with ``zeta = 0`` and a ``freq_mask`` on
  the WaveState that zeroes the fixed-point seed there, so they carry
  exactly zero response through every iteration and move neither the drag
  linearization's spectral moment nor the convergence test.

The default ladder puts the four shipped designs into two buckets (OC3 spar
and VolturnUS-S share the small class, the two OC4 semis the medium one).
``RAFT_TPU_BUCKETS`` overrides it, e.g.::

    RAFT_TPU_BUCKETS="segments=16,48,96;nodes=64,128,256;nw=32,64,128"

The promotion counter has no metrics registry behind it yet: the JAX
package also feeds ``obs.metrics.counter("buckets.promotions")``, which
comes with the port of ``obs`` (ROADMAP.md, queue 1, item 7).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import NamedTuple

import torch

from raft_tpu_torch.build.members import (
    _accumulate, member_arrays, member_counts, member_set_from_arrays,
)

log = logging.getLogger(__name__)

ENV_VAR = "RAFT_TPU_BUCKETS"

DEFAULT_LADDER: dict = {
    "segments": (16, 48, 96, 192, 384),
    "nodes": (64, 128, 256, 512, 1024),
    "nw": (16, 32, 64, 128, 256, 512),
    # panel-mesh size classes of the panel BEM (hull + lid panels), every
    # one a BEM_TILE multiple; kept as data, as in the JAX package
    "panels": (64, 128, 256, 512, 768, 1024, 1536, 2048),
}

#: tile edge of the JAX package's tiled BEM assembly; the ``panels`` ladder
#: above is aligned to it
BEM_TILE = 64

_AXES = tuple(DEFAULT_LADDER)


class BucketSig(NamedTuple):
    """One padded shape class.  ``nw`` is None when only the member axes
    were bucketed (no frequency grid in play)."""

    segments: int
    nodes: int
    nw: int | None = None


class BucketOverflow(ValueError):
    """A design (or frequency grid) exceeds the top of the ladder on some
    axis: extend the ladder (``RAFT_TPU_BUCKETS``) to admit it."""


def ladder(env: str | None = None) -> dict:
    """The active size-class ladder: ``DEFAULT_LADDER`` unless
    ``RAFT_TPU_BUCKETS`` (or the explicit ``env`` string) overrides it.
    Each axis is a strictly increasing tuple of admissible padded sizes;
    axes absent from the override keep their defaults."""
    spec = os.environ.get(ENV_VAR, "") if env is None else env
    spec = spec.strip()
    out = dict(DEFAULT_LADDER)
    if not spec:
        return out
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"{ENV_VAR}: expected 'axis=n1,n2,...' entries separated by ';', "
                             f"got {part!r}")
        axis, _, vals = part.partition("=")
        axis = axis.strip()
        if axis not in _AXES:
            raise ValueError(f"{ENV_VAR}: unknown axis {axis!r}; have {sorted(_AXES)}")
        try:
            classes = tuple(int(v) for v in vals.split(",") if v.strip())
        except ValueError:
            raise ValueError(f"{ENV_VAR}: non-integer class in {part!r}") from None
        if not classes or any(c <= 0 for c in classes):
            raise ValueError(f"{ENV_VAR}: {axis} needs positive classes")
        if list(classes) != sorted(set(classes)):
            raise ValueError(f"{ENV_VAR}: {axis} classes must be strictly increasing")
        out[axis] = classes
    return out


def ladder_salt(ld: dict | None = None) -> tuple:
    """Canonical name of the active ladder (the JAX package folds it into
    every bucketed executable's key; here it labels the sweep's stats)."""
    ld = ld or ladder()
    return ("buckets", ";".join(f"{a}={','.join(map(str, ld[a]))}" for a in _AXES))


def round_up(value: int, axis: str, ld: dict | None = None) -> int:
    """Smallest ladder class >= ``value`` on ``axis``; raises
    :class:`BucketOverflow` past the ladder top."""
    classes = (ld or ladder())[axis]
    for c in classes:
        if value <= c:
            return c
    raise BucketOverflow(
        f"{axis}={value} exceeds the ladder top {classes[-1]}; extend {ENV_VAR} "
        f"(e.g. {axis}=...,{classes[-1]},{2 * classes[-1]})")


def bucketize(design: dict, nw: int | None = None, dls_max: float = 10.0,
              include_end_b: bool = False, ld: dict | None = None) -> BucketSig:
    """Round a design's exact (segment, node) counts, and the frequency
    grid's length when given, up to their ladder classes."""
    ld = ld or ladder()
    S, N = member_counts(design, dls_max=dls_max, include_end_b=include_end_b)
    return BucketSig(segments=round_up(S, "segments", ld), nodes=round_up(N, "nodes", ld),
                     nw=None if nw is None else round_up(int(nw), "nw", ld))


# ---------------------------------------------------------------- promotion

_lock = threading.Lock()
_promotions = 0


def promotion_count() -> int:
    """Process-wide count of class promotions the self-healing build has
    performed (a design exceeded its requested class and was bumped to the
    next one)."""
    return _promotions


def _record_promotion(n: int = 1) -> None:
    global _promotions
    with _lock:
        _promotions += n


def reset_promotions() -> None:
    """Zero the promotion counter (tests)."""
    global _promotions
    with _lock:
        _promotions = 0


def bucketed_member_arrays(design: dict, sig: BucketSig | None = None, nw: int | None = None,
                           dls_max: float = 10.0, include_end_b: bool = False):
    """A design's padded member arrays (host numpy,
    :func:`~raft_tpu_torch.build.members.member_arrays`) at its bucket
    class; returns ``(arrays, sig)``.

    ``sig``: the target class (member axes only; ``sig.nw`` rides along).
    Default: bucketize the design, rounding ``nw`` (when given) into the
    signature too.  The member list is parsed once: one accumulator
    measures the counts and feeds the padded build.  A design that exceeds
    the requested class on a member axis is promoted to the class that
    admits it (logged and counted, :func:`promotion_count`); only past the
    ladder top does it raise :class:`BucketOverflow`."""
    ld = ladder()
    acc = _accumulate(design, dls_max=dls_max, include_end_b=include_end_b)
    S, N = len(acc.seg["l"]), len(acc.node["dls"])
    if sig is None:
        sig = BucketSig(segments=round_up(S, "segments", ld), nodes=round_up(N, "nodes", ld),
                        nw=None if nw is None else round_up(int(nw), "nw", ld))
    if S > sig.segments or N > sig.nodes:
        promoted = BucketSig(
            segments=round_up(S, "segments", ld) if S > sig.segments else sig.segments,
            nodes=round_up(N, "nodes", ld) if N > sig.nodes else sig.nodes,
            nw=sig.nw)
        _record_promotion(int(promoted.segments > sig.segments)
                          + int(promoted.nodes > sig.nodes))
        log.info("bucket promotion: design needs (%d segments, %d nodes) > class (%d, %d); "
                 "promoted to (%d, %d) [total promotions: %d]", S, N, sig.segments, sig.nodes,
                 promoted.segments, promoted.nodes, promotion_count())
        sig = promoted
    arrays = member_arrays(design, dls_max=dls_max, pad_segments=sig.segments,
                           pad_nodes=sig.nodes, include_end_b=include_end_b, _acc=acc)
    return arrays, sig


def build_bucketed_member_set(design: dict, sig: BucketSig | None = None, nw: int | None = None,
                              dls_max: float = 10.0, include_end_b: bool = False,
                              dtype=torch.float64, device=None):
    """A design's :class:`MemberSet` padded to its bucket class on
    ``device`` (the card by default), with the self-healing promotion of
    :func:`bucketed_member_arrays`.  Returns ``(members, sig)``."""
    from raft_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    arrays, sig = bucketed_member_arrays(design, sig, nw=nw, dls_max=dls_max,
                                         include_end_b=include_end_b)
    return member_set_from_arrays(arrays, dev, dtype), sig
