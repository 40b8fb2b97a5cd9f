"""Serve-loop configuration, snapshotted at arm time (port of
``raft_tpu.serve.config``).

A resident process reads its environment knobs once, when the daemon
arms, and carries the snapshot: the concurrent request path (batcher,
solver loop, connection readers) only ever sees this frozen dataclass.
:func:`ServeConfig.from_env` is called from ``python -m
raft_tpu_torch.serve``, the smoke and the chip smoke, all at arm time.

Knobs:

* ``RAFT_TPU_SERVE_BATCH_DEADLINE_MS``: how long an open micro-batch may
  wait for company before it closes anyway (default 25 ms).  Pure
  scheduling: every dispatch is padded to the fixed lane capacity, so the
  deadline changes latency, never results.
* ``RAFT_TPU_SERVE_BATCH_MAX``: the fixed per-bucket lane capacity
  (default 8).  Every dispatch is padded to exactly this many lanes, so a
  bucket's solve has one shape whatever its occupancy.
* ``RAFT_TPU_SERVE_SOCKET``: the default daemon socket path, else
  ``raft_tpu_torch_serve_<uid>.sock`` in the temporary directory (the JAX
  package's daemon uses another name, so both can run on one host).

Beside the JAX package's fields, ``device`` (None: the card) is the one
every entry point of the port takes; the lanes are staged and solved in
float64 (``ServeConfig.dtype``, a constant: no caller serves another type).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import ClassVar

import torch

DEADLINE_ENV = "RAFT_TPU_SERVE_BATCH_DEADLINE_MS"
BATCH_MAX_ENV = "RAFT_TPU_SERVE_BATCH_MAX"
SOCKET_ENV = "RAFT_TPU_SERVE_SOCKET"

DEFAULT_DEADLINE_MS = 25.0
DEFAULT_BATCH_MAX = 8


def default_socket_path() -> str:
    """Default AF_UNIX socket path (per-uid, in the temporary directory)."""
    return os.path.join(tempfile.gettempdir(), f"raft_tpu_torch_serve_{os.getuid()}.sock")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen arm-time snapshot of everything the serve loop consults."""

    batch_deadline_s: float = DEFAULT_DEADLINE_MS / 1e3
    batch_max: int = DEFAULT_BATCH_MAX
    socket_path: str = ""
    # solve parameters shared by every lane: the frequency grid is a
    # server-level contract (the lanes of one bucket stack one padded grid)
    nw: int = 100
    w_min: float = 0.05
    w_max: float = 2.95
    n_iter: int = 25
    escalate: bool = True
    # optional chunking of each padded batch through parallel/pipeline.py
    # (None: one dispatch per batch, right for interactive capacities)
    chunk: int | None = None
    # where the lanes are staged and solved (None: the card), and in which
    # float type (a constant, not a knob)
    device: str | None = None
    dtype: ClassVar[torch.dtype] = torch.float64

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """Snapshot the ``RAFT_TPU_SERVE_*`` knobs (at arm time only, never
        from the request path).  ``overrides`` win over the environment
        (CLI flags, test fixtures)."""
        vals: dict = {}
        raw = os.environ.get(DEADLINE_ENV, "").strip()
        if raw:
            try:
                vals["batch_deadline_s"] = max(0.0, float(raw)) / 1e3
            except ValueError:
                raise ValueError(f"{DEADLINE_ENV}={raw!r} is not a number (milliseconds)")
        raw = os.environ.get(BATCH_MAX_ENV, "").strip()
        if raw:
            try:
                vals["batch_max"] = int(raw)
            except ValueError:
                raise ValueError(f"{BATCH_MAX_ENV}={raw!r} is not an integer")
        vals["socket_path"] = os.environ.get(SOCKET_ENV, "").strip() or default_socket_path()
        vals.update(overrides)
        cfg = cls(**vals)
        if cfg.batch_max < 1:
            raise ValueError(f"{BATCH_MAX_ENV} must be >= 1, got {cfg.batch_max}")
        return cfg
