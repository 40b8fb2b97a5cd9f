"""Resilient sweeps: lane quarantine, escalation retry, chunk
checkpoint/resume, and a deterministic fault-injection harness (port of
``raft_tpu.resilience``).

A chunked sweep over thousands of designs or sea states must not lose
the batch to one diverged or NaN lane, nor every finished chunk to a
preemption, nor hang forever on a native-toolchain subprocess.  Partial
progress is durable, bad cases are quarantined and REPORTED:

* :mod:`~raft_tpu_torch.resilience.health` — per-lane ``(converged,
  finite, n_iter)`` verdicts, the first two reduced on the device inside
  the batched sweeps; quarantine instead of batch abort; the
  ``RAFT_TPU_STRICT`` gate (default ON).
* :mod:`~raft_tpu_torch.resilience.ladder` — quarantined lanes re-solved
  one at a time through an escalation ladder (bigger iteration budget →
  reduced relaxation → Tikhonov-regularized solve).
* :mod:`~raft_tpu_torch.resilience.checkpoint` — durable per-chunk result
  store (atomic npz + content-hashed manifest, keyed by the program's
  inputs, the port's sources and the device type) under
  ``RAFT_TPU_CKPT``; a killed sweep resumes at the first missing chunk
  with bit-identical results.
* :mod:`~raft_tpu_torch.resilience.retry` — bounded, exponential-backoff,
  deadline-aware retry + hard-timeout subprocess wrapper (the ``g++``
  build of the host panel solver) with shared stderr redaction.
* :mod:`~raft_tpu_torch.resilience.faults` — ``RAFT_TPU_FAULT_INJECT``
  deterministic fault points (NaN chunk, kill-after-chunk, checkpoint
  corruption, hanging subprocess), all host-side.

``python -m raft_tpu_torch.resilience`` runs the CPU smoke proving the
kill-and-resume and NaN-quarantine-and-salvage paths end to end.
"""
from raft_tpu_torch.resilience.health import (  # noqa: F401
    LaneHealth,
    failed_lanes,
    strict,
    summarize,
)
from raft_tpu_torch.resilience.ladder import (  # noqa: F401
    RUNGS,
    Rung,
    escalate_lanes,
    quarantine_and_salvage,
    rung_knobs,
)
from raft_tpu_torch.resilience.checkpoint import ChunkStore, store_for  # noqa: F401
from raft_tpu_torch.resilience.retry import (  # noqa: F401
    RetryExhausted,
    SubprocessFailed,
    checked_subprocess,
    redacted_tail,
    retry_call,
)
