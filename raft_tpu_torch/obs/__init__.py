"""Unified observability layer: spans, bounded metrics, exporters and the
per-kernel performance ledger (port of ``raft_tpu.obs``).

* :mod:`raft_tpu_torch.obs.trace` — thread-safe nested span tracing with
  request-scoped trace ids that cross threads (context tokens +
  synthetic request tracks) and a Chrome trace-event exporter; while a
  ``torch.profiler`` records, every span is also a profiler range;
* :mod:`raft_tpu_torch.obs.metrics` — process-wide counters, gauges,
  log-bucket latency histograms with deterministic quantiles, and
  sliding-window SLO histograms on an injectable clock;
* :mod:`raft_tpu_torch.obs.export` — sinks armed by ``RAFT_TPU_OBS``
  (JSONL event log, Chrome trace file, Prometheus text; auto-publish
  debounced via ``RAFT_TPU_OBS_FLUSH_MS``) plus the ``obs`` block a run
  report embeds;
* :mod:`raft_tpu_torch.obs.flight` — bounded flight recorder of the
  last-N completed request records, dumped atomically;
* :mod:`raft_tpu_torch.obs.ledger` — achieved FLOP/s, bytes/s and
  roofline fraction per kernel and shape bucket, from CUDA events around
  each launch while the cache is enabled, persisted under the cache root.

Everything here is host-side and bounded in memory; arming or reading it
never changes what the device computes.
"""
from raft_tpu_torch.obs import export, flight, ledger, metrics, trace  # noqa: F401
from raft_tpu_torch.obs.export import (                         # noqa: F401
    enabled, maybe_publish, obs_block, prometheus_text, publish, read_jsonl,
)
from raft_tpu_torch.obs.flight import FlightRecorder            # noqa: F401
from raft_tpu_torch.obs.metrics import (                        # noqa: F401
    counter, gauge, histogram, sliding, snapshot,
)
from raft_tpu_torch.obs.trace import (                          # noqa: F401
    TraceContext, chrome_trace, current_context, new_trace_id, span,
)


def reset() -> None:
    """Clear spans, metrics and the publish debounce (tests, phase
    boundaries of a daemon)."""
    trace.reset()
    metrics.reset()
    export._reset_debounce()
