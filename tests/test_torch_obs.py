"""The port's observability layer (``raft_tpu_torch.obs``: metrics, trace,
flight, export) against the JAX package's ``raft_tpu.obs``, on the CPU.

The same numpy-seeded observation sequences (an injected clock for the
sliding windows) give identical ``snapshot()``s, quantiles included, and
identical Prometheus text; the same span sequences give the same
``rollup()`` names and counts and a Chrome trace of the same schema; the
flight recorders keep and dump the same records.  Port-only: every span
opens a ``torch.profiler`` range while a profiler records, the sinks publish and
read back, and the ``obs`` block carries the compile counts of the
kernel-library registry (``cache/aot.py``) where the JAX package's carries
its executable registry's.
"""
import json
import os
import threading

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu.obs import export as jexport
from raft_tpu.obs import metrics as jmetrics
from raft_tpu.obs import trace as jtrace
from raft_tpu.obs.flight import FlightRecorder as JFlightRecorder

from raft_tpu_torch import obs
from raft_tpu_torch.obs import export, metrics, trace
from raft_tpu_torch.obs.flight import FlightRecorder


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _feed(m, rng_seed: int):
    """One numpy-seeded sequence of counter, gauge and histogram updates
    (latencies log-uniform over 1e-7..1e4 s: under- and overflow too)."""
    rng = np.random.default_rng(rng_seed)
    for i in range(400):
        kind = rng.integers(0, 3)
        name = f"m{rng.integers(0, 5)}"
        if kind == 0:
            m.counter(f"c.{name}").inc(int(rng.integers(1, 4)))
        elif kind == 1:
            m.gauge(f"g.{name}").set(float(rng.normal()))
        else:
            m.histogram(f"h.{name}").observe(float(10.0 ** rng.uniform(-7, 4)))
    m.histogram("h.nan").observe(float("nan"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_snapshot_matches_jax(seed):
    _feed(metrics, seed)
    _feed(jmetrics, seed)
    got, want = metrics.snapshot(), jmetrics.snapshot()
    assert got == want
    assert got["histograms"]["h.m0"]["p99"] >= got["histograms"]["h.m0"]["p50"]
    json.dumps(got)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.9, 0.99, 1.0])
def test_quantile_from_counts_matches_jax(q):
    rng = np.random.default_rng(7)
    for _ in range(20):
        counts = list(rng.integers(0, 5, len(metrics._EDGES) + 1))
        total = int(sum(counts))
        assert metrics._quantile_from_counts(counts, total, q) == \
            jmetrics._quantile_from_counts(counts, total, q)
    assert metrics._EDGES == jmetrics._EDGES
    assert metrics._quantile_from_counts([0] * 47, 0, 0.5) == 0.0


@pytest.mark.parametrize("seed", [3, 4])
def test_sliding_window_matches_jax_on_an_injected_clock(seed):
    rng = np.random.default_rng(seed)
    got_w = metrics.sliding("serve.lat", window_s=12.0, n_sub=4)
    want_w = jmetrics.sliding("serve.lat", window_s=12.0, n_sub=4)
    now = 0.0
    for _ in range(300):
        now += float(rng.exponential(0.2))
        if rng.random() < 0.1:
            got_w.error(now=now)
            want_w.error(now=now)
        else:
            v = float(10.0 ** rng.uniform(-5, 1))
            got_w.observe(v, now=now)
            want_w.observe(v, now=now)
        if rng.random() < 0.2:
            assert got_w.window(now=now) == want_w.window(now=now)
    assert got_w.window(now=now + 100.0) == want_w.window(now=now + 100.0)
    edges = metrics.Histogram.edges
    w = metrics.SlidingHistogram("slo", window_s=60.0, n_sub=12)
    for _ in range(5):
        w.observe(edges[10] * 0.999, now=1.0)
    for _ in range(4):
        w.observe(edges[20] * 0.999, now=2.0)
    w.observe(edges[30] * 0.999, now=3.0)
    snap = w.window(now=3.0)
    assert (snap["count"], snap["p50"], snap["p90"], snap["p99"]) == (
        10, float(f"{edges[10]:.6g}"), float(f"{edges[20]:.6g}"), float(f"{edges[30]:.6g}"))


def test_registry_bounded_and_kind_collision():
    metrics.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        metrics.histogram("x")
    for i in range(metrics._MAX_METRICS + 10):
        metrics.counter(f"n{i}").inc()
    snap = metrics.snapshot()
    assert snap["dropped_names"] == 11
    assert len(snap["counters"]) <= metrics._MAX_METRICS + 3


def _span_sequence(t, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    for k in range(int(rng.integers(3, 7))):
        with t.span("sweep_designs/bucket", attrs={"sig": "16x64x256", "chunk": k}):
            for j in range(int(rng.integers(1, 4))):
                with t.span("pipeline/stage", attrs={"chunk": j}):
                    pass
                with t.span("pipeline/dispatch"):
                    pass
            with t.span("pipeline/fetch"):
                pass
    try:
        with t.span("failing"):
            raise KeyError("x")
    except KeyError:
        pass


@pytest.mark.parametrize("seed", [0, 1])
def test_span_rollup_and_chrome_schema_match_jax(seed):
    _span_sequence(trace, seed)
    _span_sequence(jtrace, seed)
    got, want = trace.rollup(), jtrace.rollup()
    assert {k: v["count"] for k, v in got.items()} == {k: v["count"] for k, v in want.items()}
    assert "sweep_designs/bucket/pipeline/stage" in got and got["failing"]["count"] == 1
    doc, jdoc = trace.chrome_trace(), jtrace.chrome_trace()
    assert set(doc) == set(jdoc) and doc["displayTimeUnit"] == jdoc["displayTimeUnit"]
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    jevs = [e for e in jdoc["traceEvents"] if e["ph"] == "X"]
    assert len(evs) == len(jevs)
    for e, je in zip(evs, jevs):
        assert set(e) == set(je) and set(e["args"]) == set(je["args"])
        assert (e["name"], e["cat"], e["args"]["path"]) == (je["name"], je["cat"],
                                                            je["args"]["path"])
        assert all(isinstance(e[f], int) and e[f] >= 0 for f in ("ts", "dur", "pid", "tid"))
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(meta) == 1 and meta[0]["name"] == "thread_name"
    parents = [e for e in evs if e["args"]["path"] == "sweep_designs/bucket"]
    for c in (e for e in evs if e["args"]["path"] == "sweep_designs/bucket/pipeline/stage"):
        assert any(p["tid"] == c["tid"] and p["ts"] <= c["ts"]
                   and c["ts"] + c["dur"] <= p["ts"] + p["dur"] for p in parents)
    json.dumps(doc)


def test_trace_context_crosses_threads():
    ctx = {}
    with trace.span("request"):
        ctx["tok"] = trace.current_context()

    def worker():
        with trace.context(ctx["tok"]):
            with trace.span("solve"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert trace.rollup()["request/solve"]["count"] == 1
    tid = trace.new_trace_id()
    assert tid.startswith(f"{os.getpid():x}-") and tid != trace.new_trace_id()
    assert trace.synthetic_tid("abc") == jtrace.synthetic_tid("abc")


def test_span_with_jax_trace_opens_a_profiler_range():
    """While a profiler records, every span opens
    ``torch.profiler.record_function`` with its full name, so the range
    shows in a ``torch.profiler`` trace (the ``jax_trace`` keyword that
    once chose which spans did is gone); a span outside the profiler opens
    none."""
    from torch.profiler import ProfilerActivity, profile

    with trace.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("pipeline/dispatch"):
                sum(range(10))
    names = {e.name for e in prof.events()}
    assert {"outer", "outer/pipeline/dispatch"} <= names and "before" not in names
    assert trace.rollup()["outer/pipeline/dispatch"]["count"] == 1


def test_prometheus_text_matches_jax():
    for m in (metrics, jmetrics):
        m.counter("hits").inc(3)
        m.gauge("pipeline.overlap_fraction").set(0.25)
        h = m.histogram("lat_s")
        for v in (1e-4, 1e-4, 0.2, 5e3):
            h.observe(v)
    text = export.prometheus_text()
    assert text == jexport.prometheus_text()
    assert 'raft_tpu_lat_s_bucket{le="+Inf"} 4' in text
    vals = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("raft_tpu_lat_s_bucket")]
    assert vals == sorted(vals)


def test_flight_recorder_matches_jax(tmp_path):
    fr, jfr = FlightRecorder(capacity=4), JFlightRecorder(capacity=4)
    for i in range(7):
        rec = {"id": i, "op": "solve", "outcome": "ok" if i % 3 else "error",
               "stages": {"solve_s": 0.01 * i}}
        fr.record(rec)
        jfr.record(rec)
    assert fr.snapshot() == jfr.snapshot() and fr.counts() == jfr.counts()
    assert fr.counts() == {"capacity": 4, "size": 4, "recorded": 7, "errors": 3}
    p, jp = fr.dump(str(tmp_path / "a.jsonl"), reason="t"), jfr.dump(str(tmp_path / "b.jsonl"),
                                                                     reason="t")
    got, _ = export.read_jsonl(p)
    want, _ = jexport.read_jsonl(jp)
    for g, w in zip(got, want):
        g.pop("pid", None)
        w.pop("pid", None)
    assert got == want
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_flight_dump_lands_in_the_armed_sink(tmp_path, monkeypatch):
    fr = FlightRecorder(capacity=2)
    fr.record({"id": 1})
    monkeypatch.delenv("RAFT_TPU_OBS", raising=False)
    assert fr.dump() is None
    monkeypatch.setenv("RAFT_TPU_OBS", str(tmp_path))
    path = fr.dump(label="serve")
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith(f"flight-serve-p0-{os.getpid()}")


def test_publish_reads_back_and_debounces(tmp_path, monkeypatch):
    with trace.span("phase"):
        metrics.counter("n").inc()
        metrics.histogram("h_s").observe(0.01)
    paths = export.publish("t", directory=str(tmp_path))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    events, corrupt = export.read_jsonl(paths["jsonl"])
    assert corrupt == 0 and events[0]["type"] == "meta" and events[-1]["type"] == "metrics"
    assert [e["name"] for e in events if e["type"] == "span"] == ["phase"]
    with open(paths["chrome_trace"]) as f:
        assert json.load(f)["traceEvents"]
    with open(paths["prom"]) as f:
        assert "raft_tpu_n 1" in f.read()
    monkeypatch.delenv("RAFT_TPU_OBS", raising=False)
    assert export.maybe_publish("x") is None
    with pytest.raises(RuntimeError, match="not armed"):
        export.publish("x")
    monkeypatch.setenv("RAFT_TPU_OBS", str(tmp_path / "sink"))
    monkeypatch.setenv("RAFT_TPU_OBS_FLUSH_MS", "60000")
    export._reset_debounce()
    assert export.maybe_publish("deb") is not None
    assert export.maybe_publish("deb") is None
    assert metrics.snapshot()["counters"]["obs.publish_skipped"] == 1
    assert export.maybe_publish("deb", force=True) is not None
    p = tmp_path / "torn.jsonl"
    p.write_text(json.dumps({"type": "span", "name": "a"}) + "\n" + '{"type": "spa' + "\n")
    assert export.read_jsonl(str(p)) == ([{"type": "span", "name": "a"}], 1)


def test_env_arming_on_roots_under_the_ports_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("RAFT_TPU_OBS", "1")
    assert export.root() == os.path.join(str(tmp_path / "cache"), "obs")
    from raft_tpu_torch.resilience import checkpoint

    monkeypatch.setenv("RAFT_TPU_CKPT", "on")
    assert checkpoint.root() == os.path.join(str(tmp_path / "cache"), "ckpt")


def test_obs_block_reports_kernel_builds(monkeypatch):
    from raft_tpu_torch.cache import aot

    monkeypatch.setattr(aot, "_compile_counts", aot.Counter())
    with trace.span("roll"):
        pass
    metrics.counter("k").inc()
    aot._record_compile("solve6")
    block = export.obs_block()
    assert block["spans"]["roll"]["count"] == 1 and block["counters"]["k"] == 1
    assert block["compiles"] == {"solve6": 1} == aot.compile_counts()
    assert "kernel_builds" not in block
    json.dumps(block)


def test_pipeline_feeds_spans_and_metrics():
    """A CPU pass of ``run_pipelined`` records the JAX package's span and
    metric names, with the chunk count as the call count."""
    import torch

    from raft_tpu_torch.parallel import pipeline

    pipeline.run_pipelined(lambda x: x * 2.0, [torch.tensor(float(k)) for k in range(5)],
                           depth=2, device="cpu")
    roll = trace.rollup()
    for name in ("pipeline/stage", "pipeline/fetch", "pipeline/dispatch"):
        assert roll[name]["count"] == 5
    snap = metrics.snapshot()
    assert snap["counters"]["pipeline.chunks_computed"] == 5
    assert snap["histograms"]["pipeline.fetch_s"]["count"] == 5
    assert "pipeline.overlap_fraction" in snap["gauges"]
