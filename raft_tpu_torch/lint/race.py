"""Deterministic race scenarios for the port's shared state (the port's
counterpart of ``raft_tpu.lint.race``).

The GL3xx rules (:mod:`raft_tpu_torch.lint.rules`) check the locking
discipline; these scenarios check that the locks work: ``THREADS``
threads hammer each surface the serving daemon shares, with
``sys.setswitchinterval(SWITCH_INTERVAL)`` so the interpreter may switch
threads every few bytecodes, and every assertion is exact:

* **kernel-library single flight** (``cache/aot.py::library``): threads
  asking for one library get one handle from one build or one load (the
  g++ native-BEM library, which builds on the CPU too); pairs of threads on
  distinct libraries build each exactly once;
* **cache counters** (``cache/stats.py``, ``aot._record_compile``): writer
  threads record events while a resetter clears them; no torn window, and
  an uncontended phase counts exactly;
* **metrics and spans** (``obs/metrics.py``, ``obs/trace.py``): exact
  counter, histogram and span roll-up totals under a concurrent snapshot
  reader whose exports always parse;
* **the chunk store** (``resilience/checkpoint.py``): writers checkpoint
  disjoint chunks into one store; the manifest ends complete and every
  chunk resumes clean in a fresh store;
* **fault counters** (``resilience/faults.py``): each counted fault fires
  exactly its budget across threads;
* **the serving micro-batcher** (``serve/batcher.py``): submitters race a
  drainer and a ``close()``; every accepted lane drains exactly once, in
  order, within capacity.

``python -m raft_tpu_torch.lint.race`` prints one JSON line and exits 0
when every check holds, 1 otherwise.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

#: thread switch interval of the hammer phases (the default is 5 ms)
SWITCH_INTERVAL = 1e-6

THREADS = 8


def _run_threads(n: int, target) -> list:
    """``n`` threads on ``target(i)`` behind one barrier; returns the
    raised exceptions as strings."""
    barrier = threading.Barrier(n)
    errors: list = []

    def wrap(i):
        try:
            barrier.wait(timeout=30)
            target(i)
        except Exception as e:      # reported, not masked
            errors.append(f"thread {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    errors.extend(f"thread {t.name} did not join" for t in threads if t.is_alive())
    return errors


def _check(out: dict, name: str, cond: bool, detail: str) -> None:
    out.setdefault("checks", {})[name] = bool(cond)
    if not cond:
        out.setdefault("failures", []).append(f"{name}: {detail}")


class _ToyLibrary:
    """A library of the registry's interface whose build is a Python child
    writing an empty file (no compiler needed)."""

    retries = 1

    def __init__(self, tag: str, root: str):
        self.tag, self.root = tag, root

    def key(self) -> str:
        return "k0"

    def path(self, key: str | None = None) -> str:
        return os.path.join(self.root, f"lib{self.tag}-{key or 'k0'}.so")

    def job(self, path):
        from pathlib import Path

        from raft_tpu_torch.core import nvcc

        return nvcc.Job(self.tag, (sys.executable, "-c",
                                   "import sys; open(sys.argv[-1], 'wb').close()"), Path(path))

    def open(self, path):
        return ("toy", self.tag, str(path))


def scenario_library_single_flight(tmp: str) -> dict:
    """Same library from every thread, and distinct libraries in pairs."""
    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.hydro import native_bem

    out: dict = {}
    lib = native_bem._Library()
    aot.evict_memory(lib.tag)
    builds0 = aot.compile_count(lib.tag)
    opens0 = aot.open_counts().get(lib.tag, 0)
    results: list = [None] * THREADS
    errors = _run_threads(THREADS, lambda i: results.__setitem__(i, aot.library(lib)))
    builds = aot.compile_count(lib.tag) - builds0
    opens = aot.open_counts().get(lib.tag, 0) - opens0
    _check(out, "same_library_no_errors", not errors, "; ".join(errors))
    _check(out, "same_library_one_load", opens == 1 and builds <= 1,
           f"opens {opens}, builds {builds} (want 1 open and at most 1 build)")
    _check(out, "same_library_one_handle", len({id(r) for r in results}) == 1,
           "threads received different handles")
    out["native_builds"] = builds

    n_libs = THREADS // 2
    libs = [_ToyLibrary(f"race_toy{k}", tmp) for k in range(n_libs)]
    for t in libs:
        aot.evict_memory(t.tag)
    before = {t.tag: aot.compile_count(t.tag) for t in libs}
    handles: list = [None] * THREADS
    errors = _run_threads(THREADS, lambda i: handles.__setitem__(
        i, aot.library(libs[i % n_libs])))
    per_lib = {t.tag: aot.compile_count(t.tag) - before[t.tag] for t in libs}
    _check(out, "distinct_libraries_no_errors", not errors, "; ".join(errors))
    _check(out, "distinct_libraries_one_build_each", all(v == 1 for v in per_lib.values()),
           f"builds per library {per_lib} (want all 1)")
    _check(out, "distinct_libraries_paired_handles",
           all(handles[i] is handles[i + n_libs] for i in range(n_libs)),
           "the two threads of a library received different handles")
    for t in libs:
        aot.evict_memory(t.tag)
    return out


def scenario_cache_counters() -> dict:
    """``cache/stats.py`` and the compile-event ring under concurrent
    record and reset."""
    from raft_tpu_torch.cache import aot, stats

    out: dict = {}
    stats.reset()
    aot.reset_compile_events()
    writers, per_writer = 4, 2000
    stop = threading.Event()
    torn: list = []

    def resetter():
        while not stop.is_set():
            aot.reset_compile_events()
            stats.reset()
            # the only resetter: a count read after the ring can never be
            # smaller, since each event enters both under one lock
            n_ring = len(aot.compile_events("race_evt"))
            c = aot.compile_count("race_evt")
            if c < n_ring:
                torn.append(f"count {c} < ring {n_ring}")
            # a record updates its layer and its category under one lock
            rep = stats.report()
            parts = sum(rep.get(f"race/t{k}", {}).get("misses", 0) for k in (0, 1))
            if rep.get("race", {}).get("misses", 0) != parts:
                torn.append(f"stats torn: {rep.get('race')} vs categories {parts}")

    def write(i):
        for _ in range(per_writer):
            aot._record_compile("race_evt")
            stats.record("race", "miss", saved_s=0.5, category=f"t{i % 2}")

    rt = threading.Thread(target=resetter)
    rt.start()
    errors = _run_threads(writers, write)
    stop.set()
    rt.join(timeout=30)
    _check(out, "reset_phase_no_errors", not errors and not torn, "; ".join(errors + torn))
    aot.reset_compile_events()
    stats.reset()
    _check(out, "reset_zeroes", aot.compile_count() == 0 and aot.compile_events() == []
           and "race" not in stats.report(), "reset left residue")

    errors = _run_threads(writers, write)
    want = writers * per_writer
    rep = stats.report()
    total = aot.compile_count("race_evt")
    _check(out, "exact_counts", not errors and total == want
           and rep["race"]["misses"] == want
           and rep["race/t0"]["misses"] + rep["race/t1"]["misses"] == want
           and abs(rep["race"]["saved_s"] - 0.5 * want) < 1e-6,
           f"compiles {total}, stats {rep.get('race')} vs {want}; {errors}")
    out["recorded"] = total
    aot.reset_compile_events()
    stats.reset()
    return out


def scenario_metrics_and_spans() -> dict:
    """Exact counters, histograms and span roll-ups; exports that parse."""
    from raft_tpu_torch.obs import metrics, trace

    out: dict = {}
    metrics.reset()
    trace.reset()
    per_thread = 1500
    stop = threading.Event()
    corrupt: list = []

    def sampler():
        while not stop.is_set():
            try:
                snap = metrics.snapshot()
                json.dumps(snap)
                for h in snap.get("histograms", {}).values():
                    if sum(n for _, n in h["buckets"]) != h["count"]:
                        corrupt.append("histogram bucket sum != count")
                json.dumps(trace.chrome_trace())
            except Exception as e:  # reported, not masked
                corrupt.append(f"{type(e).__name__}: {e}")

    st = threading.Thread(target=sampler)
    st.start()

    def worker(i):
        c = metrics.counter("race.events")
        h = metrics.histogram("race.latency_s")
        for j in range(per_thread):
            c.inc()
            h.observe(1e-4 * ((i + j) % 7 + 1))
            with trace.span("race/outer"):
                with trace.span("inner"):
                    pass

    errors = _run_threads(THREADS, worker)
    stop.set()
    st.join(timeout=30)
    want = THREADS * per_thread
    _check(out, "no_errors", not errors and not corrupt, "; ".join(errors + corrupt))
    _check(out, "counter_exact", metrics.counter("race.events").value == want,
           f"counter {metrics.counter('race.events').value} != {want}")
    h = metrics.histogram("race.latency_s")
    _check(out, "histogram_exact", h.total == want and sum(h.counts) == want,
           f"total {h.total} / bucket sum {sum(h.counts)} != {want}")
    roll = trace.rollup()
    _check(out, "span_rollup_exact",
           roll.get("race/outer", {}).get("count") == want
           and roll.get("race/outer/inner", {}).get("count") == want,
           f"rollup counts {roll.get('race/outer')} / {roll.get('race/outer/inner')} != {want}")
    out["observed"] = want
    metrics.reset()
    trace.reset()
    return out


def scenario_chunkstore(tmp: str) -> dict:
    """Concurrent writers into one store: complete manifest, clean resume."""
    import numpy as np

    from raft_tpu_torch.resilience.checkpoint import ChunkStore

    out: dict = {}
    n_chunks, writers = 48, 4
    store = ChunkStore("race_store", n_chunks, tmp)

    def writer(t):
        for k in range(t, n_chunks, writers):
            store.save(k, (np.full(16, k, dtype=np.float32), np.arange(k + 1)))

    errors = _run_threads(writers, writer)
    _check(out, "no_errors", not errors, "; ".join(errors))
    _check(out, "all_saved", store.saved == n_chunks, f"saved {store.saved} != {n_chunks}")
    _check(out, "manifest_complete", store.complete(),
           "the manifest lost entries under concurrent saves")
    resume = ChunkStore("race_store", n_chunks, tmp)
    loaded = [resume.load(k) for k in range(n_chunks)]
    _check(out, "resume_all", all(r is not None for r in loaded),
           f"{sum(r is None for r in loaded)} chunks missing on resume")
    _check(out, "zero_corrupt", resume.corrupt == 0, f"{resume.corrupt} corrupt chunks")
    _check(out, "values_roundtrip",
           all(r is not None and float(r[0][0]) == float(k) for k, r in enumerate(loaded)),
           "resumed values diverged")
    out["stats"] = resume.to_dict()
    return out


def scenario_fault_counters() -> dict:
    """Every counted fault kind fires exactly its budget across threads."""
    from raft_tpu_torch.resilience import faults

    out: dict = {}
    budgets = {"hang_subprocess": 5, "kill_replica": 3, "stall_replica": 4,
               "refuse_connect": 2}
    old = os.environ.get("RAFT_TPU_FAULT_INJECT")
    os.environ["RAFT_TPU_FAULT_INJECT"] = ",".join(f"{n}:{k}" for n, k in budgets.items())
    faults.reset_counts()
    fires = [{name: 0 for name in budgets} for _ in range(THREADS)]

    def worker(i):
        for _ in range(200):
            for name in budgets:
                if faults.consume(name):
                    fires[i][name] += 1

    try:
        errors = _run_threads(THREADS, worker)
    finally:
        if old is None:
            os.environ.pop("RAFT_TPU_FAULT_INJECT", None)
        else:
            os.environ["RAFT_TPU_FAULT_INJECT"] = old
        faults.reset_counts()
    _check(out, "no_errors", not errors, "; ".join(errors))
    totals = {name: sum(f[name] for f in fires) for name in budgets}
    for name, k in budgets.items():
        _check(out, f"exact_fires_{name}", totals[name] == k, f"{totals[name]} fires != {k}")
    out["fires"] = totals
    return out


def scenario_microbatcher() -> dict:
    """Concurrent submit, drain and close on the serving queue."""
    from raft_tpu_torch.build.buckets import BucketSig
    from raft_tpu_torch.serve.batcher import Lane, MicroBatcher

    out: dict = {}
    sigs = (BucketSig(16, 64, 32), BucketSig(48, 128, 32))
    cap = 4
    per_thread = 150
    # deadline 0: every non-empty bucket may close at once, so the drainer
    # and the submitters race the pop/append boundary
    mb = MicroBatcher(batch_deadline_s=0.0, batch_max=cap)
    accepted: list = [0] * THREADS
    batches: list = []
    drained = threading.Event()

    def drain():
        while True:
            item = mb.next_batch()
            if item is None:
                drained.set()
                return
            batches.append(item)

    drainer = threading.Thread(target=drain, name="race-drain", daemon=True)
    drainer.start()

    def submit(i):
        n = 0
        for j in range(per_thread):
            try:
                mb.submit(sigs[j % 2], Lane(request_id=(i, j), seq=0, label="x", staged=None))
                n += 1
            except RuntimeError:
                break           # intake closed underneath us: accounted
        accepted[i] = n

    closer = threading.Timer(0.05, mb.close)
    closer.start()
    errors = _run_threads(THREADS, submit)
    closer.join()
    mb.close()
    ok_drained = drained.wait(30)
    drainer.join(10)

    ids = [ln.request_id for _sig, lns in batches for ln in lns]
    _check(out, "no_errors", not errors, "; ".join(errors))
    _check(out, "drained", ok_drained, "the drain loop did not finish")
    _check(out, "every_accepted_lane_drained_once",
           sorted(ids) == sorted(set(ids)) and len(ids) == sum(accepted),
           f"{len(ids)} drained vs {sum(accepted)} accepted "
           f"({len(ids) - len(set(ids))} duplicates)")
    _check(out, "capacity_respected", all(len(lns) <= cap for _s, lns in batches),
           f"max batch {max((len(x) for _s, x in batches), default=0)} > cap {cap}")
    fifo_ok = True
    for _sig, lns in batches:
        last: dict = {}
        for ln in lns:
            src, j = ln.request_id
            fifo_ok = fifo_ok and last.get(src, -1) < j
            last[src] = j
    _check(out, "per_submitter_fifo_within_batch", fifo_ok,
           "a batch reordered one submitter's lanes")
    counters = mb.counters()
    _check(out, "counters_exact",
           counters["submitted"] == sum(accepted) and counters["popped"] == len(ids)
           and counters["pending"] == 0,
           f"batcher counters {counters} vs accepted {sum(accepted)}")
    out["accepted"] = sum(accepted)
    out["batches"] = len(batches)
    return out


def run() -> dict:
    """Every scenario under the tiny switch interval; the report with
    ``ok`` and the failures."""
    t0 = time.perf_counter()
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(SWITCH_INTERVAL)
    report: dict = {"tool": "race-smoke", "package": "raft_tpu_torch", "threads": THREADS,
                    "switch_interval": SWITCH_INTERVAL}
    try:
        with tempfile.TemporaryDirectory(prefix="raft_torch_race_") as tmp:
            report["library_single_flight"] = scenario_library_single_flight(
                os.path.join(tmp, "libs"))
            report["cache_counters"] = scenario_cache_counters()
            report["metrics_spans"] = scenario_metrics_and_spans()
            report["chunkstore"] = scenario_chunkstore(os.path.join(tmp, "ckpt"))
            report["fault_counters"] = scenario_fault_counters()
            report["serve_microbatcher"] = scenario_microbatcher()
    finally:
        sys.setswitchinterval(old_interval)
    failures = [f for s in report.values() if isinstance(s, dict)
                for f in s.get("failures", ())]
    report["elapsed_s"] = round(time.perf_counter() - t0, 2)
    report["ok"] = not failures
    if failures:
        report["failures"] = failures
    return report


def main(argv=None) -> int:
    report = run()
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
