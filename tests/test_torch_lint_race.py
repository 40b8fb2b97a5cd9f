"""The port's race scenarios (``raft_tpu_torch.lint.race``): each passes
under 8 threads and a 1 us switch interval, and the command prints one JSON
line and exits 0; the counters the lint's GL301 findings put under a lock
count exactly under threads."""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from raft_tpu_torch.lint import race

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def own_counters(monkeypatch):
    """Fresh build, open and cache counters for each test, so what a test
    records never reaches another test's process-wide counts (the serving
    tests hold a daemon's builds to 0)."""
    from collections import Counter, defaultdict, deque

    from raft_tpu_torch.cache import aot, stats

    monkeypatch.setattr(aot, "_compile_counts", Counter())
    monkeypatch.setattr(aot, "_open_counts", Counter())
    monkeypatch.setattr(aot, "_compile_events", deque(maxlen=aot._COMPILE_EVENTS_MAX))
    monkeypatch.setattr(stats, "_layers", defaultdict(stats._zero))


@pytest.fixture
def switchy():
    old = sys.getswitchinterval()
    sys.setswitchinterval(race.SWITCH_INTERVAL)
    yield
    sys.setswitchinterval(old)


def _assert_passed(out):
    assert out["checks"] and all(out["checks"].values()), out.get("failures")


def test_library_single_flight(switchy, tmp_path):
    _assert_passed(race.scenario_library_single_flight(str(tmp_path)))


def test_cache_counters(switchy):
    _assert_passed(race.scenario_cache_counters())


def test_metrics_and_spans(switchy):
    _assert_passed(race.scenario_metrics_and_spans())


def test_chunkstore(switchy, tmp_path):
    _assert_passed(race.scenario_chunkstore(str(tmp_path)))


def test_fault_counters(switchy):
    _assert_passed(race.scenario_fault_counters())


def test_microbatcher(switchy):
    _assert_passed(race.scenario_microbatcher())


def test_race_command_prints_one_json_line():
    proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.lint.race"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    report = json.loads(lines[-1])
    assert len(lines) == 1 and report["ok"] and report["threads"] == 8
    assert {"library_single_flight", "cache_counters", "metrics_spans", "chunkstore",
            "fault_counters", "serve_microbatcher"} <= set(report)


def test_result_cache_counts_exact_under_threads(switchy, tmp_path):
    """``native_bem.CACHE_STATS`` (locked since the lint's GL301 finding)
    counts every miss and hit of concurrent loads."""
    from raft_tpu_torch.hydro import native_bem

    hit = tmp_path / "hit.npz"
    np.savez(hit, A=np.zeros(2))
    before = dict(native_bem.CACHE_STATS)
    per = 300

    def work(i):
        for _ in range(per):
            native_bem.result_cache_load(tmp_path / "absent.npz", ("A",))
            native_bem.result_cache_load(hit, ("A",))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(race.THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    got = {k: native_bem.CACHE_STATS[k] - before[k] for k in before}
    assert got == {"hit": race.THREADS * per, "miss": race.THREADS * per, "corrupt": 0}

