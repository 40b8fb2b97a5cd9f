"""The port's runtime audit (``raft_tpu_torch.lint.audit``): every
registered entry at float32 on the CPU against the committed ``"cpu"``
budgets, each detector against a planted fault, the budget rules, and the
sharded check on ``cpu_world(2)``."""
import json
import os
import subprocess
import sys

import pytest
import torch

from raft_tpu_torch.lint import audit, registry
from raft_tpu_torch.lint.registry import EntryPoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


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


def test_cli_audit_on_cpu_within_committed_budgets():
    """``python -m raft_tpu_torch.lint --audit-only --device cpu`` (the
    sharded check included) exits 0 with every entry within budget."""
    # one intra-op thread: the entries are small, and the test shares the
    # host's cores with other test processes
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.lint", "--audit-only", "--device", "cpu",
         "--json"], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    entries = {e["name"]: e for e in summary["audit"]["entries"]}
    assert set(entries) == {e.name for e in registry.ENTRY_POINTS}
    for name, e in entries.items():
        assert e["ok"] and e["budget_ok"] and e["f64_ops"] == 0 and e["rebuilds"] == 0, e
        assert e["platform"] == "cpu" and e["peak_bytes"] is None
    assert entries["freq_sharded_forward"]["host_syncs"] == registry._N_ITER + 1
    for e in registry.ENTRY_POINTS:
        m = entries[e.name]["metrics"]
        assert ("sharded_rank_bytes" in m) == e.sharded
        if e.sharded:
            assert audit.check_sharded(e.name, m)[0]
    # each of the two ranks stages half of the north star's lanes
    m = entries["north_star_sweep"]["metrics"]
    assert 2 * m["sharded_rank_bytes"] == m["unsharded_bytes"]


def test_audit_without_cuda_refuses_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        audit.run_audit(["eigen"])
    proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.lint", "--audit-only"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


def _entry(fn, args, args2=None, name="planted"):
    return EntryPoint(name, "tests.planted", lambda device, dtype: (fn, args, args2 or args))


def test_clean_entry_reports_nothing():
    x = torch.ones(4)
    r = audit.audit_entry(_entry(lambda t: (t * 2).sum(), (x,)), CPU)
    assert r.ok and r.host_syncs == 0 and r.f64_ops == 0 and r.rebuilds == 0
    assert r.ops == 2 and r.launches == {} and r.peak_bytes is None


def test_detects_a_planted_item():
    r = audit.audit_entry(_entry(lambda t: t * t.sum().item(), (torch.ones(4),)), CPU)
    assert r.host_syncs == 1 and r.sync_examples == ["_local_scalar_dense"]
    r = audit.audit_entry(_entry(lambda t: t[t > 0], (torch.ones(4),)), CPU)
    assert r.host_syncs == 1 and r.sync_examples == ["index with a boolean mask"]


def test_detects_a_planted_float64_op():
    r = audit.audit_entry(_entry(lambda t: t.double().sum(), (torch.ones(4),)), CPU)
    assert not r.ok and r.f64_ops == 2 and r.f64_examples
    r = audit.audit_entry(_entry(
        lambda t: t + torch.zeros(4, dtype=torch.float64).float(), (torch.ones(4),)), CPU)
    assert not r.ok and r.f64_ops == 1


def test_detects_a_planted_rebuild():
    from raft_tpu_torch.cache import aot, stats

    def rebuilds(t):
        aot._record_compile("planted")
        return t + 1

    def misses(t):
        stats.record("staging", "miss", category="planted")
        return t + 1

    for fn in (rebuilds, misses):
        r = audit.audit_entry(_entry(fn, (torch.ones(2),)), CPU)
        assert not r.ok and r.rebuilds == 1


def test_second_call_uses_args2():
    seen = []
    r = audit.audit_entry(_entry(lambda t: seen.append(float(t[0])) or t, (torch.zeros(1),),
                                 (torch.ones(1),)), CPU)
    assert seen == [0.0, 1.0] and r.host_syncs == 1


def _budgets(metrics, tol=0.25):
    return {"tolerance": tol, "platforms": {"cpu": {"e": dict(metrics)}}}


def test_real_entry_against_perturbed_and_missing_budgets(tmp_path):
    data = audit.load_budgets()
    path = str(tmp_path / "budgets.json")
    ops = data["platforms"]["cpu"]["fused_rao_solve"]["ops"]
    data["platforms"]["cpu"]["fused_rao_solve"]["ops"] = ops // 2
    with open(path, "w") as f:
        json.dump(data, f)
    (r,) = audit.run_audit(["fused_rao_solve"], device="cpu", budgets_path=path)
    assert not r.ok and not r.budget_ok and r.ops == ops
    assert any(n.startswith(f"ops: {ops} exceeds budget {ops // 2}") for n in r.budget_notes)
    del data["platforms"]["cpu"]["fused_rao_solve"]
    with open(path, "w") as f:
        json.dump(data, f)
    (r,) = audit.run_audit(["fused_rao_solve"], device="cpu", budgets_path=path)
    assert not r.ok and "no committed budget" in r.budget_notes[0]
    (r,) = audit.run_audit(["fused_rao_solve"], device="cpu")
    assert r.ok and r.budget_ok


def test_budget_within_tolerance_passes():
    b = _budgets({"ops": 100, "host_syncs": 4, "f64_ops": 0})
    ok, notes = audit.check_budget("e", {"ops": 120, "host_syncs": 5, "f64_ops": 0}, b, "cpu")
    assert ok and notes == []


def test_budget_fails_on_perturbed_budget():
    m = {"ops": 100, "host_syncs": 4, "f64_ops": 0}
    ok, notes = audit.check_budget("e", m, _budgets({**m, "ops": 70}), "cpu")
    assert not ok and any("ops: 100 exceeds budget 70" in n for n in notes)
    ok, notes = audit.check_budget("e", {**m, "f64_ops": 1}, _budgets(m), "cpu")
    assert not ok and any("from zero" in n for n in notes)


def test_budget_fails_on_missing_budget_and_metric():
    m = {"ops": 100}
    ok, notes = audit.check_budget("other", m, _budgets(m), "cpu")
    assert not ok and "no committed budget" in notes[0]
    ok, notes = audit.check_budget("e", m, _budgets(m), "cuda")
    assert not ok and "no committed budget" in notes[0]
    ok, notes = audit.check_budget("e", m, _budgets({"ops": 100, "peak_bytes": 10}), "cpu")
    assert not ok and "not measured" in notes[0]


def test_budget_improvement_is_a_note():
    ok, notes = audit.check_budget("e", {"ops": 50}, _budgets({"ops": 100}), "cpu")
    assert ok and notes and notes[0].startswith("note:")


def test_save_budgets_keeps_other_platforms_and_annotations(tmp_path):
    path = str(tmp_path / "budgets.json")
    with open(path, "w") as f:
        json.dump({"tolerance": 0.25, "platforms": {
            "cuda": {"e": {"ops": 1}},
            "cpu": {"e": {"ops": 5, "_host_syncs_reason": "kept"}}}}, f)
    r = audit.audit_entry(_entry(lambda t: t + 1, (torch.ones(2),), name="e"), CPU)
    r.metrics = audit.report_metrics(r)
    audit.save_budgets([r], path)
    data = json.load(open(path))
    assert data["platforms"]["cuda"] == {"e": {"ops": 1}}
    assert data["platforms"]["cpu"]["e"] == {"ops": 1, "f64_ops": 0, "host_syncs": 0,
                                             "rebuilds": 0, "_host_syncs_reason": "kept"}


def test_committed_budgets_cover_every_entry_on_both_platforms():
    data = audit.load_budgets()
    assert data["tolerance"] == audit.DEFAULT_TOLERANCE == 0.25
    names = {e.name for e in registry.ENTRY_POINTS}
    for plat in ("cpu", "cuda"):
        section = data["platforms"][plat]
        assert set(section) == names, plat
        for name, b in section.items():
            assert b["f64_ops"] == 0 and b["rebuilds"] == 0, (plat, name)
            if b["host_syncs"]:
                assert b.get("_host_syncs_reason"), (plat, name)
    assert "H100" in data["_cards"]["cuda"] and " W" in data["_cards"]["cuda"]
    for name, b in data["platforms"]["cuda"].items():
        assert b["host_syncs"] == data["platforms"]["cpu"][name]["host_syncs"], name
        assert b["peak_bytes"] > 0
    launched = data["platforms"]["cuda"]
    assert launched["fused_rao_solve"]["launches_k1_fused"] == 1
    assert launched["torch_bem_kernels"]["launches_bem_rankine"] >= 1
    assert launched["torch_bem_kernels"]["launches_bem_wave"] >= 1


def test_sharded_check_bound():
    assert audit.check_sharded("e", {"sharded_rank_bytes": 60, "unsharded_bytes": 100})[0]
    ok, notes = audit.check_sharded("e", {"sharded_rank_bytes": 100, "unsharded_bytes": 100})
    assert not ok and "the whole batch" in notes[0]
    assert not audit.check_sharded("e", {})[0]


class _Mesh:
    """The part of a 1-D ``DeviceMesh`` that the lane staging reads: one
    rank of ``size``."""

    ndim = 1
    mesh_dim_names = ("world",)

    def __init__(self, rank, size=2):
        self.rank, self._size = rank, size

    def size(self, dim=0):
        return self._size

    def get_local_rank(self, dim):
        return self.rank


SHARDED = [e.name for e in registry.ENTRY_POINTS if e.sharded]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_stage_gives_each_rank_its_half(name):
    """Each sharded entry's API staging gives each of two ranks a block
    within the sharded bound, and the two blocks together hold the whole."""
    (e,) = registry.get_entries([name])
    blocks = [audit.stage_bytes(e, _Mesh(r)) for r in (0, 1)]
    for rank_bytes, whole in blocks:
        assert audit.check_sharded(name, {"sharded_rank_bytes": rank_bytes,
                                          "unsharded_bytes": whole})[0]
    assert blocks[0][0] + blocks[1][0] >= blocks[0][1]


@pytest.mark.parametrize("name,helper", [("north_star_sweep", "_stage_variants_global"),
                                         ("dlc_solve", "_stage_cases_global"),
                                         ("sweep_designs", "_stage_bucket_global")])
def test_sharded_check_catches_an_api_that_replicates(monkeypatch, name, helper):
    """Were the API's own staging to hand every rank the whole batch, the
    sharded check fails."""
    import importlib

    sweep = importlib.import_module("raft_tpu_torch.parallel.sweep")
    whole = {"_stage_variants_global": lambda th, mesh: th,
             "_stage_cases_global": lambda waves, F_re, F_im, per_case, mesh: (waves, F_re, F_im),
             "_stage_bucket_global": lambda args, mesh: args}[helper]
    monkeypatch.setattr(sweep, helper, whole)
    (e,) = registry.get_entries([name])
    rank_bytes, total = audit.stage_bytes(e, _Mesh(0))
    ok, notes = audit.check_sharded(name, {"sharded_rank_bytes": rank_bytes,
                                           "unsharded_bytes": total})
    assert not ok and rank_bytes == total and "the whole batch" in notes[0]


