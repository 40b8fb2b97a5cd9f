"""The port's evidence runner (``raft_tpu_torch.evidence``) with its step
runner stubbed: the steps in the JAX runner's order with the SPMD smoke in
place of the multichip dry run and the three smokes after it,
``--device cpu`` passed to every step but the tests, the last JSON line
lifted (and the lint's ``audit`` and ``glNxx`` blocks one key deeper), the
bench entry marked absent and outside ``all_green``, and the JSON written
outside the repository's seed files.  ``run_step`` itself: a timeout is
rc 124 and kills the step."""
import json
import sys
import time

import pytest

from raft_tpu_torch import evidence

ORDER = ["tests_fast", "lint", "serve_smoke", "fleet_smoke", "spmd_smoke", "hetero_smoke",
         "bem_smoke", "obs_smoke"]


def _stub(monkeypatch, fail=()):
    calls = []

    def run_step(cmd, timeout, label, env=None):
        calls.append((label, list(cmd), timeout, env))
        js = {"ok": label not in fail, "step": label}
        if label == "lint":
            js.update(audit={"entries": [], "failed": 0}, gl3xx={"ok": True},
                      gl4xx={"ok": True}, static={"new": 0})
        rc = 1 if label in fail else 0
        return {"ok": rc == 0, "rc": rc, "elapsed_s": 0.5, "tail": ["x"],
                "stdout_tail": ["progress line", json.dumps(js)]}

    monkeypatch.setattr(evidence, "run_step", run_step)
    return calls


def test_steps_in_order_with_the_device_passed(monkeypatch, tmp_path):
    monkeypatch.delenv("RAFT_EVIDENCE_SKIP_TESTS", raising=False)
    calls = _stub(monkeypatch)
    out = tmp_path / "ev.json"
    assert evidence.main(["--device", "cpu", "--out", str(out)]) == 0
    assert [c[0] for c in calls] == ORDER
    by = {c[0]: c for c in calls}
    for label in ORDER[1:]:
        assert by[label][1][-2:] == ["--device", "cpu"], label
    assert "--device" not in by["tests_fast"][1]
    assert by["tests_fast"][3]["JAX_PLATFORMS"] == "cpu"
    assert by["spmd_smoke"][1][2] == "raft_tpu_torch.parallel.spmd_smoke"
    assert by["hetero_smoke"][1][2:4] == ["raft_tpu_torch.build.smoke", "--device"]
    assert by["obs_smoke"][1][2] == "raft_tpu_torch.obs"
    doc = json.loads(out.read_text())
    assert doc["all_green"] is True
    assert doc["bench"] == {"absent": "waits for the port's benchmark PR"}
    for label in ORDER:
        assert doc[label]["json"]["step"] == label and doc[label]["stdout_tail"]
    assert doc["lint"]["audit"] == {"entries": [], "failed": 0}
    assert doc["lint"]["gl3xx"] == doc["lint"]["gl4xx"] == {"ok": True}
    assert "static" not in doc["lint"]


def test_timeouts_skip_and_all_green(monkeypatch, tmp_path):
    monkeypatch.setenv("RAFT_EVIDENCE_SKIP_TESTS", "1")
    monkeypatch.setenv("RAFT_EVIDENCE_LINT_TIMEOUT", "7")
    monkeypatch.setenv("RAFT_EVIDENCE_DRYRUN_TIMEOUT", "9")
    calls = _stub(monkeypatch, fail=("bem_smoke",))
    doc = evidence.collect("cpu")
    assert [c[0] for c in calls] == ORDER[1:]
    assert {c[0]: c[2] for c in calls}["lint"] == 7.0
    assert {c[0]: c[2] for c in calls}["spmd_smoke"] == 9.0
    assert doc["all_green"] is False and doc["bem_smoke"]["rc"] == 1
    # on one card the SPMD smoke runs a world of one
    calls.clear()
    evidence.collect(None, n_cards=1)
    spmd = [c[1] for c in calls if c[0] == "spmd_smoke"][0]
    assert spmd[-2:] == ["--world", "1"] and "--device" not in spmd


def test_default_output_is_outside_the_seed_files():
    out = evidence.DEFAULT_OUT.resolve()
    assert out.name == "evidence.json"
    assert out.parent == (evidence.REPO / "raft_tpu_torch" / "_build").resolve()
    assert out != (evidence.REPO / "EVIDENCE.json").resolve()
    with open(evidence.REPO / ".gitignore") as f:
        assert "raft_tpu_torch/_build/" in f.read().split()


def test_run_step_times_out_as_rc_124_and_lifts_json():
    t0 = time.perf_counter()
    r = evidence.run_step([sys.executable, "-c", "import time; print('a', flush=True); "
                           "time.sleep(60)"], 2.0, "sleeper")
    assert r["rc"] == 124 and r["ok"] is False and time.perf_counter() - t0 < 30
    assert r["stdout_tail"] == ["a"]
    r = evidence.run_step([sys.executable, "-c", "import json, sys; print('x'); "
                           "print(json.dumps({'v': 1})); print('err', file=sys.stderr)"],
                          60.0, "json")
    assert r["ok"] and r["rc"] == 0 and evidence.last_json(r["stdout_tail"]) == {"v": 1}
    assert r["tail"][-1] == "err"
    with pytest.raises(RuntimeError, match="(?s)rc=1.*No module named"):
        evidence.run_child("raft_tpu_torch.no_such_module", [], 60.0, "missing")
