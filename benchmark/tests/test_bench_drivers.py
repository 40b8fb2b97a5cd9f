"""Each driver's whole run on the CPU at a small size (every step of a run
but the look for a card): ``correct`` against the plain reference, the
control's numbers, and ``correct`` false under each fault the cell can
have, planted in the program's entry under the timed path."""
from __future__ import annotations

import io
import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import runner

CELLS = ["oc3_spar.sweep_wide", "volturnus_s.sweep_bem", "volturnus_s.codesign_grad",
         "volturnus_s.bem_hull"]
#: the program's entry each cell's driver calls: (module, function)
ENTRIES = {
    "oc3_spar.sweep_wide": ("raft_tpu_torch.parallel.sweep", "sweep"),
    "volturnus_s.sweep_bem": ("raft_tpu_torch.parallel.sweep", "sweep_north_star"),
    "volturnus_s.codesign_grad": ("raft_tpu_torch.parallel.optimize", "grad_nacelle_accel_std"),
    "volturnus_s.bem_hull": ("raft_tpu_torch.hydro.torch_bem", "solve_bem_any"),
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, root, trace=False):
    out, err = io.StringIO(), io.StringIO()
    res = runner.run(name, 2**31 + 7, 0.2, trace, time.perf_counter(), device="cpu", root=root,
                     out=out, err=err)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == json.loads(json.dumps(res))
    assert list(res)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return res


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_cpu(name, small_root):
    res = run(name, small_root)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_metrics(name, small_root):
    res = run(name, small_root, trace=True)
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["breakdown"]["idle_gaps"]
    assert any(k.startswith("launches_per_call.") for k in res["metrics"])


def _alter(res):
    """One answer altered where it is produced."""
    if isinstance(res, dict):
        key = "std dev" if "std dev" in res else "std"
        res[key][0] = res[key][0] * 1.01
        return res
    if isinstance(res, tuple):
        A = res[0].copy()
        A[..., 0] *= 1.01
        return (A,) + tuple(res[1:])
    res[0] = res[0] * 1.01
    return res


def _half(fn, name):
    """Half of the batch left out: the entry computes the first half of its
    lanes (of its frequencies, for the panel solve) and repeats it."""
    def half(*args, **kw):
        if name == "volturnus_s.sweep_bem":
            lanes = kw["lanes"]
            sub = fn(*args, **{**kw, "lanes": lanes[:len(lanes) // 2]})
            return {k: torch.cat([v, v])[:len(lanes)] if torch.is_tensor(v) else v
                    for k, v in sub.items()}
        if name == "oc3_spar.sweep_wide":
            th = args[5]
            sub = fn(*args[:5], th[:len(th) // 2], *args[6:], **kw)
            return {k: np.concatenate([v, v])[:len(th)] for k, v in sub.items()}
        if name == "volturnus_s.codesign_grad":
            th = args[5]
            g = fn(*args[:5], th[:max(1, len(th) // 2)], *args[6:], **kw)
            return torch.cat([g, g])[:len(th)]
        w = np.asarray(args[1])
        nh = len(w) // 2 + 1
        A, B, F = fn(args[0], w[:nh], *args[2:], **kw)
        idx = np.minimum(np.arange(len(w)), nh - 1)
        return A[..., idx], B[..., idx], F[..., idx]
    return half


def _stale(fn):
    """A call that returns its state unchanged: the previous call's answer."""
    last = []

    def stale(*args, **kw):
        res = fn(*args, **kw) if not last else last[0]
        last[:] = [res]
        return res
    return stale


@pytest.mark.parametrize("fault", ["altered", "half", "stale"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_correct_false(name, fault, small_root, monkeypatch):
    import importlib

    mod_name, fn_name = ENTRIES[name]
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name)
    if fault == "altered":
        monkeypatch.setattr(mod, fn_name, lambda *a, **k: _alter(fn(*a, **k)))
    elif fault == "half":
        monkeypatch.setattr(mod, fn_name, _half(fn, name))
    else:
        monkeypatch.setattr(mod, fn_name, _stale(fn))
    res = run(name, small_root)
    assert res["correct"] is False, res["checks"]


def _late_exit(orig):
    """A stopping rule one step late everywhere: each step's convergence
    test reads the previous step's error (none at a solve's first step)."""
    last = {}

    def late(Xi, Xi_last, tol):
        err = orig(Xi, Xi_last, tol)
        first = bool((Xi_last.re == 0.1).all()) and bool((Xi_last.im == 0).all())
        prev = last.get("err")
        last["err"] = err
        if first or prev is None or prev.shape != err.shape:
            return torch.full_like(err, float("inf"))
        return prev
    return late


@pytest.mark.parametrize("name", ["oc3_spar.sweep_wide", "volturnus_s.sweep_bem"])
def test_late_exit_makes_correct_false(name, small_root, monkeypatch):
    """Every lane stops one step after the reference: each answer is the
    iterate of its own step count, so only the stopping rule's check
    (``iter_edge``) sees it."""
    from raft_tpu_torch.solve import dynamics

    monkeypatch.setattr(dynamics, "_error", _late_exit(dynamics._error))
    res = run(name, small_root)
    assert res["correct"] is False
    assert res["checks"]["iter_edge"]["value"] > res["checks"]["iter_edge"]["limit"]
    assert res["checks"]["std_gap"]["value"] <= res["checks"]["std_gap"]["limit"]


def test_iter_edge_reads_the_reference_at_the_boundary():
    from benchmark.harness.driver import exit_fault, iter_edge

    # (n_iter 4, 3 lanes); tolerance 0.01: lane 0 stops at 2, lane 1 at 3,
    # lane 2 never
    err = np.array([[0.5, 0.5, 0.5], [0.0099, 0.02, 0.5], [0.001, 0.005, 0.5],
                    [0.0, 0.0, 0.5]])
    ref_it, conv = np.array([2, 3, 4]), np.array([True, True, False])
    assert iter_edge(ref_it, ref_it, err) == (0, 0.0)
    n, d = iter_edge(np.array([3, 3, 4]), ref_it, err)     # lane 0 a step late
    assert n == 1 and d == pytest.approx(0.01)
    n, d = iter_edge(np.array([2, 2, 4]), ref_it, err)     # lane 1 a step early
    assert n == 1 and d == pytest.approx(1.0)
    f = exit_fault(ref_it, conv, err)
    assert f["late"] == pytest.approx(0.5) and f["early"] == pytest.approx(49.0)


def test_control_reads_the_same_numbers(small_root):
    from benchmark import control

    res = control.readings("oc3_spar.sweep_wide", [3, 4], [3], 2, device="cpu",
                           root=small_root)
    assert set(res["lower"]) == set(res["upper"]) == {"std_gap", "iter_far", "iter_edge"}
    assert {"lanes_off", "fault_late", "fault_early"} <= set(res["detail"]["3"]["control"])
    assert res["upper"]["std_gap"] > res["lower"]["std_gap"]
