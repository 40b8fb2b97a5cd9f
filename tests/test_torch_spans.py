"""The port's spans inside the solve path, on the profiler's clock, on the
CPU.

While a ``torch.profiler`` records, every ``obs.trace.span`` is also a
``user_annotation`` range under its full nested path: a small OC3 strip
solve with either loop holds ``forward`` (``statics``, ``strip``,
``dynamics`` with its ``step``s, their ``drag`` and ``solve``, the drag
coefficients' build and the final ``drag``, and in the ``while`` loop one ``exit_test`` per pass); each
range lies inside its parent; the north star opens one ``rebuild`` a
call; the gradient opens ``backward`` after ``forward``; the panel solve
opens ``mesh``, ``bem_stage``, ``rankine`` and its ``chunk``s.  With no
profiler recording, ``record_function`` is never entered, and the span
roll-up counts the same names either way."""
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu.hydro import mesh as jmesh
from raft_tpu.hydro import wavetable as jwt
from raft_tpu_torch import convert, utils
from raft_tpu_torch.hydro import torch_bem
from raft_tpu_torch.model import stage_design_base
from raft_tpu_torch.obs import trace
from raft_tpu_torch.parallel.optimize import grad_nacelle_accel_std
from raft_tpu_torch.parallel.sweep import (_apply_lanes, _volturnus_design, forward_response,
                                           scale_diameters, sweep_north_star)

HERE = os.path.dirname(os.path.abspath(__file__))
OC3 = os.path.join(os.path.dirname(HERE), "raft_tpu", "designs", "OC3spar.yaml")
N_ITER = 12
METHODS = ("scan", "while")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oc3():
    """Three diameter variants of OC3spar at 8 frequencies, f64."""
    _, m, rna, env, wave, C = stage_design_base(OC3, nw=8, Hs=8.0, Tp=12.0, w_min=0.05,
                                                w_max=2.95, device="cpu")
    th = torch.tensor([1.0, 1.05, 0.95], dtype=torch.float64)
    return _apply_lanes(scale_diameters, m, th), rna, env, wave, C


def _solve(oc3, method):
    m, rna, env, wave, C = oc3
    with torch.no_grad():
        return forward_response(m, rna, env, wave, C, n_iter=N_ITER, method=method,
                                device="cpu")


def _traced(tmp_path, fn):
    """``fn()`` under ``utils.torch_trace``: its result and the ranges
    (``user_annotation`` events) of the trace, in time order."""
    with utils.torch_trace(str(tmp_path / "trace")) as path:
        out = fn()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return out, sorted(ranges, key=lambda e: e["ts"])


def _count(ranges, name):
    return sum(1 for e in ranges if e["name"] == name)


@pytest.mark.parametrize("method", METHODS)
def test_strip_solve_holds_the_named_ranges(oc3, tmp_path, method):
    _, ranges = _traced(tmp_path, lambda: _solve(oc3, method))
    names = {e["name"] for e in ranges}
    want = {"forward", "forward/statics", "forward/strip", "forward/dynamics",
            "forward/dynamics/step", "forward/dynamics/step/drag",
            "forward/dynamics/step/solve", "forward/dynamics/drag"}
    if method == "while":
        want.add("forward/dynamics/exit_test")
    assert names == want
    assert _count(ranges, "forward") == 1
    # K5's coefficient build before the first step, and the final linearization
    assert _count(ranges, "forward/dynamics/drag") == 2


@pytest.mark.parametrize("method", METHODS)
def test_child_ranges_lie_inside_their_parents(oc3, tmp_path, method):
    _, ranges = _traced(tmp_path, lambda: _solve(oc3, method))
    for r in ranges:
        if "/" not in r["name"]:
            continue
        parent = r["name"].rsplit("/", 1)[0]
        assert any(p["name"] == parent and p["ts"] <= r["ts"]
                   and r["ts"] + r["dur"] <= p["ts"] + p["dur"] for p in ranges), r["name"]


@pytest.mark.parametrize("method", METHODS)
def test_step_count_is_the_loops_steps(oc3, tmp_path, method):
    out, ranges = _traced(tmp_path, lambda: _solve(oc3, method))
    steps = _count(ranges, "forward/dynamics/step")
    n_iter = out.n_iter.numpy()
    if method == "scan":
        assert steps == N_ITER
    else:
        assert steps == int(n_iter.max())
    assert 1 <= n_iter.max() < N_ITER       # the lanes converge: the two differ
    assert _count(ranges, "forward/dynamics/step/drag") == steps
    assert _count(ranges, "forward/dynamics/step/solve") == steps


def test_one_exit_test_per_pass_of_the_while_loop(oc3, tmp_path):
    """Each pass of the loop tests first: the steps alternate with the
    tests, and the last, failing test ends the loop."""
    _, ranges = _traced(tmp_path, lambda: _solve(oc3, "while"))
    seq = [e["name"].rsplit("/", 1)[1] for e in ranges
           if e["name"] in ("forward/dynamics/exit_test", "forward/dynamics/step")]
    steps = seq.count("step")
    assert steps >= 1 and seq == ["exit_test", "step"] * steps + ["exit_test"]


def test_one_rebuild_per_north_star_call(tmp_path):
    kw = dict(n_designs=16, nw=8, chunk=2, n_iter=40, device="cpu", lanes=[0, 5, 10, 15])

    def two_calls():
        return [sweep_north_star(**kw) for _ in range(2)]

    outs, ranges = _traced(tmp_path, two_calls)
    assert _count(ranges, "rebuild") == 2
    assert _count(ranges, "pipeline/dispatch/forward") == 4          # 2 chunks a call
    steps = _count(ranges, "pipeline/dispatch/forward/dynamics/step")
    tests = _count(ranges, "pipeline/dispatch/forward/dynamics/exit_test")
    assert tests == steps + 4                                        # a last test a chunk
    rebuilds = [e for e in ranges if e["name"] == "rebuild"]
    first = [e for e in ranges if e["name"] == "pipeline/dispatch"][0]
    assert rebuilds[0]["ts"] + rebuilds[0]["dur"] <= first["ts"]
    assert steps == sum(int(o["n_iter"].reshape(-1, 2).amax(1).sum()) for o in outs)


def test_no_profiler_never_enters_record_function(oc3, monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    trace.reset()
    _solve(oc3, "while")
    roll = trace.rollup()
    assert roll["forward/dynamics/exit_test"]["count"] >= 2
    trace.reset()


def test_rollup_counts_the_same_names_with_and_without_a_profiler(oc3, tmp_path):
    counts = []
    for traced in (False, True):
        trace.reset()
        if traced:
            _traced(tmp_path, lambda: _solve(oc3, "while"))
        else:
            _solve(oc3, "while")
        counts.append({k: v["count"] for k, v in trace.rollup().items()})
    trace.reset()
    assert counts[0] == counts[1]
    assert counts[0]["forward/dynamics/step"] >= 1


def test_gradient_opens_backward_after_forward(oc3, tmp_path):
    _, rna, env, wave, C = oc3
    _, m1, *_ = stage_design_base(OC3, nw=8, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95,
                                  device="cpu")
    th = torch.tensor([1.0, 1.05], dtype=torch.float64)
    g, ranges = _traced(tmp_path, lambda: grad_nacelle_accel_std(
        m1, rna, env, wave, C, th, apply_fn=lambda mm, t: _apply_lanes(scale_diameters, mm, t),
        n_iter=3, device="cpu"))
    assert bool(torch.isfinite(g).all())
    fwd = [e for e in ranges if e["name"] == "forward"]
    bwd = [e for e in ranges if e["name"] == "backward"]
    assert len(fwd) == len(bwd) == 1
    assert fwd[0]["ts"] + fwd[0]["dur"] <= bwd[0]["ts"]
    assert _count(ranges, "forward/dynamics/step") == 3


def test_panel_solve_spans(tmp_path, monkeypatch):
    """``mesh_design`` opens ``mesh``; the on-device route's staging is
    ``bem_stage``, then ``rankine`` and one ``chunk`` per frequency chunk,
    each with ``wave``, ``factor`` and ``refine``."""
    from raft_tpu_torch.hydro.mesh import mesh_design

    monkeypatch.setattr(torch_bem.wavetable, "load_tables",
                        lambda: convert.wave_tables(jwt.load_tables()))
    hull = jmesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                             rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)
    w = np.array([0.7, 1.3, 1.9])
    design = _volturnus_design()

    def both():
        pans = mesh_design(design, dz_max=3.0, da_max=2.0)
        out = torch_bem.solve_bem_jax(hull, w, cache=False, device="cpu")
        return pans, out

    (pans, (A, B, F)), ranges = _traced(tmp_path, both)
    assert len(pans) > 0 and np.isfinite(A).all()
    n_chunks = -(-len(w) // torch_bem.freq_chunk(torch_bem.pad_panel_count(len(hull)), len(w)))
    assert _count(ranges, "mesh") == _count(ranges, "bem_stage") == 1
    assert _count(ranges, "rankine") == 1
    for name in ("chunk", "chunk/wave", "chunk/factor", "chunk/refine"):
        assert _count(ranges, name) == n_chunks, name
