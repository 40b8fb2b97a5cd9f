"""The span readers (``strip_host_ms``, ``rebuild_ms``, ``exit_wait_ms``,
``step_yield``, ``mesh_self_ms``) on hand-built profiles: milliseconds per
call, paths matched by their last segments under ``pipeline/dispatch`` and
at the top level, self time less the children, spans outside the calls or
inside ``backward`` left out, and None without the span; then each cell's
traced run on the CPU reports the span metrics ``BENCHMARK.json`` gives
it."""
from __future__ import annotations

import io
import time

import pytest

from benchmark.harness import runner, spec
from benchmark.harness.profile import CALL, Event, Profile
from benchmark.layer_metrics import (exit_wait_ms, mesh_self_ms, rebuild_ms, step_yield,
                                     strip_host_ms)

MS = 1_000_000
SPAN_METRICS = {"strip_host_ms.sweep", "strip_host_ms.grad", "rebuild_ms.sweep",
                "exit_wait_ms.sweep", "step_yield.sweep", "mesh_self_ms.bem"}


def r(name, start_ms, end_ms):
    return Event(name, "user_annotation", int(start_ms * MS), int(end_ms * MS))


def north_star() -> Profile:
    """Two calls of 100 ms: a ``rebuild`` each, then chunks whose solves
    (``dynamics``) take 2 steps each, with the exit tests beside them."""
    d = "pipeline/dispatch/forward"
    host = [r(CALL, 0, 100), r(CALL, 100, 200),
            r("rebuild", 0, 4), r("rebuild", 100, 106),
            r("pipeline/dispatch", 10, 60), r(d, 10, 60),
            r(f"{d}/strip", 11, 14), r(f"{d}/dynamics", 15, 60),
            r(f"{d}/dynamics/exit_test", 15, 16), r(f"{d}/dynamics/step", 16, 30),
            r(f"{d}/dynamics/step/drag", 16, 18), r(f"{d}/dynamics/exit_test", 30, 32),
            r(f"{d}/dynamics/step", 32, 50), r(f"{d}/dynamics/step/drag", 32, 33),
            r(f"{d}/dynamics/exit_test", 50, 53), r(f"{d}/dynamics/drag", 55, 56),
            r("pipeline/dispatch", 110, 150), r(d, 110, 150),
            r(f"{d}/strip", 111, 112), r(f"{d}/dynamics", 112, 150),
            r(f"{d}/dynamics/exit_test", 112, 113), r(f"{d}/dynamics/step", 113, 140),
            r(f"{d}/dynamics/step/drag", 113, 115), r(f"{d}/dynamics/exit_test", 140, 141),
            r(f"{d}/dynamics/step", 141, 148), r(f"{d}/dynamics/step/drag", 141, 142),
            r(f"{d}/dynamics/exit_test", 148, 149),
            # outside every call: the harness's set-up, never read
            r("rebuild", 300, 400), r(f"{d}/dynamics/exit_test", 300, 400),
            Event("aten::mul", "cpu_op", 11 * MS, 13 * MS)]
    return Profile(host=host)


def test_per_call_milliseconds_under_the_pipeline():
    ctx = {"profile": north_star(), "n_calls": 2, "counters": {}}
    assert rebuild_ms.read(ctx, "sweep") == pytest.approx((4 + 6) / 2)
    assert exit_wait_ms.read(ctx, "sweep") == pytest.approx((1 + 2 + 3 + 1 + 1 + 1) / 2)
    # strip 3 + 1, drag 2 + 1 + 1 (final) + 2 + 1
    assert strip_host_ms.read(ctx, "sweep") == pytest.approx((3 + 1 + 2 + 1 + 1 + 2 + 1) / 2)


def test_paths_match_by_their_last_segments():
    p = Profile(host=[r(CALL, 0, 10), r("forward/strip", 1, 2), r("forward/dynamics/drag", 3, 5),
                      r("strip", 6, 7), r("wide_forward/strip", 7, 8),
                      r("forward/dynamics/dragon", 8, 9)])
    assert [e.name for e in rebuild_ms.spans(p, "forward/strip")] == ["forward/strip"]
    assert [e.name for e in rebuild_ms.spans(p, "drag")] == ["forward/dynamics/drag"]
    assert strip_host_ms.read({"profile": p, "n_calls": 1}, "grad") == pytest.approx(3.0)


def test_step_yield_is_lane_iterations_over_loop_steps():
    ctx = {"profile": north_star(), "n_calls": 2, "counters": {"iters": [2, 2, 1, 1]}}
    # 4 steps in 2 solves: 2 a solve; lanes 1.5 on average
    assert step_yield.read(ctx, "sweep") == pytest.approx(0.75)
    assert step_yield.read({**ctx, "counters": {}}, "sweep") is None
    scan = Profile(host=[r(CALL, 0, 100), r("forward/dynamics", 0, 90)]
                   + [r("forward/dynamics/step", 3 * i, 3 * i + 2) for i in range(25)])
    got = step_yield.read({"profile": scan, "n_calls": 1, "counters": {"iters": [6, 7, 7]}},
                          "sweep")
    assert got == pytest.approx((20 / 3) / 25)


def test_mesh_self_time_is_the_span_less_its_children():
    p = Profile(host=[r(CALL, 0, 50), r(CALL, 50, 100),
                      r("mesh", 0, 10), r("mesh/trim", 2, 5), r("mesh/trim/inner", 3, 6),
                      r("mesh/members", 4, 7), r("bem_stage", 11, 20),
                      r("mesh", 50, 54)])
    # the first hull: 10 ms less [2, 7] covered by its children; the second 4 ms
    assert mesh_self_ms.read({"profile": p, "n_calls": 2}, "bem") == pytest.approx((5 + 4) / 2)


def test_forward_pass_only_leaves_out_the_backward():
    p = Profile(host=[r(CALL, 0, 100), r("forward/strip", 0, 4),
                      r("forward/dynamics/step/drag", 5, 7), r("backward", 50, 90),
                      r("drag", 60, 65), r("forward/dynamics/drag", 20, 21)])
    assert strip_host_ms.read({"profile": p, "n_calls": 1}, "grad") == pytest.approx(7.0)


def test_none_without_the_span():
    p = Profile(host=[r(CALL, 0, 10), Event("aten::mul", "cpu_op", 1 * MS, 2 * MS),
                      r("pipeline/dispatch", 1, 9)])
    ctx = {"profile": p, "n_calls": 1, "counters": {"iters": [3, 4]}}
    for reader in (strip_host_ms, rebuild_ms, exit_wait_ms, step_yield, mesh_self_ms):
        assert reader.read(ctx, "x") is None, reader.__name__


def test_each_metric_names_its_reader_and_its_cells():
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in SPAN_METRICS}
    assert set(entries) == SPAN_METRICS
    for m in entries.values():
        assert m["source"] == "program_span"
        for cell in m["workloads"]:
            assert m in spec.cell(cell).per_layer


@pytest.fixture
def two_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["volturnus_s.sweep_bem", "oc3_spar.sweep_wide",
                                  "volturnus_s.codesign_grad", "volturnus_s.bem_hull"])
def test_traced_run_reports_its_span_metrics(name, small_root, two_threads):
    res = runner.run(name, 2**31 + 11, 0.2, True, time.perf_counter(), device="cpu",
                     root=small_root, out=io.StringIO(), err=io.StringIO())
    assert res["correct"]
    want = {m["name"] for m in spec.cell(name, small_root).per_layer
            if m["source"] == "program_span"}
    assert want and want <= set(res["metrics"])
    if "step_yield.sweep" in want:
        assert 0 < res["metrics"]["step_yield.sweep"]["value"] <= 1
