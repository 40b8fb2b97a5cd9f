"""Lane health, chunks and checkpoints in the port's design batches and the
north star, on the CPU in float64: ``sweep(health=...)`` and
``sweep_designs(health=..., chunk=...)`` against the JAX package's;
``sweep_north_star(health=True, pipeline_depth=2)`` on a 4-lane subset
against its chunk loop (the kill-and-resume proof:
``tests/test_torch_resume.py``).

Small sizes: OC3spar's variants at 8 frequencies, OC3spar and
VolturnUS-S (one bucket) at 16, the north star at 16 frequencies.
Iteration-starved lanes (``n_iter=2``) are salvaged at the JAX package's
rungs, their statistics at 1e-12 scale-relative with identical counts.
"""
import os

import numpy as np
import pytest
import torch

from raft_tpu.model import stage_design_base as jax_stage_design_base
from raft_tpu.parallel.sweep import sweep as jax_sweep
from raft_tpu.parallel.sweep import sweep_designs as jax_sweep_designs

from raft_tpu_torch.model import stage_design_base
from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
from raft_tpu_torch.parallel.sweep import (_volturnus, forward_response, north_star_grid,
                                           response_std, sweep, sweep_designs, sweep_north_star)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DESIGNS = [os.path.join(ROOT, "raft_tpu", "designs", n + ".yaml")
           for n in ("OC3spar", "VolturnUS-S")]
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _same_health(got, want):
    assert got["health"] == want["health"]
    np.testing.assert_array_equal(got["converged"], np.asarray(want["converged"]))
    np.testing.assert_array_equal(got["finite"], np.asarray(want["finite"]))


@pytest.mark.parametrize("return_xi", [True, False])
def test_variant_sweep_health_matches_jax(return_xi):
    kw = dict(nw=8, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
    _, m, rna, env, wave, C = stage_design_base(DESIGNS[0], device="cpu", **kw)
    _, jm, jrna, jenv, jwave, jC = jax_stage_design_base(DESIGNS[0], **kw)
    thetas = np.array([1.0, 1.05])
    got = sweep(m, rna, env, wave, C, thetas, n_iter=2, health=True, return_xi=return_xi,
                device="cpu")
    want = jax_sweep(jm, jrna, jenv, jwave, jC, thetas, n_iter=2, health=True,
                     return_xi=return_xi)
    _same_health(got, want)
    assert got["health"]["salvaged"] == got["health"]["n_quarantined"] == 2
    np.testing.assert_array_equal(got["iterations"], np.asarray(want["iterations"]))
    assert _rel(got["std dev"], want["std dev"]) <= TOL
    if return_xi:
        assert _rel(got["Xi_abs2"], want["Xi_abs2"]) <= TOL
    off = sweep(m, rna, env, wave, C, thetas, n_iter=25, return_xi=return_xi, device="cpu")
    assert "health" not in off
    np.testing.assert_allclose(got["std dev"], off["std dev"], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("chunk", [None, 1])
def test_sweep_designs_health_and_chunks_match_jax(chunk):
    """Two designs in one bucket, starved at ``n_iter=2``: the merged
    health block (lanes in the caller's order, per-bucket blocks) and the
    salvaged statistics as the JAX package's; chunked, the ``pipeline``
    block per bucket signature."""
    kw = dict(nw=16, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
    got = sweep_designs(DESIGNS, n_iter=2, health=True, chunk=chunk, pipeline_depth=2,
                        device="cpu", **kw)
    want = jax_sweep_designs(DESIGNS, n_iter=2, health=True, chunk=chunk, pipeline_depth=2,
                             **kw)
    _same_health(got, want)
    assert got["health"]["salvaged"] == 2 and got["health"]["rungs_used"] == {"n_iter_x4": 2}
    np.testing.assert_array_equal(got["iterations"], np.asarray(want["iterations"]))
    for k in ("std dev", "Xi_abs2"):
        assert _rel(got[k], want[k]) <= TOL, k
    assert got["buckets"] == want["buckets"]
    if chunk is None:
        assert "pipeline" not in got
    else:
        (sig, block), = got["pipeline"].items()
        assert sig == next(iter(want["pipeline"])) and block["chunks"] == 2
        assert set(block) == set(want["pipeline"][sig])


def test_sweep_designs_chunk_rounds_to_a_divisor_and_depth_alone_is_ignored():
    kw = dict(nw=16, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
    three = [DESIGNS[1]] * 3
    whole = sweep_designs(three, n_iter=10, device="cpu", **kw)
    got = sweep_designs(three, n_iter=10, chunk=2, device="cpu", **kw)
    assert next(iter(got["pipeline"].values()))["chunks"] == 3      # 2 -> 1 divides 3
    assert _rel(got["std dev"], whole["std dev"]) <= TOL
    np.testing.assert_array_equal(got["iterations"], whole["iterations"])
    plain = sweep_designs(three, n_iter=10, pipeline_depth=3, device="cpu", **kw)
    assert "pipeline" not in plain
    np.testing.assert_array_equal(plain["std dev"], whole["std dev"])
    with pytest.raises(ValueError, match="one or the other"):
        sweep_designs(three, chunk=1, mesh=object(), device="cpu", **kw)


def test_sweep_designs_feeds_the_bucket_span_and_metrics(tmp_path, monkeypatch):
    from raft_tpu_torch import obs

    obs.reset()
    monkeypatch.setenv("RAFT_TPU_OBS", str(tmp_path))
    kw = dict(nw=16, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
    sweep_designs(DESIGNS, n_iter=10, chunk=1, device="cpu", **kw)
    roll = obs.trace.rollup()
    assert roll["sweep_designs/bucket"]["count"] == 1
    assert roll["sweep_designs/bucket/pipeline/dispatch"]["count"] == 2
    snap = obs.snapshot()
    assert snap["counters"]["sweep_designs.lanes"] == 2
    assert snap["histograms"]["sweep_designs.dispatch_s[16x64x16]"]["count"] == 1
    logs = [p for p in os.listdir(tmp_path) if p.startswith("obs-sweep_designs")]
    assert len(logs) == 1                      # maybe_publish wrote the sinks
    obs.reset()


def test_north_star_health_and_pipeline_match_the_loop(monkeypatch):
    """``sweep_north_star(health=True, pipeline_depth=2)`` on a 4-lane
    subset: the same bits as the call without them, the ``pipeline`` and
    ``resilience`` blocks beside; strict mode raises on starved lanes,
    non-strict salvages them onto the full-budget answer."""
    kw = dict(n_designs=16, nw=16, chunk=2, n_iter=40, device="cpu", lanes=[0, 5, 10, 15])
    loop = sweep_north_star(**kw)
    assert set(loop) == {"std", "n_iter", "converged", "scales"}
    # the parent's host loop over chunks, written out
    _d, members, rna, env, wave, C = _volturnus(16, torch.float64, torch.device("cpu"))
    draft, plan = make_stretch_draft(members), make_scale_plan(members)
    scales = torch.as_tensor(north_star_grid(16)[kw["lanes"]])
    with torch.no_grad():
        for lo in (0, 2):
            th = scales[lo:lo + 2]
            out = forward_response(plan(draft(members, th[:, 1]), th[:, 0]), rna, env, wave, C,
                                   n_iter=40, method="while", device="cpu")
            assert torch.equal(loop["std"][lo:lo + 2], response_std(out.Xi.abs2(), wave.w))
            assert torch.equal(loop["n_iter"][lo:lo + 2], out.n_iter)
    assert torch.equal(loop["scales"], scales)
    monkeypatch.delenv("RAFT_TPU_STRICT", raising=False)
    got = sweep_north_star(**kw, health=True, pipeline_depth=2)
    for k in loop:
        assert torch.equal(got[k], loop[k]), k
    assert got["pipeline"]["chunks"] == 2 and got["pipeline"]["max_in_flight"] == 2
    assert got["resilience"]["n_quarantined"] == 0 and got["resilience"]["strict"] is True
    starved = {**kw, "n_iter": 3}
    with pytest.raises(RuntimeError, match="strict mode.*resilience="):
        sweep_north_star(**starved, health=True)
    monkeypatch.setenv("RAFT_TPU_STRICT", "0")
    salv = sweep_north_star(**starved, health=True, pipeline_depth=1)
    r = salv["resilience"]
    assert r["salvaged"] == r["n_quarantined"] > 0 and not r["unsalvaged"]
    assert bool(salv["converged"].all())
    np.testing.assert_allclose(salv["std"].numpy(), loop["std"].numpy(), rtol=1e-6)
