"""Lane health and the escalation ladder in the port's DLC table
(``sweep_sea_states(health=...)``) against the JAX package's, on the CPU
in float64 (the variant and design batches and the north star:
``tests/test_torch_health_batches.py``).

OC3spar at 8 frequencies (``__graft_entry__._base(nw=8)``'s staging):
degenerate sea states (Tp = 0 makes the spectrum NaN) get the JAX
package's quarantine verdicts; iteration-starved lanes (``n_iter=2``) are
salvaged at the same rungs with the same ``rungs_used``, their statistics
at 1e-12 scale-relative where the iteration counts agree; an unsalvageable
lane walks the whole ladder; ``health=False`` returns the parent's result
bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from raft_tpu.model import stage_design_base as jax_stage_design_base
from raft_tpu.parallel.sweep import make_wave_states as jax_make_wave_states
from raft_tpu.parallel.sweep import sweep_sea_states as jax_sweep_sea_states

from raft_tpu_torch.model import stage_design_base
from raft_tpu_torch.parallel.sweep import (forward_response, make_wave_states, response_std,
                                           sweep_sea_states)

HERE = os.path.dirname(os.path.abspath(__file__))
OC3 = os.path.join(HERE, "..", "raft_tpu", "designs", "OC3spar.yaml")
KW = dict(nw=8, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oc3():
    design, m, rna, env, wave, C = stage_design_base(OC3, device="cpu", **KW)
    _, jm, jrna, jenv, jwave, jC = jax_stage_design_base(OC3, **KW)
    return (m, rna, env, wave, C), (jm, jrna, jenv, jwave, jC), float(env.depth)


def _waves(oc3, cases):
    (m, rna, env, wave, C), (jm, jrna, jenv, jwave, jC), depth = oc3
    return (make_wave_states(wave.w.numpy(), cases, depth, device="cpu"),
            jax_make_wave_states(np.asarray(jwave.w), cases, depth))


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _same_health(got, want):
    assert got["health"] == want["health"]
    np.testing.assert_array_equal(got["converged"], np.asarray(want["converged"]))
    np.testing.assert_array_equal(got["finite"], np.asarray(want["finite"]))


@pytest.mark.parametrize("chunk", [None, 1])
def test_degenerate_sea_states_get_the_jax_verdicts(oc3, chunk):
    """Hs = 0 is a flat calm (zero response, healthy); Tp = 0 makes the
    JONSWAP spectrum NaN: that lane is quarantined, reported unsalvaged
    (``escalate=False``) and its spectra stay NaN."""
    (m, rna, env, _, C), (jm, jrna, jenv, _, jC), _ = oc3
    w, jw = _waves(oc3, [[6.0, 10.0], [0.0, 10.0], [6.0, 0.0]])
    got = sweep_sea_states(m, rna, env, w, C, health=True, escalate=False, chunk=chunk,
                           device="cpu")
    want = jax_sweep_sea_states(jm, jrna, jenv, jw, jC, health=True, escalate=False,
                                chunk=chunk)
    _same_health(got, want)
    assert got["health"]["quarantined"] == [2] and got["health"]["unsalvaged"] == [2]
    np.testing.assert_allclose(got["std dev"][1], 0.0, atol=1e-30)
    assert np.isnan(got["Xi_abs2"][2]).all()
    assert _rel(got["std dev"][:2], np.asarray(want["std dev"])[:2]) <= TOL


@pytest.mark.parametrize("chunk", [None, 2])
def test_iteration_starved_lanes_salvaged_at_the_jax_rungs(oc3, chunk):
    (m, rna, env, _, C), (jm, jrna, jenv, _, jC), _ = oc3
    cases = [[6.0, 10.0], [9.0, 13.0]]
    w, jw = _waves(oc3, cases)
    got = sweep_sea_states(m, rna, env, w, C, n_iter=2, health=True, chunk=chunk, device="cpu")
    want = jax_sweep_sea_states(jm, jrna, jenv, jw, jC, n_iter=2, health=True, chunk=chunk)
    _same_health(got, want)
    assert got["health"]["salvaged"] == 2 and got["health"]["rungs_used"] == {"n_iter_x4": 2}
    same = got["iterations"] == np.asarray(want["iterations"])
    assert same.all()
    for k in ("std dev", "nacelle accel std dev", "Xi_abs2"):
        assert _rel(got[k][same], np.asarray(want[k])[same]) <= TOL, k
    # the salvaged lanes sit on the fixed point of the full-budget batch
    ref = sweep_sea_states(m, rna, env, w, C, n_iter=25, device="cpu")
    np.testing.assert_allclose(got["std dev"], ref["std dev"], rtol=1e-6, atol=1e-12)


def test_unsalvageable_lane_walks_the_full_ladder(oc3):
    """A NaN-input lane is salvaged by no rung: all four rungs run, the
    lane is reported unsalvaged, nothing raises, and its batch-mate keeps
    its verdict (the JAX package's verdict with ``escalate=False``)."""
    from raft_tpu_torch import obs

    (m, rna, env, _, C), (jm, jrna, jenv, _, jC), _ = oc3
    w, jw = _waves(oc3, [[6.0, 10.0], [6.0, 0.0]])
    obs.reset()
    got = sweep_sea_states(m, rna, env, w, C, health=True, device="cpu")
    h = got["health"]
    assert h["quarantined"] == [1] and h["unsalvaged"] == [1] and h["rungs_used"] == {}
    assert not got["converged"][1] and got["converged"][0]
    counters = obs.snapshot()["counters"]
    assert [counters[f"resilience.rung[{r}]"] for r in
            ("n_iter_x4", "relax_0.5", "relax_0.25", "tikhonov")] == [1, 1, 1, 1]
    assert counters["resilience.unsalvaged"] == 1
    want = jax_sweep_sea_states(jm, jrna, jenv, jw, jC, health=True, escalate=False)
    assert want["health"]["quarantined"] == [1]


def test_health_off_is_the_parent_result(oc3):
    """``health=False`` (and no ``chunk``): the keys and bits of the
    batched solve, which ``health=True`` on a healthy batch reproduces."""
    (m, rna, env, _, C), _, _ = oc3
    w, _ = _waves(oc3, [[6.0, 10.0], [8.0, 12.0]])
    off = sweep_sea_states(m, rna, env, w, C, device="cpu")
    assert set(off) == {"std dev", "nacelle accel std dev", "iterations", "Xi_abs2"}
    with torch.no_grad():
        out = forward_response(m, rna, env, w, C, n_iter=25, device="cpu")
        np.testing.assert_array_equal(off["Xi_abs2"], out.Xi.abs2().numpy())
        np.testing.assert_array_equal(off["std dev"],
                                      response_std(out.Xi.abs2(), w.w[0]).numpy())
        np.testing.assert_array_equal(off["iterations"], out.n_iter.numpy())
    on = sweep_sea_states(m, rna, env, w, C, health=True, device="cpu")
    for k in off:
        np.testing.assert_array_equal(on[k], off[k])
    assert on["health"]["n_quarantined"] == 0 and on["converged"].all()
