"""The port's shared heading-grid staging (``raft_tpu_torch.model.
solve_bem_heading_grid``) against the JAX package's
(``raft_tpu.model.solve_bem_heading_grid``): a 60-panel cylinder at 3
frequencies on a 3-heading grid through the native solver, both returns
at 1e-12.  An out-of-grid heading raises before the panel solve, and
``Model.calcBEM(headings=)`` and ``ArrayModel.calcBEM(headings=)`` stage
their grid through it."""
import os

import numpy as np
import pytest

from raft_tpu.model import solve_bem_heading_grid as jax_solve_bem_heading_grid

from raft_tpu_torch import model as tmodel
from raft_tpu_torch.cache import config
from raft_tpu_torch.hydro import mesh, torch_bem
from raft_tpu_torch.model import Model, load_design, solve_bem_heading_grid

TOL = 1e-12
W = np.array([0.4, 0.9, 1.5])
HEADINGS = [0.6, 0.0, 0.3]
OC3 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "raft_tpu", "designs",
                   "OC3spar.yaml")


@pytest.fixture(autouse=True)
def _own_cache(monkeypatch, tmp_path):
    monkeypatch.setenv(config.CACHE_ENV, str(tmp_path / "cache"))


def _cylinder():
    return mesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                            rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_heading_grid_matches_jax_package():
    panels = _cylinder()
    args = (panels, W, 1025.0, 9.81, 40.0, None, HEADINGS, 0.45)
    (betas, F_all, A, B), bem = solve_bem_heading_grid(*args, mode="native", cache=False)
    (jbetas, jF_all, jA, jB), jbem = jax_solve_bem_heading_grid(*args, mode="native")
    np.testing.assert_array_equal(betas, jbetas)
    np.testing.assert_array_equal(betas, np.sort(HEADINGS))
    assert F_all.shape == (3, 6, len(W))
    for got, want in ((F_all, jF_all), (A, jA), (B, jB)) + tuple(zip(bem, jbem)):
        assert _rel(got, want) <= TOL
    # the staged excitation lies between the two bracketing headings' (0.3, 0.6)
    np.testing.assert_allclose(bem[2], 0.5 * (F_all[1] + F_all[2]), rtol=1e-12, atol=0)
    *_, diag = solve_bem_heading_grid(*args, mode="native", cache=False,
                                      return_diagnostics=True)
    assert diag["route"] == "native" and diag["headings"] == 3


def test_out_of_grid_heading_raises_before_the_solve(monkeypatch):
    calls = []
    monkeypatch.setattr(torch_bem, "solve_bem_any", lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError, match="outside the requested grid"):
        solve_bem_heading_grid(_cylinder(), W, 1025.0, 9.81, 40.0, None, HEADINGS, 0.8,
                               mode="native")
    assert calls == []


@pytest.mark.parametrize("n_turbines", [1, 2])
def test_calc_bem_routes_through_it(monkeypatch, n_turbines):
    seen = []
    orig = tmodel.solve_bem_heading_grid

    def spy(*a, **k):
        seen.append(k.get("headings"))
        return orig(*a, **k)

    monkeypatch.setattr(tmodel, "solve_bem_heading_grid", spy)
    m = Model(load_design(OC3), w=W, BEM="native", nTurbines=n_turbines, device="cpu")
    m.setEnv(Hs=6.0, Tp=10.0, beta=0.3)
    A, B, F = m.calcBEM(dz_max=6.0, da_max=4.0, headings=HEADINGS, cache=False)
    assert seen == [HEADINGS]
    betas, F_all, A_g, B_g = m._bem_headings
    np.testing.assert_array_equal(betas, np.sort(HEADINGS))
    assert A is A_g and B is B_g
    np.testing.assert_array_equal(F, F_all[1])
    assert m.bem_diagnostics["route"] == "native"
    with pytest.raises(ValueError, match="outside the requested grid"):
        m.calcBEM(dz_max=6.0, da_max=4.0, headings=[0.5, 0.9], cache=False)
