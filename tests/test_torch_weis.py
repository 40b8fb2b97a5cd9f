"""The port's WEIS adapter (``raft_tpu_torch.io.weis``) against the JAX
package's (``raft_tpu.io.weis``), on the arrays of
``tests/test_api_extras.py::test_weis_adapter_end_to_end`` (an OC3-like
spar, its tower and RNA, three catenary lines): the design dicts are equal,
member by member, and the port's Model on that design matches the JAX
Model at 1e-9 on a coarse grid (natural frequencies, response std dev
scale-relative, mean offsets, iteration counts)."""
import numpy as np
import pytest

from raft_tpu.io import weis as jweis
from raft_tpu.model import Model as JModel

from raft_tpu_torch.io import weis
from raft_tpu_torch.model import Model

W = np.arange(0.2, 1.4, 0.2)
TOL = 1e-9


def weis_design(mod):
    spar = mod.member_from_arrays(
        "spar", [0, 0, -120], [0, 0, 10], [9.4, 9.4, 6.5, 6.5], [0.027],
        stations=[-120, -12, -4, 10], potMod=False, Cd=0.8, Ca=1.0, rho_shell=8500,
        l_fill=[52.0, 0, 0], rho_fill=[1860.0, 0, 0])
    tower = mod.member_from_arrays("tower", [0, 0, 10], [0, 0, 87.6], [6.5, 3.87],
                                   [0.027, 0.019], mtype=1, Cd=0.0, Ca=0.0)
    ang = np.deg2rad([0, 120, 240])
    moor = mod.mooring_from_arrays(
        320.0, np.stack([853.87 * np.cos(ang), 853.87 * np.sin(ang), np.full(3, -320.0)], -1),
        np.stack([5.2 * np.cos(ang), 5.2 * np.sin(ang), np.full(3, -70.0)], -1), [902.2] * 3,
        diameter=0.09, mass_density=77.7066, stiffness=384.243e6)
    return mod.design_from_weis(
        [spar], tower, {"mRNA": 350000, "IxRNA": 3.5e7, "IrRNA": 2.6e7, "xCG_RNA": 0,
                        "hHub": 90.0, "Fthrust": 800e3, "yaw_stiffness": 9.834e7}, moor)


def test_design_dicts_are_equal():
    assert weis_design(weis) == weis_design(jweis)
    m = weis.member_from_arrays("c", [0, 0, -5], [0, 0, 5], 3.0, [0.02, 0.03, 0.04])
    assert m == jweis.member_from_arrays("c", [0, 0, -5], [0, 0, 5], 3.0, [0.02, 0.03, 0.04])
    assert m["stations"] == [0.0, 0.5, 1.0] and m["d"] == [3.0] * 3


def test_bad_arrays_raise_as_jax():
    for mod in (weis, jweis):
        with pytest.raises(ValueError, match="must be scalar or match"):
            mod.member_from_arrays("c", [0, 0, -5], [0, 0, 5], [1.0, 2.0], [0.02], stations=[0, 1, 2])
        with pytest.raises(ValueError, match="3 anchors but 2 fairleads"):
            mod.mooring_from_arrays(100.0, np.zeros((3, 3)), np.zeros((2, 3)), 200.0, 0.1, 50.0, 1e8)


def test_model_on_weis_design_matches_jax():
    results = []
    for cls, mod, kw in ((Model, weis, {"device": "cpu"}), (JModel, jweis, {})):
        m = cls(weis_design(mod), w=W, **kw)
        m.setEnv(Fthrust=800e3)
        m.calcSystemProps()
        m.solveEigen()
        m.calcMooringAndOffsets()
        m.solveDynamics()
        results.append(m.results)
    got, ref = results
    np.testing.assert_allclose(got["eigen"]["frequencies"], ref["eigen"]["frequencies"],
                               rtol=TOL)
    for key in ("std dev",):
        g, r = got["response"][key], np.asarray(ref["response"][key])
        assert np.abs(g - r).max() <= TOL * np.abs(r).max()
    g, r = got["means"]["platform offset"], np.asarray(ref["means"]["platform offset"])
    assert np.abs(g - r).max() <= TOL * np.abs(r).max()
    assert got["response"]["iterations"] == ref["response"]["iterations"]
    assert got["response"]["converged"]
