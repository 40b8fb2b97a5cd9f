"""The port's multi-turbine arrays (``raft_tpu_torch.array.ArrayModel``,
``Model(nTurbines=...)``) against the JAX package's, on CPU in float64 on
a coarse grid (``W``, 12 frequencies), strip theory.

Every array output (natural frequencies, mean offsets, fairlead tensions,
per-turbine response, std devs, nacelle acceleration, constraint margins)
agrees with the JAX ``ArrayModel`` to 1e-10 scale-relative with identical
iteration counts.  The array is block-diagonal: a turbine reproduces the
single-turbine ``Model`` to 1e-10, and a turbine down-wave carries the
incident phase lag.  Arrays with BEM coefficients are in
``tests/test_torch_array_bem.py``, the 16-turbine farm in
``tests/test_torch_array_farm.py``.
"""
import numpy as np
import pytest

from raft_tpu.array import ArrayModel as JaxArrayModel
from raft_tpu.model import Model as JaxModel

from raft_tpu_torch.array import ArrayModel
from raft_tpu_torch.model import Model, load_design

OC3 = "raft_tpu/designs/OC3spar.yaml"
OC4 = "raft_tpu/designs/OC4semi.yaml"
W = np.arange(0.05, 3.0, 0.25)
POS = [[0.0, 0.0], [800.0, 0.0]]
TOL = 1e-10
CPU = dict(device="cpu")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run(model, eigen=True, outputs=True, **dyn):
    model.setEnv(Hs=8.0, Tp=12.0, Fthrust=800e3)
    model.calcSystemProps()
    if eigen:
        model.solveEigen()
    model.calcMooringAndOffsets()
    model.solveDynamics(**dyn)
    if outputs:
        model.calcOutputs()
    return model


@pytest.fixture(scope="module")
def single():
    return _run(Model(load_design(OC3), w=W, **CPU))


@pytest.fixture(scope="module")
def pair():
    return _run(Model(load_design(OC3), w=W, nTurbines=2, positions=POS, **CPU))


@pytest.fixture(scope="module")
def jax_pair():
    return _run(JaxModel(load_design(OC3), w=W, nTurbines=2, positions=POS))


def test_model_constructor_routes_to_array(pair):
    assert isinstance(pair, ArrayModel)
    assert pair.nT == 2 and pair.results["properties"]["nDOF"] == 12
    np.testing.assert_array_equal(pair.positions, POS)
    # positions default to the design's array block
    design = dict(load_design(OC3), array={"positions": [[0.0, 0.0], [0.0, 600.0],
                                                         [600.0, 0.0]]})
    a = Model(design, w=W, nTurbines=3, **CPU)
    assert a.nT == 3 and a.positions[1, 1] == 600.0
    with pytest.raises(ValueError, match="nTurbines"):
        Model(load_design(OC3), positions=POS, **CPU)


@pytest.mark.parametrize("section,key", [
    ("eigen", "frequencies"), ("eigen", "estimates"), ("means", "platform offset"),
    ("response", "Xi per turbine"), ("response", "Xi"), ("response", "std dev"),
    ("response", "RAO magnitude"), ("response", "nacelle acceleration"),
    ("constraints", "slack line margin"), ("constraints", "dynamic pitch")])
def test_array_matches_jax(pair, jax_pair, section, key):
    assert _rel(pair.results[section][key], jax_pair.results[section][key]) <= TOL


def test_array_iterations_and_tensions_match_jax(pair, jax_pair):
    np.testing.assert_array_equal(pair.results["response"]["iterations"],
                                  jax_pair.results["response"]["iterations"])
    assert pair.results["response"]["converged"].all()
    for t in range(2):
        assert _rel(pair.results["means"]["fairlead tensions"][t],
                    jax_pair.results["means"]["fairlead tensions"][t]) <= TOL


def test_array_matches_single(single, pair):
    """Block-diagonality: each turbine's eigen, offset and (for the one at
    the origin) response equal the single-turbine Model's."""
    for t in range(2):
        assert _rel(pair.results["eigen"]["frequencies"][t],
                    single.results["eigen"]["frequencies"]) <= TOL
        assert _rel(pair.results["means"]["platform offset"][t],
                    single.results["means"]["platform offset"]) <= TOL
    Xi1 = single.results["response"]["Xi"]
    assert _rel(pair.results["response"]["Xi per turbine"][0], Xi1) <= TOL
    assert _rel(pair.results["response"]["Xi"][:, :6], Xi1) <= TOL
    assert int(pair.results["response"]["iterations"][0]) == single.results["response"][
        "iterations"]


def test_array_downwave_phase_lag():
    """A turbine at (d, 0) in beta = 0 waves responds with the same |Xi| and
    the extra phase lag k d (the drag linearization converged tightly)."""
    d = 800.0
    a = ArrayModel(load_design(OC3), positions=[[0.0, 0.0], [d, 0.0]], w=W, **CPU)
    _run(a, eigen=False, outputs=False, tol=1e-4)
    Xa = a.results["response"]["Xi per turbine"]
    k = a.wave.k.numpy()
    np.testing.assert_allclose(Xa[1], Xa[0] * np.exp(-1j * k[:, None] * d), rtol=2e-3,
                               atol=1e-8)


def test_mixed_design_array_eigen():
    """OC3 + OC4 in one array (different padding and mooring): the JAX
    package's eigen at 1e-10, and each block its own single model's."""
    d3, d4 = load_design(OC3), load_design(OC4)
    a = ArrayModel([d3, d4], w=W, **CPU)
    j = JaxArrayModel([d3, d4], w=W)
    for m in (a, j):
        m.setEnv(Hs=8.0, Tp=12.0)
        m.calcSystemProps()
        m.solveEigen()
    fa = a.results["eigen"]["frequencies"]
    assert _rel(fa, j.results["eigen"]["frequencies"]) <= TOL
    assert not a._moor_batchable() or a.moor[0].r_anchor.shape == a.moor[1].r_anchor.shape
    for i, d in enumerate((d3, d4)):
        m = Model(d, w=W, **CPU)
        m.setEnv(Hs=8.0, Tp=12.0)
        m.calcSystemProps()
        m.solveEigen()
        assert _rel(fa[i], m.results["eigen"]["frequencies"]) <= TOL


def test_array_history_diagnostic():
    a = ArrayModel(load_design(OC3), nT=2, w=W, **CPU)
    _run(a, eigen=False, outputs=False, history=True)
    h = a.results["response"]["iteration error history"]
    n = a.results["response"]["iterations"]
    assert h.shape == (2, 40)
    for t in range(2):
        assert np.isfinite(h[t, :int(n[t])]).all() and np.isnan(h[t, int(n[t]):]).all()


def test_mixed_design_array_with_bem_raises_and_unported_options():
    d3, d4 = load_design(OC3), load_design(OC4)
    with pytest.raises(NotImplementedError):
        ArrayModel([d3, d4], w=W, BEM="native", **CPU)
    with pytest.raises(ValueError, match="BEM="):
        ArrayModel(d3, nT=2, w=W, BEM="hams", **CPU)
    a = ArrayModel(d3, nT=2, w=W, **CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP.*multi-device"):
        a.solveDynamics(mesh=object())
    # the plots are ported (tests/test_torch_plot.py): the RAO grid needs a solve
    with pytest.raises(RuntimeError, match="solveDynamics"):
        a.plot_raos()


def test_add_fowt_grows_array(capsys):
    d = load_design(OC3)
    a = ArrayModel(d, w=W, **CPU)
    assert a.nT == 1
    a.addFOWT(d, position=(600.0, 0.0))
    assert a.nT == 2 and a.members.node_r.shape[0] == 2
    a.setEnv(Hs=8.0, Tp=12.0)
    a.calcSystemProps()
    a.solveEigen()
    f = a.results["eigen"]["frequencies"]
    assert f.shape == (2, 6)
    np.testing.assert_array_equal(f[0], f[1])
    a.print_report()
    assert "turbine 1: position (600.0, 0.0)" in capsys.readouterr().out
