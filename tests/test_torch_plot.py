"""The port's plots (``Model.plot``, ``plot_raos``, ``plot_rao_grid``,
``plot_member_wireframe``, ``ArrayModel.plot`` / ``plot_raos``,
``run_raft(plot=True)``) against the JAX package's, under matplotlib's Agg
backend.  The figures are drawn from host numpy copies of the results, so
the port's drawn lines are the JAX package's: the same number of lines
with the same data at 1e-9 (OC3spar on a coarse grid, mooring lines at
the mean offset; the RAO curves after the solve).  ``plot_raos`` before a
solve raises as the JAX package's does; a two-turbine array's wireframe
matches too and its RAO grid draws one curve per turbine."""
import matplotlib

matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from raft_tpu.model import Model as JModel  # noqa: E402

from raft_tpu_torch.model import Model, load_design, run_raft  # noqa: E402

OC3 = "raft_tpu/designs/OC3spar.yaml"
W = np.arange(0.2, 1.4, 0.2)
TOL = 1e-9


@pytest.fixture(autouse=True)
def _close():
    yield
    plt.close("all")


def _solved(cls, **kw):
    m = cls(load_design(OC3), w=W, **kw)
    m.setEnv(Hs=8.0, Tp=12.0, Fthrust=800e3)
    m.calcSystemProps()
    m.calcMooringAndOffsets()
    m.solveDynamics()
    return m


@pytest.fixture(scope="module")
def models():
    return _solved(Model, device="cpu"), _solved(JModel)


def _same_lines(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        a, b = (np.asarray(x.get_data_3d() if hasattr(x, "get_data_3d") else x.get_data(),
                           dtype=float) for x in (g, w))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1.0)
        assert (g.get_color(), g.get_linewidth()) == (w.get_color(), w.get_linewidth())


def test_model_plot_matches_jax(models):
    port, ref = models
    ax = port.plot()
    ax_ref = ref.plot()
    _same_lines(ax.get_lines(), ax_ref.get_lines())
    # members (wireframe) and the three mooring lines
    assert sum(1 for ln in ax.get_lines() if ln.get_color() == "b") == 3
    ax2 = port.plot(hideGrid=True, n_ring=8)
    assert not ax2.axison


def test_plot_raos_matches_jax(models):
    port, ref = models
    axes, axes_ref = port.plot_raos(), ref.plot_raos()
    flat, flat_ref = np.asarray(axes).ravel(), np.asarray(axes_ref).ravel()
    assert flat.shape == (6,)
    for a, b in zip(flat, flat_ref):
        _same_lines(a.get_lines(), b.get_lines())
        assert a.get_ylabel() == b.get_ylabel()


def test_plot_raos_before_a_solve_raises():
    for m in (Model(load_design(OC3), w=W, device="cpu"), JModel(load_design(OC3), w=W)):
        with pytest.raises(RuntimeError, match="run solveDynamics"):
            m.plot_raos()
    from raft_tpu_torch.model import plot_rao_grid

    _fig, axes = plt.subplots(1, 3)
    with pytest.raises(ValueError, match="needs 6 axes"):
        plot_rao_grid(W, np.ones((1, len(W), 6)), axes=axes)


def test_array_plots():
    """A two-turbine OC3spar array (``tests/test_array.py``'s pair): the
    wireframe at the two positions equals the JAX ArrayModel's, and the RAO
    grid draws one curve per turbine with a legend."""
    a = _solved(Model, nTurbines=2, positions=[[0.0, 0.0], [600.0, 0.0]], device="cpu")
    ja = JModel(load_design(OC3), w=W, nTurbines=2, positions=[[0.0, 0.0], [600.0, 0.0]])
    _same_lines(a.plot().get_lines(), ja.plot().get_lines())
    flat = np.asarray(a.plot_raos()).ravel()
    assert flat.shape == (6,) and all(len(ax.get_lines()) == 2 for ax in flat)
    assert flat[0].get_legend() is not None
    resp = a.results["response"]
    np.testing.assert_array_equal(flat[2].get_lines()[1].get_ydata(),
                                  resp["RAO magnitude"][1, :, 2])


def test_run_raft_with_plot():
    res = run_raft(OC3, plot=True, w=W, device="cpu")
    assert res["response"]["converged"]
    assert len(plt.gcf().axes) == 1 and len(plt.gca().get_lines()) > 0
