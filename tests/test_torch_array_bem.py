"""The port's arrays with BEM coefficients (``raft_tpu_torch.array.
ArrayModel``) on CPU in float64: a staged (A, B, F) tuple shared by two
turbines against the JAX package's ``ArrayModel`` at 1e-10 scale-relative
(eigen with the added mass at each mode's frequency, response with each
turbine's phased BEM excitation, identical iterations) and against the
single-turbine ``Model``; and a heading grid solved once (``calcBEM(
headings=...)``, the panel solve's plain route on the CPU) and re-staged by
``setEnv(beta=...)`` without a second solve.

The JAX side's ``eigen_with_bem_batched`` runs through ``__wrapped__`` (as
in ``tests/test_torch_bem_eigen.py``): same results, about 20 s of
compilation on the CPU instead of about 70 s.
"""
import numpy as np
import pytest
import torch

import raft_tpu.solve as jax_solve
from raft_tpu.model import Model as JaxModel

from raft_tpu_torch.array import ArrayModel
from raft_tpu_torch.model import Model, load_design

OC3 = "raft_tpu/designs/OC3spar.yaml"
W = np.arange(0.05, 3.0, 0.25)
TOL = 1e-10
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run(model, eigen=True, **dyn):
    model.setEnv(Hs=8.0, Tp=12.0, Fthrust=800e3)
    model.calcSystemProps()
    if eigen:
        model.solveEigen()
    model.calcMooringAndOffsets()
    model.solveDynamics(**dyn)
    return model


def _bem_tuple(seed=3, excite=True):
    nw = len(W)
    A = np.zeros((6, 6, nw))
    for i in range(6):
        A[i, i] = 5e6 * (1e3 if i >= 3 else 1.0) / (1 + W**2)
    rng = np.random.default_rng(seed)
    F = ((rng.normal(size=(6, nw)) + 1j * rng.normal(size=(6, nw))) * 1e5 if excite
         else np.zeros((6, nw), dtype=complex))
    return A, np.zeros((6, 6, nw)), F


def test_array_with_staged_bem_tuple_matches_jax_and_single(monkeypatch):
    """A staged (A, B, F) tuple shared by two turbines: the JAX package at
    1e-10 (eigen at each mode's frequency, response with the phased BEM
    excitation), turbine 0 equal to the single BEM model."""
    monkeypatch.setattr(jax_solve, "eigen_with_bem_batched",
                        jax_solve.eigen_with_bem_batched.__wrapped__)
    design = load_design(OC3)
    bem = _bem_tuple()
    kw = dict(w=W, nTurbines=2, BEM=bem, positions=[[0.0, 0.0], [500.0, 0.0]])
    a = _run(Model(design, **kw, **CPU), tol=1e-4)
    j = _run(JaxModel(design, **kw), tol=1e-4)
    for section, key in (("eigen", "frequencies"), ("eigen", "estimates"),
                         ("response", "Xi per turbine"), ("response", "std dev")):
        assert _rel(a.results[section][key], j.results[section][key]) <= TOL, key
    np.testing.assert_array_equal(a.results["response"]["iterations"],
                                  j.results["response"]["iterations"])
    m1 = _run(Model(design, w=W, BEM=bem, **CPU), tol=1e-4)
    assert _rel(a.results["response"]["Xi per turbine"][0], m1.results["response"]["Xi"]) <= TOL
    assert _rel(a.results["eigen"]["frequencies"][1], m1.results["eigen"]["frequencies"]) <= TOL


def test_array_heading_grid_restages_without_resolve(monkeypatch):
    """``calcBEM(headings=[...])`` on an array solves once; ``setEnv(beta)``
    re-stages the excitation by interpolation with no second solve, marks
    the phased staging stale, and at a grid heading equals a fresh
    single-heading solve there; an out-of-grid heading raises before any
    state changes."""
    from raft_tpu_torch.hydro import torch_bem

    design = load_design(OC3)
    w = np.arange(0.2, 1.4, 0.3)
    kw = dict(positions=[[0.0, 0.0], [500.0, 0.0]], w=w, BEM="jax", **CPU)
    a = ArrayModel(design, **kw)
    a.setEnv(Hs=8.0, Tp=12.0, beta=0.0)
    calls = {"n": 0}
    real = torch_bem.solve_bem_any

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_bem, "solve_bem_any", counting)
    betas = np.deg2rad([0.0, 30.0])
    a.calcBEM(dz_max=6.0, da_max=6.0, headings=betas, cache=False)
    assert calls["n"] == 1 and a.bem_diagnostics["nw"] == len(w)
    a.calcSystemProps()
    a.solveDynamics()
    Xi0 = a.results["response"]["Xi per turbine"]
    a.setEnv(Hs=8.0, Tp=12.0, beta=float(betas[1]))
    assert calls["n"] == 1
    assert a.kin is None and a._bem_staged is None
    a.calcSystemProps()
    a.solveDynamics()
    Xi1 = a.results["response"]["Xi per turbine"]
    assert np.abs(Xi0 - Xi1).max() > 1e-6
    fresh = ArrayModel(design, **kw)
    fresh.setEnv(Hs=8.0, Tp=12.0, beta=float(betas[1]))
    fresh.calcBEM(dz_max=6.0, da_max=6.0, cache=False)
    assert calls["n"] == 2
    assert _rel(a.bem[2], fresh.bem[2]) <= TOL
    with pytest.raises(ValueError, match="outside staged grid"):
        a.setEnv(beta=1.0)
    assert float(a.env.beta) == pytest.approx(float(betas[1]))
    assert a.kin is not None
