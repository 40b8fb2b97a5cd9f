"""The port's 16-turbine farm (``Model(nTurbines=16)`` with a staged BEM
tuple) on CPU in float64: eigen in one batched fixed point, the mooring
equilibrium, stiffness and tensions in one batched Newton over the turbine
axis (``array._moor_solve_batch``), against the JAX package's farm at 1e-10
scale-relative; identical co-located turbines give identical rows, and the
eigen equals the single-turbine ``Model`` with the same BEM tuple.  The
batched Newton against the per-turbine loop is in
``tests/test_torch_array_farm_loop.py``.
"""
import numpy as np

import raft_tpu.solve as jax_solve
from raft_tpu.model import Model as JaxModel

from raft_tpu_torch.model import Model, load_design

OC3 = "raft_tpu/designs/OC3spar.yaml"
W = np.arange(0.05, 3.0, 0.25)
TOL = 1e-10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bem():
    nw = len(W)
    A = np.zeros((6, 6, nw))
    for i in range(6):
        A[i, i] = 5e6 * (1e3 if i >= 3 else 1.0) / (1 + W**2)
    return A, np.zeros((6, 6, nw)), np.zeros((6, nw), dtype=complex)


def _farm(M, **kw):
    a = M(load_design(OC3), w=W, nTurbines=16, BEM=_bem(), **kw)
    a.setEnv(Hs=8.0, Tp=12.0, Fthrust=800e3)
    a.calcSystemProps()
    a.solveEigen()
    a.calcMooringAndOffsets()
    return a


def test_farm16_batched_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_solve, "eigen_with_bem_batched",
                        jax_solve.eigen_with_bem_batched.__wrapped__)
    a = _farm(Model, device="cpu")
    j = _farm(JaxModel)
    assert a._moor_batchable()
    fa = a.results["eigen"]["frequencies"]
    r6 = a.results["means"]["platform offset"]
    C = a.C_moor.numpy()
    T = np.stack(a.results["means"]["fairlead tensions"])
    assert fa.shape == (16, 6) and r6.shape == (16, 6) and C.shape == (16, 6, 6)
    assert _rel(fa, j.results["eigen"]["frequencies"]) <= TOL
    assert _rel(a.results["eigen"]["estimates"], j.results["eigen"]["estimates"]) <= TOL
    assert _rel(r6, j.results["means"]["platform offset"]) <= TOL
    assert _rel(C, np.asarray(j.C_moor)) <= TOL
    assert _rel(a.C_moor0.numpy(), np.asarray(j.C_moor0)) <= TOL
    assert _rel(T, np.stack(j.results["means"]["fairlead tensions"])) <= TOL
    for arr in (fa, r6, C, T):
        np.testing.assert_allclose(arr, np.broadcast_to(arr[:1], arr.shape), rtol=1e-12,
                                   atol=1e-12 * np.abs(arr).max())
    m1 = Model(load_design(OC3), w=W, BEM=_bem(), device="cpu")
    m1.setEnv(Hs=8.0, Tp=12.0)
    m1.calcSystemProps()
    m1.solveEigen()
    assert _rel(fa[0], m1.results["eigen"]["frequencies"]) <= TOL
