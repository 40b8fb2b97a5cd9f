"""The port's scan loop (``method="scan"``) against the JAX package.

* ``solve_dynamics(method="scan")`` on OC3 at 24 frequencies against the
  JAX package's scan loop: Xi to 1e-12 scale-relative and identical
  iteration counts, plain and with ``history`` and ``tik``;
* the scan and while loops give identical results on a design batch,
  converged lanes and capped lanes alike;
* the gradient through the scan loop against ``jax.grad`` through the
  JAX package's (1e-9), and ``remat`` leaves it unchanged (1e-12, the JAX
  package's own bound in tests/test_optimize.py);
* ``Model.solveDynamics(method="scan")`` equals the while loop.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from raft_tpu.core.cplx import Cx as JCx
from raft_tpu.hydro import strip as jstrip
from raft_tpu.solve import LinearCoeffs as JLin, solve_dynamics as jax_solve
from raft_tpu.statics import assemble_statics as jax_statics

from raft_tpu_torch import convert
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
from raft_tpu_torch.parallel.sweep import forward_response, north_star_grid
from raft_tpu_torch.solve.dynamics import LinearCoeffs, solve_dynamics

from test_torch_dynamics import _scale_rel, _stage

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oc3():
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = _stage("OC3spar", 24)
    s = jax_statics(jm, jrna, jenv)
    kin = jstrip.node_kinematics(jm, jwave, jenv)
    nw = jwave.w.shape[0]
    M = jnp.broadcast_to(s.M_struc + jstrip.strip_added_mass(jm, jenv), (nw, 6, 6))
    lin = JLin(M=M, B=jnp.zeros((nw, 6, 6)), C=s.C_struc + s.C_hydro + C,
               F=jstrip.strip_excitation(jm, kin, jenv))
    tlin = convert.from_numpy("LinearCoeffs", convert.to_numpy(lin), "cpu")
    tkin = convert.from_numpy("StripKin", convert.to_numpy(kin), "cpu")
    return (jm, kin, jwave, jenv, lin), (tm, tkin, twave, tenv, tlin)


@pytest.mark.parametrize("history,tik", [(False, 0.0), (True, 0.0), (False, 0.05)])
def test_scan_matches_jax_scan(oc3, history, tik):
    (jm, kin, jwave, jenv, lin), (tm, tkin, twave, tenv, tlin) = oc3
    ref = jax_solve(jm, kin, jwave, jenv, lin, n_iter=25, method="scan", history=history,
                    tik=tik)
    got = solve_dynamics(tm, tkin, twave, tenv, tlin, n_iter=25, method="scan",
                         history=history, tik=tik)
    assert int(got.n_iter) == int(ref.n_iter) and bool(got.converged) == bool(ref.converged)
    assert bool(got.converged)
    assert _scale_rel(got.Xi.re.numpy(), ref.Xi.re) <= TOL
    assert _scale_rel(got.Xi.im.numpy(), ref.Xi.im) <= TOL
    if history:
        np.testing.assert_allclose(got.err_hist.numpy(), np.asarray(ref.err_hist),
                                   rtol=1e-8, equal_nan=True)
        assert np.isnan(got.err_hist.numpy()[int(got.n_iter):]).all()


@pytest.mark.parametrize("n_iter", [40, 3])
def test_scan_equals_while_on_a_design_batch(n_iter):
    """Eight VolturnUS-S variants: at n_iter 40 every lane converges, at 3
    none does; either way the two loops agree lane by lane."""
    _, (tm, trna, tenv, twave, tC) = _stage("VolturnUS-S", 24)
    th = torch.as_tensor(north_star_grid(8))
    m = make_scale_plan(tm)(make_stretch_draft(tm)(tm, th[:, 1]), th[:, 0])
    outs = [forward_response(m, trna, tenv, twave, tC, n_iter=n_iter, method=method,
                             device="cpu") for method in ("while", "scan")]
    a, b = outs
    assert torch.equal(a.n_iter, b.n_iter) and torch.equal(a.converged, b.converged)
    assert bool(a.converged.all()) == (n_iter == 40)
    assert torch.equal(a.Xi.re, b.Xi.re) and torch.equal(a.Xi.im, b.Xi.im)


def test_scan_gradient_matches_jax_and_remat(oc3):
    """d sum|Xi|^2 / d (excitation scale and stiffness) through the scan
    loop: the adjoint K1 rule in every step against jax.grad through the
    JAX package's scan, and remat=True against remat=False."""
    (jm, kin, jwave, jenv, lin), (tm, tkin, twave, tenv, tlin) = oc3

    def jloss(scale, cscale):
        lin2 = lin.replace(F=JCx(lin.F.re * scale, lin.F.im * scale), C=lin.C * cscale)
        o = jax_solve(jm, kin, jwave, jenv, lin2, n_iter=25, method="scan")
        return jnp.sum(o.Xi.abs2())

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(1.0), jnp.asarray(1.0))
    grads = []
    for remat in (False, True):
        s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        c = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        lin2 = LinearCoeffs(M=tlin.M, B=tlin.B, C=tlin.C * c,
                            F=Cx(tlin.F.re * s, tlin.F.im * s))
        o = solve_dynamics(tm, tkin, twave, tenv, lin2, n_iter=25, method="scan", remat=remat)
        grads.append(torch.autograd.grad(torch.sum(o.Xi.abs2()), (s, c)))
    for got in grads:
        for g, r in zip(got, ref):
            assert np.isfinite(float(g))
            np.testing.assert_allclose(float(g), float(r), rtol=1e-9)
    for g0, g1 in zip(*grads):
        np.testing.assert_allclose(float(g1), float(g0), rtol=TOL)


def test_model_solve_dynamics_scan_equals_while():
    from raft_tpu_torch.model import Model, load_design

    design = load_design("raft_tpu/designs/OC3spar.yaml")
    res = []
    for method in ("while", "scan"):
        m = Model(design, w=np.linspace(0.05, 2.95, 24), device="cpu")
        m.setEnv(Hs=8.0, Tp=12.0)
        m.calcSystemProps()
        m.solveDynamics(nIter=25, method=method)
        res.append(m.results["response"])
    a, b = res
    assert a["iterations"] == b["iterations"] and a["converged"] and b["converged"]
    np.testing.assert_array_equal(a["Xi"], b["Xi"])
    np.testing.assert_array_equal(a["std dev"], b["std dev"])
