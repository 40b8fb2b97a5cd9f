"""``Model(BEM="jax")`` of the port against the JAX package's, on OC3spar.

Both models mesh the spar coarsely (``calcBEM(dz_max=12, da_max=8)``: 48
panels, padded to the 64 class), solve it on 8 frequencies at the 320 m
water depth, and run the BEM branches of ``calcSystemProps``,
``solveEigen`` and ``solveDynamics``.  The JAX package's on-device solve
defaults to float32; it is run in float64 here (``dtype`` of its
``solve_bem_jax``), the port's in the model's float64, and the port reads
the JAX package's wave tables, so both solve the same system.  The eigen
fixed point runs one pass (``n_pass=1``): each pass of the JAX package's
compiles for about 16 s on the CPU.  Frequencies and std dev agree to
1e-9 with identical iteration counts.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu import model as jmodel
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import wavetable as jwt

from raft_tpu_torch import convert
from raft_tpu_torch.hydro import torch_bem, wavetable
from raft_tpu_torch.model import Model, interp_heading_excitation, load_design

TOL = 1e-9
W = np.linspace(0.1, 1.5, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tables(monkeypatch):
    """The port reads the JAX package's tables instead of building its own."""
    tab = convert.wave_tables(jwt.load_tables())
    monkeypatch.setattr(wavetable, "load_tables", lambda: tab)
    return tab


def _run(model):
    model.setEnv(Hs=6.0, Tp=10.0)
    model.calcBEM(dz_max=12.0, da_max=8.0)
    model.calcSystemProps()
    model.solveEigen(n_pass=1)
    model.solveDynamics()
    model.calcOutputs()
    return model


def test_model_bem_matches_jax(tables, monkeypatch):
    monkeypatch.setattr(jax_bem, "solve_bem_jax",
                        functools.partial(jax_bem.solve_bem_jax, dtype=jnp.float64))
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    ref = _run(jmodel.Model(design, w=W, BEM="jax"))
    got = _run(Model(design, w=W, BEM="jax", device="cpu"))
    assert got.bem_diagnostics["panels"] == 48 and got.bem_diagnostics["padded"] == 64
    assert got.bem_diagnostics["max_residual"] < 1e-10
    for g, r in zip(got.bem, ref.bem):
        assert torch_bem.parity_err(g, r) <= TOL
    np.testing.assert_allclose(got.results["eigen"]["frequencies"],
                               ref.results["eigen"]["frequencies"], rtol=TOL)
    np.testing.assert_allclose(got.results["eigen"]["estimates"],
                               ref.results["eigen"]["estimates"], rtol=TOL)
    r_got, r_ref = got.results["response"], ref.results["response"]
    assert r_got["iterations"] == r_ref["iterations"] and r_got["converged"]
    assert torch_bem.parity_err(r_got["std dev"], r_ref["std dev"]) <= TOL
    # the BEM branch changed the answer against strip theory alone
    strip = Model(design, w=W, device="cpu")
    strip.setEnv(Hs=6.0, Tp=10.0)
    strip.solveEigen()
    assert np.abs(strip.results["eigen"]["frequencies"]
                  - got.results["eigen"]["frequencies"]).max() > 1e-6


def test_heading_grid_restaging(tables):
    """``calcBEM(headings=...)`` solves every heading at once; ``setEnv``
    re-stages the excitation by interpolation, without a new solve, and a
    heading outside the grid raises and leaves the model as it was."""
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    m = Model(design, w=W, BEM="jax", device="cpu")
    m.setEnv(Hs=6.0, Tp=10.0, beta=0.0)
    grid = [0.5, 0.0]
    A, B, F = m.calcBEM(dz_max=12.0, da_max=8.0, headings=grid)
    betas, F_all, A_g, B_g = m._bem_headings
    np.testing.assert_array_equal(betas, [0.0, 0.5])
    assert F_all.shape == (2, 6, len(W)) and np.array_equal(F, F_all[0])
    m.setEnv(Hs=6.0, Tp=10.0, beta=0.2)
    np.testing.assert_array_equal(m.bem[2], jmodel.interp_heading_excitation(betas, F_all, 0.2))
    np.testing.assert_array_equal(m.bem[2], interp_heading_excitation(betas, F_all, 0.2))
    assert m.bem[0] is A_g and m.bem[1] is B_g
    with pytest.raises(ValueError, match="outside staged grid"):
        m.setEnv(beta=0.9)
    assert m.env.beta == 0.2
    single = Model(design, w=W, BEM="jax", device="cpu")
    single.setEnv(Hs=6.0, Tp=10.0, beta=0.5)
    _A, _B, F_half = single.calcBEM(dz_max=12.0, da_max=8.0)
    assert torch_bem.parity_err(F_half, F_all[1]) <= 1e-12
    with pytest.raises(ValueError, match="outside the requested grid"):
        single.calcBEM(dz_max=12.0, da_max=8.0, headings=[0.0, 0.3])
    # a precomputed tuple gives the same model as the solve it came from
    pre = Model(design, w=W, BEM=(A_g, B_g, F_half), device="cpu")
    pre.setEnv(Hs=6.0, Tp=10.0, beta=0.5)
    single.calcSystemProps()
    pre.calcSystemProps()
    for mm in (single, pre):
        mm.solveEigen()
        mm.solveDynamics()
    np.testing.assert_array_equal(pre.results["response"]["std dev"],
                                  single.results["response"]["std dev"])


def test_unported_and_bad_bem_modes():
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(design, BEM="native", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_bem.solve_bem_any(np.zeros((1, 4, 3)), [1.0], mode="native", device="cpu")
    with pytest.raises(ValueError, match="BEM="):
        Model(design, BEM="capytaine", device="cpu")
    m = Model(design, BEM="auto", device="cpu")
    assert m.bem_mode == "auto" and m.bem is None
