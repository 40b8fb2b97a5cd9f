"""The port's panel solve (``torch_bem.solve_panels``) against the JAX
package's ``jax_bem.solve_panels(assembly="pallas")`` in f64, at a water
depth of 35 m (both frequencies take the four-image finite-depth branch).

The JAX package's 64-panel test cylinder with a waterplane lid, 2
frequencies and 2 headings; both packages get the same padded mesh, the
same finite-depth fit arrays and the JAX package's wave tables (carried
across with ``convert.wave_tables``).  A, B, F agree to 1e-9
scale-relative (the two factorizations differ: a blocked pure-jnp LU
against LAPACK's, each followed by two refinement steps); the refined
residual is below 1e-10."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import mesh as jmesh
from raft_tpu.hydro import wavetable as jwt

from raft_tpu_torch import convert
from raft_tpu_torch.hydro import torch_bem

DEPTH = 35.0
W = np.array([0.7, 1.3])
BETAS = np.array([0.0, 0.6])
TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_cache(monkeypatch, tmp_path):
    """Each test solves into a result cache of its own, so no result of an
    earlier run is read back."""
    monkeypatch.setenv("RAFT_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))


def _case():
    hull = jmesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                             rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)
    lid = jmesh.disk_panels([0.0, 0.0, 0.0], 1.15, da_max=1.3)
    return hull, lid


def test_solve_panels_matches_jax_finite_depth():
    hull, lid = _case()
    padded, pm, lm = jax_bem._pad_mesh(hull, lid)
    fd = jwt.fd_fit_grid(W, DEPTH if DEPTH > 0 else -1.0, 9.81)
    assert list(fd["active"]) == [1.0, 1.0]
    tab = convert.wave_tables(jwt.load_tables())
    ref = jax_bem.solve_panels(
        jnp.asarray(padded), jnp.asarray(pm), jnp.asarray(lm), jnp.asarray(W),
        jnp.asarray(BETAS), {k: jnp.asarray(v) for k, v in fd.items()},
        {k: jnp.asarray(tab[k]) for k in ("I0", "I1")}, depth=DEPTH,
        finite_depth=DEPTH > 0, dtype=jnp.float64, assembly="pallas")
    staged = torch_bem.stage_inputs(padded, pm, lm, W, BETAS, fd, finite_depth=DEPTH > 0,
                                    dtype=torch.float64, device="cpu")
    A, B, F, resid = torch_bem.solve_panels(**staged,
                                            tab=torch_bem.stage_tables(tab, torch.float64, "cpu"),
                                            depth=DEPTH, finite_depth=DEPTH > 0,
                                            dtype=torch.float64, device="cpu")
    assert A.shape == (2, 6, 6) and F.re.shape == (2, 2, 6) and resid.shape == (2,)
    for got, want in ((A, ref[0]), (B, ref[1]), (F.re, ref[2].re), (F.im, ref[2].im)):
        assert bool(torch.isfinite(got).all())
        assert torch_bem.parity_err(got.numpy(), np.asarray(want)) <= TOL
    assert float(resid.max()) < 1e-10


def test_solve_bem_layout_and_float32_finite_depth(monkeypatch):
    """``solve_bem_jax`` returns the JAX package's host layout (A[6, 6, nw],
    F[6, nw] for one heading, F[nb, 6, nw] for a grid), and, on the hull
    without its lid, the float32 solve stays within PARITY_RTOL of the
    float64 one.  (With this small lid the float32 system is ill-conditioned:
    the JAX package's own float32 solve differs from its float64 one by
    5.7e-2 in F there, as the port's does.)"""
    hull, lid = _case()
    tab = convert.wave_tables(jwt.load_tables())
    monkeypatch.setattr(torch_bem.wavetable, "load_tables", lambda: tab)
    A, B, F, info = torch_bem.solve_bem_jax(hull, W, beta=BETAS, depth=DEPTH, lid=lid,
                                            device="cpu", return_diagnostics=True)
    assert A.shape == (6, 6, 2) and B.shape == (6, 6, 2) and F.shape == (2, 6, 2)
    assert info["padded"] == 64 and info["lid"] == 12 and info["max_residual"] < 1e-10
    A1, B1, F1 = torch_bem.solve_bem_any(hull, W, beta=0.6, depth=DEPTH, lid=lid, mode="jax",
                                         device="cpu")
    assert F1.shape == (6, 2)
    np.testing.assert_allclose(F1, F[1], rtol=1e-12, atol=1e-12 * np.abs(F).max())
    want = torch_bem.solve_bem_jax(hull, W, beta=BETAS, depth=DEPTH, device="cpu")
    got = torch_bem.solve_bem_jax(hull, W, beta=BETAS, depth=DEPTH, dtype=torch.float32,
                                  device="cpu")
    for got, want in zip(got, want):
        assert torch_bem.parity_err(got, want) <= torch_bem.PARITY_RTOL
