"""The port's BEM eigen fixed point (``solve.eigen.eigen_with_bem_batched``)
against the JAX package's, at the default three passes.

Each pass interpolates the BEM added mass A(w) at every mode's current
natural frequency, re-solves, and takes mode i from the solve assembled
at its own frequency.  Inputs are seeded: 3 designs of symmetric mass and
stiffness whose natural frequencies fall inside the 24-frequency grid,
and an added-mass table that varies with w, so the later passes move the
answer.  Frequencies, estimates, modes and the mode order agree to 1e-9.

The JAX function's body runs through ``__wrapped__``: its jitted
``solve_eigen`` and ``diagonal_estimates`` then compile once and serve
every pass (about 20 s on the CPU), where jitting the whole three-pass
function compiles for about 50 s.  Here both give bit-identical results.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.solve import eigen as jeigen

from raft_tpu_torch.solve import eigen

TOL = 1e-9
NT, NW = 3, 24


def _inputs():
    rng = np.random.default_rng(7)
    w_grid = np.linspace(0.05, 2.5, NW)
    mass = np.array([1.5e7, 1.5e7, 1.5e7, 1.2e10, 1.2e10, 2.0e10])
    wn = np.array([0.06, 0.07, 0.3, 0.2, 0.22, 0.09]) * 2 * np.pi     # rad/s
    M_base, C_tot = [], []
    for _ in range(NT):
        s = np.sqrt(mass) * (1.0 + 0.05 * rng.random(6))
        G = 0.05 * rng.normal(size=(6, 6))
        Q = np.eye(6) + 0.5 * (G + G.T)
        M_base.append(s[:, None] * Q * s[None, :])
        H = 0.05 * rng.normal(size=(6, 6))
        Qc = np.eye(6) + 0.5 * (H + H.T)
        k = s * wn * (1.0 + 0.1 * rng.random(6))
        C_tot.append(k[:, None] * Qc * k[None, :])
    G = rng.normal(size=(6, 6))
    A0 = 0.3 * np.sqrt(mass)[:, None] * (np.eye(6) + 0.1 * (G + G.T)) * np.sqrt(mass)[None, :]
    A_w = np.stack([A0 * (1.0 + 0.4 * np.sin(1.7 * w) + 0.2 * w) for w in w_grid])
    return np.stack(M_base), np.stack(C_tot), A_w, w_grid


@pytest.mark.parametrize("n_pass", [3, 1])
def test_eigen_with_bem_batched_matches_jax(n_pass):
    M_base, C_tot, A_w, w_grid = _inputs()
    ref, ref_est = jeigen.eigen_with_bem_batched.__wrapped__(
        jnp.asarray(M_base), jnp.asarray(C_tot), jnp.asarray(A_w), jnp.asarray(w_grid),
        n_pass=n_pass)
    got, est = eigen.eigen_with_bem_batched(
        torch.as_tensor(M_base), torch.as_tensor(C_tot), torch.as_tensor(A_w),
        torch.as_tensor(w_grid), n_pass=n_pass)
    assert got.wns.shape == (NT, 6) and got.modes.shape == (NT, 6, 6) and est.shape == (NT, 6)
    assert bool(((got.wns > w_grid[0]) & (got.wns < w_grid[-1])).all())
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order))
    np.testing.assert_allclose(got.wns.numpy(), np.asarray(ref.wns), rtol=TOL)
    np.testing.assert_allclose(got.fns.numpy(), np.asarray(ref.fns), rtol=TOL)
    np.testing.assert_allclose(est.numpy(), np.asarray(ref_est), rtol=TOL)
    np.testing.assert_allclose(got.modes.numpy(), np.asarray(ref.modes), rtol=0, atol=TOL)


def test_eigen_with_bem_passes_move_the_answer():
    """The added mass varies enough over the grid that the second and third
    passes change the frequencies; the single-design form gives the batch's
    first lane (to roundoff: batched and single reductions may round apart)."""
    M_base, C_tot, A_w, w_grid = (torch.as_tensor(a) for a in _inputs())
    one, _ = eigen.eigen_with_bem_batched(M_base, C_tot, A_w, w_grid, n_pass=1)
    three, est = eigen.eigen_with_bem_batched(M_base, C_tot, A_w, w_grid, n_pass=3)
    assert float((one.wns - three.wns).abs().max() / three.wns.abs().max()) > 1e-3
    single, est0 = eigen.eigen_with_bem(M_base[0], C_tot[0], A_w, w_grid)
    for a, b in ((single.wns, three.wns[0]), (single.modes, three.modes[0]), (est0, est[0])):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
