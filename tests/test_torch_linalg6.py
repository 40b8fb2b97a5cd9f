"""Parity of the port's plain fused RAO solve (the CPU version of kernel K1)
with the JAX package: ``raft_tpu.core.linalg6.solve_cx_fused`` and the Pallas
kernel ``raft_tpu.core.pallas6.solve_rao_pallas`` in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.  The
tolerance is atol 1e-13 in float64 (the JAX package's own bound between its
two routes, tests/test_pallas6.py).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from raft_tpu.core import linalg6 as jlin
from raft_tpu.core.cplx import Cx as JCx
from raft_tpu.core.pallas6 import solve_rao_pallas

from raft_tpu_torch.core import cuda6, linalg6
from raft_tpu_torch.core.cplx import Cx

ATOL = 1e-13


def _case(kind: str, rng):
    """(Z0re, Z0im, w, B_drag, Fre, Fim) numpy arrays for a (B, nw) batch."""
    B, nw = 3, 16
    w = np.linspace(0.05, 2.95, nw)
    Bd = 0.2 * rng.normal(size=(B, 6, 6))
    if kind == "random":
        Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
        Zi = rng.normal(size=(B, nw, 6, 6))
    elif kind == "pivot_stressed":
        # tiny diagonal under a large permuted off-diagonal: every step pivots
        perm = rng.permutation(6)
        P = np.eye(6)[perm]
        Zr = 1e-6 * rng.normal(size=(B, nw, 6, 6)) + 10.0 * P + 0.1 * rng.normal(size=(B, nw, 6, 6))
        Zi = 0.1 * rng.normal(size=(B, nw, 6, 6))
    elif kind == "tie":
        # +-1 entries and w = 0: exact magnitude ties in the first column,
        # so the pivot rule (lowest row on a tie) decides
        Zr = np.sign(rng.normal(size=(B, nw, 6, 6)))
        Zi = np.zeros((B, nw, 6, 6))
        w = np.zeros(nw)
    elif kind == "zero_pivot":
        # a permutation matrix at w = 0: the first pivot candidate is 0
        P = np.zeros((6, 6))
        P[np.arange(6), (np.arange(6) + 1) % 6] = 1.0
        Zr = np.broadcast_to(P, (B, nw, 6, 6)).copy()
        Zi = np.zeros((B, nw, 6, 6))
        w = np.zeros(nw)
    else:  # ragged: a lane count that is no multiple of the Pallas block
        B, nw = 5, 37
        w = np.linspace(0.05, 2.95, nw)
        Bd = 0.2 * rng.normal(size=(B, 6, 6))
        Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
        Zi = rng.normal(size=(B, nw, 6, 6))
    Fr = rng.normal(size=(B, nw, 6))
    Fi = rng.normal(size=(B, nw, 6))
    return Zr, Zi, w, Bd, Fr, Fi


def _port(args):
    Zr, Zi, w, Bd, Fr, Fi = (torch.as_tensor(a) for a in args)
    return Cx(Zr, Zi), w, Bd, Cx(Fr, Fi)


def _jax(args):
    Zr, Zi, w, Bd, Fr, Fi = (jnp.asarray(a) for a in args)
    return JCx(Zr, Zi), w, Bd, JCx(Fr, Fi)


@pytest.mark.parametrize("kind", ["random", "pivot_stressed", "tie", "zero_pivot", "ragged"])
def test_plain_fused_solve_matches_jax_routes(kind):
    args = _case(kind, np.random.default_rng(["random", "pivot_stressed", "tie",
                                              "zero_pivot", "ragged"].index(kind)))
    x = linalg6.solve_cx_fused(*_port(args))
    Z0, w, Bd, F = _jax(args)
    x_xla = jlin.solve_cx_fused(Z0, w, Bd, F)
    # the Pallas wrapper broadcasts B_drag over the frequency axis itself
    x_pal = solve_rao_pallas(Z0, w, Bd, F)
    for ref in (x_xla, x_pal):
        np.testing.assert_allclose(x.re.numpy(), np.asarray(ref.re), rtol=0, atol=ATOL)
        np.testing.assert_allclose(x.im.numpy(), np.asarray(ref.im), rtol=0, atol=ATOL)
    assert np.isfinite(x.re.numpy()).all() and np.isfinite(x.im.numpy()).all()


def test_zero_pivot_solution_is_exact():
    """P x = F with a permutation P: the pivoted elimination is exact."""
    args = _case("zero_pivot", np.random.default_rng(7))
    x = linalg6.solve_cx_fused(*_port(args))
    np.testing.assert_array_equal(x.re.numpy(), np.roll(args[4], 1, axis=-1))
    np.testing.assert_array_equal(x.im.numpy(), np.roll(args[5], 1, axis=-1))


def test_singular_lane_takes_the_zero_denominator_guard():
    """A lane with an exactly zero pivot solves to finite values (the
    denominator is replaced by 1), identical to the JAX route."""
    args = list(_case("random", np.random.default_rng(11)))
    args[0][0, 0] = np.diag([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    args[1][0, 0] = 0.0
    args[2] = args[2].copy()
    args[2][0] = 0.0
    x = linalg6.solve_cx_fused(*_port(args))
    ref = jlin.solve_cx_fused(*_jax(args))
    assert x.re[0, 0, 2] == 0.0 and x.im[0, 0, 2] == 0.0
    np.testing.assert_allclose(x.re.numpy(), np.asarray(ref.re), rtol=0, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """cuda6.solve_rao on CPU tensors is the plain version and launches no
    kernel; a wrong shape or dtype is refused on either device."""
    monkeypatch.setattr(cuda6, "LAUNCHES", dict.fromkeys(cuda6.LAUNCHES, 0))
    Z0, w, Bd, F = _port(_case("random", np.random.default_rng(3)))
    x = cuda6.solve_rao(Z0, w, Bd, F)
    ref = linalg6.solve_cx_fused(Z0, w, Bd, F)
    assert torch.equal(x.re, ref.re) and torch.equal(x.im, ref.im)
    assert set(cuda6.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        cuda6.solve_rao(Z0, w[:-1], Bd, F)
    with pytest.raises(ValueError):
        cuda6.solve_rao(Z0, w.float(), Bd, F)
    with pytest.raises(ValueError):
        cuda6.solve_rao(Z0, w, Bd.transpose(-1, -2), F)


def test_generalized_eigh_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 6, 6))
    K = A @ np.swapaxes(A, -1, -2) + np.eye(6)
    Bm = rng.normal(size=(4, 6, 6))
    M = Bm @ np.swapaxes(Bm, -1, -2) + 6.0 * np.eye(6)
    lam, X = linalg6.generalized_eigh(torch.as_tensor(K), torch.as_tensor(M))
    lam_j, X_j = jlin.generalized_eigh(jnp.asarray(K), jnp.asarray(M))
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), rtol=1e-12)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_j), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(X_j)).max())


def test_cx_algebra_matches_jax():
    """The (re, im) pair algebra, including einsum over 0, 1 and 2 complex
    operands, equals the JAX package's ``Cx`` plane by plane."""
    from raft_tpu.core import cplx as jcplx
    from raft_tpu_torch.core import cplx

    rng = np.random.default_rng(8)
    a, b, c, d, r = (rng.normal(size=(3, 4)) for _ in range(5))
    ja, jb = JCx(jnp.asarray(a), jnp.asarray(b)), JCx(jnp.asarray(c), jnp.asarray(d))
    ta, tb = Cx(torch.as_tensor(a), torch.as_tensor(b)), Cx(torch.as_tensor(c), torch.as_tensor(d))
    pairs = [
        (ta * tb - tb + ta.mul_i() * 2.0, ja * jb - jb + ja.mul_i() * 2.0),
        (cplx.where(torch.as_tensor(r > 0), ta, tb), jcplx.where(jnp.asarray(r > 0), ja, jb)),
        (cplx.einsum("ij,kj->ik", ta, tb), jcplx.einsum("ij,kj->ik", ja, jb)),
        (cplx.einsum("ij,kj->ik", ta, torch.as_tensor(r)), jcplx.einsum("ij,kj->ik", ja, jnp.asarray(r))),
        (cplx.einsum("ij,kj->ik", torch.as_tensor(a), torch.as_tensor(r)),
         jcplx.einsum("ij,kj->ik", jnp.asarray(a), jnp.asarray(r))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.re.numpy(), np.asarray(ref.re), rtol=1e-15, atol=1e-15)
        np.testing.assert_allclose(got.im.numpy(), np.asarray(ref.im), rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(ta.abs().numpy(), np.asarray(ja.abs()), rtol=1e-15)
    np.testing.assert_array_equal(ta.to_complex(), ja.to_complex())
