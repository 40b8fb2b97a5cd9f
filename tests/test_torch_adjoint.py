"""The port's adjoint solves against ``jax.grad`` in the JAX package.

``cuda6.solve_cx_ad`` and ``cuda6.solve_rao_ad`` (on CPU tensors their
forward and their adjoint solve are the plain versions of kernels K2 and
K1) against reverse mode through the JAX package's ``custom_vjp`` wrappers
``solve_cx_pallas_ad`` / ``solve_rao_pallas_ad`` (the Pallas kernels in
interpret mode) and through its XLA eliminations ``linalg6.solve_cx`` /
``solve_cx_fused``.  The loss weights re and im asymmetrically so that a
conjugation or a re/im swap in the pair algebra cannot cancel out.
Tolerance rtol 1e-9, atol 1e-11: the JAX package's own bound between its
adjoint and its differentiated elimination (tests/test_pallas6.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from raft_tpu.core import linalg6 as jlin
from raft_tpu.core.cplx import Cx as JCx
from raft_tpu.core.pallas6 import solve_cx_pallas_ad, solve_rao_pallas_ad

from raft_tpu_torch.core import cuda6, linalg6
from raft_tpu_torch.core.cplx import Cx

RTOL, ATOL = 1e-9, 1e-11


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_np(xr, xi, mod):
    return mod.sum(xr**2 + 0.7 * xi**2 + 0.3 * xr * xi)


def _plain_systems(rng, lead):
    Ar = rng.normal(size=lead + (6, 6)) + 6.0 * np.eye(6)
    Ai = rng.normal(size=lead + (6, 6))
    return Ar, Ai, rng.normal(size=lead + (6,)), rng.normal(size=lead + (6,))


def _rao_systems(rng, B, nw):
    Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
    Zi = rng.normal(size=(B, nw, 6, 6))
    w = np.linspace(0.05, 2.95, nw)
    Bd = 0.3 * rng.normal(size=(B, 6, 6))
    return Zr, Zi, w, Bd, rng.normal(size=(B, nw, 6)), rng.normal(size=(B, nw, 6))


def _torch_grads(fn, arrays):
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    x = fn(*ts)
    _loss_np(x.re, x.im, torch).backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("lead", [(96,), (4, 24)])
def test_solve_cx_ad_matches_jax(lead):
    arrays = _plain_systems(np.random.default_rng(3), lead)
    got = _torch_grads(lambda ar, ai, br, bi: cuda6.solve_cx_ad(Cx(ar, ai), Cx(br, bi)), arrays)

    def make_loss(solver):
        def loss(ar, ai, br, bi):
            x = solver(JCx(ar, ai), JCx(br, bi))
            return _loss_np(x.re, x.im, jnp)
        return loss

    j = [jnp.asarray(a) for a in arrays]
    for solver in (solve_cx_pallas_ad, jlin.solve_cx):
        ref = jax.grad(make_loss(solver), argnums=(0, 1, 2, 3))(*j)
        for g, r, name in zip(got, ref, ("A.re", "A.im", "b.re", "b.im")):
            np.testing.assert_allclose(g, np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)


def test_solve_rao_ad_matches_jax():
    """A (B, nw) design batch: cotangents of Z0, the shared w (reduced over
    the designs), the per-design B_drag (reduced over the frequencies) and
    F, against both JAX routes."""
    arrays = _rao_systems(np.random.default_rng(12), 3, 32)
    got = _torch_grads(lambda zr, zi, w, bd, fr, fi: cuda6.solve_rao_ad(
        Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
    assert got[2].shape == (32,) and got[3].shape == (3, 6, 6)

    def make_loss(solver):
        def loss(zr, zi, w, bd, fr, fi):
            x = solver(JCx(zr, zi), w, bd, JCx(fr, fi))
            return _loss_np(x.re, x.im, jnp)
        return loss

    j = [jnp.asarray(a) for a in arrays]
    for solver in (solve_rao_pallas_ad, jlin.solve_cx_fused):
        ref = jax.grad(make_loss(solver), argnums=tuple(range(6)))(*j)
        for g, r, name in zip(got, ref, ("Z0.re", "Z0.im", "w", "B_drag", "F.re", "F.im")):
            np.testing.assert_allclose(g, np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)


def test_adjoint_matches_autograd_through_the_plain_elimination():
    """The analytic rule against torch autograd through the port's own
    plain elimination, on a pivot-stressed batch (every step pivots)."""
    rng = np.random.default_rng(4)
    P = np.eye(6)[rng.permutation(6)]
    Zr = 1e-3 * rng.normal(size=(2, 16, 6, 6)) + 10.0 * P
    Zi = 0.1 * rng.normal(size=(2, 16, 6, 6))
    w, Bd = np.linspace(0.05, 2.95, 16), 0.3 * rng.normal(size=(2, 6, 6))
    arrays = (Zr, Zi, w, Bd, rng.normal(size=(2, 16, 6)), rng.normal(size=(2, 16, 6)))
    got = _torch_grads(lambda zr, zi, w, bd, fr, fi: cuda6.solve_rao_ad(
        Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
    ref = _torch_grads(lambda zr, zi, w, bd, fr, fi: linalg6.solve_cx_fused(
        Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def test_needs_input_grad_and_one_sided_cotangents():
    """Only the inputs that need a gradient get one; a loss on x.re alone
    (a zero cotangent for x.im) still gives the JAX package's cotangents."""
    Zr, Zi, w, Bd, Fr, Fi = (torch.as_tensor(a) for a in
                             _rao_systems(np.random.default_rng(5), 2, 8))
    F = Cx(Fr.clone().requires_grad_(True), Fi.clone().requires_grad_(True))
    x = cuda6.solve_rao_ad(Cx(Zr, Zi), w, Bd, F)
    x.re.sum().backward()
    assert F.re.grad is not None and F.im.grad is not None

    def loss(fr, fi):
        return jlin.solve_cx_fused(JCx(jnp.asarray(Zr.numpy()), jnp.asarray(Zi.numpy())),
                                   jnp.asarray(w.numpy()), jnp.asarray(Bd.numpy()),
                                   JCx(fr, fi)).re.sum()

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(Fr.numpy()), jnp.asarray(Fi.numpy()))
    np.testing.assert_allclose(F.re.grad.numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(F.im.grad.numpy(), np.asarray(ref[1]), rtol=RTOL, atol=ATOL)


def test_solve_cx_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """cuda6.solve_cx on CPU tensors is linalg6.solve_cx and launches no
    kernel; wrong shapes, dtypes, strides and devices are refused."""
    monkeypatch.setattr(cuda6, "LAUNCHES", dict.fromkeys(cuda6.LAUNCHES, 0))
    Ar, Ai, br, bi = (torch.as_tensor(a) for a in
                      _plain_systems(np.random.default_rng(6), (5, 7)))
    x = cuda6.solve_cx(Cx(Ar, Ai), Cx(br, bi))
    ref = linalg6.solve_cx(Cx(Ar, Ai), Cx(br, bi))
    assert torch.equal(x.re, ref.re) and torch.equal(x.im, ref.im)
    xa = cuda6.solve_cx_ad(Cx(Ar.requires_grad_(True), Ai), Cx(br, bi))
    xa.re.sum().backward()
    assert torch.equal(xa.re.detach(), ref.re)
    assert set(cuda6.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        cuda6.solve_cx(Cx(Ar, Ai), Cx(br[..., :5], bi[..., :5]))
    with pytest.raises(ValueError):
        cuda6.solve_cx(Cx(Ar, Ai.float()), Cx(br, bi))
    with pytest.raises(ValueError):
        cuda6.solve_cx(Cx(Ar.detach().transpose(-1, -2), Ai), Cx(br, bi))
    meta = Cx(torch.empty(3, 6, 6, device="meta", dtype=torch.float64),
              torch.empty(3, 6, 6, device="meta", dtype=torch.float64))
    rhs = Cx(torch.empty(3, 6, device="meta", dtype=torch.float64),
             torch.empty(3, 6, device="meta", dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel"):
        cuda6.solve_cx(meta, rhs)
