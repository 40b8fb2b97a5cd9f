"""The adjoint mode of kernels K1 and K2 (``cuda6.solve_rao_adjoint``,
``cuda6.solve_cx_adjoint``) on CPU tensors.

On the card the kernel reads ``Z0^H`` and ``-B_drag^T`` (or ``A^H``) in
place; on the CPU the wrapper builds that transposed system and hands it
to the plain version.  Here: the CPU entry is exactly the plain solve of
the system materialized by hand (difference 0) and solves the conjugate-
transposed system; the backward of ``solve_rao_ad`` / ``solve_cx_ad`` is
that entry, so its cotangents equal ``jax.grad`` through the JAX package's
Pallas wrappers (interpret mode) to 1e-9 on a pivot-stressed batch; wrong
shapes, dtypes and layouts are refused in adjoint mode as in the forward.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

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


def _rao(rng, B=3, nw=16):
    Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
    Zi = rng.normal(size=(B, nw, 6, 6))
    w = np.linspace(0.05, 2.95, nw)
    Bd = 0.3 * rng.normal(size=(B, 6, 6))
    G = (rng.normal(size=(B, nw, 6)), rng.normal(size=(B, nw, 6)))
    return [torch.as_tensor(a) for a in (Zr, Zi, w, Bd, *G)]


def test_rao_adjoint_entry_is_the_plain_solve_of_the_materialized_system(monkeypatch):
    monkeypatch.setattr(cuda6, "LAUNCHES", dict.fromkeys(cuda6.LAUNCHES, 0))
    Zr, Zi, w, Bd, Gr, Gi = _rao(np.random.default_rng(21))
    lam = cuda6.solve_rao_adjoint(Cx(Zr, Zi), w, Bd, Cx(Gr, Gi))
    ZH = Cx(Zr.transpose(-1, -2).contiguous(), (-Zi.transpose(-1, -2)).contiguous())
    ref = linalg6.solve_cx_fused(ZH, w, (-Bd.transpose(-1, -2)).contiguous(), Cx(Gr, Gi))
    assert torch.equal(lam.re, ref.re) and torch.equal(lam.im, ref.im)
    # and it is the conjugate-transposed solve: (Z0 + i w B)^H lam = G
    Z = torch.complex(Zr, Zi + w[:, None, None] * Bd[:, None])
    res = Z.conj().transpose(-1, -2) @ torch.complex(lam.re, lam.im)[..., None]
    assert float((res[..., 0] - torch.complex(Gr, Gi)).abs().max()) < 1e-12
    assert set(cuda6.LAUNCHES.values()) == {0}


def test_cx_adjoint_entry_is_the_plain_solve_of_the_materialized_system(monkeypatch):
    monkeypatch.setattr(cuda6, "LAUNCHES", dict.fromkeys(cuda6.LAUNCHES, 0))
    rng = np.random.default_rng(22)
    Ar, Ai = (torch.as_tensor(rng.normal(size=(4, 24, 6, 6)) + s * np.eye(6)) for s in (6.0, 0.0))
    br, bi = (torch.as_tensor(rng.normal(size=(4, 24, 6))) for _ in range(2))
    lam = cuda6.solve_cx_adjoint(Cx(Ar, Ai), Cx(br, bi))
    ref = linalg6.solve_cx(Cx(Ar.transpose(-1, -2).contiguous(),
                              (-Ai.transpose(-1, -2)).contiguous()), Cx(br, bi))
    assert torch.equal(lam.re, ref.re) and torch.equal(lam.im, ref.im)
    assert set(cuda6.LAUNCHES.values()) == {0}


def _pivot_stressed(rng, B, nw):
    """Every elimination step pivots: a permutation scaled up, plus noise."""
    P = np.eye(6)[rng.permutation(6)]
    Zr = 1e-3 * rng.normal(size=(B, nw, 6, 6)) + 10.0 * P
    Zi = 0.1 * rng.normal(size=(B, nw, 6, 6))
    return Zr, Zi


def _grads(fn, arrays):
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    x = fn(*ts)
    (x.re**2 + 0.7 * x.im**2 + 0.3 * x.re * x.im).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(solver, arrays):
    def loss(*a):
        x = solver(*a)
        return jnp.sum(x.re**2 + 0.7 * x.im**2 + 0.3 * x.re * x.im)

    j = [jnp.asarray(a) for a in arrays]
    return jax.grad(loss, argnums=tuple(range(len(j))))(*j)


def test_ad_cotangents_through_the_adjoint_entry_match_jax_on_a_pivoting_batch():
    rng = np.random.default_rng(23)
    Zr, Zi = _pivot_stressed(rng, 2, 12)
    arrays = (Zr, Zi, np.linspace(0.05, 2.95, 12), 0.3 * rng.normal(size=(2, 6, 6)),
              rng.normal(size=(2, 12, 6)), rng.normal(size=(2, 12, 6)))
    got = _grads(lambda zr, zi, w, bd, fr, fi: cuda6.solve_rao_ad(
        Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
    ref = _jax_grads(lambda zr, zi, w, bd, fr, fi: solve_rao_pallas_ad(
        JCx(zr, zi), w, bd, JCx(fr, fi)), arrays)
    for g, r, name in zip(got, ref, ("Z0.re", "Z0.im", "w", "B_drag", "F.re", "F.im")):
        np.testing.assert_allclose(g, np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)

    arrays = (Zr.reshape(-1, 6, 6), Zi.reshape(-1, 6, 6), rng.normal(size=(24, 6)),
              rng.normal(size=(24, 6)))
    got = _grads(lambda ar, ai, br, bi: cuda6.solve_cx_ad(Cx(ar, ai), Cx(br, bi)), arrays)
    ref = _jax_grads(lambda ar, ai, br, bi: solve_cx_pallas_ad(JCx(ar, ai), JCx(br, bi)), arrays)
    for g, r, name in zip(got, ref, ("A.re", "A.im", "b.re", "b.im")):
        np.testing.assert_allclose(g, np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)


def test_adjoint_mode_refuses_wrong_shapes_dtypes_and_layouts():
    Zr, Zi, w, Bd, Gr, Gi = _rao(np.random.default_rng(24), B=2, nw=5)
    Z0, G = Cx(Zr, Zi), Cx(Gr, Gi)
    bad_rao = [
        (Z0, w[:-1], Bd, G),                                  # w not (nw,)
        (Z0, w, Bd[:1], G),                                   # one B_drag per design
        (Z0, w, Bd, Cx(Gr[..., :5], Gi[..., :5])),            # right-hand side not 6
        (Cx(Zr[..., :5], Zi[..., :5]), w, Bd, G),             # not 6 x 6
        (Z0, w.float(), Bd, G),                               # mixed dtypes
        (Cx(Zr.to(torch.int64), Zi.to(torch.int64)), w.to(torch.int64), Bd.to(torch.int64),
         Cx(Gr.to(torch.int64), Gi.to(torch.int64))),         # not a float type
        (Z0, w, Bd.transpose(-1, -2), G),                     # not contiguous
    ]
    for args in bad_rao:
        with pytest.raises(ValueError):
            cuda6.solve_rao_adjoint(*args)
    A, b = Cx(Zr[0], Zi[0]), Cx(Gr[0], Gi[0])
    bad_cx = [
        (A, Cx(b.re[..., :5], b.im[..., :5])),
        (Cx(A.re, A.im.float()), b),
        (Cx(A.re.transpose(-1, -2), A.im), b),
        (Cx(A.re[..., :4, :], A.im[..., :4, :]), b),
    ]
    for args in bad_cx:
        with pytest.raises(ValueError):
            cuda6.solve_cx_adjoint(*args)
    meta = dict(device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel"):
        cuda6.solve_cx_adjoint(Cx(torch.empty(3, 6, 6, **meta), torch.empty(3, 6, 6, **meta)),
                               Cx(torch.empty(3, 6, **meta), torch.empty(3, 6, **meta)))
