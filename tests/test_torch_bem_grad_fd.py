"""The port's BEM gradient at finite depth (30 m): ``bem_fn``'s values
against the JAX package's and its ``torch.autograd.grad`` against a central
difference of the JAX package's ``bem_fn`` forward (float64, h = 1e-5,
relative 1e-6, as tests/test_jax_bem.py holds ``jax.grad``).

The difference is taken at theta = 1, as the JAX package's own test does:
on this column the jitted JAX forward steps by 1.5e-4 (on an objective of
3.4) between theta = 1.05 and 1.05 + 1e-5, where the eager forward of
either package does not (the objective is piecewise: subdivision levels
and wave-integral regions are picked by comparisons, and one of them
flips under XLA's rounding), which would make the difference there
meaningless.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu.hydro import jax_bem

from raft_tpu_torch.hydro import torch_bem

from test_torch_bem_grad import BETA, TOL, W, column, loss

DEPTH = 30.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    """The jitted JAX ``bem_fn`` and the port's, at 30 m."""
    jf = jax.jit(jax_bem.make_bem_fn(column(), W, depth=DEPTH, beta=BETA, dtype=jnp.float64))
    tf = torch_bem.make_bem_fn(column(), W, depth=DEPTH, beta=BETA, dtype=torch.float64,
                               device="cpu")
    return jf, tf


def test_bem_fn_values_match_jax_finite_depth(cases):
    jf, tf = cases
    with torch.no_grad():
        A, B, F = tf(1.05)
    Aj, Bj, Fj = jf(jnp.float64(1.05))
    for got, want in ((A, Aj), (B, Bj), (F.re, Fj.re), (F.im, Fj.im)):
        assert torch_bem.parity_err(got.numpy(), np.asarray(want)) <= TOL


def test_bem_fn_gradient_matches_jax_central_difference(cases):
    jf, tf = cases

    def value(th):
        A, B, F = jf(jnp.float64(th))
        return (float(np.sum(A)) * 1e-6 + float(np.sum(B)) * 1e-6
                + float(np.sum(np.asarray(F.re) ** 2 + np.asarray(F.im) ** 2)) * 1e-10)

    eps = 1e-5
    fd = (value(1.0 + eps) - value(1.0 - eps)) / (2 * eps)
    th = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(*tf(th)), th)
    assert np.isfinite(float(g)) and float(g) != 0.0
    assert float(g) == pytest.approx(fd, rel=1e-6)
