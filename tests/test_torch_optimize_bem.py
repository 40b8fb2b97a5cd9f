"""``optimize_design(bem_fn=...)``, the co-design loop closed through the
panel solve, on CPU (as tests/test_jax_bem.py:284-317 runs the JAX
package's), and the ``bem_fn`` wiring of ``_make_loss`` against the JAX
package's.

OC3spar at 24 frequencies with a coarse 64-panel-class column's
``make_bem_fn`` (float32, deep water) re-solved inside each step: the
history is finite and descends.  The wiring check swaps the panel solve
for a seeded function of theta, the same in both packages (one solve per
theta, zeta-staged per case over a batch of sea states): loss and gradient
agree with ``jax.grad`` to 1e-9.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu.core.cplx import Cx as JCx
from raft_tpu.parallel.optimize import _make_loss as jax_make_loss, nacelle_accel_std as jax_nac
from raft_tpu.parallel.sweep import (make_wave_states as jax_make_wave_states,
                                     scale_diameters as jax_scale_diameters)

from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.hydro import torch_bem
from raft_tpu_torch.parallel.optimize import _make_loss, nacelle_accel_std, optimize_design
from raft_tpu_torch.parallel.sweep import make_wave_states, scale_diameters

from test_torch_bem_grad import column
from test_torch_dynamics import _stage

NW = 24
W = np.linspace(0.05, 2.95, NW)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oc3():
    return _stage("OC3spar", NW)


def test_optimize_design_bem_fn_descends(oc3):
    _, (tm, trna, tenv, twave, tC) = oc3
    mesh = column(r=3.25, draft=8.0, dz_max=3.5, da_max=3.4)
    assert torch_bem.pad_panel_count(len(mesh)) == 64
    bem_fn = torch_bem.make_bem_fn(mesh, twave.w.numpy(), beta=0.0, device="cpu")
    res = optimize_design(tm, trna, tenv, twave, tC, theta0=1.0, steps=2, learning_rate=0.02,
                          bounds=(0.8, 1.25), n_iter=8, bem_fn=bem_fn, device="cpu")
    assert res.history.shape == (3,) and np.isfinite(res.history).all()
    assert res.history[-1] < res.history[0]


def test_bem_fn_with_bem_or_heading_lanes_raises(oc3):
    _, (tm, trna, tenv, twave, tC) = oc3
    bem_fn = lambda th: None                                      # noqa: E731
    raw = (np.zeros((6, 6, NW)), np.zeros((6, 6, NW)), np.zeros((6, NW), complex))
    with pytest.raises(ValueError, match="not both"):
        optimize_design(tm, trna, tenv, twave, tC, theta0=1.0, steps=1, bem=raw, bem_fn=bem_fn,
                        device="cpu")
    lanes = make_wave_states(W, [[6.0, 10.0, 0.0], [8.0, 12.0, 0.5]], tenv.depth, device="cpu")
    with pytest.raises(ValueError, match="heading"):
        _make_loss(tm, trna, tenv, lanes, tC, nacelle_accel_std, scale_diameters, None, 8, False,
                   bem_fn=bem_fn, device="cpu")


def _coeffs(seed=4):
    rng = np.random.default_rng(seed)
    return (np.eye(6) * 4e6 + rng.normal(size=(NW, 6, 6)) * 1e5,
            np.eye(6) * 2e5 + np.abs(rng.normal(size=(NW, 6, 6))) * 1e4,
            rng.normal(size=(2, NW, 6)) * 2e5)


def test_bem_fn_wiring_matches_jax(oc3):
    """A seeded theta -> (A, B, F) in place of the panel solve, over a DLC
    table of three [Hs, Tp] rows: the coefficients enter every case once,
    zeta-staged per case, in both packages."""
    (jm, jrna, jenv, _jw, C), (tm, trna, tenv, _tw, tC) = oc3
    A0, B0, F0 = _coeffs()
    rows = [[6.0, 10.0], [8.0, 12.0], [10.0, 14.0]]

    def jax_fn(th):
        s = th ** 2
        return jnp.asarray(A0) * s, jnp.asarray(B0) * th, JCx(jnp.asarray(F0[0]) * s,
                                                               jnp.asarray(F0[1]) * th)

    def torch_fn(th):
        s = th ** 2
        return (torch.as_tensor(A0) * s, torch.as_tensor(B0) * th,
                Cx(torch.as_tensor(F0[0]) * s, torch.as_tensor(F0[1]) * th))

    jloss = jax_make_loss(jm, jrna, jenv, jax_make_wave_states(W, rows, jenv.depth), C, jax_nac,
                          jax_scale_diameters, None, 25, False, bem_fn=jax_fn)
    ref_val, ref_g = jax.jit(jax.value_and_grad(jloss))(jnp.float64(1.02))
    loss = _make_loss(tm, trna, tenv, make_wave_states(W, rows, tenv.depth, device="cpu"), tC,
                      nacelle_accel_std, scale_diameters, None, 25, False, bem_fn=torch_fn,
                      device="cpu")
    th = torch.tensor(1.02, dtype=torch.float64, requires_grad=True)
    val = loss(th)
    (g,) = torch.autograd.grad(val, th)
    np.testing.assert_allclose(float(val.detach()), float(ref_val), rtol=1e-9)
    np.testing.assert_allclose(float(g), float(ref_g), rtol=1e-9)
