"""The co-design loss over batched sea states (``_make_loss`` with a case
axis, ``case_reduce``) against the JAX package's, on CPU in float64.

OC3spar at 24 frequencies, the same seeded BEM coefficients in both
packages: a DLC table of three [Hs, Tp] rows with the raw (A, B, F) tuple
and the default worst-case reduction, and a seven-direction spread sea
(each lane its own heading) with a heading grid and ``energy_sum``.  The
port runs the cases as lanes of one batched solve where the JAX package
vmaps; loss and ``torch.autograd.grad`` agree with ``jax.grad`` of the JAX
loss to 1e-9 relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu.parallel.optimize import (_make_loss as jax_make_loss, energy_sum as jax_energy_sum,
                                        nacelle_accel_std as jax_nac)
from raft_tpu.parallel.sweep import (make_wave_states as jax_make_wave_states,
                                     scale_diameters as jax_scale_diameters,
                                     spread_sea_state as jax_spread_sea_state)

from raft_tpu_torch.parallel.optimize import (_make_loss, energy_sum, grad_nacelle_accel_std,
                                              nacelle_accel_std)
from raft_tpu_torch.parallel.sweep import make_wave_states, scale_diameters, spread_sea_state

from test_torch_dynamics import _stage

NW = 24
W = np.linspace(0.05, 2.95, NW)
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oc3():
    return _stage("OC3spar", NW)


def _raw_bem(seed=2, nb=None):
    """Seeded coefficients: (A, B, F[6, nw]), or F[nb, 6, nw] on a grid."""
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(6)[:, :, None] * 4e6, (1, 1, NW))
    B = np.tile(np.eye(6)[:, :, None] * 2e5, (1, 1, NW))
    shape = (6, NW) if nb is None else (nb, 6, NW)
    F = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 2e5
    return A, B, F


def _cases(depth):
    """(JAX waves, port waves, bem, JAX case_reduce, port case_reduce) per case."""
    rows = [[6.0, 10.0], [8.0, 12.0], [10.0, 14.0]]
    bgrid = np.linspace(-np.pi / 2, np.pi / 2, 5)
    A, B, F_all = _raw_bem(nb=len(bgrid))
    return {
        "dlc-max-raw": (jax_make_wave_states(W, rows, depth),
                        make_wave_states(W, rows, depth, device="cpu"), _raw_bem(),
                        None, None),
        "spread-energy-grid": (jax_spread_sea_state(W, 8.0, 12.0, depth, beta0=0.2, n_dir=7),
                               spread_sea_state(W, 8.0, 12.0, depth, beta0=0.2, n_dir=7,
                                                device="cpu"),
                               (bgrid, F_all, A, B), jax_energy_sum, energy_sum),
    }


@pytest.mark.parametrize("case", ["dlc-max-raw", "spread-energy-grid"])
def test_batched_wave_loss_gradient_matches_jax(oc3, case):
    (jm, jrna, jenv, _jw, C), (tm, trna, tenv, _tw, tC) = oc3
    jwaves, twaves, bem, jreduce, treduce = _cases(tenv.depth)[case]
    jloss = jax_make_loss(jm, jrna, jenv, jwaves, C, jax_nac, jax_scale_diameters, bem, 25,
                          False, case_reduce=jreduce)
    ref_val, ref_g = jax.jit(jax.value_and_grad(jloss))(jnp.float64(1.05))
    loss = _make_loss(tm, trna, tenv, twaves, tC, nacelle_accel_std, scale_diameters, bem, 25,
                      False, case_reduce=treduce, device="cpu")
    th = torch.tensor(1.05, dtype=torch.float64, requires_grad=True)
    val = loss(th)
    (g,) = torch.autograd.grad(val, th)
    assert val.shape == () and float(g) != 0.0
    np.testing.assert_allclose(float(val.detach()), float(ref_val), rtol=RTOL)
    np.testing.assert_allclose(float(g), float(ref_g), rtol=RTOL)
    if treduce is None:            # the entry point takes case_reduce too
        got = grad_nacelle_accel_std(tm, trna, tenv, twaves, tC, 1.05, bem=bem, device="cpu")
        np.testing.assert_allclose(float(got), float(ref_g), rtol=RTOL)
