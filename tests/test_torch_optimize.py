"""The port's co-design gradient (``raft_tpu_torch.parallel.optimize``,
``sweep.grad_response_std``) against the JAX package's, on CPU in float64.

Same inputs to both packages (OC3spar at 24 frequencies); gradients,
objectives and Adam trajectories agree to 1e-9 relative.  Every gradient
goes through the scan loop, so every step's solve is the adjoint rule of
kernel K1 (its plain version here).  The mooring knobs and the design
batch are in tests/test_torch_optimize_knobs.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from raft_tpu.core.cplx import Cx as JCx
from raft_tpu.parallel import (forward_response as jax_forward,
                               grad_nacelle_accel_std as jax_grad_nac,
                               grad_response_std as jax_grad_std,
                               nacelle_accel_std as jax_nac, optimize_design as jax_optimize,
                               stage_bem as jax_stage_bem)

from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.parallel.optimize import (grad_nacelle_accel_std, nacelle_accel_std,
                                              optimize_design)
from raft_tpu_torch.parallel.sweep import forward_response, grad_response_std, stage_bem

from test_torch_dynamics import _stage

RTOL = 1e-9


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
    return _stage("OC3spar", 24)


def _raw_bem(nw, seed=2):
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(6)[:, :, None] * 4e6, (1, 1, nw))
    B = np.tile(np.eye(6)[:, :, None] * 2e5, (1, 1, nw))
    F = (rng.normal(size=(6, nw)) + 1j * rng.normal(size=(6, nw))) * 2e5
    return A, B, F


def test_nacelle_accel_std_matches_jax(oc3):
    """The objective on the same response, for one design and a batch of
    three, and a zero response has gradient 0 (the double-where guard)."""
    (_, jrna, _, jwave, _), (_, trna, _, twave, _) = oc3
    rng = np.random.default_rng(7)
    Xr, Xi = rng.normal(size=(3, 24, 6)), rng.normal(size=(3, 24, 6))
    got = nacelle_accel_std(Cx(torch.as_tensor(Xr), torch.as_tensor(Xi)), twave, trna)
    ref = jax.vmap(lambda a, b: jax_nac(JCx(a, b), jwave, jrna))(jnp.asarray(Xr),
                                                                  jnp.asarray(Xi))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)
    z = torch.zeros(24, 6, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(nacelle_accel_std(Cx(z, z), twave, trna), z)
    assert float(nacelle_accel_std(Cx(z, z), twave, trna)) == 0.0
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) == 0.0


def test_grad_nacelle_accel_std_strip_matches_jax(oc3):
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = oc3
    ref = float(jax_grad_nac(jm, jrna, jenv, jwave, C, 1.0))
    got = grad_nacelle_accel_std(tm, trna, tenv, twave, tC, 1.0, device="cpu")
    assert got.shape == () and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), ref, rtol=RTOL)


def test_grad_nacelle_accel_std_with_staged_bem_matches_jax(oc3):
    """The BEM coefficients as stage_bem output, as the raw host tuple and
    as a one-heading grid give the port one gradient, the JAX package's."""
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = oc3
    A, B, F = _raw_bem(24)
    ref = float(jax_grad_nac(jm, jrna, jenv, jwave, C, 1.0, bem=jax_stage_bem((A, B, F), jwave)))
    for bem in (stage_bem((A, B, F), twave), (A, B, F),
                (np.array([0.0]), F[None], A, B)):
        got = float(grad_nacelle_accel_std(tm, trna, tenv, twave, tC, 1.0, bem=bem,
                                           device="cpu"))
        np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("dof", [0, 4])
def test_grad_response_std_matches_jax(oc3, dof):
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = oc3
    ref = float(jax_grad_std(jm, jrna, jenv, jwave, C, jnp.asarray(1.05), dof=dof))
    got = grad_response_std(tm, trna, tenv, twave, tC, 1.05, dof=dof, device="cpu")
    np.testing.assert_allclose(float(got), ref, rtol=RTOL)


def test_optimize_design_matches_jax_trajectory(oc3):
    """Three Adam steps with bounds: the port's torch.optim.Adam with
    optax's defaults follows optax.adam's trajectory."""
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = oc3
    kw = dict(theta0=1.0, steps=3, learning_rate=0.02, bounds=(0.8, 1.25), n_iter=25)
    ref = jax_optimize(jm, jrna, jenv, jwave, C, **kw)
    got = optimize_design(tm, trna, tenv, twave, tC, device="cpu", **kw)
    assert got.history.shape == (4,) and got.thetas.shape == (4,)
    np.testing.assert_allclose(got.history, ref.history, rtol=RTOL)
    np.testing.assert_allclose(got.thetas, ref.thetas, rtol=RTOL)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm, rtol=RTOL)
    assert got.objective == got.history[-1] and got.history[-1] < got.history[0]


def test_unported_options_raise(oc3):
    """The batched sea-state sweep's options: pipelined chunks, the
    dispatch window and lane health now run, each as the JAX package's on
    the same two cases (1e-12 scale-relative, identical iterations and
    verdicts); sharding over a mesh still raises and names the
    multi-device slice of its ROADMAP item."""
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = oc3
    from raft_tpu.parallel.sweep import make_wave_states as jax_make_wave_states
    from raft_tpu.parallel.sweep import sweep_sea_states as jax_sweep_sea_states
    from raft_tpu_torch.parallel.sweep import make_wave_states, sweep_sea_states

    rows = [[6.0, 10.0], [8.0, 12.0]]
    waves = make_wave_states(twave.w.numpy(), rows, tenv.depth, device="cpu")
    jwaves = jax_make_wave_states(np.asarray(jwave.w), rows, float(jenv.depth))
    with pytest.raises(NotImplementedError, match="ROADMAP.*multi-device"):
        sweep_sea_states(tm, trna, tenv, waves, tC, device="cpu", mesh=object())
    for kw in ({"chunk": 1}, {"pipeline_depth": 2}, {"health": True}):
        got = sweep_sea_states(tm, trna, tenv, waves, tC, device="cpu", **kw)
        want = jax_sweep_sea_states(jm, jrna, jenv, jwaves, C, **kw)
        np.testing.assert_array_equal(got["iterations"], np.asarray(want["iterations"]))
        for k in ("std dev", "nacelle accel std dev", "Xi_abs2"):
            want_k = np.asarray(want[k])
            assert np.abs(got[k] - want_k).max() <= 1e-12 * np.abs(want_k).max(), (kw, k)
        assert ("pipeline" in got) == ("chunk" in kw) == ("pipeline" in want)
        if "health" in kw:
            assert got["health"] == want["health"] and got["converged"].all()


def test_forward_response_scan_matches_jax(oc3):
    """The scan loop inside the batched pipeline, one design: Xi and
    counts as the JAX package's forward_response (its default loop)."""
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = oc3
    ref = jax_forward(jm, jrna, jenv, jwave, C, n_iter=25)
    got = forward_response(tm, trna, tenv, twave, tC, n_iter=25, method="scan", device="cpu")
    assert int(got.n_iter) == int(ref.n_iter)
    scale = float(np.abs(np.asarray(ref.Xi.re)).max())
    assert float(np.abs(got.Xi.re.numpy() - np.asarray(ref.Xi.re)).max()) <= 1e-12 * scale
