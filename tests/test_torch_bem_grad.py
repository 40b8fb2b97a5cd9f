"""The port's BEM gradient (``torch_bem.make_bem_fn``, ``solve_refined``,
``solve_panels(assembly="plain")``) against the JAX package's, on CPU in
float64, deep water.

Same inputs to both packages: seeded block systems for the refined solve's
implicit-function rule (against ``jax.vjp`` of ``jax_bem._solve_refined``,
1e-12), and the JAX package's 64-panel-class test column for ``bem_fn``'s
values (against the jitted JAX ``make_bem_fn``, 1e-10 scale-relative).
The gradient against central differences of the JAX forward is in
tests/test_torch_bem_grad_fd.py (finite depth); ``jax.grad`` through the
whole JAX ``make_bem_fn`` is not run here: its jitted gradient at this size
takes minutes on the CPU (the JAX package marks those tests slow).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro.mesh import mesh_member

from raft_tpu_torch.hydro import torch_bem, wavetable

W = np.array([0.7, 1.2])
BETA = 0.1
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def column(r=1.2, draft=6.0, dz_max=2.2, da_max=1.9):
    """The JAX package's gradient-test column (tests/test_jax_bem.py): 16
    panels, padded to the 64 class."""
    return mesh_member(stations=[0.0, draft + 2.0], diameters=[2 * r, 2 * r],
                       rA=[0.0, 0.0, -draft], rB=[0.0, 0.0, 2.0], dz_max=dz_max, da_max=da_max)


def loss(A, B, F):
    """The JAX package's test objective of A, B and F (tests/test_jax_bem.py)."""
    return A.sum() * 1e-6 + B.sum() * 1e-6 + (F.re**2 + F.im**2).sum() * 1e-10


def _systems(seed, nf=3, m=10, nrhs=4):
    rng = np.random.default_rng(seed)
    M2 = rng.normal(size=(nf, m, m)) + m * np.eye(m)
    return M2, rng.normal(size=(nf, m, nrhs)), rng.normal(size=(nf, m, nrhs))


def test_solve_refined_vjp_matches_jax():
    """Forward and cotangents of the refined solve, per system against
    ``jax.vjp`` of the JAX package's ``custom_vjp``: the port reuses the
    forward's factors (``lu_solve(adjoint=True)``), the JAX package factors
    ``M2^T`` anew, both refine twice."""
    M2, B2, xbar = _systems(11)
    Mt = torch.as_tensor(M2).requires_grad_(True)
    Bt = torch.as_tensor(B2).requires_grad_(True)
    x = torch_bem.solve_refined(Mt, Bt)
    gM, gB = torch.autograd.grad(x, (Mt, Bt), torch.as_tensor(xbar))

    @jax.jit
    def ref(M, B, xb):
        xj, vjp = jax.vjp(jax_bem._solve_refined, M, B)
        return (xj,) + vjp(xb)

    for i in range(len(M2)):
        want = ref(jnp.asarray(M2[i]), jnp.asarray(B2[i]), jnp.asarray(xbar[i]))
        for got, w_i in zip((x[i], gM[i], gB[i]), want):
            w_i = np.asarray(w_i)
            assert np.abs(got.detach().numpy() - w_i).max() <= 1e-12 * np.abs(w_i).max()


def test_singular_block_system_raises_on_cpu():
    """A singular system among the batch raises on CPU tensors, naming it,
    where the unchecked factors would carry inf or NaN on silently."""
    M2, B2, _ = _systems(12)
    M2[1, :, 3] = 0.0
    with pytest.raises(torch.linalg.LinAlgError, match=r"block systems \[1\] are singular"):
        torch_bem.solve_refined(torch.as_tensor(M2), torch.as_tensor(B2))


@pytest.fixture(scope="module")
def jax_deep():
    """The jitted JAX ``bem_fn`` in deep water (one compile, about 20 s)."""
    return jax.jit(jax_bem.make_bem_fn(column(), W, depth=0.0, beta=BETA, dtype=jnp.float64))


def test_bem_fn_values_match_jax_deep(jax_deep):
    """A, B, F of the warped hull (theta 1.05) as the JAX package's
    ``bem_fn``, whose assembly is its XLA route."""
    bem_fn = torch_bem.make_bem_fn(column(), W, depth=0.0, beta=BETA, dtype=torch.float64,
                                   device="cpu")
    with torch.no_grad():
        A, B, F = bem_fn(1.05)
    Aj, Bj, Fj = jax_deep(jnp.float64(1.05))
    assert A.shape == (2, 6, 6) and B.shape == (2, 6, 6) and F.re.shape == (2, 6)
    for got, want in ((A, Aj), (B, Bj), (F.re, Fj.re), (F.im, Fj.im)):
        assert torch_bem.parity_err(got.numpy(), np.asarray(want)) <= TOL


def test_bem_fn_float32_gradient_finite_through_padding():
    """The float32 gradient through a mesh with degenerate padding panels
    (16 of 64 real) is finite and moves: the ``_safe_norm`` guards."""
    mesh = column(r=1.0, draft=5.0)
    assert torch_bem.pad_panel_count(len(mesh)) > len(mesh)
    bem_fn = torch_bem.make_bem_fn(mesh, np.array([0.8]), beta=0.0, device="cpu")
    th = torch.tensor(1.0, requires_grad=True)
    A, B, F = bem_fn(th)
    assert A.dtype == torch.float32
    (g,) = torch.autograd.grad(loss(A, B, F), th)
    assert bool(torch.isfinite(g)) and float(g) != 0.0


def test_recomputation_keeps_the_gradient_bits(monkeypatch):
    """Recomputing the chunks, quadrature points, wave-integral evaluations,
    near nodes and fit terms in the backward pass (``_remat``) gives the
    same gradient bits as keeping every intermediate."""
    def grad():
        bem_fn = torch_bem.make_bem_fn(column(), W[:1], depth=0.0, beta=BETA,
                                       dtype=torch.float64, device="cpu")
        th = torch.tensor(1.05, dtype=torch.float64, requires_grad=True)
        return torch.autograd.grad(loss(*bem_fn(th)), th)[0]

    g_remat = grad()
    monkeypatch.setattr(torch_bem, "_remat", lambda fn, *args: fn(*args))
    g_kept = grad()
    assert float(g_remat) != 0.0 and torch.equal(g_remat, g_kept)


def test_solve_panels_takes_staged_tensors_only():
    """solve_panels stages nothing: host arrays and tensors in another dtype
    raise; on the CPU the plain assembly is the kernels' CPU route, so both
    give the same bits; an unknown assembly raises."""
    padded, pm, lm = torch_bem.pad_mesh(column(), None)
    fd = wavetable.fd_fit_grid(W, -1.0, 9.81)
    staged = torch_bem.stage_inputs(padded, pm, lm, W, [BETA], fd, finite_depth=False,
                                    dtype=torch.float64, device="cpu")
    assert staged["fd_active"] == (False, False)
    tab = torch_bem.stage_tables(wavetable.load_tables(), torch.float64, "cpu")
    kw = dict(dtype=torch.float64, device="cpu")
    with pytest.raises(TypeError, match="stage_inputs"):
        torch_bem.solve_panels(**{**staged, "w": W}, tab=tab, **kw)
    with pytest.raises(TypeError, match="stage_tables"):
        torch_bem.solve_panels(**staged, tab={**tab, "I0": np.zeros((2, 2))}, **kw)
    with pytest.raises(ValueError, match="dtype"):
        torch_bem.solve_panels(**{**staged, "pans": staged["pans"].float()}, tab=tab, **kw)
    with pytest.raises(ValueError, match="assembly"):
        torch_bem.solve_panels(**staged, tab=tab, assembly="xla", **kw)
    with torch.no_grad():
        got = torch_bem.solve_panels(**staged, tab=tab, assembly="plain", **kw)
        want = torch_bem.solve_panels(**staged, tab=tab, **kw)
    for g, w in zip((got[0], got[1], got[2].re, got[2].im, got[3]),
                    (want[0], want[1], want[2].re, want[2].im, want[3])):
        assert torch.equal(g, w)


def test_frozen_branches_hold_the_step_of_a_piecewise_function():
    """The held-branch central difference (the check of the BEM gradient on
    the card) is the derivative with theta's branches held: across a step
    the difference taken afresh is off, the held one is exact; a replay that
    takes other branches raises."""
    from raft_tpu_torch.tools.bem_grad_fd import FrozenBranches

    def f(x):
        return torch.where(x < 1.0, x * x, 3.0 * x + (x > 5.0).to(torch.int64))

    x0, h = torch.tensor(1.0 - 1e-7, dtype=torch.float64), 1e-6
    afresh = float((f(x0 + h) - f(x0 - h)) / (2 * h))
    with FrozenBranches() as frozen:
        f(x0)
    held = []
    for s in (1.0, -1.0):
        with frozen.replay():
            held.append(f(x0 + s * h))
    assert frozen.n_held == 3 and abs(afresh - 2 * float(x0)) > 0.1
    assert float((held[0] - held[1]) / (2 * h)) == pytest.approx(2 * float(x0), rel=1e-9)
    with pytest.raises(RuntimeError, match="branches"):
        with frozen.replay():
            x0 < 1.0
