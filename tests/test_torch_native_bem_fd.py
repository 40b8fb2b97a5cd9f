"""The port's host C++ panel solver at finite depth, its WAMIT files, and
``Model(BEM="native")``, against the JAX package and on their own.

Against the JAX package (same host, same compiler and flags): the
dispersion and finite-depth Green-function probes and the finite-depth
solve (heading grid, Haskind) to 1e-12, every solve with ``cache=False``;
the WAMIT readers on ``tests/data/cylinder`` and ``tests/data/cyl_fd``
bit for bit, and a write/read round trip through both packages' writers;
``Model(BEM="native")`` on a coarse OC3spar (48 panels, 8 frequencies at
320 m, the lowest on the finite-depth branch): A, B, F, the
eigenfrequencies and the response std dev to 1e-10.  On the port alone,
the JAX package's finite-depth oracles (``tests/oracles_fd.py``): the
dispersion relation, John's series, the gradients, the deep limit, the
long-wave heave excitation and the committed WAMIT fixture of a fresh
solve.
"""
import os

import numpy as np
import pytest

from raft_tpu import model as jmodel
from raft_tpu.hydro import bem_io as jio
from raft_tpu.hydro import native_bem as jnative

from raft_tpu_torch.hydro import bem_io, native_bem, torch_bem
from raft_tpu_torch.model import Model, load_design

from oracles_fd import green_series, truncated_cylinder_mesh

TOL = 1e-12
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = {"cylinder": (os.path.join(HERE, "data", "cylinder"), 1000.0, 9.80665),
            "cyl_fd": (os.path.join(HERE, "data", "cyl_fd"), 1000.0, 9.81)}


@pytest.fixture(autouse=True)
def _own_cache(monkeypatch, tmp_path):
    """Each test solves into a result cache of its own."""
    monkeypatch.setenv(native_bem.CACHE_ENV, str(tmp_path / "cache"))


def test_dispersion_and_green_fd_match_jax_package():
    for nu, h in [(1e-3, 50.0), (0.1, 50.0), (0.5, 200.0), (2.0, 30.0)]:
        assert native_bem.dispersion(nu, h) == pytest.approx(jnative.dispersion(nu, h),
                                                             rel=TOL)
    for args in [(0.002, 50.0, 30.0, -5.0, -10.0), (0.03, 30.0, 25.0, -0.5, -29.0),
                 (0.004, 80.0, 4.0, -3.0, -60.0), (0.5, 40.0, 1.0, -0.2, -0.4)]:
        for g, r in zip(native_bem.green_fd(*args), jnative.green_fd(*args)):
            assert abs(g - r) <= TOL * max(abs(r), 1e-30), args


def test_finite_depth_solve_matches_jax_package():
    mesh = truncated_cylinder_mesh(a=2.0, d=1.5, naz=16, nz=3, nr=2)
    w = np.array([0.3, 0.8, 1.4])
    kw = dict(rho=1000.0, g=9.81, depth=12.0, beta=np.array([0.0, 0.5]), haskind=True,
              cache=False)
    got = native_bem.solve_bem(mesh, w, **kw)
    ref = jnative.solve_bem(mesh, w, **kw)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch_bem.parity_err(g, r) <= TOL
    A, _B, F = native_bem.solve_bem(mesh, w, rho=1000.0, g=9.81, depth=12.0, beta=0.5,
                                    cache=False)
    np.testing.assert_array_equal(A, got[0])
    np.testing.assert_array_equal(F, got[2][1])


def test_dispersion_solves_relation():
    for nu, h in [(1e-3, 50.0), (0.1, 50.0), (0.5, 200.0), (2.0, 30.0)]:
        k0 = native_bem.dispersion(nu, h)
        assert k0 * np.tanh(k0 * h) == pytest.approx(nu, rel=1e-12)
        assert k0 >= nu * (1 - 1e-12)


def test_green_fd_matches_john_series():
    for nu, h, R, z, zeta in [(0.002, 50.0, 30.0, -5.0, -10.0),
                              (0.008, 50.0, 60.0, -1.0, -2.0),
                              (0.03, 30.0, 25.0, -0.5, -29.0),
                              (0.004, 80.0, 4.0, -3.0, -60.0)]:
        G, _, _ = native_bem.green_fd(nu, h, R, z, zeta)
        Gs = green_series(nu, h, R, z, zeta)
        assert abs(G - Gs) / max(abs(Gs), 1e-4 / h) < 2e-3, (nu, h, R, z, zeta)


def test_green_fd_gradient_consistency():
    for nu, h, R, z, zeta in [(0.005, 60.0, 20.0, -8.0, -15.0),
                              (0.02, 40.0, 12.0, -2.0, -30.0)]:
        _, dR, dz = native_bem.green_fd(nu, h, R, z, zeta)
        e = 1e-5 * h
        gR1, _, _ = native_bem.green_fd(nu, h, R + e, z, zeta)
        gR0, _, _ = native_bem.green_fd(nu, h, R - e, z, zeta)
        gz1, _, _ = native_bem.green_fd(nu, h, R, z + e, zeta)
        gz0, _, _ = native_bem.green_fd(nu, h, R, z - e, zeta)
        scale = max(abs(dR), abs(dz))
        assert abs((gR1 - gR0) / (2 * e) - dR) / scale < 2e-2
        assert abs((gz1 - gz0) / (2 * e) - dz) / scale < 2e-2


def test_deep_limit_consistency():
    """k0 h ~ 8: the finite-depth path runs, and agrees with deep water."""
    mesh = truncated_cylinder_mesh(a=2.0, d=1.5, naz=24, nz=4, nr=3)
    w = np.array([1.0])
    h = 80.0
    assert 5.0 < native_bem.dispersion(1.0 / 9.81, h) * h < 10.0
    Af, Bf, Ff = native_bem.solve_bem(mesh, w, rho=1000.0, g=9.81, depth=h, cache=False)
    Ad, Bd, Fd = native_bem.solve_bem(mesh, w, rho=1000.0, g=9.81, cache=False)
    assert Af[2, 2, 0] == pytest.approx(Ad[2, 2, 0], rel=1e-3)
    assert Bf[2, 2, 0] == pytest.approx(Bd[2, 2, 0], rel=1e-2)
    assert abs(Ff[2, 0]) == pytest.approx(abs(Fd[2, 0]), rel=1e-3)


def test_long_wave_heave_excitation_limit():
    """w -> 0: heave excitation per unit amplitude -> rho g Awp."""
    mesh = truncated_cylinder_mesh(a=3.0, d=2.0, naz=28, nz=4, nr=4)
    _, _, F = native_bem.solve_bem(mesh, np.array([0.15]), rho=1000.0, g=9.81, depth=20.0,
                                   cache=False)
    assert abs(F[2, 0]) == pytest.approx(1000.0 * 9.81 * np.pi * 3.0**2, rel=0.02)


def test_committed_wamit_fixture_roundtrip():
    """A fresh finite-depth solve reproduces the committed WAMIT fixture
    (``tests/data/cyl_fd``), read by the port's readers."""
    path, rho, g = FIXTURES["cyl_fd"]
    w = np.array([0.4, 0.7, 1.0, 1.4, 2.0])
    A_g, B_g, F_g = bem_io.load_wamit_coeffs(os.path.join(path, "Buoy.1"),
                                             os.path.join(path, "Buoy.3"), w, rho=rho, g=g)
    A, B, F = native_bem.solve_bem(truncated_cylinder_mesh(), w, rho=rho, g=g, depth=12.0,
                                   cache=False)
    np.testing.assert_allclose(A, A_g, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(B, B_g, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.abs(F), np.abs(F_g), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_wamit_readers_match_jax_package(name, tmp_path):
    """``read_wamit1/3``, ``dimensionalize`` and ``load_wamit_coeffs`` on the
    committed fixtures give the JAX package's arrays bit for bit; the port's
    writers round-trip them and the JAX package's readers read the port's
    files."""
    path, rho, g = FIXTURES[name]
    p1, p3 = os.path.join(path, "Buoy.1"), os.path.join(path, "Buoy.3")
    got1, ref1 = bem_io.read_wamit1(p1), jio.read_wamit1(p1)
    got3, ref3 = bem_io.read_wamit3(p3), jio.read_wamit3(p3)
    for g_, r_ in zip(got1 + got3, ref1 + ref3):
        np.testing.assert_array_equal(g_, r_)
    w, A_bar, B_bar = got1
    _w3, hd, _mod, _ph, re, im = got3
    A, B, F = bem_io.dimensionalize(w, A_bar, B_bar, re, im, rho=rho, g=g)
    for g_, r_ in zip((A, B, F), jio.dimensionalize(w, A_bar, B_bar, re, im, rho=rho, g=g)):
        np.testing.assert_array_equal(g_, r_)
    grid = np.linspace(w.min(), w.max(), 7)
    for g_, r_ in zip(bem_io.load_wamit_coeffs(p1, p3, grid, rho=rho, g=g),
                      jio.load_wamit_coeffs(p1, p3, grid, rho=rho, g=g)):
        np.testing.assert_array_equal(g_, r_)
    q1 = bem_io.write_wamit1(str(tmp_path / "Out.1"), w, A, B, rho=rho, g=g)
    q3 = bem_io.write_wamit3(str(tmp_path / "Out.3"), w, F, rho=rho, g=g, heading=hd[0])
    assert open(q1).read() == open(jio.write_wamit1(str(tmp_path / "Ref.1"), w, A, B,
                                                    rho=rho, g=g)).read()
    assert open(q3).read() == open(jio.write_wamit3(str(tmp_path / "Ref.3"), w, F, rho=rho,
                                                    g=g, heading=hd[0])).read()
    A2, B2, F2 = bem_io.load_wamit_coeffs(q1, q3, w, rho=rho, g=g)
    np.testing.assert_allclose(A2, A, rtol=1e-5, atol=1e-8 * np.abs(A).max())
    np.testing.assert_allclose(B2, B, rtol=1e-5, atol=1e-8 * np.abs(B).max())
    np.testing.assert_allclose(F2, F, rtol=1e-5, atol=1e-8 * np.abs(F).max())
    C = np.arange(36.0).reshape(6, 6)
    hst = tmp_path / "Out.hst"
    hst.write_text("".join(f"{i + 1} {j + 1} {C[i, j]:.6e}\n" for i in range(6)
                           for j in range(6)))
    np.testing.assert_array_equal(bem_io.read_wamit_hst(str(hst)), C)
    np.testing.assert_array_equal(bem_io.read_wamit_hst(str(hst)), jio.read_wamit_hst(str(hst)))


def test_wamit3_multiheading_roundtrip(tmp_path):
    """A heading grid survives write_wamit3/read_wamit3; one heading selected
    keeps the [6, nw] layout; a heading not in the file raises."""
    rng = np.random.default_rng(7)
    w = np.array([0.4, 0.8, 1.2])
    headings = [0.0, 45.0, 90.0]
    F = rng.normal(size=(3, 6, 3)) + 1j * rng.normal(size=(3, 6, 3))
    p = str(tmp_path / "Buoy.3")
    bem_io.write_wamit3(p, w, F, rho=1000.0, g=9.81, heading=headings)
    w_r, hd_r, mod, _ph, re, im = bem_io.read_wamit3(p)
    assert mod.shape == (3, 6, 3)
    np.testing.assert_allclose(hd_r, headings)
    for ih in range(3):
        _, _, F_dim = bem_io.dimensionalize(w_r, np.zeros((6, 6, 3)), np.zeros((6, 6, 3)),
                                            re[ih], im[ih], rho=1000.0, g=9.81)
        np.testing.assert_allclose(F_dim, F[ih], rtol=1e-5, atol=1e-8)
    _w, _hd, mod_s, _, _, _ = bem_io.read_wamit3(p, heading=45.0)
    assert mod_s.shape == (6, 3)
    np.testing.assert_allclose(mod_s, mod[1], rtol=1e-12)
    with pytest.raises(ValueError):
        bem_io.read_wamit3(p, heading=10.0)
    with pytest.raises(ValueError, match="heading"):
        bem_io.write_wamit3(p, w, F, heading=[0.0, 45.0])


def _run(model):
    model.setEnv(Hs=6.0, Tp=10.0)
    model.calcBEM(dz_max=12.0, da_max=8.0)
    model.calcSystemProps()
    model.solveEigen(n_pass=1)
    model.solveDynamics()
    model.calcOutputs()
    return model


def test_model_native_matches_jax_package():
    """``Model(BEM="native")`` on OC3spar against the JAX package's: A, B,
    F, the eigenfrequencies and the std dev to 1e-10, the same iterations."""
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    w = np.linspace(0.1, 1.5, 8)
    assert native_bem.dispersion(w[0] ** 2 / 9.81, 320.0) * 320.0 < 10.0
    ref = _run(jmodel.Model(design, w=w, BEM="native"))
    got = _run(Model(design, w=w, BEM="native", device="cpu"))
    diag = got.bem_diagnostics
    assert diag["route"] == "native" and diag["panels"] == 48 and not diag["cached"]
    for g, r in zip(got.bem, ref.bem):
        assert torch_bem.parity_err(g, r) <= 1e-10
    np.testing.assert_allclose(got.results["eigen"]["frequencies"],
                               ref.results["eigen"]["frequencies"], rtol=1e-10)
    r_got, r_ref = got.results["response"], ref.results["response"]
    assert r_got["iterations"] == r_ref["iterations"] and r_got["converged"]
    assert torch_bem.parity_err(r_got["std dev"], r_ref["std dev"]) <= 1e-10
