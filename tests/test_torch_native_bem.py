"""The port's host C++ panel solver (``raft_tpu_torch.hydro.native_bem``,
built from ``raft_tpu_torch/native/bem.cpp``) against the JAX package's
(``raft_tpu.hydro.native_bem``), and on its own.

Both libraries are built here with the same compiler and flags from the
same physics, so on one host they agree to 1e-12 (in practice bit for
bit): deep water, a heading grid, the Haskind excitation, a waterplane lid,
and the wave-integral probes (table and direct quadrature).  Every solve
runs with ``cache=False`` on both sides, or under a ``tmp_path`` cache root
for the port.  On the port alone: the table against its quadrature, the
deep-sphere added mass 0.5 rho V, the result cache's atomic publish and
corrupt-file miss, the HAMS cylinder (slow, as in the JAX package), the
on-device route's plain version against native at ``PARITY_RTOL``, the
``"auto"`` / ``RAFT_TPU_BEM`` rule.  ``Model(BEM="native")`` is held
against the JAX package's in ``test_torch_native_bem_fd.py``.
"""
import os

import numpy as np
import pytest
import torch

from raft_tpu.hydro import native_bem as jnative

from raft_tpu_torch.cache import config
from raft_tpu_torch.hydro import mesh, native_bem, torch_bem

from test_native_bem import sphere_mesh

TOL = 1e-12
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "cylinder")


@pytest.fixture(autouse=True)
def _own_cache(monkeypatch, tmp_path):
    """Each test solves into a result cache of its own."""
    monkeypatch.setenv(config.CACHE_ENV, str(tmp_path / "cache"))


def _cylinder():
    hull = mesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                            rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)
    lid = mesh.disk_panels([0.0, 0.0, 0.0], 1.15, da_max=1.3)
    return hull, lid


CASES = {
    "deep": dict(beta=0.0),
    "headings": dict(beta=np.array([0.0, 0.4, 1.1])),
    "haskind": dict(beta=np.array([0.0, 0.7]), haskind=True),
    "lid": dict(beta=0.3, lid=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_bem_matches_jax_package(case):
    kw = dict(CASES[case])
    if kw.pop("lid", False):
        panels, kw["lid"] = _cylinder()
    else:
        panels = sphere_mesh(zc=-2.0, nth=6, naz=10)
    w = np.array([0.4, 1.0, 1.7])
    got = native_bem.solve_bem(panels, w, rho=1000.0, g=9.81, cache=False, **kw)
    ref = jnative.solve_bem(panels, w, rho=1000.0, g=9.81, cache=False, **kw)
    assert len(got) == len(ref) == (4 if kw.get("haskind") else 3)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch_bem.parity_err(g, r) <= TOL
    assert np.abs(got[0]).max() > 0 and np.abs(got[2]).max() > 0


def test_wave_integral_probes_match_jax_package():
    for X, Y in [(0.05, -0.02), (0.5, -0.5), (5.0, -0.1), (10.0, -2.0), (2.0, -20.0),
                 (70.0, -3.0)]:
        for direct in (False, True):
            got = native_bem.wave_integral(X, Y, direct=direct)
            ref = jnative.wave_integral(X, Y, direct=direct)
            for g, r in zip(got, ref):
                assert abs(g - r) <= TOL * max(abs(r), 1.0), (X, Y, direct)


def test_wave_integral_against_quadrature():
    """The table against the independent pole-subtracted quadrature."""
    for X, Y in [(0.5, -0.5), (5.0, -0.1), (10.0, -2.0), (2.0, -20.0)]:
        t0, t1 = native_bem.wave_integral(X, Y)
        d0, d1 = native_bem.wave_integral(X, Y, direct=True)
        assert t0 == pytest.approx(d0, rel=2e-3, abs=2e-4)
        assert t1 == pytest.approx(d1, rel=2e-3, abs=2e-4)


def test_deep_sphere_added_mass():
    """A sphere 10 radii down: added mass 0.5 rho V in every translation,
    no damping to speak of, a symmetric radiation matrix."""
    A, B, _F = native_bem.solve_bem(sphere_mesh(), np.array([1.0]), rho=1000.0, g=9.81,
                                    cache=False)
    rhoV = 1000.0 * 4.0 / 3.0 * np.pi
    for d in range(3):
        assert A[d, d, 0] == pytest.approx(0.5 * rhoV, rel=0.05)
    assert abs(B[2, 2, 0]) < 0.01 * A[2, 2, 0]
    assert A[0, 4, 0] == pytest.approx(A[4, 0, 0], abs=0.02 * rhoV)


def test_result_cache_atomic_and_corruption_tolerant(tmp_path, monkeypatch):
    """A result is published whole, served bit for bit from the port's own
    namespace, and a torn file is a counted miss: deleted, solved again and
    published again."""
    monkeypatch.setenv(config.CACHE_ENV, str(tmp_path))
    p = sphere_mesh(nth=6, naz=10)
    w = np.array([1.0])
    stats = dict(native_bem.CACHE_STATS)
    A1, B1, F1 = native_bem.solve_bem(p, w, rho=1000.0, g=9.81, cache=True)
    (art,) = os.listdir(tmp_path / "torch-bem")
    assert os.listdir(tmp_path) == ["torch-bem"] and art.endswith(".npz")
    path = tmp_path / "torch-bem" / art
    A2, B2, F2 = native_bem.solve_bem(p, w, rho=1000.0, g=9.81, cache=True)
    for a, b in ((A1, A2), (B1, B2), (F1, F2)):
        np.testing.assert_array_equal(a, b)
    path.write_bytes(b"\x00not-an-npz")
    A3, _, _ = native_bem.solve_bem(p, w, rho=1000.0, g=9.81, cache=True)
    np.testing.assert_array_equal(A3, A1)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["A"], A1)
    assert [native_bem.CACHE_STATS[k] - stats[k] for k in ("hit", "miss", "corrupt")] == [1, 2, 1]
    assert not [f for f in os.listdir(tmp_path / "torch-bem") if f.endswith(".tmp")]
    # the key carries the port's tag: the JAX package's key of the same solve differs
    key = native_bem.result_cache_key("torch-bem", p, w, np.zeros(1),
                                      (1000.0, 9.81, -1.0, 0.0, 0.0),
                                      salt=(native_bem.lib_key(),))
    assert key == path


@pytest.mark.slow
def test_cylinder_matches_hams():
    """The 1,008-panel HAMS cylinder (``tests/data/cylinder``) through the
    port's solver and WAMIT readers."""
    from raft_tpu_torch.hydro.bem_io import read_wamit1, read_wamit3

    panels = mesh.read_pnl(os.path.join(DATA, "HullMesh.pnl"))
    w_h, A_h, B_h = read_wamit1(os.path.join(DATA, "Buoy.1"))
    _, _, mod, _, _, _ = read_wamit3(os.path.join(DATA, "Buoy.3"))
    rho, g = 1000.0, 9.80665
    wsel = np.array([0.2, 2.0, 4.0])
    A, B, F = native_bem.solve_bem(panels, wsel, rho=rho, g=g, cache=False)
    for i, wv in enumerate(wsel):
        ih = int(np.argmin(np.abs(w_h - wv)))
        assert A[0, 0, i] == pytest.approx(rho * A_h[0, 0, ih], rel=0.04)
        assert A[2, 2, i] == pytest.approx(rho * A_h[2, 2, ih], rel=0.04)
        assert A[4, 4, i] == pytest.approx(rho * A_h[4, 4, ih], rel=0.04)
        assert B[2, 2, i] == pytest.approx(rho * wv * B_h[2, 2, ih], rel=0.05, abs=0.02)
        assert abs(F[0, i]) == pytest.approx(rho * g * mod[0, ih], rel=0.04)
        assert abs(F[2, i]) == pytest.approx(rho * g * mod[2, ih], rel=0.04)


def test_device_route_plain_against_native():
    """The on-device route (its plain version on the CPU) against the host
    solver on the 64-panel cylinder, deep and at 35 m: within the JAX
    package's ``PARITY_RTOL`` per output, scale-relative."""
    hull, _lid = _cylinder()
    w = np.array([0.5, 1.2])
    for depth in (0.0, 35.0):
        ref = torch_bem.solve_bem_any(hull, w, beta=0.3, depth=depth, mode="native",
                                      cache=False, device="cpu")
        got = torch_bem.solve_bem_any(hull, w, beta=0.3, depth=depth, mode="jax",
                                      cache=False, device="cpu")
        for g, r in zip(got, ref):
            assert torch_bem.parity_err(g, r) <= torch_bem.PARITY_RTOL, depth


def test_auto_mode_rule(monkeypatch):
    """An explicit native or jax wins; None or "auto" defers to
    RAFT_TPU_BEM; auto then takes the kernels on the card and the native
    solver on the CPU; a bad knob warns and is auto."""
    monkeypatch.delenv(torch_bem.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert torch_bem.resolved_mode(None, None) == "jax"
    assert torch_bem.resolved_mode("auto", "cuda") == "jax"
    assert torch_bem.resolved_mode("auto", "cpu") == "native"
    assert torch_bem.resolved_mode(None, "cpu") == "native"
    assert torch_bem.resolved_mode("jax", "cpu") == "jax"
    assert torch_bem.resolved_mode("native", "cuda") == "native"
    monkeypatch.setenv(torch_bem.ENV_VAR, "jax")
    assert torch_bem.resolved_mode("auto", "cpu") == "jax"
    assert torch_bem.resolved_mode("native", "cpu") == "native"
    monkeypatch.setenv(torch_bem.ENV_VAR, " Native ")
    assert torch_bem.resolved_mode(None, "cuda") == "native"
    assert torch_bem.resolved_mode("jax", "cuda") == "jax"
    monkeypatch.setenv(torch_bem.ENV_VAR, "capytaine")
    with pytest.warns(UserWarning, match="native|jax|auto"):
        assert torch_bem.resolved_mode(None, "cpu") == "native"
    with pytest.raises(ValueError, match="BEM mode"):
        torch_bem.resolved_mode("capytaine", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(torch_bem.ENV_VAR)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_bem.resolved_mode("auto", None)
