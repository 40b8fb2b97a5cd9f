"""Host pieces of the port's panel BEM against the JAX package: the mesher,
the wave-integral table build, the finite-depth fit, the Bessel
polynomials, frequency interpolation and mesh padding.

Meshes and padding are equal exactly (same numpy code path); the f64
numerical pieces agree to 1e-13 (same formulas, roundoff only)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.core import bessel as jbessel
from raft_tpu.hydro import bem_io as jbem_io
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import mesh as jmesh
from raft_tpu.hydro import wavetable as jwt

from raft_tpu_torch.core import bessel
from raft_tpu_torch.hydro import bem_io, mesh, torch_bem, wavetable
from raft_tpu_torch.model import load_design

DESIGNS = ["OC3spar", "OC4semi", "OC4semi_2", "VolturnUS-S"]
TOL = 1e-13


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref))) / np.max(np.abs(ref)))


@pytest.mark.parametrize("name", DESIGNS)
def test_mesh_design_and_lid_equal_jax(name):
    design = load_design(f"raft_tpu/designs/{name}.yaml")
    for dz, da in ((3.0, 2.0), (8.0, 6.0)):
        hull = mesh.mesh_design(design, dz_max=dz, da_max=da)
        assert hull.shape[0] > 0
        np.testing.assert_array_equal(hull, jmesh.mesh_design(design, dz_max=dz, da_max=da))
        np.testing.assert_array_equal(mesh.mesh_lid(design, da_max=da),
                                      jmesh.mesh_lid(design, da_max=da))


def test_mesh_files_equal_jax(tmp_path):
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    hull = mesh.mesh_design(design, dz_max=8.0, da_max=6.0)
    mesh.write_pnl(tmp_path / "a.pnl", hull)
    jmesh.write_pnl(tmp_path / "b.pnl", hull)
    mesh.write_gdf(tmp_path / "a.gdf", hull)
    jmesh.write_gdf(tmp_path / "b.gdf", hull)
    assert (tmp_path / "a.pnl").read_text() == (tmp_path / "b.pnl").read_text()
    assert (tmp_path / "a.gdf").read_text() == (tmp_path / "b.gdf").read_text()
    np.testing.assert_array_equal(mesh.read_pnl(tmp_path / "a.pnl"),
                                  jmesh.read_pnl(tmp_path / "b.pnl"))


def test_analytic_integrals_match_jax():
    rng = np.random.default_rng(7)
    X = np.concatenate([rng.uniform(0.0, 60.0, 40), [0.0, 1e-3, 25.0, 59.9]])
    Y = -np.concatenate([rng.uniform(1e-3, 60.0, 40), [1e-6, 0.5, 1e-3, 30.0]])
    got = wavetable.analytic_i(X, Y)
    ref = jwt.analytic_i(X, Y)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL
    z = X[:8] * 0.3 + 1j * np.abs(Y[:8])
    assert _rel(wavetable.phi_pv(z), jwt.phi_pv(z)) <= TOL


def test_table_build_on_subgrid_matches_jax():
    """The smooth parts the table stores, at 64 of its grid points (8 x 8
    spread over the grid, corner included), against the JAX package's
    closed forms at the same points."""
    X1, Y1 = wavetable.grid_axes()
    np.testing.assert_array_equal(X1, jwt.XMAX * np.arange(jwt.NX) / (jwt.NX - 1))
    np.testing.assert_array_equal(Y1, 1.0 - np.exp(jwt.SMAX * np.arange(jwt.NS) / (jwt.NS - 1)))
    ix = np.linspace(0, wavetable.NX - 1, 8).astype(int)
    iy = np.linspace(0, wavetable.NS - 1, 8).astype(int)
    Xg, Yg = np.meshgrid(X1[ix], Y1[iy], indexing="ij")
    X, Y = Xg.ravel().copy(), Yg.ravel().copy()
    Y[0] = -1e-6                           # the build's X = Y = 0 corner rule
    t0, t1 = wavetable.smooth_parts(X, Y)
    a0, a1 = jwt.analytic_i(X, Y)
    assert _rel(t0, a0 - jwt.sing_i0(X, Y)) <= TOL
    assert _rel(t1, a1 - jwt.sing_i1(X, Y)) <= TOL
    assert (wavetable.NX, wavetable.NS, wavetable.XMAX, wavetable.SMAX) == \
        (jwt.NX, jwt.NS, jwt.XMAX, jwt.SMAX)
    assert wavetable._params_key() == jwt._params_key()


def test_load_tables_caches_atomically(tmp_path, monkeypatch):
    """A built table is written once, reloaded from disk by a fresh memo,
    and a torn file is rebuilt rather than served."""
    calls = []

    def fake_build():
        calls.append(1)
        return {"I0": np.full((wavetable.NX, wavetable.NS), 1.5),
                "I1": np.full((wavetable.NX, wavetable.NS), -2.5),
                "meta": np.array([wavetable.NX, wavetable.NS, wavetable.XMAX, wavetable.SMAX])}

    monkeypatch.setenv("RAFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(wavetable, "_build", fake_build)
    monkeypatch.setattr(wavetable, "_memo", {})
    tab = wavetable.load_tables()
    assert calls == [1] and float(tab["I1"][3, 4]) == -2.5
    files = list((tmp_path / "wavetable").glob("*.npz"))
    assert wavetable.cache_dir() == tmp_path / "wavetable" and len(files) == 1 and files[0].name.startswith(wavetable.TABLE_VERSION)
    monkeypatch.setattr(wavetable, "_memo", {})
    assert float(wavetable.load_tables()["I0"][0, 0]) == 1.5 and calls == [1]
    files[0].write_bytes(b"torn")
    monkeypatch.setattr(wavetable, "_memo", {})
    wavetable.load_tables()
    assert calls == [1, 1]


@pytest.mark.parametrize("depth", [35.0, 200.0])
def test_fd_fit_grid_matches_jax(depth):
    w = np.linspace(0.05, 2.95, 24)
    got = wavetable.fd_fit_grid(w, depth, 9.81)
    ref = jwt.fd_fit_grid(w, depth, 9.81)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["active"], ref["active"])
    assert 0 < got["active"].sum() < len(w) or depth < 100
    for key in ("k0", "A0", "kw", "lam", "a"):
        if np.abs(ref[key]).max() > 0:
            assert _rel(got[key], ref[key]) <= TOL, key
    assert wavetable.dispersion(0.3, depth) == pytest.approx(jwt.dispersion(0.3, depth), rel=TOL)


def test_bessel_matches_jax():
    x = np.concatenate([np.linspace(0.0, 60.0, 2401), [7.999999, 8.0, 8.000001, 1e-8]])
    xt = torch.as_tensor(x)
    for name in ("j0", "j1", "y0", "y1"):
        got = getattr(bessel, name)(xt).numpy()
        ref = np.asarray(getattr(jbessel, name)(jnp.asarray(x)))
        sel = np.isfinite(ref) & (x > 0 if name.startswith("y") else np.ones_like(x, bool))
        scale = np.maximum(np.abs(ref[sel]), 1.0)
        assert np.max(np.abs(got[sel] - ref[sel]) / scale) <= TOL, name
    neg = torch.as_tensor(-x[:50])
    np.testing.assert_allclose(bessel.j1(neg).numpy(), -bessel.j1(torch.as_tensor(x[:50])).numpy())


def test_interp_to_grid_matches_jax():
    rng = np.random.default_rng(3)
    w_src = np.linspace(0.05, 2.95, 48)
    w_dst = np.linspace(0.05, 2.95, 200)
    A = rng.normal(size=(6, 6, 48))
    F = rng.normal(size=(6, 48)) + 1j * rng.normal(size=(6, 48))
    for arr in (A, F):
        np.testing.assert_array_equal(bem_io.interp_to_grid(w_src, arr, w_dst),
                                      jbem_io.interp_to_grid(w_src, arr, w_dst))
    with pytest.raises(ValueError, match="outside source data range"):
        bem_io.interp_to_grid(w_src, A, np.linspace(0.01, 2.0, 5))
    with pytest.raises(ValueError, match="outside source data range"):
        bem_io.interp_to_grid(w_src, A, np.linspace(0.1, 3.5, 5))


def test_padding_matches_jax():
    design = load_design("raft_tpu/designs/VolturnUS-S.yaml")
    hull = mesh.mesh_design(design, dz_max=8.0, da_max=6.0)
    lid = mesh.mesh_lid(design, da_max=6.0)
    for lid_ in (None, lid):
        got = torch_bem.pad_mesh(hull, lid_)
        ref = jax_bem._pad_mesh(hull, lid_)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    for n in (1, 64, 65, 700, 1025, 2048):
        assert torch_bem.pad_panel_count(n) == jax_bem.pad_panel_count(n)
    with pytest.raises(ValueError):
        torch_bem.pad_panel_count(2049)
    assert torch_bem.freq_chunk(1024, 48) == jax_bem._freq_chunk(1024, 48) == 2
    assert torch_bem.freq_chunk(64, 3) == jax_bem._freq_chunk(64, 3)
