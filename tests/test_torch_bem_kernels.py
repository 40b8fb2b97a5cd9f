"""The plain versions of kernels K3 (Rankine) and K4 (wave part) against the
JAX package's two assembly routes: the Pallas kernels in interpret mode
(``pallas_bem.rankine_assembly`` / ``wave_assembly``) and the XLA route
(``jax_bem._rankine_fused``, ``_wave_deep``, ``_wave_fd`` + the combine).

The mesh is the JAX package's 64-panel test cylinder (30 hull panels) plus
a 12-panel waterplane lid, so lid self pairs at z = 0 and degenerate
padding are on the diagonal.  The wave tables are seeded random numbers:
the functions compared interpolate whatever table they are given, and a
random one needs no 20 s build.  Limits, scale-relative per output: K3
1e-12 and K4 1e-10 in f64; 1e-4 in f32 (the JAX package's
INTERP_PARITY_RTOL between its own routes)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.core import pallas_bem
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import mesh as jmesh
from raft_tpu.hydro import wavetable as jwt

from raft_tpu_torch.core import cuda_bem
from raft_tpu_torch.hydro import torch_bem, wavetable

TOL = {"float64": {"rankine": 1e-12, "wave": 1e-10}, "float32": {"rankine": 1e-4, "wave": 1e-4}}
DTYPES = {"float64": (torch.float64, jnp.float64), "float32": (torch.float32, jnp.float32)}


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    hull = jmesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                             rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)
    lid = jmesh.disk_panels([0.0, 0.0, 0.0], 1.15, da_max=1.3)
    padded, pm, lm = jax_bem._pad_mesh(hull, lid)
    rng = np.random.default_rng(20261016)
    tab = {"I0": 0.3 * rng.normal(size=(wavetable.NX, wavetable.NS)),
           "I1": 0.3 * rng.normal(size=(wavetable.NX, wavetable.NS))}
    return padded, pm, lm, tab


def _jax_geometry(padded, pm, lm, jdt):
    P = jnp.asarray(padded, jdt)
    c, nrm, area, diag = jax_bem.panel_geometry(P)
    lid_surface = (jnp.asarray(lm, jdt) > 0.5) & (jnp.abs(c[:, 2]) < 1e-6 * jnp.maximum(diag, 1e-9))
    return P, c, nrm, area, diag, jnp.asarray(pm, jdt), lid_surface


def _torch_geometry(padded, pm, lm, tdt):
    P = torch.as_tensor(padded).to(tdt)
    c, nrm, area, diag = torch_bem.panel_geometry(P)
    lmt = torch.as_tensor(lm).to(tdt)
    lid_surface = (lmt > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
    return P, c, nrm, area, diag, torch.as_tensor(pm).to(tdt), lid_surface


def _err(got, ref):
    return torch_bem.parity_err(got.double().numpy(), np.asarray(ref, dtype=np.float64))


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_rankine_plain_matches_both_jax_routes(case, dt):
    padded, pm, lm, _tab = case
    tdt, jdt = DTYPES[dt]
    jg = _jax_geometry(padded, pm, lm, jdt)
    tg = _torch_geometry(padded, pm, lm, tdt)
    assert bool((tg[6].numpy() == np.asarray(jg[6])).all()) and int(tg[6].sum()) == 12
    spot = torch_bem.self_potential(tg[0], tg[1], tg[2])
    got = torch_bem.rankine_plain(*tg, spot)
    ref_pallas = pallas_bem.rankine_assembly(*jg, jax_bem.self_potential(*jg[:3]),
                                             interpret=True)
    ref_xla = jax_bem._rankine_fused(*jg)
    for g, rp, rx in zip(got, ref_pallas, ref_xla):
        assert bool(torch.isfinite(g).all())
        assert _err(g, rp) <= TOL[dt]["rankine"]
        assert _err(g, rx) <= TOL[dt]["rankine"]
    # padded (masked-out) source columns are exactly zero
    assert float(got[0][:, 42:].abs().max()) == 0.0 and float(got[1][:, 42:].abs().max()) == 0.0


def _xla_wave(jg, R_pot, R_dn, tab, k, fd, f, finite_depth, depth):
    """The JAX package's XLA-route wave part + combine for frequency f."""
    P, c, nrm, area, diag, pmj, lid_surface = jg
    n = c.shape[0]
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    R = jnp.sqrt(dx * dx + dy * dy + 1e-20)
    zP = jnp.broadcast_to(c[:, 2][:, None], (n, n))
    zQ = jnp.broadcast_to(c[:, 2][None, :], (n, n))
    diag_lid = jnp.eye(n, dtype=bool) & lid_surface[None, :]
    if finite_depth and fd["active"][f] > 0.5:
        G, gx, gy, gz = jax_bem._wave_fd(
            jnp.asarray(fd["k0"][f], c.dtype), jnp.asarray(fd["A0"][f], c.dtype),
            jnp.asarray(fd["lam"][f], c.dtype), jnp.asarray(fd["a"][f], c.dtype), depth,
            R, dx, dy, zP, zQ, area, diag_lid, tab)
    else:
        G, gx, gy, gz = jax_bem._wave_deep(jnp.asarray(k, c.dtype), R, dx, dy, zP + zQ, area,
                                           diag_lid, tab)
    ar, colm = area[None, :], pmj[None, :]
    proj = [gx.re * nrm[:, 0][:, None] + gy.re * nrm[:, 1][:, None] + gz.re * nrm[:, 2][:, None],
            gx.im * nrm[:, 0][:, None] + gy.im * nrm[:, 1][:, None] + gz.im * nrm[:, 2][:, None]]
    return ((R_pot + G.re * ar) * colm, (G.im * ar) * colm,
            (R_dn + proj[0] * ar) * colm, (proj[1] * ar) * colm)


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("depth,ws", [(0.0, (0.7, 1.5))], ids=["deep"])
def test_wave_plain_matches_both_jax_routes(case, dt, depth, ws):
    """Deep water (the finite-depth chunks are in
    ``test_torch_bem_wave_fd.py``)."""
    padded, pm, lm, tab = case
    tdt, jdt = DTYPES[dt]
    finite = depth > 0
    w = np.array(ws)
    fd = jwt.fd_fit_grid(w, depth if finite else -1.0, 9.81)
    if depth == 200.0:
        assert list(fd["active"]) == [1.0, 0.0]
    k = w * w / 9.81
    jg = _jax_geometry(padded, pm, lm, jdt)
    tg = _torch_geometry(padded, pm, lm, tdt)
    R_pot, R_dn = jax_bem._rankine_fused(*jg)
    tab_j = {key: jnp.asarray(v, jdt) for key, v in tab.items()}
    fd_t = {key: torch.as_tensor(v).to(tdt) for key, v in fd.items()} if finite else None
    got = torch_bem.wave_plain(torch.as_tensor(np.array(R_pot)), torch.as_tensor(np.array(R_dn)),
                               tg[1], tg[2], tg[3], tg[5], tg[6],
                               torch_bem.stage_tables(tab, tdt, "cpu"),
                               torch.as_tensor(k).to(tdt), fd_t, finite_depth=finite, depth=depth)
    P, c, nrm, area, diag, pmj, lid_surface = jg
    for f in range(len(w)):
        fds = ({key: fd[key][f] for key in ("k0", "A0", "active", "lam", "a")} if finite else None)
        ref_pallas = pallas_bem.wave_assembly(R_pot, R_dn, c, nrm, area, pmj, lid_surface, tab_j,
                                              jnp.asarray(k[f], jdt), fds, finite_depth=finite,
                                              depth=depth, interpret=True)
        ref_xla = _xla_wave(jg, R_pot, R_dn, tab_j, k[f], fd, f, finite, depth)
        for g, rp, rx in zip(got, ref_pallas, ref_xla):
            assert bool(torch.isfinite(g[f]).all())
            assert _err(g[f], rp) <= TOL[dt]["wave"]
            assert _err(g[f], rx) <= TOL[dt]["wave"]


def test_wrappers_take_the_plain_version_on_cpu(case, monkeypatch):
    """On CPU tensors the kernel wrappers return the plain versions'
    results and launch nothing."""
    padded, pm, lm, tab = case
    monkeypatch.setattr(cuda_bem, "LAUNCHES", {"rankine": 0, "wave": 0})
    tg = _torch_geometry(padded, pm, lm, torch.float64)
    spot = torch_bem.self_potential(tg[0], tg[1], tg[2])
    got = cuda_bem.rankine_assembly(*tg, spot)
    ref = torch_bem.rankine_plain(*tg, spot)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    tabd = torch_bem.stage_tables(tab, torch.float64, "cpu")
    k = torch.tensor([0.05, 0.2], dtype=torch.float64)
    args = (ref[0], ref[1], tg[1], tg[2], tg[3], tg[5], tg[6], tabd, k, None)
    got_w = cuda_bem.wave_assembly(*args, finite_depth=False, depth=0.0)
    ref_w = torch_bem.wave_plain(*args, finite_depth=False, depth=0.0)
    assert all(torch.equal(g, r) for g, r in zip(got_w, ref_w))
    assert cuda_bem.LAUNCHES == {"rankine": 0, "wave": 0}
    with pytest.raises(ValueError, match="no kernel"):
        cuda_bem.rankine_assembly(*(t.to("meta") for t in tg), spot.to("meta"))


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_wrappers_take_the_staged_quadrature_on_cpu(case, monkeypatch, dt):
    """On CPU tensors K3's wrapper and its plain version give the same bits
    with the quadrature staged by stage_tables (``quad=``, as solve_panels
    passes it) as without, and launch nothing; the kernel's near-pair
    counter has no plain counterpart and is refused."""
    padded, pm, lm, tab = case
    tdt = DTYPES[dt][0]
    monkeypatch.setattr(cuda_bem, "LAUNCHES", {"rankine": 0, "wave": 0})
    tg = _torch_geometry(padded, pm, lm, tdt)
    spot = torch_bem.self_potential(tg[0], tg[1], tg[2])
    quad = torch_bem.stage_tables(tab, tdt, "cpu")["quad"]
    ref = torch_bem.rankine_plain(*tg, spot)
    for got in (cuda_bem.rankine_assembly(*tg, spot, quad=quad),
                cuda_bem.rankine_assembly(*tg, spot),
                torch_bem.rankine_plain(*tg, spot, quad=quad)):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert cuda_bem.LAUNCHES == {"rankine": 0, "wave": 0}
    with pytest.raises(ValueError, match="near_count"):
        cuda_bem.rankine_assembly(*tg, spot, quad=quad,
                                  near_count=torch.zeros(1, dtype=torch.int32))


def test_quadrature_layout_matches_jax_and_kernel():
    """The subdivision points, in the JAX package's order, and the level
    offsets compiled into bem_rankine.cu."""
    got = torch_bem.quad_points()
    ref = [np.concatenate([a, b]) for a, b in zip(jax_bem._QUAD_MAIN, jax_bem._QUAD_FINE)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert torch_bem.NQ_MAIN == len(jax_bem._QUAD_MAIN[0]) == 190
    assert len(got[0]) == 766
    np.testing.assert_array_equal(torch_bem.GL16_X, jax_bem._GL16_X)
    np.testing.assert_array_equal(torch_bem.GL16_W, jax_bem._GL16_W)
    source = (torch_bem.__file__.rsplit("/hydro/", 1)[0] + "/csrc/bem_rankine.cu")
    text = open(source).read()
    starts = ", ".join(str(q) for q in torch_bem.LEVEL_START)
    counts = ", ".join(str(q) for q in torch_bem.LEVEL_COUNT)
    assert f"kLevelStart[5] = {{{starts}}}" in text and f"kLevelCount[5] = {{{counts}}}" in text


def test_build_log_kept_beside_library(tmp_path, monkeypatch):
    """The compiler's output (ptxas registers and spills) is written beside
    the library it built, so it reads back on a later run that only loads
    the library.  A stand-in compiler writes the library and one ptxas line."""
    from raft_tpu_torch.core import nvcc

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
                    'echo "ptxas info    : Used 40 registers, 0 bytes spill stores" >&2\n')
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nvcc, "_nvcc", lambda: str(fake))
    spec = cuda_bem.RANKINE
    assert nvcc.build_log(spec) is None
    nvcc.compile_all([spec])
    assert spec.path().exists() and spec.log_path().parent == spec.path().parent
    assert "Used 40 registers" in nvcc.build_log(spec)
    fake.write_text("#!/bin/sh\nexit 1\n")          # a second run builds nothing
    nvcc.compile_all([spec])
    assert "Used 40 registers" in nvcc.build_log(spec)
