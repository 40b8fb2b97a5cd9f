"""The plain version of kernel K4 (wave part) on finite-depth frequency
chunks, against the JAX package's Pallas kernel in interpret mode and its
XLA route (``jax_bem._wave_fd`` / ``_wave_deep`` + the combine).

Same mesh, seeded tables and limits as ``test_torch_bem_kernels.py``
(K4: 1e-10 in f64, 1e-4 in f32, scale-relative per output): a 200 m chunk
whose first frequency (0.4 rad/s) takes the four-image branch and whose
second (1.5 rad/s) the deep one, and a 35 m chunk where both are finite
depth."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.core import pallas_bem
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import mesh as jmesh
from raft_tpu.hydro import wavetable as jwt

from raft_tpu_torch.hydro import torch_bem, wavetable

TOL = {"float64": {"wave": 1e-10}, "float32": {"wave": 1e-4}}
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
@pytest.mark.parametrize("depth,ws", [(200.0, (0.4, 1.5)), (35.0, (0.5, 2.2))],
                         ids=["mixed-200m", "finite-35m"])
def test_wave_plain_finite_depth_matches_both_jax_routes(case, dt, depth, ws):
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
