"""Kernel K4's reformulation of the wave part, checked on the CPU.

The kernel (``raft_tpu_torch/csrc/bem_wave.cu``) evaluates the near
quadrature's E1 series as a Horner polynomial with tables staged beside
the wave tables (``tab["near"]`` of ``torch_bem.stage_tables``), sums the
16 nodes by a shuffle tree, node-major with the images inner, and builds
the exponential-fit terms from one rsqrt.  A torch transcription of that
arithmetic, on exactly those tables, is held here against the plain
version (``torch_bem._near_integrals``, ``_wave_fd``) and the JAX
package's ``jax_bem._near_integrals``: 1e-12 scale-relative in f64.
"""
from fractions import Fraction
from math import factorial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import mesh as jmesh

from raft_tpu_torch.core import cuda_bem
from raft_tpu_torch.hydro import torch_bem, wavetable

TOL = 1e-12
PI, EULER = torch_bem._PI, torch_bem._EULER


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(dtype):
    return torch_bem.stage_tables({"I0": np.zeros((2, 2)), "I1": np.zeros((2, 2))}, dtype,
                                  "cpu")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_staged_tables_equal_their_closed_forms(dtype):
    """sin(theta_q) at theta_q = pi/2 (1 + x_q), w_q pi/2 and the Horner
    coefficients (-1)^(m+1) / (m m!), m = 1..12, in the kernel's dtype."""
    s, w, coef = _tables(dtype)["near"]
    assert s.dtype == w.dtype == coef.dtype == dtype
    assert s.shape == w.shape == (16,) and coef.shape == (torch_bem.N_SERIES,)
    x = torch_bem.GL16_X.astype(np.float64)
    eps = torch.finfo(dtype).eps
    # theta_q rounds to about an ulp of pi, so sin(theta_q) is held to that
    np.testing.assert_allclose(s.double().numpy(), np.sin(0.5 * np.pi * (1.0 + x)),
                               rtol=2 * eps, atol=2 * np.pi * eps)
    np.testing.assert_allclose(w.double().numpy(), torch_bem.GL16_W.astype(np.float64) * np.pi / 2,
                               rtol=2 * eps, atol=0)
    exact = [float(Fraction((-1) ** (m + 1), m * factorial(m))) for m in range(1, 13)]
    np.testing.assert_array_equal(coef.numpy(), np.asarray(exact, dtype=np.float64).astype(
        coef.numpy().dtype))


def test_kernel_constants_match_the_port():
    """The series length, node count and fit-term limit compiled into the
    kernel are the plain version's."""
    text = (Path(cuda_bem.__file__).parent.parent / "csrc" / "bem_wave.cu").read_text()
    assert f"constexpr int kNSeries = {torch_bem.N_SERIES};" in text
    assert "constexpr int kNodes = 16;" in text
    assert f"constexpr double kRNear = {torch_bem.R_NEAR};" in text
    assert "constexpr int kMaxNL = 64;" in text and wavetable.FD_NL <= 64


def _tree_sum(t):
    """The kernel's shuffle sum over 16 lanes (xor 8, 4, 2, 1), as lane 0
    holds it: t (16, ...)."""
    idx = torch.arange(16)
    for off in (8, 4, 2, 1):
        t = t + t[idx ^ off]
    return t[0]


def near_nodemajor(X, Ys, tables):
    """The kernel's near integrals of the images ``Ys`` at a shared ``X``:
    node-major, images inner, Horner series, e^Y once per image, one
    sincos per node; returns [(I0, I1)] per image."""
    s, w, coef = tables
    ws = w * s
    ez = [torch.exp(Y) for Y in Ys]
    a0 = [[] for _ in Ys]
    aX = [[] for _ in Ys]
    for q in range(16):
        zi = X * s[q]
        sn, cs = torch.sin(zi), torch.cos(zi)
        for m, Y in enumerate(Ys):
            az2 = torch.clamp(Y * Y + zi * zi, min=1e-14)
            log_re = 0.5 * torch.log(az2)
            log_im = torch.atan2(zi, Y)
            pr, pim = coef[-1] * torch.ones_like(Y), torch.zeros_like(Y)
            for c in coef.flip(0)[1:]:
                pr, pim = pr * Y - pim * zi + c, pr * zi + pim * Y
            sr, si = pr * Y - pim * zi, pr * zi + pim * Y
            e1r = -EULER - log_re + sr
            e1i = -log_im + si
            phr = cs * e1r - sn * (e1i + PI)
            phi = cs * (e1i + PI) + sn * e1r
            inv = 1.0 / az2
            a0[m].append(w[q] * phr)
            aX[m].append(ws[q] * (ez[m] * phi + zi * inv))
    out = []
    for m, Y in enumerate(Ys):
        i0 = (ez[m] * _tree_sum(torch.stack(a0[m]))) / PI
        dI0_dX = -_tree_sum(torch.stack(aX[m])) / PI
        rr = torch.sqrt(torch.clamp(X * X + Y * Y, min=1e-14))
        pos = X > 1e-9
        xs = torch.where(pos, X, torch.ones_like(X))
        C1 = torch.where(pos, (1.0 / xs) * (1.0 - (-Y) / rr), torch.zeros_like(X))
        out.append((i0, torch.where(pos, -C1 - dI0_dX, torch.zeros_like(X))))
    return out


def _near_grid():
    """(X, Y) over the near region rho < 0.6: a grid with X = 0 and Y = 0
    on it, and the lid self pair of the test cylinder's waterplane lid
    (X = k R_eff, Y = 0) at the staging grid's frequencies."""
    xs = np.linspace(0.0, 0.599, 41)
    ys = -np.linspace(0.0, 0.599, 41)
    X, Y = (a.ravel() for a in np.meshgrid(xs, ys))
    keep = np.hypot(X, Y) < 0.6
    lid = jmesh.disk_panels([0.0, 0.0, 0.0], 1.15, da_max=1.3)
    area = np.array([torch_bem.panel_geometry(torch.as_tensor(lid, dtype=torch.float64))[2]
                     .min().item()])
    k = np.linspace(0.05, 2.95, 48) ** 2 / 9.81
    X_lid = k * 0.4 * np.sqrt(area)
    X_lid = X_lid[X_lid < 0.6]
    return (np.concatenate([X[keep], X_lid]), np.concatenate([Y[keep], np.zeros_like(X_lid)]))


def test_nodemajor_horner_near_integrals_match_plain_and_jax():
    X, Y = _near_grid()
    assert (X == 0).any() and (Y == 0).any() and len(X) > 1000
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    tab = _tables(torch.float64)
    nodes = tab["nodes"]
    # four images sharing X, as the finite-depth pole parts do
    Ys = [Yt, 0.5 * Yt, torch.flip(Yt, (0,)) * 0.9, torch.zeros_like(Yt)]
    keep = [torch.sqrt(Xt * Xt + Y * Y + 1e-18) < 0.6 for Y in Ys]
    got = near_nodemajor(Xt, Ys, tab["near"])
    for (g0, g1), Y, k in zip(got, Ys, keep):
        p0, p1 = torch_bem._near_integrals(Xt, Y, nodes)
        j0, j1 = (torch.as_tensor(np.array(a)) for a in jax_bem._near_integrals(
            jnp.asarray(X), jnp.asarray(Y.numpy()),
            nodes=(jnp.asarray(nodes[0].numpy()), jnp.asarray(nodes[1].numpy()))))
        for g, p, j in ((g0, p0, j0), (g1, p1, j1)):
            assert bool(torch.isfinite(g[k]).all())
            assert _rel(g[k], p[k]) <= TOL and _rel(g[k], j[k]) <= TOL


@pytest.fixture(scope="module")
def cylinder():
    """The JAX package's 64-panel test cylinder with its waterplane lid."""
    hull = jmesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                             rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)
    lid = jmesh.disk_panels([0.0, 0.0, 0.0], 1.15, da_max=1.3)
    padded, pm, lm = jax_bem._pad_mesh(hull, lid)
    P = torch.as_tensor(padded, dtype=torch.float64)
    c, nrm, area, diag = torch_bem.panel_geometry(P)
    lid_surface = (torch.as_tensor(lm) > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * diag.clamp(min=1e-9))
    return c, area, lid_surface


def _fit_sums(R_use, d4, lam, a_fit, rsqrt: bool):
    """(sum a/r, sum -R a/r^3, sum -c a/r^3 sgn) over the fit terms and the
    four images: the plain version's form or the kernel's rsqrt form."""
    sgn = (-1.0, -1.0, 1.0, 1.0)
    R2 = R_use * R_use
    g0 = gR = gz = torch.zeros_like(R_use)
    for j in range(lam.shape[-1]):
        s0 = sR = sz = None
        for i in range(4):
            cc = d4[i] + lam[j]
            rr2 = torch.clamp(R2 + cc * cc, min=1e-12)
            if rsqrt:
                ri = torch.rsqrt(rr2)
                t0 = a_fit[j] * ri
                t3 = t0 * (ri * ri)
            else:
                rr = torch.sqrt(rr2)
                t0 = a_fit[j] / rr
                t3 = a_fit[j] / (rr2 * rr)
            tR, tz = -R_use * t3, -cc * t3 * sgn[i]
            s0 = t0 if s0 is None else s0 + t0
            sR = tR if sR is None else sR + tR
            sz = tz if sz is None else sz + tz
        g0, gR, gz = g0 + s0, gR + sR, gz + sz
    return g0, gR, gz


def test_rsqrt_fit_terms_match_plain_finite_depth_part(cylinder):
    """The fit terms at 0.4 rad/s in 200 m on the test cylinder: the rsqrt
    form against the plain form, and the plain finite-depth Green function
    (``_wave_fd``) with its fit part swapped for the rsqrt form."""
    c, area, lid_surface = cylinder
    n, h = c.shape[0], 200.0
    fd = wavetable.fd_fit_grid(np.array([0.4]), h, 9.81)
    assert fd["active"][0] == 1.0
    lam, a_fit = torch.as_tensor(fd["lam"][0]), torch.as_tensor(fd["a"][0])
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    R = torch.sqrt(dx * dx + dy * dy + 1e-20)
    zP = c[:, 2][:, None].expand(n, n)
    zQ = c[:, 2][None, :].expand(n, n)
    diag_lid = torch.eye(n, dtype=torch.bool) & lid_surface[None, :]
    R_use = torch.where(diag_lid, 0.4 * torch.sqrt(torch.clamp(area, min=1e-14))[None, :], R)
    d4 = [-(zP + zQ), 2.0 * h - (zP - zQ), 2.0 * h + (zP - zQ), 4.0 * h + (zP + zQ)]
    plain = _fit_sums(R_use, d4, lam, a_fit, rsqrt=False)
    fast = _fit_sums(R_use, d4, lam, a_fit, rsqrt=True)
    for g, p in zip(fast, plain):
        assert _rel(g, p) <= TOL

    tab = torch_bem.stage_tables({"I0": np.zeros((wavetable.NX, wavetable.NS)),
                                  "I1": np.zeros((wavetable.NX, wavetable.NS))},
                                 torch.float64, "cpu")
    col = {key: torch.as_tensor(fd[key])[:, None, None] for key in ("k0", "A0")}
    G, gx, gy, gz = torch_bem._wave_fd(col["k0"], col["A0"], torch.as_tensor(fd["lam"]),
                                       torch.as_tensor(fd["a"]), h, R, dx, dy, zP, zQ, area,
                                       diag_lid, tab)
    pos = R_use > 1e-12
    ux = torch.where(pos, dx / torch.where(pos, R_use, torch.ones_like(R_use)), 0.0)
    swapped = G.re - plain[0] + fast[0]
    assert _rel(swapped, G.re) <= TOL
    assert _rel(gx.re - (plain[1] - fast[1]) * ux, gx.re) <= TOL
    assert _rel(gz.re - plain[2] + fast[2], gz.re) <= TOL
