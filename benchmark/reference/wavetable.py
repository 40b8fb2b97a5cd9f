# A frozen copy of raft_tpu_torch/hydro/wavetable.py for the benchmark's reference;
# it imports nothing of the program.
"""Host-side f64 build of the wave-integral smooth-part tables (the port's
own copy of ``raft_tpu.hydro.wavetable``, numpy only).

The on-device BEM (:mod:`raft_tpu_torch.hydro.torch_bem`) needs the
dimensionless principal-value wave integrals

    I0(X, Y) = PV Int_0^inf e^{uY} J0(uX) / (u-1) du        (Y <= 0)

and its J1 counterpart I1 at every panel pair.  They are evaluated once,
on the host in f64, over a 2-D grid of (X, log(1-Y)), with the -ln rho /
1/rho singular closed forms subtracted; the device interpolates the
smooth parts bilinearly (kernel K4, ``csrc/bem_wave.cu``).  The table is
design- and frequency-independent: :func:`load_tables` keeps it in memory
and as an atomically written npz under the cache root's ``wavetable/``
(:func:`raft_tpu_torch.cache.config.cache_root`: ``RAFT_TPU_TORCH_CACHE_DIR``,
else ``raft_tpu_torch/_build/cache``, as the JAX package's table follows its
cache root), keyed by the build parameters, so the one-time build (about
20 s of numpy on one core) happens once per root.  The finite-depth exponential fit
(:func:`fd_fit_grid`) depends only on (w, depth) and stays on the host too.
"""
from __future__ import annotations

import os
import tempfile
import threading
from pathlib import Path

import numpy as np

#: version tag of the build math and grid semantics (the JAX package's)
TABLE_VERSION = "jaxwt-v1"

XMAX = 60.0                      # X grid: uniform [0, XMAX]
SMAX = float(np.log(1.0 + 60.0))  # s = log(1 - Y) grid: uniform [0, SMAX]
NX = 900
NS = 200

_EULER = 0.5772156649015329

_lock = threading.Lock()
_memo: dict = {}


def cache_dir() -> Path:
    """Where :func:`load_tables` keeps the built tables: the cache root's
    ``wavetable/``."""
    return Path(__file__).resolve().parents[1] / ".cache" / "reference" / "wavetable"


# ------------------------------------------------------------ closed forms

def sing_i0(X, Y):
    """Singular part of I0 near the origin: -ln(rho)."""
    return -0.5 * np.log(X * X + Y * Y)


def sing_i1(X, Y):
    """Singular part of I1: -C1 + X/rho^2, C1 = (1/X)(1 - (-Y)/rho)."""
    r2 = X * X + Y * Y
    with np.errstate(divide="ignore", invalid="ignore"):
        C1 = np.where(X > 1e-12, (1.0 / np.where(X > 1e-12, X, 1.0))
                      * (1.0 - (-Y) / np.sqrt(r2)), 0.0)
    return -C1 + X / r2


# -------------------------------------------------------------- Phi(zeta)

def phi_pv(z: np.ndarray) -> np.ndarray:
    """Vectorized Phi(zeta) = e^zeta [E1(zeta) + i pi], Im zeta >= 0.

    Power series for |z| <= 22 (principal log = the PV convention on the
    negative-real cut), asymptotic e^{-z}/z series beyond — the exact
    branch structure of native/bem.cpp::phi_pv, vectorized.
    """
    z = np.asarray(z, dtype=np.complex128)
    az = np.abs(z)
    z = np.where(az < 1e-14, -1e-14 + 0.0j, z)
    az = np.abs(z)
    out = np.empty_like(z)

    small = az <= 22.0
    if small.any():
        zs = z[small]
        term = np.ones_like(zs)
        ssum = np.zeros_like(zs)
        for n in range(1, 221):
            term = term * (-zs) / n
            add = -term / n
            ssum += add
            if n > 4 and np.all(np.abs(add) < 1e-17 * (1.0 + np.abs(ssum))):
                break
        E1 = -_EULER - np.log(zs) + ssum
        out[small] = np.exp(zs) * (E1 + 1j * np.pi)

    big = ~small
    if big.any():
        zb = z[big]
        # e^z E1(z) ~ (1/z) sum (-1)^n n! / z^n; for |z| > 22 the first 20
        # terms are strictly decreasing, so the truncate-at-smallest-term
        # rule of the native code reduces to a plain 20-term sum
        acc = np.zeros_like(zb)
        zp = 1.0 / zb
        fact = 1.0
        for n in range(20):
            acc += (fact if n % 2 == 0 else -fact) * zp
            zp = zp / zb
            fact *= n + 1
        out[big] = acc + np.exp(zb) * (1j * np.pi)
    return out


def analytic_i(X, Y):
    """Exact (I0, I1) via the theta reduction — vectorized f64 port of
    native/bem.cpp::analytic_I (64-pt Gauss-Legendre per pi/m segment,
    m = 1 + int(X/20) segments to resolve cos(X sin theta))."""
    X = np.asarray(X, dtype=np.float64).ravel()
    Y = np.asarray(Y, dtype=np.float64).ravel()
    gx, gw = np.polynomial.legendre.leggauss(64)
    i0 = np.zeros_like(X)
    dI0_dX = np.zeros_like(X)
    m_all = 1 + (X / 20.0).astype(int)
    for m in np.unique(m_all):
        sel = m_all == m
        Xs, Ys = X[sel], Y[sel]
        acc0 = np.zeros_like(Xs)
        accX = np.zeros_like(Xs)
        for p in range(m):
            a = np.pi * p / m
            b = np.pi * (p + 1) / m
            th = 0.5 * (a + b) + 0.5 * (b - a) * gx          # (64,)
            wgt = gw * 0.5 * (b - a)
            s = np.sin(th)
            zeta = Ys[:, None] + 1j * Xs[:, None] * s[None, :]
            Phi = phi_pv(zeta)
            acc0 += (wgt[None, :] * Phi.real).sum(axis=1)
            dPhi = -1.0 / np.where(np.abs(zeta) < 1e-14, -1e-14 + 0j,
                                   zeta) + Phi
            accX += (wgt[None, :] * (dPhi * (1j * s[None, :])).real
                     ).sum(axis=1)
        i0[sel] = acc0 / np.pi
        dI0_dX[sel] = accX / np.pi
    rr = np.sqrt(X * X + Y * Y)
    with np.errstate(divide="ignore", invalid="ignore"):
        C1 = np.where(X > 1e-9, (1.0 / np.where(X > 1e-9, X, 1.0))
                      * (1.0 - (-Y) / rr), 0.0)
    i1 = np.where(X > 1e-9, -C1 - dI0_dX, 0.0)
    return i0, i1


# ----------------------------------------------------------------- tables

def _params_key() -> str:
    return f"{TABLE_VERSION}-{NX}x{NS}-{XMAX:g}-{SMAX:.6f}"


def grid_axes():
    """The table's X and Y = 1 - e^s grid axes, (NX,) and (NS,)."""
    X1 = XMAX * np.arange(NX) / (NX - 1)
    s1 = SMAX * np.arange(NS) / (NS - 1)
    return X1, 1.0 - np.exp(s1)


def smooth_parts(X, Y):
    """(I0 - sing_i0, I1 - sing_i1) at the points (X, Y), chunked to bound
    memory -- the values the table stores at its grid points."""
    X = np.asarray(X, dtype=np.float64).ravel()
    Y = np.asarray(Y, dtype=np.float64).ravel()
    t0 = np.empty_like(X)
    t1 = np.empty_like(X)
    chunk = 4096
    for lo in range(0, len(X), chunk):
        hi = min(lo + chunk, len(X))
        a0, a1 = analytic_i(X[lo:hi], Y[lo:hi])
        t0[lo:hi] = a0 - sing_i0(X[lo:hi], Y[lo:hi])
        t1[lo:hi] = a1 - sing_i1(X[lo:hi], Y[lo:hi])
    return t0, t1


def _build() -> dict:
    """Evaluate the smooth parts over the full (X, s) grid -- a one-time
    ~20 s f64 numpy pass on one core."""
    X1, Y1 = grid_axes()
    Xg, Yg = np.meshgrid(X1, Y1, indexing="ij")        # (NX, NS)
    Xf, Yf = Xg.ravel().copy(), Yg.ravel().copy()
    Yf[0] = -1e-6                                      # avoid X=Y=0 corner
    t0, t1 = smooth_parts(Xf, Yf)
    return {
        "I0": t0.reshape(NX, NS), "I1": t1.reshape(NX, NS),
        "meta": np.array([NX, NS, XMAX, SMAX], dtype=np.float64),
    }


def _load(path: Path) -> dict | None:
    """The cached tables, or None when the file is missing, torn or of
    other parameters (then it is rebuilt and replaced)."""
    try:
        with np.load(path) as z:
            tab = {k: np.array(z[k]) for k in ("I0", "I1", "meta")}
    except (OSError, ValueError, KeyError, EOFError):
        return None
    if (int(tab["meta"][0]), int(tab["meta"][1])) != (NX, NS) or \
            tab["I0"].shape != (NX, NS) or tab["I1"].shape != (NX, NS):
        return None
    return tab


def _store(path: Path, tab: dict):
    """Atomic publish: write a temporary file beside the target, then
    ``os.replace`` it, so a reader never sees a torn file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **tab)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_tables() -> dict:
    """The smooth-part tables ``{"I0", "I1", "meta"}`` (f64 numpy, (NX, NS)),
    from the in-process memo, the npz under :func:`cache_dir`, or a fresh
    build that is then written there."""
    key = _params_key()
    with _lock:
        hit = _memo.get(key)
        if hit is not None:
            return hit
        path = cache_dir() / f"{key}.npz"
        tab = _load(path)
        if tab is None:
            tab = _build()
            _store(path, tab)
        _memo[key] = tab
        return tab


# ------------------------------------------------- finite-depth fit (host)

def dispersion(nu: float, h: float) -> float:
    """k0 with k0 tanh(k0 h) = nu (Newton, the native iteration)."""
    k = np.sqrt(nu / h) if nu * h < 1.0 else nu
    for _ in range(100):
        t = np.tanh(k * h)
        c = np.cosh(k * h)
        f = k * t - nu
        df = t + k * h / (c * c)
        dk = f / df
        k -= dk
        if abs(dk) < 1e-15 * (k + 1e-300):
            break
    return float(k)


FD_NL = 46          # exponential-fit terms (native FDGreen::NL)


def fd_fit(nu: float, h: float) -> dict | None:
    """Per-frequency finite-depth Green-function fit — the f64 host port
    of native/bem.cpp::FDGreen::setup.  Returns None outside the active
    regime (h <= 0, nu <= 0, or k0 h >= 10: deep water).

    The fit depends only on (nu, h) — never on geometry — so it stays on
    host at oracle precision and feeds the device kernel as plain input
    arrays (lam/a/k0/A0 per frequency)."""
    if h <= 0 or nu <= 0:
        return None
    k0 = dispersion(nu, h)
    if k0 * h >= 10.0:
        return None
    e2 = np.exp(-2.0 * k0 * h)
    A0 = (k0 + nu) / (2.0 * (1.0 - e2 + 2.0 * h * (k0 + nu) * e2))
    NSs = 1200
    mumax = 20.0 * max(k0, 1.0 / h)
    t = np.arange(NSs) / (NSs - 1)
    mu = mumax * t * t
    ref = max(k0, 1.0)
    mu = np.where(np.abs(mu - k0) < 1e-9 * ref, mu + 1e-6 * ref, mu)
    F = (mu + nu) / (2.0 * ((mu - nu) - (mu + nu) * np.exp(-2.0 * mu * h)))
    y = 2.0 * F - 1.0 - 2.0 * A0 / (mu - k0)
    lmin = min(h, 1.0 / k0) / 50.0
    lmax = 50.0 / (mumax / 20.0)
    lam = lmin * (lmax / lmin) ** (np.arange(FD_NL) / (FD_NL - 1))
    B = np.exp(-mu[:, None] * lam[None, :])            # (NS, NL)
    coln = np.sqrt((B * B).sum(axis=0))
    Bs = B / coln[None, :]
    M = Bs.T @ Bs + 1e-10 * np.eye(FD_NL)
    rhs = Bs.T @ y
    a = np.linalg.solve(M, rhs) / coln
    return {"k0": float(k0), "A0": float(A0), "lam": lam, "a": a}


def fd_fit_grid(w: np.ndarray, depth: float, g: float) -> dict:
    """Stack per-frequency fits into kernel input arrays.

    Returns dict of (nw,)-leading f64 arrays: ``active`` (1.0 where the
    finite-depth path applies), ``k0``/``A0``/``kw`` and the (nw, NL)
    ``lam``/``a`` fit (zeros where inactive — the kernel selects per
    frequency).  ``kw`` is the incident wavenumber: k0 when active, the
    deep nu = w^2/g otherwise."""
    w = np.asarray(w, dtype=np.float64)
    nw = len(w)
    out = {
        "active": np.zeros(nw), "k0": np.zeros(nw), "A0": np.zeros(nw),
        "lam": np.ones((nw, FD_NL)), "a": np.zeros((nw, FD_NL)),
        "kw": np.zeros(nw),
    }
    for i, om in enumerate(w):
        nu = float(om * om / g)
        fit = fd_fit(nu, depth) if depth and depth > 0 else None
        if fit is None:
            out["kw"][i] = nu
        else:
            out["active"][i] = 1.0
            out["k0"][i] = fit["k0"]
            out["A0"][i] = fit["A0"]
            out["lam"][i] = fit["lam"]
            out["a"][i] = fit["a"]
            out["kw"][i] = fit["k0"]
    return out
