"""BEM coefficient files and frequency-grid interpolation (the port's own
copy of the WAMIT part of ``raft_tpu.hydro.bem_io``, host numpy).

The WAMIT ``.1`` (added mass and damping), ``.3`` (excitation, one heading
or a grid) and ``.hst`` (hydrostatics) readers, their writers, the
WAMIT nondimensionalization both ways, and the interpolation onto the
model's frequency grid: what a user needs to stage HAMS or WAMIT output as
``Model(BEM=(A, B, F))``, and the format of the host solver's validation
fixtures (``tests/data/cylinder``, ``tests/data/cyl_fd``).  The HAMS
project and control writers and the NEMOH readers come with a later slice
(ROADMAP.md, queue 1, item 5).
"""
from __future__ import annotations

import numpy as np


# ----------------------------------------------------------- WAMIT readers


def read_wamit1(path: str):
    """Read a WAMIT .1 file: returns (w, addedMass[6,6,nw], damping[6,6,nw]).

    Coefficients are WAMIT-nondimensional (A' = A/(rho L^k),
    B' = B/(rho w L^k)); see :func:`dimensionalize`.
    """
    data = np.loadtxt(path)
    w = np.unique(data[:, 0])
    nw = len(w)
    A = data[:, 3].reshape(nw, 6, 6).transpose(1, 2, 0)
    B = data[:, 4].reshape(nw, 6, 6).transpose(1, 2, 0)
    return w, A, B


def read_wamit3(path: str, heading: float | None = None):
    """Read a WAMIT .3 excitation file, ALL headings.

    Returns (w, headings, mod, phase_deg, re, im).  With one heading in the
    file (or ``heading=`` selecting one) the arrays are [6, nw] — the
    reference reader's layout (hams/pyhams.py:325-359, which always keeps a
    single heading).  Multi-heading files return [nh, 6, nw] stacked in
    ``headings`` order.
    """
    data = np.loadtxt(path)
    w = np.unique(data[:, 0])
    headings = np.unique(data[:, 1])
    if heading is not None:
        i = int(np.argmin(np.abs(headings - heading)))
        if not np.isclose(headings[i], heading):
            raise ValueError(
                f"heading {heading} not in file (has {headings})"
            )
        data = data[np.isclose(data[:, 1], headings[i])]
        headings = headings[i : i + 1]
    nw, nh = len(w), len(headings)

    def grab(col):
        out = np.empty((nh, 6, nw))
        for ih, hd in enumerate(headings):
            rows = data[np.isclose(data[:, 1], hd)]
            out[ih] = rows[:, col].reshape(nw, 6).T
        return out[0] if nh == 1 else out

    return w, headings, grab(3), grab(4), grab(5), grab(6)


def read_wamit_hst(path: str):
    """Read a WAMIT .hst hydrostatic-stiffness file -> C'[6,6] (nondim)."""
    C = np.zeros((6, 6))
    for row in np.loadtxt(path):
        C[int(row[0]) - 1, int(row[1]) - 1] = row[2]
    return C


def dimensionalize(w, A_bar, B_bar, X_re_bar, X_im_bar, rho=1025.0, g=9.81, ulen=1.0):
    """WAMIT nondimensional -> SI, for ULEN=ulen.

    A_ij = rho ulen^k A'_ij ; B_ij = rho w ulen^k B'_ij ;
    X_i = rho g A ulen^m X'_i  (per unit wave amplitude).
    k = 3 for translation-translation, 4 cross, 5 rotation-rotation;
    m = 2 translation, 3 rotation.
    """
    k = np.zeros((6, 6))
    for i in range(6):
        for j in range(6):
            k[i, j] = 3 + (i >= 3) + (j >= 3)
    m = np.where(np.arange(6) < 3, 2.0, 3.0)
    A = rho * (ulen ** k)[:, :, None] * A_bar
    B = rho * (ulen ** k)[:, :, None] * B_bar * np.asarray(w)[None, None, :]
    scale = rho * g * (ulen ** m)[:, None]
    F = scale * (X_re_bar + 1j * X_im_bar)
    return A, B, F


def interp_to_grid(w_src, arr, w_dst):
    """Interpolate coefficient arrays (..., nw_src) onto w_dst.

    Raises ValueError if w_dst extends beyond the source grid."""
    w_src = np.asarray(w_src)
    w_dst = np.asarray(w_dst)
    if w_dst.min() < w_src.min() - 1e-9 or w_dst.max() > w_src.max() + 1e-9:
        raise ValueError(
            f"requested grid [{w_dst.min():.3f}, {w_dst.max():.3f}] outside "
            f"source data range [{w_src.min():.3f}, {w_src.max():.3f}]"
        )
    out = np.empty(arr.shape[:-1] + (len(w_dst),), dtype=arr.dtype)
    flat = arr.reshape(-1, arr.shape[-1])
    oflat = out.reshape(-1, len(w_dst))
    for i in range(flat.shape[0]):
        if np.iscomplexobj(arr):
            oflat[i] = np.interp(w_dst, w_src, flat[i].real) + 1j * np.interp(
                w_dst, w_src, flat[i].imag
            )
        else:
            oflat[i] = np.interp(w_dst, w_src, flat[i])
    return out


def load_wamit_coeffs(path1: str, path3: str, w_grid, rho=1025.0, g=9.81,
                      heading: float | None = None):
    """Read + dimensionalize + interpolate: returns (A, B, F) on w_grid,
    ready for ``Model(design, BEM=(A, B, F))``.  Multi-heading .3 files:
    pass ``heading`` (deg) to select one; default takes the first heading
    (the reference reader's behavior, hams/pyhams.py:325-359)."""
    w1, A_bar, B_bar = read_wamit1(path1)
    w3, _hds, _, _, re, im = read_wamit3(path3, heading=heading)
    if re.ndim == 3:                   # multi-heading, none selected
        re, im = re[0], im[0]
    A, B, F = dimensionalize(w1, A_bar, B_bar, re, im, rho=rho, g=g)
    if len(w1) != len(w3) or not np.allclose(w1, w3):
        F = interp_to_grid(w3, F, w1)
    return (
        interp_to_grid(w1, A, w_grid),
        interp_to_grid(w1, B, w_grid),
        interp_to_grid(w1, F, w_grid),
    )


def nondimensionalize(w, A, B, F, rho=1025.0, g=9.81, ulen=1.0):
    """SI -> WAMIT nondimensional (inverse of :func:`dimensionalize`)."""
    k = np.zeros((6, 6))
    for i in range(6):
        for j in range(6):
            k[i, j] = 3 + (i >= 3) + (j >= 3)
    m = np.where(np.arange(6) < 3, 2.0, 3.0)
    A_bar = np.asarray(A) / (rho * (ulen ** k)[:, :, None])
    B_bar = np.asarray(B) / (rho * (ulen ** k)[:, :, None] * np.asarray(w)[None, None, :])
    X_bar = np.asarray(F) / (rho * g * (ulen ** m)[:, None])
    return A_bar, B_bar, X_bar


def write_wamit1(path: str, w, A, B, rho=1025.0, g=9.81, ulen=1.0):
    """Write a WAMIT .1 added-mass/damping file from SI arrays
    (A[6,6,nw], B[6,6,nw]) — the format HAMS emits to
    Output/Wamit_format (cf. read_wamit1)."""
    A_bar, B_bar, _ = nondimensionalize(w, A, B, np.zeros((6, len(w))),
                                        rho=rho, g=g, ulen=ulen)
    with open(path, "w") as f:
        for iw, wv in enumerate(np.asarray(w)):
            for i in range(6):
                for j in range(6):
                    f.write(f" {wv:13.6E} {i+1:5d} {j+1:5d} "
                            f"{A_bar[i, j, iw]:13.6E} {B_bar[i, j, iw]:13.6E}\n")
    return path


def write_wamit3(path: str, w, F, rho=1025.0, g=9.81, ulen=1.0, heading=0.0):
    """Write a WAMIT .3 excitation file from SI excitation (complex, per
    unit wave amplitude): F[6,nw] with a scalar ``heading`` [deg], or
    F[nh,6,nw] with ``heading`` a matching grid of degrees."""
    F = np.asarray(F)
    if F.ndim == 2:
        F = F[None]
        headings = [float(heading)]
    else:
        headings = list(np.atleast_1d(heading).astype(float))
        if len(headings) != F.shape[0]:
            raise ValueError(f"{F.shape[0]} heading blocks, {len(headings)} headings")
    X_bars = [
        nondimensionalize(w, np.zeros((6, 6, len(w))), np.ones((6, 6, len(w))),
                          F[ih], rho=rho, g=g, ulen=ulen)[2]
        for ih in range(len(headings))
    ]
    with open(path, "w") as f:
        for iw, wv in enumerate(np.asarray(w)):
            for ih, hd in enumerate(headings):
                for i in range(6):
                    x = X_bars[ih][i, iw]
                    f.write(f" {wv:13.6E} {hd:10.3f} {i+1:5d} "
                            f"{abs(x):13.6E} {np.degrees(np.angle(x)):13.6E} "
                            f"{x.real:13.6E} {x.imag:13.6E}\n")
    return path
