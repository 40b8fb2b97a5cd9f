"""BEM coefficient files and frequency-grid interpolation (the port's own
copy of the WAMIT part of ``raft_tpu.hydro.bem_io``, host numpy).

The WAMIT ``.1`` (added mass and damping), ``.3`` (excitation, one heading
or a grid) and ``.hst`` (hydrostatics) readers, their writers, the
WAMIT nondimensionalization both ways, and the interpolation onto the
model's frequency grid: what a user needs to stage HAMS or WAMIT output as
``Model(BEM=(A, B, F))``, and the format of the host solver's validation
fixtures (``tests/data/cylinder``, ``tests/data/cyl_fd``).  Then the HAMS
project files (the directory tree, ``Input/Hydrostatic.in`` and
``Input/ControlFile.in``, byte for byte the JAX package's) and the Nemoh
mesh reader and its ``.pnl`` converter.
"""
from __future__ import annotations

import os

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
    (the reference reader's behavior, hams/pyhams.py:325-359).

    When the cache is enabled (:func:`raft_tpu_torch.cache.enable`) the
    staged (A, B, F) arrays are memoized on disk
    (:func:`raft_tpu_torch.cache.staging.cached_arrays`, category
    ``"wamit_coeffs"``) keyed by the two files' CONTENTS, the grid, the
    constants and the heading, so a repeat process skips the parse and the
    interpolation; editing either file re-keys the entry.
    """
    from raft_tpu_torch.cache import staging

    def _compute():
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

    if not staging.config.is_enabled():
        return _compute()
    return staging.cached_arrays(
        "wamit_coeffs",
        (staging.FileKey(path1), staging.FileKey(path3), np.asarray(w_grid, dtype=float),
         float(rho), float(g), None if heading is None else float(heading)),
        _compute,
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


# ------------------------------------------------------ HAMS project files


def create_project_dirs(project_dir: str):
    """The HAMS project tree under ``project_dir``: ``Input`` and
    ``Output`` with its HAMS, Hydrostar and WAMIT format folders."""
    for sub in ("Input", "Output", "Output/Hams_format", "Output/Hydrostar_format",
                "Output/Wamit_format"):
        os.makedirs(os.path.join(project_dir, sub), exist_ok=True)


def write_hydrostatic_file(project_dir: str, cog=(0.0, 0.0, 0.0), mass=None, damping=None,
                           kHydro=None, kExt=None):
    """Write ``Input/Hydrostatic.in``: the centre of gravity and the 6 x 6
    mass, external damping, hydrostatic and external restoring matrices
    (zeros where not given).  Returns the path."""
    mats = [np.zeros((6, 6)) if M is None else np.asarray(M) for M in (mass, damping, kHydro, kExt)]
    path = os.path.join(project_dir, "Input", "Hydrostatic.in")
    with open(path, "w") as f:
        f.write(" Center of Gravity:\n")
        f.write(f"  {cog[0]:>12.6E}  {cog[1]:>12.6E}  {cog[2]:>12.6E}\n")
        for name, M in zip(("Body Mass Matrix:", "External Linear Damping Matrix:",
                            "Hydrostatic Restoring Matrix:", "External Restoring Matrix:"), mats):
            f.write(f" {name}\n")
            for row in M:
                f.write("".join(f"  {x:>12.6E}" for x in row) + "\n")
    return path


def write_control_file(project_dir: str, water_depth: float = 50.0, num_freqs: int = 30,
                       min_freq: float = 0.2, d_freq: float = 0.2, num_headings: int = 1,
                       min_heading: float = 0.0, d_heading: float = 0.0, num_threads: int = 8,
                       irr: int = 0):
    """Write ``Input/ControlFile.in``.  The frequency count is written
    negative: the list is of angular frequencies (the HAMS convention).
    Returns the path."""
    lines = [
        "   --------------HAMS Control file---------------", "",
        f"   Waterdepth  {water_depth}D0", "",
        "   #Start Definition of Wave Frequencies",
        f"    0_inf_frequency_limits      {irr}",
        "    Input_frequency_type        3",
        "    Output_frequency_type       3",
        f"    Number_of_frequencies      -{abs(num_freqs)}",
        f"    Minimum_frequency_Wmin      {min_freq}D0",
        f"    Frequency_step              {d_freq}D0",
        "   #End Definition of Wave Frequencies", "",
        "   #Start Definition of Wave Headings",
        f"    Number_of_headings          {num_headings}",
        f"    Minimum_heading             {min_heading}D0",
        f"    Heading_step                {d_heading}D0",
        "   #End Definition of Wave Headings", "",
        "    Reference_body_center   0.000000  0.000000  0.000000",
        "    Reference_body_length   1.0D0",
        "    Wave-diffrac-solution   2",
        f"    If_remove_irr_freq      {irr}",
        f"    Number of threads       {num_threads}", "",
        "   #Start Definition of Pressure and/or Elevation",
        "    Number_of_field_points     0",
        "   #End Definition of Pressure and/or Elevation", "",
        "   ----------End HAMS Control file---------------",
    ]
    path = os.path.join(project_dir, "Input", "ControlFile.in")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


# ------------------------------------------------------------- Nemoh meshes


def read_nemoh_mesh(path: str) -> np.ndarray:
    """Read a Nemoh mesh (``.nemoh``/``.dat``) into (n, 4, 3) panels: the
    header line, node lines ``id x y z`` up to an id of 0, then panel lines
    of four node ids up to four zeros."""
    nodes = {}
    panels = []
    in_nodes = True
    with open(path) as f:
        f.readline()                    # header, e.g. "2 0"
        for ln in f:
            parts = ln.split()
            if not parts:
                continue
            if in_nodes:
                if len(parts) >= 4:
                    idx = int(parts[0])
                    if idx == 0:
                        in_nodes = False
                        continue
                    nodes[idx] = [float(parts[1]), float(parts[2]), float(parts[3])]
            else:
                ids = [int(p) for p in parts[:4]]
                if all(i == 0 for i in ids):
                    break
                panels.append([nodes[i] for i in ids])
    return np.asarray(panels)


def nemoh_to_pnl(nemoh_path: str, pnl_path: str):
    """Convert a Nemoh mesh file to the HAMS ``.pnl`` format; returns
    ``pnl_path``."""
    from raft_tpu_torch.hydro.mesh import write_pnl

    write_pnl(pnl_path, read_nemoh_mesh(nemoh_path))
    return pnl_path
