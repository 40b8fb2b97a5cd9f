"""Capytaine BEM datasets (the port's own copy of ``raft_tpu.hydro.capy``,
host numpy).

* :func:`read_capy_nc` reads a Capytaine NetCDF (classic CDF) dataset into
  ``(w, addedMass[6, 6, nw], damping[6, 6, nw], fEx[6, nw])``, with the
  degrees of freedom put in surge..yaw order and, with ``wDes``, linear
  interpolation onto a design frequency grid (a grid beyond the data
  raises ``ValueError``).
* :func:`load_capytaine_nc` returns ``(A, B, F)`` ready for
  ``Model(design, BEM=(A, B, F))``, the staging layout of the WAMIT readers
  (:func:`raft_tpu_torch.hydro.bem_io.load_wamit_coeffs`).
* :func:`call_capy` runs a live Capytaine radiation and diffraction solve;
  it needs the optional ``capytaine`` package and raises ``ImportError``
  without it.
"""
from __future__ import annotations

import numpy as np

_DOF_ORDER = ("Surge", "Sway", "Heave", "Roll", "Pitch", "Yaw")


def _decode(char_rows) -> list[str]:
    """NetCDF character rows -> stripped strings."""
    return ["".join(c.decode() for c in row).strip("\x00 ") for row in char_rows]


def read_capy_nc(path: str, wDes=None, heading_idx: int = 0,
                 include_froude_krylov: bool = True):
    """Read a Capytaine NetCDF dataset.

    Returns ``(w, addedMass, damping, fEx)`` of shapes ``(nw,)``,
    ``(6, 6, nw)``, ``(6, 6, nw)`` and ``(6, nw)`` (``fEx`` complex128, per
    unit wave amplitude, at heading ``heading_idx``).  The excitation is
    the diffraction force plus the Froude-Krylov force;
    ``include_froude_krylov=False`` takes the diffraction force alone.
    With ``wDes`` every output is interpolated linearly onto it and
    ``wDes`` is returned first; a ``wDes`` outside the data's frequencies
    raises ``ValueError``."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        w = np.array(f.variables["omega"][:], dtype=float)
        A = np.array(f.variables["added_mass"][:], dtype=float)
        B = np.array(f.variables["radiation_damping"][:], dtype=float)
        D = np.array(f.variables["diffraction_force"][:], dtype=float)
        FK = np.array(f.variables["Froude_Krylov_force"][:], dtype=float)
        rad_dofs = _decode(f.variables["radiating_dof"][:])
        inf_dofs = _decode(f.variables["influenced_dof"][:])

    # the dataset may order its degrees of freedom otherwise
    ri = [rad_dofs.index(d) for d in _DOF_ORDER]
    ii = [inf_dofs.index(d) for d in _DOF_ORDER]
    # (omega, radiating, influenced) -> (radiating, influenced, omega)
    A = A[:, ri, :][:, :, ii].transpose(1, 2, 0)
    B = B[:, ri, :][:, :, ii].transpose(1, 2, 0)
    # (complex part, omega, heading, dof) -> complex (dof, omega)
    if include_froude_krylov:
        fEx_all = (D[0] + FK[0]) + 1j * (D[1] + FK[1])
    else:
        fEx_all = D[0] + 1j * D[1]
    fEx = fEx_all[:, heading_idx, :][:, ii].T.astype(np.complex128)

    if wDes is not None:
        wDes = np.asarray(wDes, dtype=float)
        if wDes.min() < w.min() - 1e-12 or wDes.max() > w.max() + 1e-12:
            raise ValueError(
                f"requested frequency range [{wDes.min():.3f}, {wDes.max():.3f}] outside "
                f"capytaine data range [{w.min():.3f}, {w.max():.3f}]")
        return (wDes, _interp_last(w, A, wDes), _interp_last(w, B, wDes),
                _interp_last(w, fEx, wDes))
    return w, A, B, fEx


def _interp_last(w_src, arr, w_dst):
    """``np.interp`` along the last axis, row by row (a complex row in one
    call)."""
    out = np.empty(arr.shape[:-1] + (len(w_dst),), dtype=arr.dtype)
    flat = arr.reshape(-1, arr.shape[-1])
    oflat = out.reshape(-1, len(w_dst))
    for i in range(flat.shape[0]):
        oflat[i] = np.interp(w_dst, w_src, flat[i])
    return out


def call_capy(meshFName: str, wCapy, CoG=(0.0, 0.0, 0.0), headings=(0.0,),
              depth=None, ncFName: str | None = None, density: float = 1025.0):
    """Run a live Capytaine radiation + diffraction solve of the mesh in
    ``meshFName`` at the angular frequencies ``wCapy``.

    Needs the optional ``capytaine`` package; without it raises
    ``ImportError`` naming :func:`read_capy_nc` and the port's native
    solver.  Returns the same tuple as :func:`read_capy_nc` and, with
    ``ncFName``, writes the dataset there."""
    try:
        import capytaine as cpt
    except ImportError as e:
        raise ImportError(
            "capytaine is not installed; precompute a NetCDF dataset and load it with "
            "raft_tpu_torch.hydro.capy.read_capy_nc(), or use the native solver "
            "(raft_tpu_torch.hydro.native_bem.solve_bem)") from e

    body = cpt.FloatingBody.from_file(meshFName)
    body.center_of_mass = np.asarray(CoG)
    body.keep_immersed_part()
    body.add_all_rigid_body_dofs()
    bottom = -abs(depth) if depth else -np.inf
    problems = [
        cpt.RadiationProblem(body=body, radiating_dof=dof, omega=w, sea_bottom=bottom,
                             rho=density)
        for dof in body.dofs for w in wCapy
    ] + [
        cpt.DiffractionProblem(body=body, omega=w, wave_direction=b, sea_bottom=bottom,
                               rho=density)
        for b in headings for w in wCapy
    ]
    ds = cpt.assemble_dataset(cpt.BEMSolver().solve_all(problems))
    if ncFName is not None:
        cpt.io.xarray.separate_complex_values(ds).to_netcdf(ncFName)
    A = ds["added_mass"].values.transpose(1, 2, 0)
    B = ds["radiation_damping"].values.transpose(1, 2, 0)
    fEx = (ds["diffraction_force"] + ds["Froude_Krylov_force"]).values
    fEx = fEx[:, 0, :].T.astype(np.complex128)
    return np.asarray(wCapy), A, B, fEx


def load_capytaine_nc(path: str, w_grid=None):
    """A Capytaine dataset as ``(A, B, F)`` for ``Model(design, BEM=(A, B,
    F))``, on ``w_grid`` when given (the layout of
    :func:`raft_tpu_torch.hydro.bem_io.load_wamit_coeffs`)."""
    _w, A, B, F = read_capy_nc(path, wDes=w_grid)
    return A, B, F
