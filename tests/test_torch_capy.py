"""The port's Capytaine reader (``raft_tpu_torch.hydro.capy``) against the
JAX package's (``raft_tpu.hydro.capy``) on synthetic Capytaine-layout
NetCDF datasets written here from a seed.

``read_capy_nc`` returns exactly the JAX package's arrays, with and without
``wDes`` and the Froude-Krylov part; a ``wDes`` outside the data raises the
same ``ValueError``; a dataset with its DOFs permuted reads as the ordered
one.  ``call_capy`` raises ``ImportError`` (capytaine is not installed
here).  ``Model(OC3spar, BEM=load_capytaine_nc(path))`` matches the JAX
Model with the same coefficients on a coarse grid at 1e-9: natural
frequencies, response std dev (scale-relative) and iteration counts.
"""
import warnings

import numpy as np
import pytest

from raft_tpu.hydro import capy as jcapy
from raft_tpu.model import Model as JModel
from raft_tpu.model import load_design

from raft_tpu_torch.hydro import capy
from raft_tpu_torch.model import Model

DOFS = ["Surge", "Sway", "Heave", "Roll", "Pitch", "Yaw"]
W = np.arange(0.2, 1.4, 0.2)
TOL = 1e-9


def write_nc(path, w, A, B, D, FK, dofs=DOFS):
    """A minimal Capytaine-layout classic NetCDF (the layout of
    ``tests/test_capy.py``'s fixture writer): A, B (6, 6, nw) and the
    diffraction and Froude-Krylov forces (6, nw) complex, one heading,
    the DOFs named in the order ``dofs``."""
    from scipy.io import netcdf_file

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f = netcdf_file(str(path), "w")
        f.createDimension("omega", len(w))
        for dim, size in (("radiating_dof", 6), ("influenced_dof", 6), ("wave_direction", 1),
                          ("complex", 2), ("string5", 5)):
            f.createDimension(dim, size)
        f.createVariable("omega", "d", ("omega",))[:] = w
        for name in ("radiating_dof", "influenced_dof"):
            v = f.createVariable(name, "c", (name, "string5"))
            for i, d in enumerate(dofs):
                v[i] = np.frombuffer(d.ljust(5)[:5].encode(), dtype="S1")
        for name, arr in (("added_mass", A), ("radiation_damping", B)):
            f.createVariable(name, "d", ("omega", "radiating_dof", "influenced_dof"))[:] = \
                arr.transpose(2, 0, 1)
        for name, arr in (("diffraction_force", D), ("Froude_Krylov_force", FK)):
            v = f.createVariable(name, "d", ("complex", "omega", "wave_direction",
                                             "influenced_dof"))
            v[0] = arr.real.T[:, None, :]
            v[1] = arr.imag.T[:, None, :]
        f.close()


def coeffs(w, seed=4):
    """Seeded coefficients of OC3spar's order of magnitude."""
    rng = np.random.default_rng(seed)
    nw = len(w)
    scale = np.array([8e6, 8e6, 2e5, 5e9, 5e9, 1e5])
    A = np.einsum("i,ijk->ijk", np.sqrt(scale), np.einsum(
        "j,ijk->ijk", np.sqrt(scale), 0.05 * rng.normal(size=(6, 6, nw))))
    A[np.arange(6), np.arange(6)] = scale[:, None] * (1 + 0.1 * rng.uniform(size=(6, nw)))
    B = np.zeros((6, 6, nw))
    B[np.arange(6), np.arange(6)] = 0.05 * scale[:, None] * rng.uniform(size=(6, nw))
    D = (rng.normal(size=(6, nw)) + 1j * rng.normal(size=(6, nw))) * 1e5
    FK = (rng.normal(size=(6, nw)) + 1j * rng.normal(size=(6, nw))) * 1e6
    return A, B, D, FK


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("capy") / "oc3.nc"
    arrays = coeffs(W)
    write_nc(path, W, *arrays)
    return path, arrays


@pytest.mark.parametrize("fk", [True, False])
@pytest.mark.parametrize("wdes", [None, np.linspace(0.25, 1.1, 9)])
def test_read_capy_nc_matches_jax(dataset, fk, wdes):
    path, _arrays = dataset
    got = capy.read_capy_nc(str(path), wDes=wdes, include_froude_krylov=fk)
    want = jcapy.read_capy_nc(str(path), wDes=wdes, include_froude_krylov=fk)
    assert [np.asarray(x).dtype for x in got] == [np.asarray(x).dtype for x in want]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[3].dtype == np.complex128 and got[1].shape == (6, 6, len(got[0]))


def test_out_of_range_and_permuted_dofs(dataset, tmp_path):
    path, (A, B, D, FK) = dataset
    for wdes in ([0.1, 0.5], [0.4, 1.3]):
        with pytest.raises(ValueError) as e_port:
            capy.read_capy_nc(str(path), wDes=wdes)
        with pytest.raises(ValueError) as e_jax:
            jcapy.read_capy_nc(str(path), wDes=wdes)
        assert str(e_port.value) == str(e_jax.value)
    perm = [2, 0, 5, 1, 4, 3]
    permuted = tmp_path / "permuted.nc"
    write_nc(permuted, W, A[perm][:, perm], B[perm][:, perm], D[perm], FK[perm],
             dofs=[DOFS[i] for i in perm])
    ordered = capy.read_capy_nc(str(path))
    for g, w, j in zip(capy.read_capy_nc(str(permuted)), ordered,
                       jcapy.read_capy_nc(str(permuted))):
        assert np.array_equal(g, w) and np.array_equal(g, j)


def test_call_capy_needs_capytaine(tmp_path):
    with pytest.raises(ImportError, match="raft_tpu_torch.hydro.capy.read_capy_nc"):
        capy.call_capy(str(tmp_path / "hull.dat"), W)


def test_model_with_capytaine_coefficients_matches_jax(dataset, monkeypatch):
    """The JAX side's ``eigen_with_bem_batched`` runs through ``__wrapped__``
    (its jit compiles for about 40 s here; ``tests/test_torch_array_bem.py``
    does the same)."""
    from raft_tpu.solve import eigen as jeigen

    monkeypatch.setattr(jeigen, "eigen_with_bem_batched", jeigen.eigen_with_bem_batched.__wrapped__)
    path, _arrays = dataset
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    results = []
    for cls, loader, kw in ((Model, capy.load_capytaine_nc, {"device": "cpu"}),
                            (JModel, jcapy.load_capytaine_nc, {})):
        m = cls(design, w=W, BEM=loader(str(path)), **kw)
        m.setEnv(Hs=6.0, Tp=10.0, Fthrust=float(design["turbine"]["Fthrust"]))
        m.calcSystemProps()
        m.solveEigen()
        m.calcMooringAndOffsets()
        m.solveDynamics()
        results.append(m.results)
    got, ref = results
    np.testing.assert_allclose(got["eigen"]["frequencies"], ref["eigen"]["frequencies"],
                               rtol=TOL)
    s_g, s_r = got["response"]["std dev"], np.asarray(ref["response"]["std dev"])
    assert np.abs(s_g - s_r).max() <= TOL * np.abs(s_r).max()
    assert got["response"]["iterations"] == ref["response"]["iterations"]
    assert got["response"]["converged"]
