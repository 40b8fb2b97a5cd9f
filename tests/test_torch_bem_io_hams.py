"""The port's HAMS project files and Nemoh mesh converter
(``raft_tpu_torch.hydro.bem_io``) against the JAX package's
(``raft_tpu.hydro.bem_io``): for the same inputs the project tree is the
same, ``Input/Hydrostatic.in`` and ``Input/ControlFile.in`` are
byte-identical, ``read_nemoh_mesh`` returns the same panels and
``nemoh_to_pnl`` writes the same ``.pnl``, byte for byte."""
import filecmp
import os

import numpy as np
import pytest

from raft_tpu.hydro import bem_io as jio
from raft_tpu.hydro import mesh as jmesh

from raft_tpu_torch.hydro import bem_io as tio


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, x), root)
                  for d, dirs, files in os.walk(root) for x in dirs + files)


@pytest.mark.parametrize("kind", ["defaults", "given"])
def test_hams_project_files_are_byte_identical(tmp_path, kind):
    rng = np.random.default_rng(9)
    hydro = {} if kind == "defaults" else {
        "cog": (0.25, -1.5, -78.0), "mass": rng.normal(size=(6, 6)) * 1e6,
        "damping": np.diag(rng.uniform(size=6)), "kHydro": np.eye(6) * 3.3e7,
        "kExt": rng.normal(size=(6, 6))}
    control = {} if kind == "defaults" else {
        "water_depth": 200.0, "num_freqs": 48, "min_freq": 0.05, "d_freq": 0.0617,
        "num_headings": 7, "min_heading": -90.0, "d_heading": 30.0, "num_threads": 4, "irr": 1}
    paths = {}
    for name, mod in (("jax", jio), ("port", tio)):
        root = str(tmp_path / name)
        mod.create_project_dirs(root)
        mod.create_project_dirs(root)              # idempotent
        paths[name] = (root, mod.write_hydrostatic_file(root, **hydro),
                       mod.write_control_file(root, **control))
    assert _tree(paths["jax"][0]) == _tree(paths["port"][0])
    for j, p in zip(paths["jax"][1:], paths["port"][1:]):
        assert os.path.relpath(j, paths["jax"][0]) == os.path.relpath(p, paths["port"][0])
        assert filecmp.cmp(j, p, shallow=False)


def _write_nemoh(path, panels):
    """A Nemoh mesh: header, one node per vertex, then the panels."""
    verts = panels.reshape(-1, 3)
    with open(path, "w") as f:
        f.write("2 0\n")
        for i, v in enumerate(verts, 1):
            f.write(f"{i} {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        f.write("0 0.00 0.00 0.00\n\n")
        for p in range(len(panels)):
            f.write(" ".join(str(4 * p + k + 1) for k in range(4)) + "\n")
        f.write("0 0 0 0\n")


def test_nemoh_mesh_and_pnl_match(tmp_path):
    """The test cylinder (hull and a bottom cap) as a Nemoh mesh: the same
    panels from both readers, the same .pnl from both converters."""
    panels = jmesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                               rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)
    src = tmp_path / "cyl.nemoh"
    _write_nemoh(src, panels)
    got, want = tio.read_nemoh_mesh(str(src)), jio.read_nemoh_mesh(str(src))
    assert got.shape == want.shape == panels.shape
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, panels, rtol=0, atol=1e-8)
    out_p, out_j = str(tmp_path / "port.pnl"), str(tmp_path / "jax.pnl")
    assert tio.nemoh_to_pnl(str(src), out_p) == out_p
    jio.nemoh_to_pnl(str(src), out_j)
    assert filecmp.cmp(out_p, out_j, shallow=False)
