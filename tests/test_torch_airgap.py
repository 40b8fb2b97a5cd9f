"""The port's ``Model.airgap`` against the JAX package's, on CPU in float64:
relative wave elevation and 3-sigma air gap at deck points of the same
OC3spar run (the cases of ``tests/test_model.py::test_airgap_outputs``, and
one off the centreline), to 1e-10 scale-relative.
"""
import numpy as np
import pytest

from raft_tpu.model import Model as JaxModel

from raft_tpu_torch.model import Model, load_design

OC3 = "raft_tpu/designs/OC3spar.yaml"
W = np.arange(0.05, 3.0, 0.25)
TOL = 1e-10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run(model):
    model.setEnv(Hs=8.0, Tp=12.0, Fthrust=800e3)
    model.calcSystemProps()
    model.calcMooringAndOffsets()
    model.solveDynamics()
    return model


@pytest.fixture(scope="module")
def single():
    return _run(Model(load_design(OC3), w=W, device="cpu"))


@pytest.fixture(scope="module")
def jax_single():
    return _run(JaxModel(load_design(OC3), w=W))


@pytest.mark.parametrize("points,deck_z", [([[0.0, 0.0], [30.0, 0.0]], 15.0),
                                           ([[0.0, 0.0]], 4.0),
                                           ([[10.0, -5.0], [0.0, 20.0], [-7.5, 3.0]], 12.0)])
def test_airgap_matches_jax(single, jax_single, points, deck_z):
    """``Model.airgap`` against the JAX package's on the same OC3spar run
    (the cases of ``tests/test_model.py::test_airgap_outputs``, and one off
    the centreline)."""
    got = single.airgap(points, deck_z=deck_z)
    ref = jax_single.airgap(points, deck_z=deck_z)
    for key in ("sigma rel elevation", "margin 3 sigma"):
        assert _rel(got[key], ref[key]) <= TOL, key
    assert got["deck_z"] == deck_z and single.results["airgap"] is got
    if points[0] == [0.0, 0.0]:
        # at the centreline the relative elevation is zeta - Xi_heave
        w = single.w.numpy()
        eta_rel = single.wave.zeta.numpy() - single.rao.Xi.to_complex()[:, 2]
        np.testing.assert_allclose(got["sigma rel elevation"][0],
                                   np.sqrt((np.abs(eta_rel) ** 2).sum() * float(w[1] - w[0])),
                                   rtol=1e-9)
    with pytest.raises(ValueError, match="plan coordinates"):
        single.airgap([[0.0, 0.0, 10.0]], deck_z=15.0)
