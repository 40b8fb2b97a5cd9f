"""End-to-end parity: the port's ``run_raft(..., device="cpu")`` against
``raft_tpu.model.run_raft`` on OC3spar, OC4semi and VolturnUS-S (float64).

Natural frequencies, response std dev and mean offsets agree to 1e-9
(frequencies elementwise; std dev and offsets relative to their largest
entry, since the DOFs a symmetric design does not excite carry only
roundoff), and the fixed point takes the same number of iterations.
"""
import numpy as np
import pytest

from raft_tpu.model import run_raft as jax_run_raft

from raft_tpu_torch.model import Model, load_design, run_raft

TOL = 1e-9


def _scale_rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref))) / np.max(np.abs(ref)))


@pytest.mark.parametrize("name", ["OC3spar", "OC4semi", "VolturnUS-S"])
def test_run_raft_matches_jax(name):
    path = f"raft_tpu/designs/{name}.yaml"
    ref = jax_run_raft(path)
    got = run_raft(path, device="cpu")
    np.testing.assert_allclose(got["eigen"]["frequencies"], ref["eigen"]["frequencies"],
                               rtol=TOL)
    assert got["response"]["iterations"] == ref["response"]["iterations"]
    assert got["response"]["converged"] and ref["response"]["converged"]
    assert _scale_rel(got["response"]["std dev"], ref["response"]["std dev"]) <= TOL
    assert _scale_rel(got["means"]["platform offset"], ref["means"]["platform offset"]) <= TOL
    for key in ("nacelle acceleration std dev", "fairlead tension std dev"):
        assert _scale_rel(got["response"][key], ref["response"][key]) <= TOL
    for key, val in ref["properties"].items():
        np.testing.assert_allclose(got["properties"][key], val, rtol=TOL,
                                   atol=TOL * np.max(np.abs(val)), err_msg=key)


def test_unported_options_name_their_slice(capsys):
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(design, device="cpu", nTurbines=2)
    # BEM="native" is ported (tests/test_torch_native_bem*.py)
    assert Model(design, device="cpu", BEM="native").bem_mode == "native"
    m = Model(design, device="cpu")
    for call in (lambda: m.airgap([[0.0, 0.0]], 10.0), m.plot):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    m.setEnv(Hs=6.0, Tp=10.0)
    m.calcSystemProps()
    m.solveEigen()
    m.print_report()
    assert "natural frequencies" in capsys.readouterr().out
