"""The port's batched mooring solve over a farm against its per-turbine
loop, on CPU in float64: 16 OC3spar turbines whose line lengths differ
(scaled 0.98 ... 1.02, so ``LineProps`` carries a turbine axis) solve their
mean offsets, linearized stiffness and fairlead tensions in one batched
Newton (``ArrayModel._moor_batchable`` true), equal to the loop the array
takes when the line structures differ, to 1e-10 scale-relative.
"""
import copy

import numpy as np

from raft_tpu_torch.array import ArrayModel
from raft_tpu_torch.model import load_design

OC3 = "raft_tpu/designs/OC3spar.yaml"
W = np.arange(0.05, 3.0, 0.25)
TOL = 1e-10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _variants(n=16):
    base = load_design(OC3)
    out = []
    for s in np.linspace(0.98, 1.02, n):
        d = copy.deepcopy(base)
        for line in d["mooring"]["lines"]:
            line["length"] = float(line["length"]) * float(s)
        out.append(d)
    return out


def _farm(batched: bool):
    a = ArrayModel(_variants(), w=W, device="cpu")
    if not batched:
        a._moor_batchable = lambda: False
    a.setEnv(Hs=8.0, Tp=12.0, Fthrust=800e3)
    a.calcSystemProps()
    a.calcMooringAndOffsets()
    return a


def test_farm16_batched_mooring_matches_loop():
    b, loop = _farm(True), _farm(False)
    assert b._moor_batchable()
    assert b.moor[0].props.L.shape == (3,)
    for key in ("platform offset", "equilibrium residual"):
        assert _rel(b.results["means"][key], loop.results["means"][key]) <= TOL, key
    assert _rel(b.C_moor0.numpy(), loop.C_moor0.numpy()) <= TOL
    assert _rel(b.C_moor.numpy(), loop.C_moor.numpy()) <= TOL
    assert _rel(np.stack(b.results["means"]["fairlead tensions"]),
                np.stack(loop.results["means"]["fairlead tensions"])) <= TOL
    # the line lengths move the offsets: the lanes really differ
    surge = b.results["means"]["platform offset"][:, 0]
    assert np.all(np.diff(surge) != 0)
