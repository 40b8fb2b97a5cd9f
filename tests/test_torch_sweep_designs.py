"""The port's variant and mixed-design sweeps (``raft_tpu_torch.parallel.
sweep.sweep``, ``sweep_designs``) against the JAX package's, on CPU in
float64.

``sweep`` runs OC3spar's ``scale_diameters`` variants (4 thetas, 16
frequencies) in both ``return_xi`` modes; ``sweep_designs`` the four
shipped designs (two buckets) at 16 frequencies, and two designs with
seeded synthetic BEM tuples on a padded grid (10 physical bins in a
16-bin bucket).  Std devs and ``Xi_abs2`` agree to 1e-12 scale-relative
with identical iteration counts, in the caller's order, with the same
bucket signatures and promotions; the mixed result equals each design's
solo solve.  The options of ROADMAP queue 1 item 7 (chunks, the dispatch
window, lane health) agree with the JAX package's; ``mesh`` takes a
``DeviceMesh`` only.
"""
import os

import numpy as np
import pytest
import torch

from raft_tpu.model import stage_design_base as jax_stage_design_base
from raft_tpu.parallel.sweep import sweep as jax_sweep
from raft_tpu.parallel.sweep import sweep_designs as jax_sweep_designs

from raft_tpu_torch.model import stage_design_base, stage_designs
from raft_tpu_torch.parallel.sweep import forward_response, response_std, sweep, sweep_designs

HERE = os.path.dirname(os.path.abspath(__file__))
DESIGNS = [os.path.join(HERE, "..", "raft_tpu", "designs", n + ".yaml")
           for n in ("OC3spar", "VolturnUS-S", "OC4semi", "OC4semi_2")]
KW = dict(nw=16, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
THETAS = np.array([0.9, 0.97, 1.03, 1.1])
TOL = 1e-12


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def mixed():
    return (sweep_designs(DESIGNS, n_iter=10, device="cpu", **KW),
            jax_sweep_designs(DESIGNS, n_iter=10, **KW))


def _synth_bem(seed, nw):
    r = np.random.default_rng(seed)
    A = r.normal(size=(6, 6, nw)) * 1e5
    B = np.abs(r.normal(size=(6, 6, nw))) * 1e4
    F = (r.normal(size=(6, nw)) + 1j * r.normal(size=(6, nw))) * 1e4
    return A + A.transpose(1, 0, 2), B + B.transpose(1, 0, 2), F


@pytest.mark.parametrize("return_xi", [True, False])
def test_sweep_matches_jax(return_xi):
    _, m, rna, env, wave, C = stage_design_base(DESIGNS[0], device="cpu", **KW)
    _, jm, jr, je, jw, jC = jax_stage_design_base(DESIGNS[0], **KW)
    got = sweep(m, rna, env, wave, C, THETAS, return_xi=return_xi, device="cpu")
    ref = jax_sweep(jm, jr, je, jw, jC, THETAS, return_xi=return_xi)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    assert _rel(got["std dev"], ref["std dev"]) <= TOL
    if return_xi:
        assert got["Xi_abs2"].shape == (4, KW["nw"], 6)
        assert _rel(got["Xi_abs2"], ref["Xi_abs2"]) <= TOL
    # a lane is the design's own solve at that scale
    from raft_tpu_torch.parallel.sweep import scale_diameters

    o = forward_response(scale_diameters(m, float(THETAS[2])), rna, env, wave, C, device="cpu")
    assert int(o.n_iter) == int(got["iterations"][2])
    assert _rel(got["std dev"][2], response_std(o.Xi.abs2(), wave.w).numpy()) <= TOL


def test_sweep_designs_matches_jax(mixed):
    got, ref = mixed
    assert got["designs"] == ref["designs"] == DESIGNS
    assert got["buckets"] == ref["buckets"]
    assert got["buckets"]["n_buckets"] == 2 and got["buckets"]["promotions"] == 0
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    assert _rel(got["std dev"], ref["std dev"]) <= TOL
    assert got["Xi_abs2"].shape == (4, KW["nw"], 6)
    assert _rel(got["Xi_abs2"], ref["Xi_abs2"]) <= TOL


def test_sweep_designs_mixed_equals_solo(mixed):
    got, _ = mixed
    for i, fn in enumerate(DESIGNS):
        _, m, rna, env, wv, C = stage_design_base(fn, device="cpu", **KW)
        o = forward_response(m, rna, env, wv, C, n_iter=10, device="cpu")
        assert int(got["iterations"][i]) == int(o.n_iter)
        s = response_std(o.Xi.abs2(), wv.w).numpy()
        assert np.abs(got["std dev"][i] - s).max() / np.abs(s).max() <= TOL


def test_sweep_designs_with_bems_matches_jax():
    """Two designs of one bucket with seeded synthetic BEM tuples on a padded
    grid (10 physical bins, bucket 16): the port and the JAX package agree,
    ``Xi_abs2`` is trimmed to the physical bins, and ``return_xi=False``
    gives the same std devs."""
    names = DESIGNS[:2]
    kw = dict(KW, nw=10)
    bems = [_synth_bem(i, 10) for i in range(2)]
    got = sweep_designs(names, bems=bems, n_iter=25, device="cpu", **kw)
    ref = jax_sweep_designs(names, bems=bems, n_iter=25, **kw)
    assert got["buckets"] == ref["buckets"]
    assert got["buckets"]["signatures"][0]["nw"] == 16
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    assert _rel(got["std dev"], ref["std dev"]) <= TOL
    assert got["Xi_abs2"].shape == (2, 10, 6)
    assert _rel(got["Xi_abs2"], ref["Xi_abs2"]) <= TOL
    lean = sweep_designs(names, bems=bems, n_iter=25, return_xi=False, device="cpu", **kw)
    assert "Xi_abs2" not in lean
    np.testing.assert_array_equal(lean["std dev"], got["std dev"])


def test_sweep_designs_staged_passes_through_and_bems_with_it_raise():
    staged = stage_designs(DESIGNS[:2], device="cpu", **KW)
    got = sweep_designs(staged=staged, n_iter=10, device="cpu")
    assert got["designs"] == DESIGNS[:2] and got["std dev"].shape == (2, 6)
    with pytest.raises(ValueError, match="bems"):
        sweep_designs(staged=staged, bems=[_synth_bem(0, 16)] * 2, device="cpu")
    with pytest.raises(ValueError, match="fnames"):
        sweep_designs(device="cpu")


@pytest.mark.parametrize("kw", [{"chunk": 2}, {"pipeline_depth": 2}, {"mesh": object()},
                                {"health": True}])
def test_unported_options_name_item_7(kw):
    """ROADMAP queue 1 item 7's options of the design batches: ``chunk``,
    ``pipeline_depth`` and ``health`` now run, each as the JAX package's
    on the same design and variants (1e-12 scale-relative, identical
    iterations and verdicts); ``mesh`` (item 7.3) takes a
    ``DeviceMesh`` only, and anything else raises ``TypeError`` naming it
    (the sharded runs: ``tests/test_torch_mesh_sweeps.py``)."""
    _, m, rna, env, wave, C = stage_design_base(DESIGNS[0], device="cpu", **KW)
    if "mesh" in kw:
        with pytest.raises(TypeError, match="sweep_designs: mesh must be a .*DeviceMesh"):
            sweep_designs(DESIGNS[:1], device="cpu", **KW, **kw)
        with pytest.raises(TypeError, match="sweep: mesh must be a .*DeviceMesh"):
            sweep(m, rna, env, wave, C, THETAS, device="cpu", **kw)
        return
    got = sweep_designs(DESIGNS[:1], device="cpu", **KW, **kw)
    ref = jax_sweep_designs(DESIGNS[:1], **KW, **kw)
    np.testing.assert_array_equal(got["iterations"], np.asarray(ref["iterations"]))
    for k in ("std dev", "Xi_abs2"):
        assert _rel(got[k], ref[k]) <= TOL
    assert ("pipeline" in got) == ("chunk" in kw) == ("pipeline" in ref)
    if "health" in kw:
        assert got["health"] == ref["health"] and got["converged"].all()
        _, jm, jr, je, jw, jC = jax_stage_design_base(DESIGNS[0], **KW)
        v = sweep(m, rna, env, wave, C, THETAS, device="cpu", **kw)
        jv = jax_sweep(jm, jr, je, jw, jC, THETAS, **kw)
        assert v["health"] == jv["health"] and _rel(v["std dev"], jv["std dev"]) <= TOL


def test_sweep_takes_tensor_thetas_and_a_custom_apply_fn():
    """``apply_fn`` is mapped over the rows of ``thetas``: a two-parameter
    map (diameter scale, draft shift) gives each lane its own variant."""
    import dataclasses

    from raft_tpu_torch.parallel.sweep import scale_diameters

    def apply_fn(m, th):
        m = scale_diameters(m, th[0])
        shift = torch.stack([torch.zeros_like(th[1]), torch.zeros_like(th[1]), th[1]])
        return dataclasses.replace(m, seg_rA=m.seg_rA + shift, node_r=m.node_r + shift)

    _, m, rna, env, wave, C = stage_design_base(DESIGNS[0], device="cpu", **KW)
    th = torch.tensor([[1.0, 0.0], [1.05, -2.0]], dtype=torch.float64)
    got = sweep(m, rna, env, wave, C, th, apply_fn=apply_fn, return_xi=False, device="cpu")
    for i in range(2):
        o = forward_response(apply_fn(m, th[i]), rna, env, wave, C, device="cpu")
        assert int(o.n_iter) == int(got["iterations"][i])
        assert _rel(got["std dev"][i], response_std(o.Xi.abs2(), wave.w).numpy()) <= TOL
