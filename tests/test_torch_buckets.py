"""The port's shape-bucket ladder and mixed-design staging
(``raft_tpu_torch.build.buckets``, ``model._staged_wave``,
``stage_design_base``, ``stage_designs``, ``_stage_bem_padded``) against the
JAX package's, on CPU in float64.

The host logic (ladder, ``RAFT_TPU_BUCKETS``, ``round_up``, ``bucketize``,
the self-healing promotion) gives the same classes and counts; the staged
arrays agree to 1e-14.  A bucket-padded forward solve equals the unpadded
one to 1e-12 with identical iteration counts and exactly zero response at
the padded bins; a bucket that mixes two water depths (OC3spar at 320 m,
VolturnUS-S at 200 m) gives each lane its solo result to 1e-12.
"""
import copy
import os

import numpy as np
import pytest
import torch

from raft_tpu.build import buckets as jax_buckets
from raft_tpu.build.members import member_counts as jax_member_counts
from raft_tpu.model import _stage_bem_padded as jax_stage_bem_padded
from raft_tpu.model import _staged_wave as jax_staged_wave
from raft_tpu.model import stage_design_base as jax_stage_design_base
from raft_tpu.model import stage_designs as jax_stage_designs

from raft_tpu_torch.build import buckets
from raft_tpu_torch.build.members import build_member_set, member_counts
from raft_tpu_torch.model import (_stage_bem_padded, _staged_wave, load_design,
                                  stage_design_base, stage_designs)
from raft_tpu_torch.parallel.sweep import forward_response, response_std

HERE = os.path.dirname(os.path.abspath(__file__))
DESIGN_DIR = os.path.join(HERE, "..", "raft_tpu", "designs")
ALL_DESIGNS = ["OC3spar", "VolturnUS-S", "OC4semi", "OC4semi_2"]
KW = dict(nw=10, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
CPU = dict(device="cpu")


def _path(name):
    return os.path.join(DESIGN_DIR, name + ".yaml")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    got, want = _np(got).astype(float), np.asarray(want).astype(float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(autouse=True)
def _fresh_promotions():
    buckets.reset_promotions()
    yield
    buckets.reset_promotions()


# --------------------------------------------------------------- ladder


def test_ladder_default_and_env_override(monkeypatch):
    assert buckets.ladder() == buckets.DEFAULT_LADDER == jax_buckets.DEFAULT_LADDER
    assert buckets.BEM_TILE == jax_buckets.BEM_TILE
    monkeypatch.setenv(buckets.ENV_VAR, "segments=8,24; nw=12,48")
    ld = buckets.ladder()
    assert ld == jax_buckets.ladder()
    assert ld["segments"] == (8, 24) and ld["nw"] == (12, 48)
    assert ld["nodes"] == buckets.DEFAULT_LADDER["nodes"]
    assert buckets.ladder_salt() == jax_buckets.ladder_salt()
    assert "segments=8,24" in buckets.ladder_salt()[1]
    monkeypatch.delenv(buckets.ENV_VAR)
    assert "segments=8,24" not in buckets.ladder_salt()[1]


@pytest.mark.parametrize("spec", ["segments=8,4", "segments=0,4", "bogus=4", "segments=a,b",
                                  "segments 4"])
def test_ladder_rejects_bad_spec(monkeypatch, spec):
    monkeypatch.setenv(buckets.ENV_VAR, spec)
    with pytest.raises(ValueError):
        buckets.ladder()
    with pytest.raises(ValueError):
        jax_buckets.ladder()


def test_round_up_and_overflow():
    ld = {"segments": (16, 48), "nodes": (64,), "nw": (16,)}
    for v in (1, 16, 17, 48):
        assert buckets.round_up(v, "segments", ld) == jax_buckets.round_up(v, "segments", ld)
    assert buckets.round_up(17, "segments", ld) == 48
    with pytest.raises(buckets.BucketOverflow):
        buckets.round_up(49, "segments", ld)
    assert issubclass(buckets.BucketOverflow, ValueError)


def test_member_counts_match_unpadded_build():
    for name in ALL_DESIGNS:
        design = load_design(_path(name))
        S, N = member_counts(design)
        assert (S, N) == jax_member_counts(design)
        m = build_member_set(design, "cpu")
        assert m.seg_l.shape == (S,) and m.node_dls.shape == (N,)


def test_bucketize_shipped_designs_share_classes():
    sigs = [buckets.bucketize(load_design(_path(n)), nw=100) for n in ALL_DESIGNS]
    assert [tuple(s) for s in sigs] == [
        tuple(jax_buckets.bucketize(load_design(_path(n)), nw=100)) for n in ALL_DESIGNS]
    assert sigs[0] == sigs[1] and sigs[2] == sigs[3] and sigs[0] != sigs[2]
    assert all(s.nw == 128 for s in sigs)
    # the two-depth bucket of the mixed-design smoke: OC3spar (320 m) with
    # VolturnUS-S (200 m) at nw 200 -> (16, 64, 256)
    assert tuple(buckets.bucketize(load_design(_path("OC3spar")), nw=200)) == (16, 64, 256)


# ------------------------------------------------------------ promotion


def test_promotion_self_heals_undersized_class():
    design = load_design(_path("OC4semi"))       # 36 seg, 114 nodes
    too_small = buckets.BucketSig(segments=16, nodes=64, nw=16)
    m, sig = buckets.build_bucketed_member_set(design, too_small, device="cpu")
    jax_buckets.reset_promotions()
    jm, jsig = jax_buckets.build_bucketed_member_set(design, jax_buckets.BucketSig(16, 64, 16))
    assert tuple(sig) == tuple(jsig) and sig.nw == 16
    assert m.seg_l.shape == (sig.segments,)
    assert _rel(m.node_r, jm.node_r) <= 1e-14
    assert buckets.promotion_count() == 2 == jax_buckets.promotion_count()
    m2, sig2 = buckets.build_bucketed_member_set(design, sig, device="cpu")
    assert sig2 == sig and buckets.promotion_count() == 2
    jax_buckets.reset_promotions()


def test_stage_designs_promotions_are_per_call_not_cumulative():
    staged = stage_designs([_path("OC3spar")], with_mooring=False, **KW, **CPU)
    assert all(b.promotions == 0 for b in staged.values())
    buckets.build_bucketed_member_set(load_design(_path("OC4semi")),
                                      buckets.BucketSig(segments=16, nodes=64, nw=16),
                                      device="cpu")
    assert buckets.promotion_count() == 2
    staged = stage_designs([_path("OC3spar")], with_mooring=False, **KW, **CPU)
    assert all(b.promotions == 0 for b in staged.values())


def test_promotion_raises_past_ladder_top(monkeypatch):
    monkeypatch.setenv(buckets.ENV_VAR, "segments=16;nodes=64")
    with pytest.raises(buckets.BucketOverflow):
        buckets.build_bucketed_member_set(load_design(_path("OC4semi")),
                                          buckets.BucketSig(segments=16, nodes=64, nw=None),
                                          device="cpu")
    # a mixed list the ladder cannot take raises; nothing falls back to a solo
    with pytest.raises(buckets.BucketOverflow):
        stage_designs([_path("OC3spar"), _path("OC4semi")], **KW, **CPU)


# ------------------------------------------------- frequency-grid padding


def test_staged_wave_padding_invariants():
    w0 = _staged_wave(10, 0.05, 2.95, 300.0, 8.0, 12.0, **CPU)
    wp = _staged_wave(10, 0.05, 2.95, 300.0, 8.0, 12.0, nw_pad=16, **CPU)
    jp = jax_staged_wave(10, 0.05, 2.95, 300.0, 8.0, 12.0, nw_pad=16)
    assert w0.freq_mask is None
    for key in ("w", "k", "zeta"):
        assert _rel(getattr(wp, key), getattr(jp, key)) <= 1e-14, key
    np.testing.assert_array_equal(_np(wp.freq_mask), np.arange(16) < 10)
    np.testing.assert_array_equal(_np(wp.w[:10]), _np(w0.w))
    np.testing.assert_allclose(np.diff(_np(wp.w)), float(w0.w[1] - w0.w[0]), rtol=1e-12)
    np.testing.assert_array_equal(_np(wp.zeta[10:]), 0.0)
    np.testing.assert_array_equal(_np(wp.zeta[:10]), _np(w0.zeta))
    with pytest.raises(ValueError):
        _staged_wave(10, 0.05, 2.95, 300.0, 8.0, 12.0, nw_pad=8, **CPU)


def test_padded_forward_parity_fast():
    """Bucket-padded OC3 (members and frequency grid) reproduces the
    unpadded solve: the same iterations, padded bins exactly 0, physical
    bins at 1e-12; both equal the JAX package's padded solve."""
    from raft_tpu.parallel import forward_response as jax_forward

    fn = _path("OC3spar")
    _, m0, rna, env, w0, C = stage_design_base(fn, **KW, **CPU)
    _, mp, _, _, wp, _ = stage_design_base(fn, bucket=True, **KW, **CPU)
    assert wp.w.shape[0] == 16 and w0.w.shape[0] == 10
    o0 = forward_response(m0, rna, env, w0, C, n_iter=20, method="while", device="cpu")
    op = forward_response(mp, rna, env, wp, C, n_iter=20, method="while", device="cpu")
    assert int(o0.n_iter) == int(op.n_iter)
    a0, ap = _np(o0.Xi.abs2()), _np(op.Xi.abs2())
    np.testing.assert_array_equal(ap[10:], 0.0)
    assert _rel(ap[:10], a0) <= 1e-12
    _, jm, jr, je, jw, jC = jax_stage_design_base(fn, bucket=True, **KW)
    jo = jax_forward(jm, jr, je, jw, jC, n_iter=20, method="while")
    assert int(jo.n_iter) == int(op.n_iter)
    assert _rel(ap, np.asarray(jo.Xi.abs2())) <= 1e-12
    assert _rel(C, jC) <= 1e-12


# ------------------------------------------------------- staging/grouping


def test_stage_designs_groups_and_stacks():
    names = [_path(n) for n in ALL_DESIGNS]
    staged = stage_designs(names, **KW, **CPU)
    ref = {tuple(s): b for s, b in jax_stage_designs(names, **KW).items()}
    assert len(staged) == 2 and set(map(tuple, staged)) == set(ref)
    D = 0
    for sig, b in staged.items():
        B = len(b.fnames)
        D += B
        r = ref[tuple(sig)]
        assert b.indices == r.indices and b.nw == KW["nw"]
        assert b.members.seg_rA.shape == (B, sig.segments, 3)
        assert b.wave.w.shape == (sig.nw,)                 # one shared grid
        assert b.wave.k.shape == b.wave.freq_mask.shape == (B, sig.nw)
        assert b.env.depth.shape == b.rna.mRNA.shape == (B,)
        for f in ("seg_rA", "seg_dA", "node_r", "node_ds", "node_Cd_q", "seg_mask", "node_mask"):
            assert _rel(getattr(b.members, f), getattr(r.members, f)) <= 1e-14, f
        assert _rel(b.wave.k, r.wave.k) <= 1e-14
        assert _rel(b.wave.zeta, r.wave.zeta) <= 1e-14
        assert _rel(b.env.depth, r.env.depth) == 0.0
        assert _rel(b.rna.hHub, r.rna.hHub) == 0.0
        assert _rel(b.C_moor, r.C_moor) <= 1e-12
    assert sorted(i for b in staged.values() for i in b.indices) == list(range(4)) and D == 4


def test_stage_designs_accepts_dicts_and_validates_bems():
    d = load_design(_path("OC3spar"))
    (b,) = stage_designs([d, copy.deepcopy(d)], with_mooring=False, **KW, **CPU).values()
    assert len(b.fnames) == 2 and b.C_moor is None
    with pytest.raises(ValueError, match="bems"):
        stage_designs([d, d], bems=[None], with_mooring=False, **KW, **CPU)
    with pytest.raises(ValueError, match="every design"):
        stage_designs([d, d], bems=[None, None], with_mooring=False, **KW, **CPU)


def _synth_bem(seed, nw):
    r = np.random.default_rng(seed)
    A = r.normal(size=(6, 6, nw)) * 1e5
    B = np.abs(r.normal(size=(6, 6, nw))) * 1e4
    F = (r.normal(size=(6, nw)) + 1j * r.normal(size=(6, nw))) * 1e4
    return A + A.transpose(1, 0, 2), B + B.transpose(1, 0, 2), F


def test_stage_bem_padded_matches_jax():
    """A bucket's BEM tuples staged on the padded grid, as a (B, nw_pad)
    lane batch, equal the JAX package's per-design staging; the padded
    bins carry exactly zero coefficients and excitation."""
    names = [_path("OC3spar"), _path("VolturnUS-S")]
    bems = [_synth_bem(i, KW["nw"]) for i in range(2)]
    (b,) = stage_designs(names, bems=bems, **KW, **CPU).values()
    (jb,) = jax_stage_designs(names, bems=bems, **KW).values()
    A, Bm, F = b.bem
    assert A.shape == (2, 16, 6, 6) and F.re.shape == (2, 16, 6)
    for got, want in ((A, jb.bem[0]), (Bm, jb.bem[1]), (F.re, jb.bem[2].re),
                      (F.im, jb.bem[2].im)):
        assert _rel(got, want) <= 1e-14
    np.testing.assert_array_equal(_np(A[:, 10:]), 0.0)
    np.testing.assert_array_equal(_np(F.re[:, 10:]), 0.0)
    one = _stage_bem_padded([bems[1]], stage_designs([names[1]], **KW, **CPU)[b.sig].wave, 10)
    jone = jax_stage_bem_padded(bems[1], jax_staged_wave(10, 0.05, 2.95, 200.0, 8.0, 12.0,
                                                         nw_pad=16), 10)
    assert _rel(one[2].re[0], jone[2].re) <= 1e-14
    with pytest.raises(ValueError, match="frequency bins"):
        _stage_bem_padded([bems[0]], b.wave, 12)


def test_two_depth_bucket_lanes_match_solo():
    """OC3spar (320 m) and VolturnUS-S (200 m) share one bucket: each lane
    of the batched solve keeps its own depth and wavenumbers and equals its
    solo run (1e-12, identical iterations) and the JAX package's."""
    from raft_tpu.parallel import forward_response as jax_forward

    names = [_path("OC3spar"), _path("VolturnUS-S")]
    (b,) = stage_designs(names, **KW, **CPU).values()
    assert sorted(set(_np(b.env.depth).tolist())) == [200.0, 320.0]
    out = forward_response(b.members, b.rna, b.env, b.wave, b.C_moor, n_iter=25, device="cpu")
    std = _np(response_std(out.Xi.abs2(), b.wave.w))
    for i, fn in enumerate(names):
        _, m, rna, env, wv, C = stage_design_base(fn, bucket=b.sig, **KW, **CPU)
        o = forward_response(m, rna, env, wv, C, n_iter=25, device="cpu")
        assert int(out.n_iter[i]) == int(o.n_iter)
        assert _rel(out.Xi.abs2()[i], o.Xi.abs2()) <= 1e-12
        assert _rel(std[i], response_std(o.Xi.abs2(), wv.w)) <= 1e-12
        _, jm, jr, je, jw, jC = jax_stage_design_base(fn, bucket=True, **KW)
        jo = jax_forward(jm, jr, je, jw, jC, n_iter=25)
        assert int(jo.n_iter) == int(o.n_iter)
        assert _rel(o.Xi.abs2(), np.asarray(jo.Xi.abs2())) <= 1e-12
