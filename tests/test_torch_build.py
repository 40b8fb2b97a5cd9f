"""The port's host build (YAML -> MemberSet / RNA) against
``raft_tpu.build.members``, and the ``convert.from_numpy`` round trip.

Ints and bools must be equal; floats agree to 1e-15 (both sides run the same
float64 numpy accumulation).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from raft_tpu.build.members import build_member_set as jax_members, build_rna as jax_rna
from raft_tpu.core.cplx import Cx as JCx
from raft_tpu.core.types import Env as JEnv, WaveState as JWave
from raft_tpu.hydro.strip import node_kinematics as jax_kin
from raft_tpu.model import load_design
from raft_tpu.mooring import parse_mooring as jax_parse_mooring
from raft_tpu.solve import LinearCoeffs as JLin

from raft_tpu_torch import convert
from raft_tpu_torch.build.members import build_member_set, build_rna

DESIGNS = ["OC3spar", "OC4semi", "OC4semi_2", "VolturnUS-S"]


def _design(name):
    return load_design(f"raft_tpu/designs/{name}.yaml")


@pytest.mark.parametrize("name", DESIGNS)
def test_member_set_matches_jax_build(name):
    design = _design(name)
    ref = jax_members(design)
    got = build_member_set(design, device="cpu", dtype=torch.float64)
    for f in dataclasses.fields(ref):
        r = np.asarray(getattr(ref, f.name))
        g = getattr(got, f.name).numpy()
        assert g.shape == r.shape, f.name
        if r.dtype.kind == "f":
            assert g.dtype == np.float64, f.name
            np.testing.assert_allclose(g, r, rtol=1e-15, atol=1e-15, err_msg=f.name)
        else:
            assert g.dtype == r.dtype, f.name
            np.testing.assert_array_equal(g, r, err_msg=f.name)


@pytest.mark.parametrize("name", DESIGNS)
def test_rna_matches_jax_build(name):
    design = _design(name)
    ref, got = jax_rna(design), build_rna(design)
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == float(getattr(ref, f.name)), f.name


def test_member_set_float32_and_padding():
    design = _design("OC3spar")
    ref = jax_members(design, pad_segments=20, pad_nodes=40)
    got = build_member_set(design, device="cpu", dtype=torch.float32,
                           pad_segments=20, pad_nodes=40)
    assert got.seg_rA.dtype == torch.float32 and got.seg_member.dtype == torch.int32
    np.testing.assert_array_equal(got.seg_mask.numpy(), np.asarray(ref.seg_mask))
    np.testing.assert_array_equal(got.node_member.numpy(), np.asarray(ref.node_member))
    np.testing.assert_allclose(got.node_r.numpy(), np.asarray(ref.node_r), rtol=1e-6)
    with pytest.raises(ValueError):
        build_member_set(design, device="cpu", pad_segments=2)


def _jax_objects():
    """One JAX pytree of every kind from_numpy carries, built from a seed."""
    rng = np.random.default_rng(0)
    design = _design("VolturnUS-S")
    m = jax_members(design)
    nw = 7
    w = jnp.linspace(0.1, 1.5, nw)
    wave = JWave(w=w, k=w * w / 9.81, zeta=jnp.asarray(rng.uniform(size=nw)),
                 beta=jnp.asarray(0.3), freq_mask=jnp.asarray(np.arange(nw) < 5))
    env = JEnv(Hs=8.0, Tp=12.0, depth=200.0)
    return {
        "MemberSet": m,
        "RNA": jax_rna(design),
        "Env": env,
        "WaveState": wave,
        "MooringSystem": jax_parse_mooring(design["mooring"], yaw_stiffness=1e5),
        "LinearCoeffs": JLin(M=jnp.asarray(rng.normal(size=(nw, 6, 6))),
                             B=jnp.asarray(rng.normal(size=(nw, 6, 6))),
                             C=jnp.asarray(rng.normal(size=(6, 6))),
                             F=JCx(jnp.asarray(rng.normal(size=(nw, 6))),
                                   jnp.asarray(rng.normal(size=(nw, 6))))),
        "StripKin": jax_kin(m, wave, env),
        "Cx": JCx(jnp.asarray(rng.normal(size=(3, 4))), jnp.asarray(rng.normal(size=(3, 4)))),
    }


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif a is None:
        assert b is None, path
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("kind", list(convert.KINDS))
def test_from_numpy_round_trip_is_exact(kind):
    if kind == "LineProps":
        obj = _jax_objects()["MooringSystem"].props
    else:
        obj = _jax_objects()[kind]
    fields = convert.to_numpy(obj)
    port = convert.from_numpy(kind, fields, device="cpu", dtype=torch.float64)
    assert type(port).__name__ == kind
    back = convert.to_numpy(port)
    # Python floats (Env / RNA defaults) come back as 0-d float64 arrays
    _assert_same({k: (np.asarray(v, dtype=np.float64) if np.asarray(v).ndim == 0
                      and np.asarray(v).dtype.kind == "f" else v)
                  for k, v in fields.items()}, back)


def test_geometry_warps_match_jax():
    """A batch of plan-radius x draft warps (then a diameter scale) equals
    ``jax.vmap`` of the JAX warps field by field (float64, 1e-14 relative
    to each field's scale)."""
    import jax

    from raft_tpu.parallel.geometry import (make_scale_plan as jax_plan,
                                            make_stretch_draft as jax_draft)
    from raft_tpu.parallel.sweep import scale_diameters as jax_scale
    from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
    from raft_tpu_torch.parallel.sweep import north_star_grid, scale_diameters

    design = _design("OC4semi")
    jm = jax_members(design)
    tm = convert.from_numpy("MemberSet", convert.to_numpy(jm), "cpu")
    grid = north_star_grid(6)
    jd, jp = jax_draft(jm, anchor=-5.0), jax_plan(jm)
    ref = jax_scale(jax.vmap(lambda th: jp(jd(jm, th[1]), th[0]))(jnp.asarray(grid)), 1.1)
    th = torch.as_tensor(grid)
    got = make_scale_plan(tm)(make_stretch_draft(tm, anchor=-5.0)(tm, th[:, 1]), th[:, 0])
    got = scale_diameters(got, 1.1)
    for f in dataclasses.fields(ref):
        r = np.asarray(getattr(ref, f.name))
        g = getattr(got, f.name).numpy()
        assert g.shape == r.shape, f.name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-14 * max(np.abs(r).max(), 1.0),
                                   err_msg=f.name)
