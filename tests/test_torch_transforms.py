"""The small leftovers of ported modules against the JAX package's own
pins: ``small_rotation_displacement``, ``heading_rotation`` and the
``HydroCoeffs`` coefficient type."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import transforms as jtf
from raft_tpu.core import types as jtypes
from raft_tpu_torch.core import transforms as tf


@pytest.mark.parametrize("seed", [0, 1])
def test_small_rotation_displacement_matches_jax(seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(5, 3))
    th = 0.01 * rng.normal(size=(5, 3))
    got = tf.small_rotation_displacement(torch.as_tensor(r), torch.as_tensor(th)).numpy()
    want = np.asarray(jtf.small_rotation_displacement(jnp.asarray(r), jnp.asarray(th)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got, np.cross(th, r), rtol=0, atol=1e-15)
    # broadcasting one point against a batch of rotations, and a complex
    # rotation amplitude
    thc = th + 1j * 0.01 * rng.normal(size=(5, 3))
    got = tf.small_rotation_displacement(torch.as_tensor(r[0]), torch.as_tensor(thc)).numpy()
    want = np.asarray(jtf.small_rotation_displacement(jnp.asarray(r[0]), jnp.asarray(thc)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_small_rotation_displacement_pin():
    r = np.array([1.0, 2.0, 3.0])
    th = np.array([0.01, -0.02, 0.005])
    out = tf.small_rotation_displacement(torch.as_tensor(r), torch.as_tensor(th)).numpy()
    np.testing.assert_allclose(out, np.cross(th, r), atol=1e-15)


@pytest.mark.parametrize("heading", [0.0, 30.0, 120.0, -75.5, [0.0, 120.0, 240.0]])
def test_heading_rotation_matches_jax(heading):
    got = tf.heading_rotation(heading).numpy()
    want = np.asarray(jtf.heading_rotation(jnp.asarray(heading, dtype=jnp.float64)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_heading_rotation_pattern():
    # a 120-degree pattern of a point forms an equilateral triangle set
    p = np.array([10.0, 0.0, -5.0])
    Rz = tf.heading_rotation(torch.tensor(120.0, dtype=torch.float64)).numpy()
    p2 = Rz @ p
    assert abs(np.linalg.norm(p2[:2]) - 10.0) < 1e-12
    assert abs(p2[2] - p[2]) < 1e-12


def test_hydro_coeffs_fields_match_jax_and_export():
    import raft_tpu_torch
    from raft_tpu_torch.core.cplx import Cx
    from raft_tpu_torch.core.types import HydroCoeffs

    assert raft_tpu_torch.HydroCoeffs is HydroCoeffs
    names = [f.name for f in dataclasses.fields(HydroCoeffs)]
    assert names == [f.name for f in dataclasses.fields(jtypes.HydroCoeffs)]
    nw = 4
    hc = HydroCoeffs(A_bem=torch.zeros(6, 6, nw), B_bem=torch.zeros(6, 6, nw),
                     F_bem=Cx(torch.zeros(6, nw), torch.zeros(6, nw)),
                     A_morison=torch.eye(6), F_morison=Cx(torch.ones(6, nw), torch.zeros(6, nw)))
    hc2 = dataclasses.replace(hc, A_morison=2 * hc.A_morison)
    assert float(hc2.A_morison[0, 0]) == 2.0 and hc2.F_bem is hc.F_bem
