"""Co-design knobs of the port against the JAX package, on CPU in float64:
the mooring design knobs (``scale_mooring``, the stiffness recomputed
inside the loss) and a design batch of north-star warps, each lane with
its own gradient.  Gradients agree to 1e-9 relative.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from raft_tpu.model import load_design
from raft_tpu.mooring import parse_mooring as jax_parse, scale_mooring as jax_scale_mooring
from raft_tpu.parallel import (grad_nacelle_accel_std as jax_grad_nac,
                               make_scale_plan as jax_plan, make_stretch_draft as jax_draft,
                               nacelle_accel_std as jax_nac, scale_diameters as jax_scale)
from raft_tpu.parallel.optimize import _make_loss as jax_make_loss

from raft_tpu_torch import convert
from raft_tpu_torch.mooring.system import scale_mooring
from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
from raft_tpu_torch.parallel.optimize import _make_loss, grad_nacelle_accel_std, nacelle_accel_std
from raft_tpu_torch.parallel.sweep import north_star_grid, scale_diameters

from test_torch_dynamics import _stage

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mooring_knob_gradient_matches_jax():
    """theta = [diameter, line length, anchor radius, EA] scales, with the
    mooring stiffness recomputed inside the loss: reverse mode through the
    catenary's implicit forward-mode rule, against jax.grad."""
    (jm, jrna, jenv, jwave, _), (tm, trna, tenv, twave, _) = _stage("OC3spar", 16)
    design = load_design("raft_tpu/designs/OC3spar.yaml")
    jmoor = jax_parse(design["mooring"], yaw_stiffness=design["turbine"]["yaw_stiffness"])
    tmoor = convert.from_numpy("MooringSystem", convert.to_numpy(jmoor), "cpu")
    jloss = jax_make_loss(jm, jrna, jenv, jwave, None, jax_nac,
                          lambda m, t: jax_scale(m, t[0]), None, 20, False,
                          moor=jmoor, moor_apply_fn=lambda s, t: jax_scale_mooring(s, t[1:4]))
    ref_val, ref = jax.jit(jax.value_and_grad(jloss))(jnp.ones(4))
    ref = np.asarray(ref)
    loss = _make_loss(tm, trna, tenv, twave, None, nacelle_accel_std,
                      lambda m, t: scale_diameters(m, t[0]), None, 20, False, moor=tmoor,
                      moor_apply_fn=lambda s, t: scale_mooring(s, t[1:4]), device="cpu")
    th = torch.ones(4, dtype=torch.float64, requires_grad=True)
    val = loss(th)
    (got,) = torch.autograd.grad(val, th)
    np.testing.assert_allclose(float(val), float(ref_val), rtol=1e-12)
    assert (np.abs(ref[1:]) > 1e-12).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)


def test_design_batch_gives_each_lane_its_own_gradient():
    """A (3, 2) theta of plan-radius and draft scales through the north
    star's warps: each lane's gradient equals that lane's own, solved
    alone, and the JAX package's."""
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = _stage("VolturnUS-S", 16)
    draft, plan = make_stretch_draft(tm), make_scale_plan(tm)
    jdraft, jplan = jax_draft(jm), jax_plan(jm)
    grid = north_star_grid(4)[:3]
    got = grad_nacelle_accel_std(tm, trna, tenv, twave, tC, grid, device="cpu",
                                 apply_fn=lambda m, th: plan(draft(m, th[..., 1]), th[..., 0]))
    assert got.shape == (3, 2)
    for lane, th in enumerate(grid):
        one = grad_nacelle_accel_std(tm, trna, tenv, twave, tC, th, device="cpu",
                                     apply_fn=lambda m, t: plan(draft(m, t[1]), t[0]))
        np.testing.assert_allclose(got[lane].numpy(), one.numpy(), rtol=1e-12)
        ref = jax_grad_nac(jm, jrna, jenv, jwave, C, jnp.asarray(th),
                           apply_fn=lambda m, t: jplan(jdraft(m, t[1]), t[0]))
        np.testing.assert_allclose(got[lane].numpy(), np.asarray(ref), rtol=RTOL)
