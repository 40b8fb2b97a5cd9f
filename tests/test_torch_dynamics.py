"""The port's drag-linearized fixed point against the JAX package.

* ``solve_dynamics`` (``while`` driver) on OC3: Xi to 1e-10 scale-relative,
  identical iteration count, and the per-iteration error history;
* a batch of 8 VolturnUS-S plan-radius x draft variants through the port's
  batched ``forward_response`` against ``jax.vmap`` of
  ``raft_tpu.parallel.forward_response``: identical per-lane iteration
  counts, std dev to 1e-10;
* an iteration cap of 3, which pins the freeze semantics of unconverged
  lanes.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from raft_tpu.build.members import build_member_set as jax_members, build_rna as jax_rna
from raft_tpu.core import waves as jwaves
from raft_tpu.core.types import Env as JEnv, WaveState as JWave
from raft_tpu.hydro import strip as jstrip
from raft_tpu.model import load_design
from raft_tpu.mooring import mooring_stiffness as jax_stiffness, parse_mooring as jax_parse
from raft_tpu.parallel import (forward_response as jax_forward, make_scale_plan as jax_plan,
                               make_stretch_draft as jax_draft, response_std as jax_std)
from raft_tpu.solve import LinearCoeffs as JLin, solve_dynamics as jax_solve
from raft_tpu.statics import assemble_statics as jax_statics

from raft_tpu_torch import convert
from raft_tpu_torch.core.types import Env
from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
from raft_tpu_torch.parallel.sweep import forward_response, north_star_grid, response_std
from raft_tpu_torch.solve.dynamics import solve_dynamics

TOL = 1e-10


def _scale_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _stage(name, nw):
    design = load_design(f"raft_tpu/designs/{name}.yaml")
    depth = float(design["mooring"]["water_depth"])
    jm = jax_members(design)
    w = jnp.asarray(np.linspace(0.05, 2.95, nw))
    jwave = JWave(w=w, k=jwaves.wave_number(w, depth), zeta=jnp.sqrt(jwaves.jonswap(w, 8.0, 12.0)))
    jenv = JEnv(Hs=8.0, Tp=12.0, depth=depth)
    C = jax_stiffness(jax_parse(design["mooring"],
                                yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0)),
                      jnp.zeros(6))
    port = (convert.from_numpy("MemberSet", convert.to_numpy(jm), "cpu"),
            convert.from_numpy("RNA", convert.to_numpy(jax_rna(design)), "cpu"),
            Env(Hs=8.0, Tp=12.0, depth=depth),
            convert.from_numpy("WaveState", convert.to_numpy(jwave), "cpu"),
            torch.as_tensor(np.asarray(C)))
    return (jm, jax_rna(design), jenv, jwave, C), port


@pytest.mark.parametrize("history,tik", [(False, 0.0), (True, 0.0), (False, 0.05)])
def test_solve_dynamics_oc3(history, tik):
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = _stage("OC3spar", 40)
    s = jax_statics(jm, jrna, jenv)
    kin = jstrip.node_kinematics(jm, jwave, jenv)
    nw = jwave.w.shape[0]
    M = jnp.broadcast_to(s.M_struc + jstrip.strip_added_mass(jm, jenv), (nw, 6, 6))
    lin = JLin(M=M, B=jnp.zeros((nw, 6, 6)), C=s.C_struc + s.C_hydro + C,
               F=jstrip.strip_excitation(jm, kin, jenv))
    ref = jax_solve(jm, kin, jwave, jenv, lin, n_iter=40, method="while", history=history,
                    tik=tik)

    tlin = convert.from_numpy("LinearCoeffs", convert.to_numpy(lin), "cpu")
    tkin = convert.from_numpy("StripKin", convert.to_numpy(kin), "cpu")
    got = solve_dynamics(tm, tkin, twave, tenv, tlin, n_iter=40, history=history, tik=tik)
    assert int(got.n_iter) == int(ref.n_iter) and bool(got.converged) == bool(ref.converged)
    scale = max(np.abs(np.asarray(ref.Xi.re)).max(), np.abs(np.asarray(ref.Xi.im)).max())
    for g, r in ((got.Xi.re, ref.Xi.re), (got.Xi.im, ref.Xi.im)):
        assert np.max(np.abs(g.numpy() - np.asarray(r))) <= TOL * scale
    assert _scale_rel(got.B_drag.numpy(), ref.B_drag) <= TOL
    if history:
        np.testing.assert_allclose(got.err_hist.numpy(), np.asarray(ref.err_hist),
                                   rtol=1e-8, equal_nan=True)


def _variants(n_iter, n=8, nw=24):
    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = _stage("VolturnUS-S", nw)
    grid = north_star_grid(n)
    draft, plan = jax_draft(jm), jax_plan(jm)

    def one(th):
        m = plan(draft(jm, th[1]), th[0])
        out = jax_forward(m, jrna, jenv, jwave, C, n_iter=n_iter, method="while")
        return jax_std(out.Xi.abs2(), jwave.w), out.n_iter, out.converged, out.Xi.re

    ref = jax.vmap(one)(jnp.asarray(grid))
    th = torch.as_tensor(grid)
    m = make_scale_plan(tm)(make_stretch_draft(tm)(tm, th[:, 1]), th[:, 0])
    out = forward_response(m, trna, tenv, twave, tC, n_iter=n_iter, device="cpu")
    return ref, out, twave


def test_batched_forward_response_matches_vmap():
    (s_ref, it_ref, c_ref, _), out, twave = _variants(n_iter=40)
    np.testing.assert_array_equal(out.n_iter.numpy(), np.asarray(it_ref))
    assert bool(out.converged.all()) and bool(np.asarray(c_ref).all())
    assert _scale_rel(response_std(out.Xi.abs2(), twave.w).numpy(), s_ref) <= TOL


def test_iteration_cap_freezes_lanes():
    """At n_iter=3 no lane converges: every lane stops at the cap with the
    third raw solve, exactly as the vmapped JAX while loop keeps it."""
    (s_ref, it_ref, c_ref, xr_ref), out, twave = _variants(n_iter=3)
    assert (out.n_iter.numpy() == 3).all() and (np.asarray(it_ref) == 3).all()
    np.testing.assert_array_equal(out.converged.numpy(), np.asarray(c_ref))
    assert not out.converged.any()
    assert _scale_rel(out.Xi.re.numpy(), xr_ref) <= TOL
    assert _scale_rel(response_std(out.Xi.abs2(), twave.w).numpy(), s_ref) <= TOL


def test_forward_response_with_staged_bem():
    """A pre-staged (A, B, F) tuple adds to the strip coefficients and takes
    the potMod members out of the Morison inertia, as in the JAX package."""
    from raft_tpu.core.cplx import Cx as JCx

    from raft_tpu_torch.core.cplx import Cx

    (jm, jrna, jenv, jwave, C), (tm, trna, tenv, twave, tC) = _stage("OC4semi", 24)
    rng = np.random.default_rng(9)
    nw = 24
    G = rng.normal(size=(nw, 6, 6))
    A = 1e6 * (G @ np.swapaxes(G, -1, -2) + np.eye(6))
    B = 1e5 * np.abs(rng.normal(size=(nw, 6, 6)))
    Fr, Fi = 1e5 * rng.normal(size=(nw, 6)), 1e5 * rng.normal(size=(nw, 6))
    ref = jax_forward(jm, jrna, jenv, jwave, C, n_iter=40, method="while",
                      bem=(jnp.asarray(A), jnp.asarray(B), JCx(jnp.asarray(Fr), jnp.asarray(Fi))))
    got = forward_response(tm, trna, tenv, twave, tC, n_iter=40, device="cpu",
                           bem=(torch.as_tensor(A), torch.as_tensor(B),
                                Cx(torch.as_tensor(Fr), torch.as_tensor(Fi))))
    assert int(got.n_iter) == int(ref.n_iter)
    assert _scale_rel(got.Xi.re.numpy(), ref.Xi.re) <= TOL
    assert _scale_rel(got.Xi.im.numpy(), ref.Xi.im) <= TOL
