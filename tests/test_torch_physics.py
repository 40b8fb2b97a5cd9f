"""Component parity of the port with the JAX package at rtol 1e-12 (float64).

Each JAX input is carried across with ``convert.from_numpy`` (numpy dicts,
no JAX object crosses), extra inputs are made with numpy from a seed, and
every output is compared elementwise at rtol 1e-12 with an absolute floor of
1e-12 x the output's largest magnitude (entries that are zero by symmetry
carry only roundoff on both sides).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from raft_tpu.build.members import build_member_set as jax_members, build_rna as jax_rna
from raft_tpu.core import waves as jwaves
from raft_tpu.core.cplx import Cx as JCx
from raft_tpu.core.types import Env as JEnv, WaveState as JWave
from raft_tpu.hydro import strip as jstrip
from raft_tpu.model import load_design
from raft_tpu.mooring import system as jmoor
from raft_tpu.solve import eigen as jeigen
from raft_tpu.statics import assemble_statics as jax_statics

from raft_tpu_torch import convert
from raft_tpu_torch.core import waves
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.types import Env, WaveState
from raft_tpu_torch.hydro import strip
from raft_tpu_torch.mooring import system as moor
from raft_tpu_torch.solve import eigen
from raft_tpu_torch.statics import assemble_statics

RTOL = 1e-12
DESIGNS = ["OC3spar", "OC4semi", "VolturnUS-S"]


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


def close_cx(got: Cx, ref: JCx, rtol=RTOL):
    scale = max(np.abs(np.asarray(ref.re)).max(), np.abs(np.asarray(ref.im)).max())
    for g, r in ((got.re, ref.re), (got.im, ref.im)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=rtol * scale)


def _staged(name, nw=24, current=0.0):
    """JAX and port versions of members / env / wave for one design."""
    design = load_design(f"raft_tpu/designs/{name}.yaml")
    jm = jax_members(design)
    depth = float(design["mooring"]["water_depth"])
    w = np.linspace(0.05, 2.95, nw)
    jenv = JEnv(Hs=8.0, Tp=12.0, depth=depth, current=current, current_exp=1.0 / 7.0,
                current_heading=0.4)
    jw = jnp.asarray(w)
    jwave = JWave(w=jw, k=jwaves.wave_number(jw, depth),
                  zeta=jnp.sqrt(jwaves.jonswap(jw, 8.0, 12.0)))
    tm = convert.from_numpy("MemberSet", convert.to_numpy(jm), "cpu")
    tenv = Env(Hs=8.0, Tp=12.0, depth=depth, current=current, current_exp=1.0 / 7.0,
               current_heading=0.4)
    twave = convert.from_numpy("WaveState", convert.to_numpy(jwave), "cpu")
    return design, (jm, jenv, jwave), (tm, tenv, twave)


@pytest.mark.parametrize("depth", [200.0, 320.0, 5000.0])
def test_wave_number_and_kinematics(depth):
    rng = np.random.default_rng(int(depth))
    w = np.linspace(0.05, 2.95, 40)
    k_ref = jwaves.wave_number(jnp.asarray(w), depth)
    k = waves.wave_number(torch.as_tensor(w), depth)
    close(k, k_ref)
    close(waves.jonswap(torch.as_tensor(w), 6.0, 10.0), jwaves.jonswap(jnp.asarray(w), 6.0, 10.0))
    r = rng.uniform(-1, 1, size=(9, 3)) * np.array([50.0, 50.0, 120.0])
    zeta = rng.uniform(0.1, 1.0, size=40)
    ref = jwaves.wave_kinematics(jnp.asarray(zeta), jnp.asarray(w), k_ref, depth,
                                 jnp.asarray(r), beta=0.3)
    got = waves.wave_kinematics(torch.as_tensor(zeta), torch.as_tensor(w), k, depth,
                                torch.as_tensor(r), beta=0.3)
    for g, rr in zip(got, ref):
        close_cx(g, rr)


def test_member_orientation_and_frustum():
    from raft_tpu.core import frustum as jfr, transforms as jtr

    from raft_tpu_torch.core import frustum, transforms

    rng = np.random.default_rng(2)
    rA, rB = rng.normal(size=(5, 3)) * 20.0, rng.normal(size=(5, 3)) * 20.0
    g = rng.uniform(0, 1, size=5)
    for got, ref in zip(transforms.member_orientation(*map(torch.as_tensor, (rA, rB, g))),
                        jtr.member_orientation(*map(jnp.asarray, (rA, rB, g)))):
        close(got, ref)
    dA, dB = rng.uniform(1, 9, size=(5, 2)), rng.uniform(1, 9, size=(5, 2))
    H, rho, circ = rng.uniform(1, 30, size=5), rng.uniform(1e3, 8e3, size=5), rng.uniform(size=5) > 0.5
    for got, ref in zip(frustum.frustum_moi(*map(torch.as_tensor, (dA, dB, H, rho, circ))) +
                        frustum.frustum_vcv(*map(torch.as_tensor, (dA, dB, H, circ))),
                        jfr.frustum_moi(*map(jnp.asarray, (dA, dB, H, rho, circ))) +
                        jfr.frustum_vcv(*map(jnp.asarray, (dA, dB, H, circ)))):
        close(got, ref)


@pytest.mark.parametrize("name", DESIGNS)
def test_assemble_statics(name):
    design, (jm, jenv, _), (tm, tenv, _) = _staged(name)
    ref = jax_statics(jm, jax_rna(design), jenv)
    got = assemble_statics(tm, convert.from_numpy("RNA", convert.to_numpy(jax_rna(design)), "cpu"),
                           tenv)
    for key, r in convert.to_numpy(ref).items():
        close(getattr(got, key), r)


@pytest.mark.parametrize("name", DESIGNS)
def test_strip_added_mass_and_excitation(name):
    _, (jm, jenv, jwave), (tm, tenv, twave) = _staged(name)
    jkin = jstrip.node_kinematics(jm, jwave, jenv)
    tkin = strip.node_kinematics(tm, twave, tenv)
    close_cx(tkin.u, jkin.u)
    for excl in (False, True):
        close(strip.strip_added_mass(tm, tenv, exclude_potmod=excl),
              jstrip.strip_added_mass(jm, jenv, exclude_potmod=excl))
        close_cx(strip.strip_excitation(tm, tkin, tenv, exclude_potmod=excl),
                 jstrip.strip_excitation(jm, jkin, jenv, exclude_potmod=excl))


@pytest.mark.parametrize("name,current", [("OC3spar", 0.0), ("OC4semi", 0.0),
                                          ("VolturnUS-S", 0.0), ("VolturnUS-S", 1.2)])
def test_linearized_drag_at_fixed_xi(name, current):
    _, (jm, jenv, jwave), (tm, tenv, twave) = _staged(name, current=current)
    rng = np.random.default_rng(42)
    nw = twave.w.shape[0]
    Xr, Xi_ = rng.normal(size=(nw, 6)), rng.normal(size=(nw, 6))
    B_ref, F_ref = jstrip.linearized_drag(jm, jstrip.node_kinematics(jm, jwave, jenv),
                                          JCx(jnp.asarray(Xr), jnp.asarray(Xi_)), jwave, jenv)
    B, F = strip.linearized_drag(tm, strip.node_kinematics(tm, twave, tenv),
                                 Cx(torch.as_tensor(Xr), torch.as_tensor(Xi_)), twave, tenv)
    close(B, B_ref)
    close_cx(F, F_ref)
    if current:
        close(strip.current_mean_force(tm, tenv), jstrip.current_mean_force(jm, jenv))


@pytest.mark.parametrize("name", DESIGNS)
def test_mooring_force_stiffness_and_tensions(name):
    design = load_design(f"raft_tpu/designs/{name}.yaml")
    yaw = float(design["turbine"].get("yaw_stiffness", 0.0))
    jsys = jmoor.parse_mooring(design["mooring"], yaw_stiffness=yaw)
    tsys = moor.parse_mooring(design["mooring"], "cpu", yaw_stiffness=yaw)
    tsys_c = convert.from_numpy("MooringSystem", convert.to_numpy(jsys), "cpu")
    close(tsys.r_anchor, tsys_c.r_anchor.numpy())
    close(tsys.props.w, tsys_c.props.w.numpy())
    rng = np.random.default_rng(1)
    for r6 in (np.zeros(6), rng.normal(size=6) * np.array([5.0, 5.0, 1.0, 0.02, 0.02, 0.02])):
        jr, tr = jnp.asarray(r6), torch.as_tensor(r6)
        close(moor.mooring_force(tsys, tr), jmoor.mooring_force(jsys, jr))
        close(moor.mooring_stiffness(tsys, tr), jmoor.mooring_stiffness(jsys, jr))
        close(moor.fairlead_tensions(tsys, tr), jmoor.fairlead_tensions(jsys, jr))
        close(moor.tension_jacobian(tsys, tr), jmoor.tension_jacobian(jsys, jr))


def test_solve_equilibrium():
    design, (jm, jenv, _), (tm, tenv, _) = _staged("OC3spar")
    jsys = jmoor.parse_mooring(design["mooring"], yaw_stiffness=design["turbine"]["yaw_stiffness"])
    tsys = convert.from_numpy("MooringSystem", convert.to_numpy(jsys), "cpu")
    s = jax_statics(jm, jax_rna(design), jenv)
    thrust = np.array([8e5, 0.0, 0.0, 0.0, 8e5 * 90.0, 0.0])
    F_const = np.asarray(s.W_struc + s.W_hydro) + thrust
    C_body = np.asarray(s.C_struc + s.C_hydro)
    r_ref, res_ref = jmoor.solve_equilibrium(jsys, jnp.asarray(F_const), jnp.asarray(C_body))
    r, res = moor.solve_equilibrium(tsys, torch.as_tensor(F_const), torch.as_tensor(C_body))
    close(r, r_ref)
    assert float(res) < 1e-6 and float(res_ref) < 1e-6


@pytest.mark.parametrize("name", DESIGNS)
def test_solve_eigen_and_estimates(name):
    design, (jm, jenv, _), (tm, tenv, _) = _staged(name)
    jsys = jmoor.parse_mooring(design["mooring"],
                               yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0))
    s = jax_statics(jm, jax_rna(design), jenv)
    M = np.asarray(s.M_struc + jstrip.strip_added_mass(jm, jenv))
    C = np.asarray(s.C_struc + s.C_hydro + jmoor.mooring_stiffness(jsys, jnp.zeros(6)))
    ref = jeigen.solve_eigen(jnp.asarray(M), jnp.asarray(C))
    got = eigen.solve_eigen(torch.as_tensor(M), torch.as_tensor(C))
    close(got.fns, ref.fns)
    close(got.modes, ref.modes, rtol=1e-9)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order))
    close(eigen.diagonal_estimates(torch.as_tensor(M), torch.as_tensor(C)),
          jeigen.diagonal_estimates(jnp.asarray(M), jnp.asarray(C)))
