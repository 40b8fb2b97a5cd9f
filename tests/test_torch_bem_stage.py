"""BEM staging of the port's north-star sweep against the JAX package:
``stage_bem`` lays a host-layout (A, B, F) tuple out on the device exactly
as ``raft_tpu.parallel.stage_bem`` does, and ``sweep_north_star`` with that
staged tuple matches ``jax.vmap`` of the JAX ``forward_response`` over the
same 4 VolturnUS-S plan-radius x draft variants at 16 frequencies:
identical per-lane iteration counts, std dev to 1e-10 scale-relative.

The coefficients are seeded numbers in the panel solver's host layout
(A[6, 6, nw], B[6, 6, nw], F[6, nw] complex); the device panel solve that
makes them in the sweep is pinned by ``test_torch_bem_solve*.py`` and runs
at full width on the card (``chip_smoke.py``)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from raft_tpu.build.members import build_member_set as jax_members, build_rna as jax_rna
from raft_tpu.core import waves as jwaves
from raft_tpu.core.types import Env as JEnv, WaveState as JWave
from raft_tpu.model import load_design
from raft_tpu.mooring import mooring_stiffness as jax_stiffness, parse_mooring as jax_parse
from raft_tpu.parallel import (forward_response as jax_forward, make_scale_plan as jax_plan,
                               make_stretch_draft as jax_draft, response_std as jax_std,
                               stage_bem as jax_stage_bem)

from raft_tpu_torch import convert
from raft_tpu_torch.core.types import WaveState
from raft_tpu_torch.core.waves import jonswap, wave_number
from raft_tpu_torch.parallel.sweep import north_star_grid, stage_bem, sweep_north_star

TOL = 1e-10
NW = 16
N = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _bem():
    rng = np.random.default_rng(11)
    G = rng.normal(size=(NW, 6, 6))
    A = 1e6 * (G @ np.swapaxes(G, -1, -2) + np.eye(6))
    B = 1e5 * np.abs(rng.normal(size=(NW, 6, 6)))
    F = 1e6 * (rng.normal(size=(NW, 6)) + 1j * rng.normal(size=(NW, 6)))
    return convert.bem_tuple((np.moveaxis(A, 0, -1), np.moveaxis(B, 0, -1), F.T))


def _port_wave(depth):
    w = torch.as_tensor(np.linspace(0.05, 2.95, NW))
    return WaveState(w=w, k=wave_number(w, depth), zeta=torch.sqrt(jonswap(w, 8.0, 12.0)))


def test_stage_bem_matches_jax():
    bem = _bem()
    w = jnp.asarray(np.linspace(0.05, 2.95, NW))
    jwave = JWave(w=w, k=jwaves.wave_number(w, 200.0), zeta=jnp.sqrt(jwaves.jonswap(w, 8.0, 12.0)))
    ref = jax_stage_bem(bem, jwave)
    got = stage_bem(bem, _port_wave(200.0))
    assert got[0].shape == (NW, 6, 6) and got[2].re.shape == (NW, 6)
    for g, r in ((got[0], ref[0]), (got[1], ref[1]), (got[2].re, ref[2].re), (got[2].im, ref[2].im)):
        assert _scale_rel(g.numpy(), r) <= 1e-15


def test_sweep_north_star_with_staged_bem_matches_vmap():
    design = load_design("raft_tpu/designs/VolturnUS-S.yaml")
    depth = float(design["mooring"]["water_depth"])
    bem = _bem()
    jm = jax_members(design)
    w = jnp.asarray(np.linspace(0.05, 2.95, NW))
    jwave = JWave(w=w, k=jwaves.wave_number(w, depth), zeta=jnp.sqrt(jwaves.jonswap(w, 8.0, 12.0)))
    jenv = JEnv(Hs=8.0, Tp=12.0, depth=depth)
    C = jax_stiffness(jax_parse(design["mooring"],
                                yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0)),
                      jnp.zeros(6))
    jbem = jax_stage_bem(bem, jwave)
    draft, plan = jax_draft(jm), jax_plan(jm)

    def one(th):
        m = plan(draft(jm, th[1]), th[0])
        out = jax_forward(m, jax_rna(design), jenv, jwave, C, bem=jbem, n_iter=40,
                          method="while")
        return jax_std(out.Xi.abs2(), jwave.w), out.n_iter, out.converged

    s_ref, it_ref, c_ref = jax.vmap(one)(jnp.asarray(north_star_grid(N)))
    staged = stage_bem(bem, _port_wave(depth))
    got = sweep_north_star(n_designs=N, nw=NW, chunk=N, n_iter=40, dtype=torch.float64,
                           device="cpu", bem=staged)
    np.testing.assert_array_equal(got["n_iter"].numpy(), np.asarray(it_ref))
    assert bool(got["converged"].all()) and bool(np.asarray(c_ref).all())
    assert _scale_rel(got["std"].numpy(), s_ref) <= TOL
    # chunking and a lane subset change nothing; without BEM the answer moves
    split = sweep_north_star(n_designs=N, nw=NW, chunk=3, n_iter=40, dtype=torch.float64,
                             device="cpu", bem=staged, lanes=np.array([1, 3]))
    assert _scale_rel(split["std"].numpy(), got["std"][[1, 3]].numpy()) <= 1e-14
    strip = sweep_north_star(n_designs=N, nw=NW, chunk=N, n_iter=40, dtype=torch.float64,
                             device="cpu")
    assert _scale_rel(strip["std"].numpy(), s_ref) > 1e-3
