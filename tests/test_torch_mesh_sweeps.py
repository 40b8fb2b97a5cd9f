"""The data-parallel ``mesh=`` options of the port in a CPU world of 2 Gloo
ranks (``parallel.spmd.cpu_world``, spawned once for the file), each
against the same call unsharded in this process, float64:

* ``sweep`` of OC3spar's ``scale_diameters`` variants (4 thetas, 16
  frequencies), with and without ``Xi_abs2``, and with ``health``;
* ``sweep_sea_states`` over 4 cases: without BEM, with a shared raw BEM
  tuple and with a staged heading grid (each case its own heading), and
  with ``health`` and iteration-starved lanes salvaged;
* ``directional_response`` of a 6-direction spread sea;
* ``sweep_designs`` of 8 designs in two buckets of 4 lanes with
  ``health``, one lane's batch solve poisoned with NaN (by its RNA mass) and
  salvaged alone;
* ``ArrayModel.solveDynamics`` of 4 OC3spar turbines, with its history;
* ``checkpoint.store_for(mesh=)``: one key per layout.

Statistics agree at 1e-12 scale-relative with identical iteration counts
(the same per-lane arithmetic in blocks of another size; the tests record
whether the bits are the same), every rank returns the whole result, and
every rank's health block is the unsharded call's.  ``sweep_designs`` and
``sweep_sea_states`` in its grid mode are held too against the JAX
package's own sharded runs of the same inputs on 2 of the conftest's
virtual CPU devices, at 1e-12 with identical iteration counts (the JAX
side's designs are not poisoned: the port's salvaged lane must come out
as the JAX batch solves it).  Also the mesh errors:
``mesh=object()`` names ``DeviceMesh``, a lane count not divisible by the
mesh and ``chunk`` with ``mesh`` raise ``ValueError``.

JAX is imported inside a fixture only: the spawned ranks import this
module by name and must not load JAX.
"""
import copy
import importlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from raft_tpu_torch.array import ArrayModel
from raft_tpu_torch.model import load_design, stage_design_base
from raft_tpu_torch.parallel.multihost import global_mesh
from raft_tpu_torch.parallel.spmd import cpu_world
from raft_tpu_torch.parallel.sweep import (directional_response, make_wave_states,
                                           spread_sea_state, sweep, sweep_designs,
                                           sweep_sea_states)
from raft_tpu_torch.resilience import checkpoint

# the module itself (the package exports the function ``sweep`` under its name)
sweep_mod = importlib.import_module("raft_tpu_torch.parallel.sweep")

HERE = os.path.dirname(os.path.abspath(__file__))
DESIGN_DIR = os.path.join(HERE, "..", "raft_tpu", "designs")
OC3 = os.path.join(DESIGN_DIR, "OC3spar.yaml")
KW = dict(nw=16, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
THETAS = np.array([0.9, 0.97, 1.03, 1.1])
CASES = [[4.0, 9.0, 0.0], [6.0, 10.0, 0.3], [8.0, 12.0, 0.7], [10.0, 13.0, 1.1]]
POISON_MRNA = 350001.0
TOL = 1e-12


def _base():
    return stage_design_base(OC3, device="cpu", **KW)


def _raw_bem(nw):
    rng = np.random.default_rng(3)
    A = np.tile(np.eye(6)[:, :, None] * 4e6, (1, 1, nw))
    B = np.tile(np.eye(6)[:, :, None] * 2e5, (1, 1, nw))
    F = (rng.normal(size=(6, nw)) + 1j * rng.normal(size=(6, nw))) * 2e5
    return A, B, F


def _grid_bem(nw):
    """A seeded heading grid (betas, F_all[3, 6, nw], A, B)."""
    A, B, _ = _raw_bem(nw)
    rng = np.random.default_rng(4)
    F_all = (rng.normal(size=(3, 6, nw)) + 1j * rng.normal(size=(3, 6, nw))) * 2e5
    return np.array([0.0, 0.6, 1.2]), F_all, A, B


def _designs():
    """Each shipped platform twice (two buckets of 4 lanes); the second
    OC3spar carries the poison RNA mass."""
    out = []
    for name in ("OC3spar", "VolturnUS-S", "OC4semi", "OC4semi_2"):
        d = load_design(os.path.join(DESIGN_DIR, name + ".yaml"))
        out += [d, copy.deepcopy(d)]
    out[1]["turbine"]["mRNA"] = POISON_MRNA
    return out


def _poisoned(forward_response):
    """``forward_response`` with the poisoned lanes of a batch solve (more
    than one lane) set to NaN: the batch quarantines them, the ladder's
    one-lane solve salvages them."""
    def run(members, rna, env, wave, C_moor, *args, **kw):
        out = forward_response(members, rna, env, wave, C_moor, *args, **kw)
        if members.node_r.ndim == 3 and members.node_r.shape[0] > 1:
            bad = (torch.as_tensor(rna.mRNA) == POISON_MRNA)[:, None, None]
            out.Xi.re = torch.where(bad, float("nan"), out.Xi.re)
        return out
    return run


def _farm(**dyn):
    a = ArrayModel(load_design(OC3), nT=4, positions=[[0, 0], [800, 0], [0, 800], [800, 800]],
                   w=np.arange(0.05, 3.0, 0.25), device="cpu")
    a.setEnv(Hs=8.0, Tp=12.0, Fthrust=800e3)
    a.calcSystemProps()
    a.solveDynamics(history=True, **dyn)
    r = a.results["response"]
    return {k: r[k] for k in ("Xi per turbine", "std dev", "iterations", "converged",
                              "iteration error history")}


def _calls(mesh=None):
    """Every call of the file, with ``mesh`` (None: unsharded)."""
    _, m, rna, env, wave, C = _base()
    w = wave.w.numpy()
    waves = make_wave_states(w, CASES, env.depth, device="cpu")
    waves2 = make_wave_states(w, [c[:2] for c in CASES], env.depth, device="cpu")
    spread = spread_sea_state(w, 8.0, 12.0, env.depth, beta0=0.2, n_dir=6, device="cpu")
    dm = dict(mesh=mesh, device="cpu")
    out = {
        "sweep": sweep(m, rna, env, wave, C, THETAS, **dm),
        "sweep_std": sweep(m, rna, env, wave, C, THETAS, return_xi=False, **dm),
        "sweep_health": sweep(m, rna, env, wave, C, THETAS, n_iter=3, health=True, **dm),
        "sea": sweep_sea_states(m, rna, env, waves2, C, **dm),
        "sea_raw": sweep_sea_states(m, rna, env, waves2, C, bem=_raw_bem(len(w)), **dm),
        "sea_grid": sweep_sea_states(m, rna, env, waves, C, bem=_grid_bem(len(w)), **dm),
        "sea_health": sweep_sea_states(m, rna, env, waves, C, n_iter=3, health=True, **dm),
        "directional": directional_response(m, rna, env, spread, C, **dm),
    }
    orig = sweep_mod.forward_response
    sweep_mod.forward_response = _poisoned(orig)
    try:
        out["designs"] = sweep_designs(_designs(), n_iter=30, health=True, **KW, **dm)
    finally:
        sweep_mod.forward_response = orig
    out["farm"] = _farm(mesh=mesh)
    return out


def _errors(calls):
    got = []
    for call in calls:
        try:
            call()
            got.append(None)
        except (TypeError, ValueError) as e:
            got.append(f"{type(e).__name__}: {e}")
    return got


def _world(rank, mesh, ckpt_dir):
    res = _calls(mesh)
    _, m, rna, env, wave, C = _base()
    three = make_wave_states(wave.w.numpy(), CASES[:3], env.depth, device="cpu")
    res["errors"] = _errors([
        lambda: sweep(m, rna, env, wave, C, THETAS[:3], mesh=mesh, device="cpu"),
        lambda: sweep_sea_states(m, rna, env, three, C, mesh=mesh, device="cpu"),
        lambda: sweep_sea_states(m, rna, env, three, C, mesh=mesh, chunk=1, device="cpu"),
        lambda: sweep_designs([OC3] * 3, mesh=mesh, device="cpu", **KW),
        lambda: sweep(m, rna, env, wave, C, THETAS, mesh=object(), device="cpu"),
    ])
    os.environ["RAFT_TPU_CKPT"] = ckpt_dir
    meshes = [None, mesh, global_mesh(("designs", "freq"), (2, 1)), global_mesh(("cases",))]
    res["keys"] = [checkpoint.store_for("sweep_sea_states", (np.zeros(4),), n_chunks=2,
                                        device="cpu", mesh=mm).key for mm in meshes]
    return res


@pytest.fixture(scope="module")
def world_started(tmp_path_factory):
    """The world, started in a thread so that it runs while the JAX side
    compiles."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(cpu_world, 2, _world, str(tmp_path_factory.mktemp("ckpt")),
                        axis_names=("designs",), timeout=240.0)


@pytest.fixture(scope="module")
def world(world_started, jax_sharded):
    return world_started.result()


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded ``sweep_sea_states`` (grid mode) and
    ``sweep_designs`` (health on, no poison) on 2 virtual CPU devices."""
    import jax
    from jax.sharding import Mesh

    from raft_tpu.model import stage_design_base as jax_stage_design_base
    from raft_tpu.parallel.sweep import make_wave_states as jax_make_wave_states
    from raft_tpu.parallel.sweep import sweep_designs as jax_sweep_designs
    from raft_tpu.parallel.sweep import sweep_sea_states as jax_sweep_sea_states

    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("designs",))
    _, jm, jr, je, jw, jC = jax_stage_design_base(OC3, **KW)
    w = np.asarray(jw.w)
    designs = _designs()
    return {"sea_grid": jax_sweep_sea_states(jm, jr, je, jax_make_wave_states(w, CASES, je.depth),
                                             jC, bem=_grid_bem(len(w)), mesh=mesh),
            "designs": jax_sweep_designs(designs, n_iter=30, health=True, mesh=mesh, **KW)}


@pytest.fixture(scope="module")
def plain(world):
    orig = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _calls(None)
    finally:
        torch.set_num_threads(orig)


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


STATS = {"sweep": ("std dev", "Xi_abs2"), "sweep_std": ("std dev",),
         "sweep_health": ("std dev", "Xi_abs2"),
         "sea": ("std dev", "nacelle accel std dev", "Xi_abs2"),
         "sea_raw": ("std dev", "nacelle accel std dev", "Xi_abs2"),
         "sea_grid": ("std dev", "nacelle accel std dev", "Xi_abs2"),
         "sea_health": ("std dev", "nacelle accel std dev", "Xi_abs2"),
         "designs": ("std dev", "Xi_abs2")}


@pytest.mark.parametrize("key", sorted(STATS))
def test_mesh_matches_unsharded(world, plain, key):
    want = plain[key]
    for r, res in enumerate(world):
        got = res[key]
        np.testing.assert_array_equal(got["iterations"], want["iterations"])
        for k in STATS[key]:
            assert _rel(got[k], want[k]) <= TOL, (r, k)
        if "health" in want:
            assert got["health"] == want["health"]
            np.testing.assert_array_equal(got["converged"], want["converged"])
            np.testing.assert_array_equal(got["finite"], want["finite"])


@pytest.mark.parametrize("key", ["sea_grid", "designs"])
def test_mesh_matches_jax_sharded(world, jax_sharded, key):
    want = jax_sharded[key]
    for r, res in enumerate(world):
        got = res[key]
        np.testing.assert_array_equal(got["iterations"], np.asarray(want["iterations"]))
        for k in STATS[key]:
            assert _rel(got[k], np.asarray(want[k])) <= TOL, (r, k)


def test_health_salvages_on_every_rank(world, plain):
    """The poisoned lane is quarantined and salvaged; the starved lanes of
    the variants and the sea states are salvaged the same way on every
    rank as unsharded."""
    h = plain["designs"]["health"]
    assert h["quarantined"] == [1] and h["salvaged"] == 1 and not h["unsalvaged"]
    assert plain["sweep_health"]["health"]["n_quarantined"] > 0
    assert plain["sea_health"]["health"]["n_quarantined"] > 0
    for res in world:
        assert res["designs"]["health"] == h
        assert bool(np.isfinite(res["designs"]["std dev"]).all())
        assert res["designs"]["buckets"]["n_buckets"] == 2


def test_directional_response_matches_unsharded(world, plain):
    want = plain["directional"]
    for res in world:
        got = res["directional"]
        assert _rel(got["std dev"], want["std dev"]) <= TOL
        assert abs(got["nacelle accel std dev"] - want["nacelle accel std dev"]) <= (
            TOL * want["nacelle accel std dev"])
        np.testing.assert_array_equal(got["per direction"]["iterations"],
                                      want["per direction"]["iterations"])


def test_array_solve_dynamics_matches_unsharded(world, plain):
    want = plain["farm"]
    for res in world:
        got = res["farm"]
        np.testing.assert_array_equal(got["iterations"], want["iterations"])
        np.testing.assert_array_equal(got["converged"], want["converged"])
        for k in ("Xi per turbine", "std dev"):
            assert _rel(np.abs(got[k]), np.abs(want[k])) <= TOL
        np.testing.assert_array_equal(np.isnan(got["iteration error history"]),
                                      np.isnan(want["iteration error history"]))


def test_mesh_bits_and_whole_results(world, plain):
    """Every rank holds the same bits; record which paths match the
    unsharded call bit for bit (the same arithmetic on fewer lanes)."""
    for key in STATS:
        for k in STATS[key]:
            np.testing.assert_array_equal(world[1][key][k], world[0][key][k])
    same = {key: all(np.array_equal(world[0][key][k], plain[key][k]) for k in STATS[key])
            for key in STATS}
    same["farm"] = np.array_equal(world[0]["farm"]["Xi per turbine"],
                                  plain["farm"]["Xi per turbine"])
    print("bit for bit against unsharded:", same)
    assert same["sweep"] and same["sea"] and same["farm"]


def test_mesh_errors(world):
    not_div, sea_div, chunk, buckets, not_mesh = world[0]["errors"]
    assert not_div == "ValueError: sweep: 3 lanes not divisible by 2 devices"
    assert sea_div == "ValueError: sweep_sea_states: 3 lanes not divisible by 2 devices"
    assert chunk.startswith("ValueError: chunked (pipelined) sweep_sea_states does not compose "
                            "with a mesh")
    assert buckets.startswith("ValueError: sweep_designs: bucket lane count 3 is not divisible "
                              "by mesh axis 'designs' size 2")
    assert not_mesh.startswith("TypeError: sweep: mesh must be a "
                               "torch.distributed.device_mesh.DeviceMesh")
    assert world[1]["errors"] == world[0]["errors"]


def test_store_keys_differ_by_layout(world):
    keys = world[0]["keys"]
    assert len(set(keys)) == len(keys) == 4
    assert world[1]["keys"] == keys


def test_make_mesh_joins_a_world_of_one():
    """In a process that joined no world, ``make_mesh`` joins a world of
    one (Gloo on the CPU; without CUDA the default device raises first);
    ``sweep(mesh=make_mesh())`` is then the unsharded sweep bit for bit."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep_mod.make_mesh()
    assert not dist.is_initialized()
    mesh = sweep_mod.make_mesh(device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("designs",) and tuple(mesh.shape) == (1,)
        _, m, rna, env, wave, C = _base()
        got = sweep(m, rna, env, wave, C, THETAS, mesh=mesh, device="cpu")
        want = sweep(m, rna, env, wave, C, THETAS, device="cpu")
        for k in ("std dev", "iterations", "Xi_abs2"):
            np.testing.assert_array_equal(got[k], want[k])
        assert sweep_mod.make_mesh(axis="cases", device="cpu").mesh_dim_names == ("cases",)
        with pytest.raises(ValueError, match="n_devices=2 but the world has 1 ranks"):
            sweep_mod.make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
