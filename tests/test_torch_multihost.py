"""The port's frequency-sharded and design x frequency solves
(``raft_tpu_torch.parallel.sweep.forward_response_freq_sharded``,
``forward_response_dp_sp``) in a CPU world of 4 Gloo ranks
(``parallel.spmd.cpu_world``, spawned once for the file), against the JAX
package's own sharded solves on 4 of the conftest's virtual CPU devices
(the same mesh shapes) and against the port's unsharded solve, float64.

OC3spar: the freq-sharded solve at 40 frequencies (one rank per 10 bins)
and at 8 with a seeded staged BEM; dp x sp on a 2 x 2 mesh, thetas [0.92,
0.98, 1.04, 1.1] at 8 frequencies, and with the staged BEM on two
thetas (held against the port's unsharded solve only: the JAX package
keeps that case among its slow tests).  Pins are the JAX package's
(``tests/test_parallel.py``): freq-sharded rtol 1e-10 / atol 1e-14, dp x sp
rtol 1e-9 / atol 1e-12, identical iteration counts.  The psum carries
autograd: the ranks' scan-driver gradients of their shards' losses sum to
the unsharded gradient; the entry points that gather refuse inputs that
require grad.  Also the divisibility and mesh errors and
``init_multihost``'s partial arguments.

JAX is imported inside the tests only: the spawned ranks import this
module by name and must not load JAX.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from raft_tpu_torch.model import stage_design_base
from raft_tpu_torch.parallel import multihost
from raft_tpu_torch.parallel.multihost import global_mesh, pmax, psum
from raft_tpu_torch.parallel.spmd import cpu_world
from raft_tpu_torch.parallel.sweep import (_apply_lanes, forward_response,
                                           forward_response_dp_sp,
                                           forward_response_freq_sharded, response_std,
                                           scale_diameters, stage_bem)

HERE = os.path.dirname(os.path.abspath(__file__))
OC3 = os.path.join(HERE, "..", "raft_tpu", "designs", "OC3spar.yaml")
NW_FS, NW_DP = 40, 8
THETAS = np.array([0.92, 0.98, 1.04, 1.1])
GRAD_THETA = 1.03


def _base(nw):
    return stage_design_base(OC3, nw=nw, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95, device="cpu")


def _synth_bem(nw):
    """The JAX package's staged-BEM test coefficients (seeded)."""
    rng = np.random.default_rng(1)
    A = np.tile(np.eye(6)[:, :, None] * 4e6, (1, 1, nw))
    B = np.tile(np.eye(6)[:, :, None] * 2e5, (1, 1, nw))
    F = (rng.normal(size=(6, nw)) + 1j * rng.normal(size=(6, nw))) * 2e5
    return A, B, F


def _rao(out):
    return {"Xi": out.Xi.to_complex(), "n_iter": out.n_iter.numpy(),
            "converged": out.converged.numpy(), "B_drag": out.B_drag.numpy()}


def _errors(calls):
    """Each call's exception as ``type: message`` (None when none)."""
    got = []
    for call in calls:
        try:
            call()
            got.append(None)
        except (TypeError, ValueError) as e:
            got.append(f"{type(e).__name__}: {e}")
    return got


def _scan_grad(m, rna, env, wave, C, axis):
    """d(sum of |Xi|^2 over this shard's bins)/d(diameter scale), scan
    driver through the psum of the drag linearization."""
    th = torch.tensor(GRAD_THETA, dtype=torch.float64, requires_grad=True)
    out = forward_response(scale_diameters(m, th), rna, env, wave, C, n_iter=12,
                           method="scan", device="cpu", axis=axis)
    loss = out.Xi.abs2().sum()
    (g,) = torch.autograd.grad(loss, th)
    return float(g), float(loss.detach())


def _world(rank, mesh):
    """One rank of the world of 4: every sharded solve of this file."""
    res = {}
    _, m, rna, env, wave, C = _base(NW_FS)
    res["fs"] = _rao(forward_response_freq_sharded(m, rna, env, wave, C, mesh, device="cpu"))
    _, m8, rna8, env8, wave8, C8 = _base(NW_DP)
    bem = stage_bem(_synth_bem(NW_DP), wave8)
    res["fs_bem"] = _rao(forward_response_freq_sharded(m8, rna8, env8, wave8, C8, mesh, bem=bem,
                                                       device="cpu"))
    mesh2 = global_mesh(("designs", "freq"), (2, 2))
    res["dpsp"] = _rao(forward_response_dp_sp(m8, rna8, env8, wave8, C8, THETAS, mesh2,
                                              device="cpu"))
    res["dpsp_bem"] = _rao(forward_response_dp_sp(m8, rna8, env8, wave8, C8, THETAS[:2], mesh2,
                                                  bem=bem, device="cpu"))
    # the scan driver on this rank's shard; the ranks' gradients sum to the
    # unsharded one (the psum's backward all-reduces the cotangents)
    sl = multihost.block(mesh, "freq", NW_FS, "test")
    wave_l = multihost.stage_global(wave, mesh, type(wave)(w=("freq",), k=("freq",),
                                                         zeta=("freq",)))
    assert wave_l.w.shape == (NW_FS // 4,) and torch.equal(wave_l.w, wave.w[sl])
    g, loss = _scan_grad(m, rna, env, wave_l, C, (mesh, "freq"))
    res["grad"] = float(psum(torch.tensor([g], dtype=torch.float64), (mesh, "freq"))[0])
    res["loss"] = float(psum(torch.tensor([loss], dtype=torch.float64), (mesh, "freq"))[0])
    # the collectives reduce copies: the caller's tensors keep their values
    x = torch.full((3,), float(rank + 1), dtype=torch.float64)
    xg = x.clone().requires_grad_(True)
    axis = (mesh, "freq")
    got = [psum(x, axis), pmax(x, axis), psum(xg, axis), psum(x, axis)]
    res["collectives"] = [x.tolist(), xg.detach().tolist()] + [t.detach().tolist() for t in got]
    th = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    raw = _synth_bem(NW_DP)
    res["errors"] = _errors([
        lambda: forward_response_freq_sharded(m, rna, env, _base(42)[4], C, mesh, device="cpu"),
        lambda: forward_response_dp_sp(m8, rna8, env8, wave8, C8, THETAS[:3], mesh2,
                                       device="cpu"),
        lambda: forward_response_dp_sp(m8, rna8, env8, _base(7)[4], C8, THETAS, mesh2,
                                       device="cpu"),
        lambda: forward_response_dp_sp(m8, rna8, env8, wave8, C8, THETAS, mesh, device="cpu"),
        lambda: forward_response_dp_sp(m8, rna8, env8, wave8, C8, THETAS, mesh2, bem=raw,
                                       device="cpu"),
        lambda: forward_response_freq_sharded(m, rna, env, wave, C, object(), device="cpu"),
        lambda: forward_response_freq_sharded(scale_diameters(m, th), rna, env, wave, C, mesh,
                                              device="cpu"),
    ])
    return res


@pytest.fixture(scope="module")
def world_started():
    """The world, started in a thread so that it runs while the JAX side
    compiles."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(cpu_world, 4, _world, axis_names=("freq",), timeout=240.0)


@pytest.fixture(scope="module")
def world(world_started, jax_sharded):
    return world_started.result()


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded solves on 4 virtual CPU devices."""
    import jax
    from jax.sharding import Mesh

    from raft_tpu.model import stage_design_base as jax_stage_design_base
    from raft_tpu.parallel.sweep import forward_response_dp_sp as jax_dp_sp
    from raft_tpu.parallel.sweep import forward_response_freq_sharded as jax_fs
    from raft_tpu.parallel.sweep import stage_bem as jax_stage_bem

    kw = dict(Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
    devs = np.array(jax.devices()[:4])
    mesh1 = Mesh(devs, axis_names=("freq",))
    mesh2 = Mesh(devs.reshape(2, 2), axis_names=("designs", "freq"))
    _, jm, jr, je, jw, jC = jax_stage_design_base(OC3, nw=NW_FS, **kw)
    _, jm8, jr8, je8, jw8, jC8 = jax_stage_design_base(OC3, nw=NW_DP, **kw)
    jbem = jax_stage_bem(_synth_bem(NW_DP), jw8)

    def rao(out):
        return {"Xi": np.asarray(out.Xi.re) + 1j * np.asarray(out.Xi.im),
                "n_iter": np.asarray(out.n_iter), "converged": np.asarray(out.converged),
                "B_drag": np.asarray(out.B_drag)}

    return {"fs": rao(jax_fs(jm, jr, je, jw, jC, mesh=mesh1)),
            "fs_bem": rao(jax_fs(jm8, jr8, je8, jw8, jC8, mesh=mesh1, bem=jbem)),
            "dpsp": rao(jax_dp_sp(jm8, jr8, je8, jw8, jC8, THETAS, mesh=mesh2))}


def _unsharded(key):
    """The port's unsharded solve of the same case (``while``, 40)."""
    if key == "fs":
        _, m, rna, env, wave, C = _base(NW_FS)
        return _rao(forward_response(m, rna, env, wave, C, n_iter=40, method="while",
                                     device="cpu"))
    _, m, rna, env, wave, C = _base(NW_DP)
    bem = stage_bem(_synth_bem(NW_DP), wave) if key.endswith("bem") else None
    if key.startswith("fs"):
        return _rao(forward_response(m, rna, env, wave, C, bem=bem, n_iter=40, method="while",
                                     device="cpu"))
    th = torch.as_tensor(THETAS[:2] if key == "dpsp_bem" else THETAS)
    return _rao(forward_response(_apply_lanes(scale_diameters, m, th), rna, env, wave, C,
                                 bem=bem, n_iter=40, method="while", device="cpu"))


def _held(got, want, rtol, atol):
    """Xi elementwise at the pins; B_drag at ``rtol`` of its scale (its
    off-diagonal entries are sums that cancel to roundoff of the diagonal's
    size, exactly zero on one side and 1e-15 of the scale on the other)."""
    np.testing.assert_array_equal(got["n_iter"], want["n_iter"])
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["Xi"].real, want["Xi"].real, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["Xi"].imag, want["Xi"].imag, rtol=rtol, atol=atol)
    assert np.abs(got["B_drag"] - want["B_drag"]).max() <= rtol * np.abs(want["B_drag"]).max()


@pytest.mark.parametrize("key,rtol,atol", [("fs", 1e-10, 1e-14), ("fs_bem", 1e-10, 1e-14),
                                           ("dpsp", 1e-9, 1e-12)])
def test_sharded_solve_matches_jax_sharded(world, jax_sharded, key, rtol, atol):
    got, want = world[0][key], jax_sharded[key]
    assert got["Xi"].shape == want["Xi"].shape
    assert bool(np.all(got["converged"]))
    _held(got, want, rtol, atol)


@pytest.mark.parametrize("key,rtol,atol", [("fs", 1e-10, 1e-14), ("fs_bem", 1e-10, 1e-14),
                                           ("dpsp", 1e-9, 1e-12), ("dpsp_bem", 1e-9, 1e-12)])
def test_sharded_solve_matches_unsharded(world, key, rtol, atol):
    _held(world[0][key], _unsharded(key), rtol, atol)


@pytest.mark.parametrize("key", ["fs", "fs_bem", "dpsp", "dpsp_bem"])
def test_every_rank_returns_the_whole_result(world, key):
    for r in range(1, 4):
        for k in ("Xi", "n_iter", "converged", "B_drag"):
            np.testing.assert_array_equal(world[r][key][k], world[0][key][k])


def test_sharded_psum_carries_autograd(world):
    """The ranks' scan gradients of their shards' sums of |Xi|^2, summed,
    are the unsharded gradient of the whole sum (and the losses add up)."""
    _, m, rna, env, wave, C = _base(NW_FS)
    g, loss = _scan_grad(m, rna, env, wave, C, None)
    for r in range(4):
        np.testing.assert_allclose(world[r]["loss"], loss, rtol=1e-12)
        np.testing.assert_allclose(world[r]["grad"], g, rtol=1e-9)
    assert g != 0.0


def test_collectives_leave_the_callers_tensor(world):
    """``psum`` (with and without a gradient) and ``pmax`` return new
    tensors: a second ``psum`` of the same tensor gives the same sum."""
    for r in range(4):
        x, xg, s, mx, sg, s2 = world[r]["collectives"]
        assert x == xg == [float(r + 1)] * 3
        assert s == sg == s2 == [10.0] * 3 and mx == [4.0] * 3


def test_sharded_errors(world):
    fs_nw, dp_b, dp_nw, dp_1d, dp_raw, fs_type, fs_grad = world[0]["errors"]
    assert fs_nw == "ValueError: nw=42 not divisible by 4 devices"
    assert dp_b == "ValueError: design batch 3 not divisible by 2 (axis 'designs')"
    assert dp_nw == "ValueError: nw=7 not divisible by 2 (axis 'freq')"
    assert dp_1d.startswith("ValueError: forward_response_dp_sp needs a 2-D mesh")
    assert dp_raw.startswith("ValueError: forward_response_dp_sp expects the STAGED bem tuple")
    assert fs_type.startswith("TypeError: forward_response_freq_sharded: mesh must be a "
                              "torch.distributed.device_mesh.DeviceMesh")
    assert fs_grad.startswith("ValueError: forward_response_freq_sharded returns gathered "
                              "results without gradient history")
    assert all(world[r]["errors"] == world[0]["errors"] for r in range(4))


def test_init_multihost_partial_arguments_raise():
    with pytest.raises(ValueError, match="without a coordinator_address"):
        multihost.init_multihost(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="without a coordinator_address"):
        multihost.init_multihost(process_id=0, device="cpu")
    with pytest.raises(ValueError, match="needs num_processes and process_id"):
        multihost.init_multihost("127.0.0.1:1", num_processes=2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_sharded_response_std_matches_unsharded(world):
    """The std dev from the gathered freq-sharded spectra equals the
    unsharded solve's (the gather concatenates the ranks' bins in order)."""
    want = _unsharded("fs")
    _, _, _, _, wave, _ = _base(NW_FS)
    got_std = response_std(torch.as_tensor(np.abs(world[2]["fs"]["Xi"]) ** 2), wave.w)
    want_std = response_std(torch.as_tensor(np.abs(want["Xi"]) ** 2), wave.w)
    np.testing.assert_allclose(got_std.numpy(), want_std.numpy(), rtol=1e-10)
