"""Kernel K5's plain version and the drag linearization's two routes, on
the CPU (``raft_tpu_torch/core/cuda_drag.py``).

* K5's plain version, fed by ``strip.drag_coeffs`` and ``cuda_drag.plan``,
  against the differentiable ``strip.linearized_drag`` at float64 within
  1e-12 (an absolute floor of 1e-12 x the output's largest magnitude), on
  the inputs that the entries hand ``solve_dynamics``: one design, a
  variant batch, a mixed-depth ``sweep_designs`` bucket with per-lane Env
  fields, sea-state lanes (kinematics with a lane axis, one design's
  nodes), potMod nodes, lanes at sigma = 0 and a non-zero current;
* whole fixed-point solves in either driver through K5's plain version
  against the same solves through ``linearized_drag``;
* the route rule: no-grad solves take K5's wrapper, gradients, sharded
  solves and other dtypes keep ``linearized_drag``, as the counters
  ``drag.kernel`` and ``drag.plain`` show;
* the wrapper off the CPU refuses inputs that require grad, as K1's does,
  and finds no kernel on another device than CUDA.

The kernel itself runs on the card only: ``chip_smoke.py``'s phase "K5 vs
plain" holds it to the plain version there.
"""
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch.core import cuda_drag
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.hydro import strip
from raft_tpu_torch.model import stage_design_base
from raft_tpu_torch.obs import metrics
from raft_tpu_torch.solve import dynamics

sweep_mod = importlib.import_module("raft_tpu_torch.parallel.sweep")

HERE = os.path.dirname(os.path.abspath(__file__))
DESIGNS = os.path.join(os.path.dirname(HERE), "raft_tpu", "designs")
RTOL = 1e-12
NW = 8
CURRENT = dict(current=1.2, current_exp=1.0 / 7.0, current_heading=0.4)
CASES = ("single", "variants", "designs_bucket", "sea_states", "potmod", "sigma0", "current")


def _design(name):
    return os.path.join(DESIGNS, name + ".yaml")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage(name):
    _, m, rna, env, wave, C = stage_design_base(_design(name), nw=NW, Hs=8.0, Tp=12.0,
                                                w_min=0.05, w_max=2.95, device="cpu")
    return m, rna, env, wave, C


def _captured(call):
    """The (members, kin, wave, env, lin) that ``call()`` hands
    ``solve_dynamics`` (the last of its calls)."""
    seen = []
    orig = sweep_mod.solve_dynamics

    def rec(m, kin, wave, env, lin, **kw):
        seen.append((m, kin, wave, env, lin))
        return orig(m, kin, wave, env, lin, **kw)

    sweep_mod.solve_dynamics = rec
    try:
        with torch.no_grad():
            call()
    finally:
        sweep_mod.solve_dynamics = orig
    return seen[-1]


@pytest.fixture(scope="module")
def inputs():
    """Each case's (members, kin, wave, env, lead) and an iterate Xi."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        m, rna, env, wave, C = _stage("OC3spar")
        fr = sweep_mod.forward_response
        out["single"] = _captured(lambda: fr(m, rna, env, wave, C, n_iter=1, device="cpu"))
        th = torch.tensor([1.0, 1.05, 0.93, 1.1], dtype=torch.float64)
        out["variants"] = _captured(lambda: sweep_mod.sweep(m, rna, env, wave, C, th, n_iter=1,
                                                            device="cpu"))
        out["designs_bucket"] = _captured(lambda: sweep_mod.sweep_designs(
            [_design("OC3spar"), _design("VolturnUS-S")], nw=NW, n_iter=1, device="cpu"))
        depth = out["designs_bucket"][3].depth
        assert depth.shape == (2,) and float(depth[0]) != float(depth[1])   # per-lane Env
        cases = np.array([[8.0, 12.0, 0.1], [6.0, 10.0, 0.3], [3.0, 7.0, -0.2]])
        waves = sweep_mod.make_wave_states(wave.w, cases, float(env.depth), device="cpu")
        out["sea_states"] = _captured(lambda: sweep_mod.sweep_sea_states(
            m, rna, env, waves, C, n_iter=1, device="cpu"))
        env_c = dataclasses.replace(env, **CURRENT)
        out["current"] = _captured(lambda: fr(m, rna, env_c, wave, C, n_iter=1, device="cpu"))
        m4, rna4, env4, wave4, C4 = _stage("OC4semi")
        assert m4.node_potmod is not None and bool(m4.node_potmod.any())
        out["potmod"] = _captured(lambda: fr(m4, rna4, env4, wave4, C4, n_iter=1,
                                             device="cpu"))
        # lane 0 at rest in still water: every moment 0, so the slope is 2|U|
        mv, kin, wv, _, lin = _captured(lambda: sweep_mod.sweep(m, rna, env_c, wave, C, th,
                                                                n_iter=1, device="cpu"))
        still = torch.ones(4, 1, 1, 1, dtype=torch.float64)
        still[0] = 0.0
        kin0 = dataclasses.replace(kin, u=Cx(kin.u.re * still, kin.u.im * still))
        out["sigma0"] = (mv, kin0, wv, env_c, lin)
    finally:
        torch.set_num_threads(n)
    rng = np.random.default_rng(7)
    staged = {}
    for name, (mm, kin, wv, ev, lin) in out.items():
        lead = tuple(lin.F.re.shape[:-2])
        shape = lead + (wv.w.shape[0], 6)
        Xi = Cx(torch.as_tensor(rng.normal(size=shape)), torch.as_tensor(rng.normal(size=shape)))
        if name == "sigma0":
            Xi = Cx(Xi.re * still[:, 0], Xi.im * still[:, 0])
        staged[name] = (mm, kin, wv, ev, lead, Xi)
    return staged


def _close(got, want):
    got, want = got.detach().numpy(), want.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("case", CASES)
def test_plain_step_matches_linearized_drag(inputs, case):
    m, kin, wave, env, lead, Xi = inputs[case]
    B_ref, F_ref = strip.linearized_drag(m, kin, Xi, wave, env)
    p = cuda_drag.plan(strip.drag_coeffs(m, env), kin.u, wave.w, lead)
    B, F = cuda_drag.drag_step(p, Xi)
    _close(B, B_ref)
    _close(F.re, F_ref.re)
    _close(F.im, F_ref.im)
    if case == "sea_states":
        # one design's nodes, each sea state its own kinematics
        assert p.coef.shape[0] == 1 and p.u.re.shape[0] == lead[0] == 3
    if case == "sigma0":
        # lane 0: B_drag from the current alone, the slope 2|U| of every node
        assert float(B[0].abs().max()) > 0 and float(F.re[0].abs().max()) == 0.0


@pytest.mark.parametrize("method", ("scan", "while"))
def test_solve_through_the_plain_step_matches_linearized_drag(method, monkeypatch):
    m, rna, env, wave, C = _stage("OC3spar")
    th = torch.tensor([1.0, 1.05, 0.93, 1.1], dtype=torch.float64)
    mv = sweep_mod._apply_lanes(sweep_mod.scale_diameters, m, th)

    def solve():
        with torch.no_grad():
            return sweep_mod.forward_response(mv, rna, env, wave, C, n_iter=12, method=method,
                                              device="cpu")

    got = solve()
    monkeypatch.setattr(dynamics, "_kernel_route", lambda *a: False)
    want = solve()
    assert torch.equal(got.n_iter, want.n_iter) and torch.equal(got.converged, want.converged)
    for g, w in ((got.Xi.re, want.Xi.re), (got.Xi.im, want.Xi.im), (got.B_drag, want.B_drag),
                 (got.F_drag.re, want.F_drag.re), (got.F_drag.im, want.F_drag.im)):
        _close(g, w)


def _counts():
    return metrics.counter("drag.kernel").value, metrics.counter("drag.plain").value


@pytest.mark.parametrize("mode", ("no_grad", "grad_off_inputs", "grad"))
def test_route_follows_grad(mode):
    """No-grad solves, and solves with grad mode on but no input that
    requires grad, take K5's wrapper in every linearization; a gradient
    keeps ``linearized_drag`` in each."""
    m, rna, env, wave, C = _stage("OC3spar")
    n_iter = 3
    k0, p0 = _counts()
    if mode == "grad":
        th = torch.tensor([1.0, 1.05], dtype=torch.float64)
        g = sweep_mod.grad_response_std(m, rna, env, wave, C, th, n_iter=n_iter, device="cpu")
        assert torch.isfinite(g).all()
    elif mode == "no_grad":
        with torch.no_grad():
            sweep_mod.forward_response(m, rna, env, wave, C, n_iter=n_iter, device="cpu")
    else:
        assert torch.is_grad_enabled()
        sweep_mod.forward_response(m, rna, env, wave, C, n_iter=n_iter, device="cpu")
    k1, p1 = _counts()
    # the scan driver's n_iter steps and the final linearization
    want = (0, n_iter + 1) if mode == "grad" else (n_iter + 1, 0)
    assert (k1 - k0, p1 - p0) == want


def test_route_keeps_linearized_drag_for_sharded_solves_and_other_dtypes(inputs):
    m, kin, wave, env, lead, _ = inputs["variants"]
    nw = wave.w.shape[0]
    lin = dynamics.LinearCoeffs(M=torch.zeros(lead + (nw, 6, 6), dtype=torch.float64),
                                B=torch.zeros(lead + (nw, 6, 6), dtype=torch.float64),
                                C=torch.zeros(lead + (6, 6), dtype=torch.float64),
                                F=Cx(torch.zeros(lead + (nw, 6), dtype=torch.float64),
                                     torch.zeros(lead + (nw, 6), dtype=torch.float64)))
    assert dynamics._kernel_route(m, kin, wave, env, lin, None)
    assert not dynamics._kernel_route(m, kin, wave, env, lin, ("mesh", "freq"))
    half = dataclasses.replace(lin, C=lin.C.to(torch.bfloat16))
    assert not dynamics._kernel_route(m, kin, wave, env, half, None)
    wide = dataclasses.replace(wave, w=torch.linspace(0.05, 3.0, cuda_drag.MAX_NW + 1,
                                                      dtype=torch.float64))
    assert not dynamics._kernel_route(m, kin, wide, env, lin, None)
    with torch.enable_grad():
        lin_g = dataclasses.replace(lin, C=lin.C.clone().requires_grad_(True))
        assert not dynamics._kernel_route(m, kin, wave, env, lin_g, None)
        with torch.no_grad():
            assert dynamics._kernel_route(m, kin, wave, env, lin_g, None)


@pytest.mark.parametrize("nw,want", [(8, (64, 1)), (100, (128, 1)), (200, (224, 1)),
                                     (256, (256, 1)), (257, (160, 2)), (1024, (256, 4))])
def test_launch_shape(nw, want):
    threads, per = cuda_drag._launch_shape(nw)
    assert (threads, per) == want and threads * per >= nw and threads % 32 == 0
    with pytest.raises(ValueError, match="at most 1024"):
        cuda_drag._launch_shape(cuda_drag.MAX_NW + 1)


def test_wrapper_refuses_grad_off_the_cpu():
    """Off the CPU, K5's wrapper under grad mode with an input that requires
    grad raises and names the scan driver, as K1's does; without grad mode
    the same call reaches the device dispatch, which finds no kernel on a
    device other than CUDA."""
    meta = {"device": "meta", "dtype": torch.float64}
    L, N, nw = 2, 5, 8

    def call(grad):
        p = cuda_drag.plan(torch.empty(L, N, cuda_drag.N_COEF, **meta),
                           Cx(torch.empty(L, N, nw, 3, **meta), torch.empty(L, N, nw, 3, **meta)),
                           torch.empty(nw, **meta), (L,))
        Xi = Cx(torch.empty(L, nw, 6, **meta).requires_grad_(grad), torch.empty(L, nw, 6, **meta))
        return cuda_drag.drag_step(p, Xi)

    with pytest.raises(RuntimeError, match='method="scan"'):
        call(True)
    with torch.no_grad():
        with pytest.raises(ValueError, match="no kernel"):
            call(True)
    with pytest.raises(ValueError, match="no kernel"):
        call(False)
