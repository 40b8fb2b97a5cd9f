"""The port's dispatch-ahead chunk executor
(``raft_tpu_torch.parallel.pipeline.run_pipelined``) and the chunked DLC
table (``sweep_sea_states(chunk=...)``), on the CPU.

``run_pipelined`` keeps item order, bounds the in-flight window, stages
chunk k+1 before it fetches chunk k, and at depth 1 is the blocking loop;
its knobs read as the JAX package's; donated staged tensors are counted
and, once the executor has dropped them, invalidated.  The chunked DLC
table of ``raft_tpu/parallel/pipeline.py:_smoke`` (OC3spar, 4 cases with
their own headings on a synthetic 3-heading grid, 12 frequencies, 8
iterations, chunks of 2) equals the JAX package's chunked call at 1e-12
scale-relative (f64) with identical iteration counts, and the port's
unchunked call at 1e-12; the raw-BEM mode as well.  (The CUDA-stream path
runs on the card only: ``chip_smoke.py`` phase "operations".)
"""
import os

import numpy as np
import pytest
import torch

from raft_tpu.model import stage_design_base as jax_stage_design_base
from raft_tpu.parallel import pipeline as jpipeline
from raft_tpu.parallel.sweep import make_wave_states as jax_make_wave_states
from raft_tpu.parallel.sweep import sweep_sea_states as jax_sweep_sea_states

from raft_tpu_torch.model import stage_design_base
from raft_tpu_torch.parallel import pipeline
from raft_tpu_torch.parallel.sweep import make_wave_states, sweep_sea_states

HERE = os.path.dirname(os.path.abspath(__file__))
OC3 = os.path.join(HERE, "..", "raft_tpu", "designs", "OC3spar.yaml")
KW = dict(nw=12, Hs=6.0, Tp=10.0, w_min=0.3, w_max=2.1)
CASES = [[6.0, 10.0, 0.1], [7.0, 11.0, 0.4], [8.0, 12.0, 0.6], [9.0, 13.0, 0.9]]
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _smoke_grid(nw):
    """The synthetic 3-heading grid of ``raft_tpu/parallel/pipeline.py:_smoke``."""
    rng = np.random.default_rng(7)
    bgrid = np.array([0.0, 0.5, 1.0])
    scale = 1e6
    A_h = np.repeat((rng.normal(size=(6, 6, 1)) * 0.1 + np.eye(6)[..., None]) * scale, nw,
                    axis=2)
    B_h = np.repeat((rng.normal(size=(6, 6, 1)) * 0.02) * scale, nw, axis=2)
    F_all = (rng.normal(size=(3, 6, nw)) + 1j * rng.normal(size=(3, 6, nw))) * scale * 0.01
    return (bgrid, F_all, A_h, B_h)


@pytest.fixture(scope="module")
def table():
    design, m, rna, env, wave, C = stage_design_base(OC3, device="cpu", **KW)
    _, jm, jrna, jenv, jwave, jC = jax_stage_design_base(OC3, **KW)
    depth = float(design["mooring"]["water_depth"])
    waves = make_wave_states(wave.w.numpy(), CASES, depth, device="cpu")
    jwaves = jax_make_wave_states(np.asarray(jwave.w), CASES, depth)
    return (m, rna, env, waves, C), (jm, jrna, jenv, jwaves, jC), _smoke_grid(KW["nw"])


# ----------------------------------------------------------- run_pipelined


@pytest.mark.parametrize("depth", [2, 3])
def test_run_pipelined_order_depth_and_overlap(depth):
    log = []

    def stage(k):
        log.append(("stage", k))
        return (torch.tensor(float(k)),)

    def fetch(out):
        v = float(out)
        log.append(("fetch", int(v // 2)))
        return v

    results, stats = pipeline.run_pipelined(lambda x: x * 2.0, list(range(6)), depth=depth,
                                            stage=stage, fetch=fetch, device="cpu")
    assert results == [2.0 * k for k in range(6)]
    assert stats.chunks == 6 and stats.max_in_flight == depth
    for k in range(depth - 1, 6):
        # chunk k is staged before chunk k-depth+1 is fetched
        assert log.index(("stage", k)) < log.index(("fetch", k - depth + 1))
    assert stats.overlap_fraction > 0.0 and stats.chunks_computed == 6


def test_run_pipelined_depth_one_is_the_blocking_loop():
    log = []

    def stage(k):
        log.append(("stage", k))
        return torch.tensor(float(k))

    def fetch(out):
        log.append(("fetch", int(out)))
        return float(out)

    results, stats = pipeline.run_pipelined(lambda x: x + 1.0, [1, 2, 3], depth=1, stage=stage,
                                            fetch=fetch, device="cpu")
    assert results == [2.0, 3.0, 4.0] and stats.max_in_flight == 1
    assert log == [("stage", 1), ("fetch", 2), ("stage", 2), ("fetch", 3), ("stage", 3),
                   ("fetch", 4)]
    assert stats.overlap_fraction == 0.0


def test_run_pipelined_default_fetch_gives_numpy_and_keeps_tuples():
    results, stats = pipeline.run_pipelined(
        lambda x: (x * 2.0, (x > 0).to(torch.int32)),
        [torch.arange(3.0) + k for k in range(3)], device="cpu")
    assert all(isinstance(r, tuple) and isinstance(r[0], np.ndarray) for r in results)
    np.testing.assert_array_equal(results[2][0], [4.0, 6.0, 8.0])
    assert results[0][1].dtype == np.int32 and stats.depth == pipeline.DEFAULT_DEPTH


def test_run_pipelined_refuses_the_cpu_fallback_without_a_card(monkeypatch):
    """The default device is the card: without CUDA the executor raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run_pipelined(lambda x: x, [torch.zeros(1)])


@pytest.mark.parametrize("mod", [pipeline, jpipeline], ids=["port", "jax"])
def test_dispatch_depth_knob(monkeypatch, mod):
    monkeypatch.delenv("RAFT_TPU_PIPELINE_DEPTH", raising=False)
    assert mod.dispatch_depth() == 2
    monkeypatch.setenv("RAFT_TPU_PIPELINE_DEPTH", "4")
    assert mod.dispatch_depth() == 4
    monkeypatch.setenv("RAFT_TPU_PIPELINE_DEPTH", "0")
    assert mod.dispatch_depth() == 1
    monkeypatch.setenv("RAFT_TPU_PIPELINE_DEPTH", "nope")
    with pytest.warns(UserWarning, match="RAFT_TPU_PIPELINE_DEPTH"):
        assert mod.dispatch_depth() == 2


def test_donation_enabled_knob(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_DONATE", raising=False)
    assert pipeline.donation_enabled() is jpipeline.donation_enabled() is True
    for v in ("0", "false", "OFF", "no", "1"):
        monkeypatch.setenv("RAFT_TPU_DONATE", v)
        assert pipeline.donation_enabled() is jpipeline.donation_enabled() is (v == "1")


def test_stats_keys_match_jax():
    assert set(pipeline.PipelineStats().to_dict()) == set(jpipeline.PipelineStats().to_dict())


def test_donated_tensors_are_counted_and_invalidated():
    """The executor drops its references to donated staged tensors at
    dispatch: with ``fn`` keeping none, each is gone by the fetch."""
    def stage(k):
        return (torch.full((64,), float(k), dtype=torch.float64), torch.ones(2))

    results, stats = pipeline.run_pipelined(lambda x, y: x * 3.0, [0, 1, 2], depth=2,
                                            stage=stage, donate_argnums=(0,), device="cpu")
    assert stats.donated_buffers == 3 and stats.invalidated_buffers == 3
    assert stats.donated_bytes == 3 * 64 * 8
    np.testing.assert_array_equal(results[1], np.full(64, 3.0))


def test_a_donated_tensor_still_held_stays_visible():
    kept = []

    def fn(x):
        kept.append(x)                      # something still holds it
        return x + 1.0

    _, stats = pipeline.run_pipelined(fn, [0, 1], stage=lambda k: (torch.zeros(4) + k,),
                                      donate_argnums=(0,), device="cpu")
    assert stats.donated_buffers == 2 and stats.invalidated_buffers == 0


def test_to_device_casts_on_the_host_to_the_same_bits():
    from raft_tpu_torch.core.device import to_device

    a = np.random.default_rng(0).normal(size=(5, 7))
    t = to_device(a, torch.float32, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert torch.equal(t, torch.as_tensor(a).to(torch.float32))
    assert torch.equal(to_device(a.T, torch.float64, "cpu"), torch.as_tensor(a.T))
    assert to_device(a.T, torch.float64, "cpu").is_contiguous()
    assert to_device(0.5, torch.float32, "cpu").shape == ()
    x = torch.ones(3, requires_grad=True)
    assert to_device(x, torch.float32, "cpu") is x          # a tensor in place: autograd kept


# ------------------------------------------------- chunked sweep_sea_states


def test_chunked_heading_grid_matches_jax_and_unchunked(table, monkeypatch):
    monkeypatch.delenv("RAFT_TPU_DONATE", raising=False)
    (m, rna, env, waves, C), (jm, jrna, jenv, jwaves, jC), grid = table
    got = sweep_sea_states(m, rna, env, waves, C, bem=grid, n_iter=8, chunk=2,
                           pipeline_depth=2, device="cpu")
    ref = jax_sweep_sea_states(jm, jrna, jenv, jwaves, jC, bem=grid, n_iter=8, chunk=2,
                               pipeline_depth=2)
    whole = sweep_sea_states(m, rna, env, waves, C, bem=grid, n_iter=8, device="cpu")
    for k in ("std dev", "nacelle accel std dev", "Xi_abs2"):
        assert _rel(got[k], ref[k]) <= TOL, k
        assert _rel(got[k], whole[k]) <= TOL, k
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    np.testing.assert_array_equal(got["iterations"], whole["iterations"])
    st = got["pipeline"]
    assert set(st) == set(ref["pipeline"])
    assert st["chunks"] == 2 and st["max_in_flight"] == 2 and st["chunks_computed"] == 2
    # the per-chunk excitation (its real part) is donated and released
    assert st["donated_buffers"] == 2 == st["invalidated_buffers"]
    assert st["donated_bytes"] == 2 * 2 * KW["nw"] * 6 * 8
    assert "checkpoint" not in got and "health" not in got


def test_chunked_donation_knob_opts_out(table, monkeypatch):
    (m, rna, env, waves, C), _, grid = table
    monkeypatch.setenv("RAFT_TPU_DONATE", "0")
    out = sweep_sea_states(m, rna, env, waves, C, bem=grid, n_iter=8, chunk=1, device="cpu")
    assert out["pipeline"]["donated_buffers"] == 0 and out["pipeline"]["chunks"] == 4


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunked_raw_bem_matches_jax_and_unchunked(table, chunk):
    (m, rna, env, waves, C), (jm, jrna, jenv, jwaves, jC), grid = table
    bem = (grid[2], grid[3], grid[1][0])               # raw single-heading tuple
    w2 = make_wave_states(waves.w[0].numpy(), [r[:2] for r in CASES], float(env.depth),
                          device="cpu")
    jw2 = jax_make_wave_states(np.asarray(jwaves.w[0]), [r[:2] for r in CASES],
                               float(jenv.depth))
    got = sweep_sea_states(m, rna, env, w2, C, bem=bem, n_iter=8, chunk=chunk, device="cpu")
    ref = jax_sweep_sea_states(jm, jrna, jenv, jw2, jC, bem=bem, n_iter=8, chunk=chunk)
    whole = sweep_sea_states(m, rna, env, w2, C, bem=bem, n_iter=8, device="cpu")
    for k in ("std dev", "nacelle accel std dev", "Xi_abs2"):
        assert _rel(got[k], ref[k]) <= TOL and _rel(got[k], whole[k]) <= TOL, k
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    assert got["pipeline"]["donated_buffers"] == 0      # nothing fresh to donate


def test_chunked_strip_only_matches_unchunked(table):
    (m, rna, env, waves, C), _, _ = table
    got = sweep_sea_states(m, rna, env, waves, C, n_iter=8, chunk=2, device="cpu")
    whole = sweep_sea_states(m, rna, env, waves, C, n_iter=8, device="cpu")
    for k in ("std dev", "Xi_abs2"):
        assert _rel(got[k], whole[k]) <= TOL
    np.testing.assert_array_equal(got["iterations"], whole["iterations"])


def test_chunk_validation(table):
    (m, rna, env, waves, C), _, _ = table
    three = make_wave_states(waves.w[0].numpy(), [r[:2] for r in CASES[:3]], float(env.depth),
                             device="cpu")
    with pytest.raises(ValueError, match="divisible by chunk"):
        sweep_sea_states(m, rna, env, three, C, chunk=2, device="cpu")
    with pytest.raises(ValueError, match="divisible by chunk"):
        sweep_sea_states(m, rna, env, three, C, chunk=0, device="cpu")
    with pytest.raises(ValueError, match="does not compose"):
        sweep_sea_states(m, rna, env, three, C, chunk=3, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="mesh must be a .*DeviceMesh"):
        sweep_sea_states(m, rna, env, three, C, mesh=object(), device="cpu")


def test_chunked_checkpoint_resume_parity(table, tmp_path, monkeypatch):
    """The chunked DLC table with ``RAFT_TPU_CKPT`` armed: a second run
    resumes every chunk and returns the same bits; another table of the
    same shapes, or another iteration budget, lands in another store."""
    (m, rna, env, waves, C), _, grid = table
    monkeypatch.setenv("RAFT_TPU_CKPT", str(tmp_path))
    out1 = sweep_sea_states(m, rna, env, waves, C, bem=grid, n_iter=8, chunk=2, device="cpu")
    assert out1["checkpoint"]["saved"] == 2 and out1["pipeline"]["chunks_computed"] == 2
    out2 = sweep_sea_states(m, rna, env, waves, C, bem=grid, n_iter=8, chunk=2, device="cpu")
    assert out2["pipeline"]["chunks_resumed"] == 2 and out2["pipeline"]["chunks_computed"] == 0
    for k in ("std dev", "Xi_abs2", "iterations", "nacelle accel std dev"):
        np.testing.assert_array_equal(out2[k], out1[k])
    out3 = sweep_sea_states(m, rna, env, waves, C, bem=grid, n_iter=9, chunk=2, device="cpu")
    assert out3["pipeline"]["chunks_resumed"] == 0
    other = make_wave_states(waves.w[0].numpy(), [[5.0, 9.0, 0.1], *CASES[1:]],
                             float(env.depth), device="cpu")
    out4 = sweep_sea_states(m, rna, env, other, C, bem=grid, n_iter=8, chunk=2, device="cpu")
    assert out4["pipeline"]["chunks_resumed"] == 0 and out4["pipeline"]["chunks_computed"] == 2
    assert not np.allclose(out4["std dev"], out1["std dev"])
