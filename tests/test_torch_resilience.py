"""The port's resilience modules (``raft_tpu_torch.resilience``: health,
ladder, faults, retry, checkpoint) against the JAX package's, on the CPU.

Mirrors the unit cases of ``tests/test_resilience.py``: where a function
returns data (verdicts, summaries, rung knobs, ladder records, fault
specs, redacted tails, content hashes) the port's answer equals the JAX
package's on the same numpy-seeded inputs.  The chunk store's key is the
port's own digest, with the device type in it: a CPU store is never the
card's.  The g++ build of the host panel solver retries through
``retry_call`` and raises when the retries are spent.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from raft_tpu.resilience import checkpoint as jckpt
from raft_tpu.resilience import faults as jfaults
from raft_tpu.resilience import health as jhealth
from raft_tpu.resilience import ladder as jladder
from raft_tpu.resilience import retry as jretry

from raft_tpu_torch.resilience import checkpoint, faults, health, ladder, retry


def _records(recs):
    return [(r.index, r.converged, r.finite, r.n_iter, r.quarantined, r.salvaged, r.rung)
            for r in recs]


# ------------------------------------------------------------------ health


def test_strict_env_parsing(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_STRICT", raising=False)
    assert health.strict() is True and jhealth.strict() is True
    for v in ("1", "on", "true", "STRICT", "0", "false", "OFF", "no"):
        monkeypatch.setenv("RAFT_TPU_STRICT", v)
        assert health.strict() is jhealth.strict() is (v.lower() not in ("0", "false", "off",
                                                                          "no"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_failed_lanes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    conv = rng.random(16) > 0.2
    finite = rng.random(16) > 0.2
    vals = rng.normal(size=(16, 3, 2))
    vals[rng.integers(0, 16, 3), 1, 0] = np.nan
    one = rng.normal(size=16)
    one[rng.integers(0, 16)] = np.inf
    for args in ((conv,), (conv, finite), (conv, None, (vals,)), (conv, finite, (vals, one))):
        got = health.failed_lanes(*args)
        np.testing.assert_array_equal(got, jhealth.failed_lanes(*args))
    assert list(health.failed_lanes([True, True, True, True], None,
                                    host_values=(np.array([1.0, 1.0, np.nan, 1.0]),))) == [2]


def test_summarize_matches_jax():
    mk = lambda m: [m.LaneHealth(3, True, True, 12, quarantined=True, salvaged=True,  # noqa: E731
                                 rung="n_iter_x4"),
                    m.LaneHealth(7, False, False, 48, quarantined=True),
                    m.LaneHealth(9, True, True, 30, quarantined=True, salvaged=True,
                                 rung="relax_0.5")]
    got = health.summarize(mk(health), 10, extra={"strict": False})
    assert got == jhealth.summarize(mk(jhealth), 10, extra={"strict": False})
    assert got["unsalvaged"] == [7] and got["rungs_used"] == {"n_iter_x4": 1, "relax_0.5": 1}
    json.dumps(got)


# ------------------------------------------------------------------ ladder


@pytest.mark.parametrize("base", [0, 1, 8, 25, 40])
def test_rung_knobs_match_jax(base):
    assert [r.name for r in ladder.RUNGS] == [r.name for r in jladder.RUNGS]
    for r, jr in zip(ladder.RUNGS, jladder.RUNGS):
        assert ladder.rung_knobs(r, base) == jladder.rung_knobs(jr, base)
    assert ladder.rung_knobs(ladder.RUNGS[3], 8) == (48, 0.5, 1e-6)


@pytest.mark.parametrize("ok_relax", [0.8, 0.5, 0.25, None])
def test_escalate_lanes_matches_jax(ok_relax):
    """A fake lane solver that converges only at one rung's relaxation
    (None: never; the tikhonov rung shares relax 0.5 with relax_0.5): the
    same rungs are walked and the same records come back."""
    def make(calls):
        def solve_lane(idx, n_iter, relax, tik):
            calls.append((idx, n_iter, relax, tik))
            ok = relax == ok_relax
            return (np.full(3, 1.0 if ok else np.nan),), ok, ok, n_iter
        return solve_lane

    c1, c2 = [], []
    got = ladder.escalate_lanes([5, 2], make(c1), 8)
    want = jladder.escalate_lanes([5, 2], make(c2), 8)
    assert c1 == c2
    assert _records(got[0]) == _records(want[0])
    assert sorted(got[1]) == sorted(want[1])


def test_escalate_lanes_rejects_nan_payload_despite_flags():
    def solve_lane(idx, n_iter, relax, tik):
        return (np.full(2, np.nan),), True, True, n_iter

    records, salvaged = ladder.escalate_lanes([0], solve_lane, 4)
    assert not records[0].salvaged and salvaged == {} and records[0].rung is None
    assert _records(records) == _records(jladder.escalate_lanes([0], solve_lane, 4)[0])


@pytest.mark.parametrize("escalate", [True, False])
def test_quarantine_and_salvage_matches_jax(escalate):
    def arrays():
        return [np.array([[1.0, 1.0], [np.nan, np.nan], [3.0, 3.0], [4.0, 4.0]]),
                np.array([4, 4, 4, 4])]

    conv = np.array([True, False, True, False])

    def solve_lane(idx, n_iter, relax, tik):
        return (np.array([9.0, 9.0]), np.array(n_iter)), True, True, n_iter

    a1, a2 = arrays(), arrays()
    got = ladder.quarantine_and_salvage(a1, conv, None, solve_lane, 4, escalate=escalate,
                                        iters=a1[1])
    want = jladder.quarantine_and_salvage(a2, conv, None, solve_lane, 4, escalate=escalate,
                                          iters=a2[1])
    assert _records(got[0]) == _records(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for x, y in zip(a1, a2):
        np.testing.assert_array_equal(x, y)
    if escalate:
        np.testing.assert_array_equal(a1[0][1], [9.0, 9.0])
        assert a1[1][1] == 16 and got[1].all()


# ------------------------------------------------------------------ faults


@pytest.mark.parametrize("spec", ["", "nan_chunk:3,kill_after_chunk:5,hang_subprocess",
                                  "nan_chunk", "corrupt_ckpt:2,corrupt_ckpt:4",
                                  "kill_replica:2,stall_replica,refuse_connect:1"])
def test_fault_spec_parsing_matches_jax(monkeypatch, spec):
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", spec)
    assert faults.specs() == jfaults.specs()
    assert faults.active() is jfaults.active()
    assert faults.KINDS == jfaults.KINDS and faults.KILL_EXIT == jfaults.KILL_EXIT == 77
    for name in ("nan_chunk", "kill_after_chunk", "corrupt_ckpt"):
        for k in range(6):
            assert faults.chunk_fault(name, k) is jfaults.chunk_fault(name, k)


@pytest.mark.parametrize("spec,match", [("nan_chunk:xyz", "non-integer"),
                                        ("nan_chunks:1", "unknown fault kind")])
def test_malformed_fault_specs_warn_and_arm_nothing(monkeypatch, spec, match):
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", spec)
    with pytest.warns(UserWarning, match=match):
        assert faults.specs() == {}


def test_fault_consume_counted(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "hang_subprocess:2")
    faults.reset_counts()
    try:
        assert [faults.consume("hang_subprocess") for _ in range(3)] == [True, True, False]
    finally:
        faults.reset_counts()


def test_nan_results_matches_jax():
    res = (np.ones((2, 3)), np.array([7, 9]), np.array([True, True]),
           np.ones(2, dtype=np.float32))
    got, want = faults.nan_results(res), jfaults.nan_results(res)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert np.isnan(faults.nan_results(np.zeros(4))).all()


def test_maybe_corrupt_file_flips_one_byte(tmp_path, monkeypatch):
    p, q = tmp_path / "x.bin", tmp_path / "y.bin"
    p.write_bytes(b"\x00" * 64)
    q.write_bytes(b"\x00" * 64)
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "corrupt_ckpt:2")
    assert not faults.maybe_corrupt_file("corrupt_ckpt", 1, str(p))
    assert faults.maybe_corrupt_file("corrupt_ckpt", 2, str(p))
    assert jfaults.maybe_corrupt_file("corrupt_ckpt", 2, str(q))
    assert p.read_bytes() == q.read_bytes()
    assert sum(b != 0 for b in p.read_bytes()) == 1


# ------------------------------------------------------------------- retry


def test_retry_call_bounded_with_exponential_backoff():
    def run(m):
        sleeps, attempts = [], []

        def fn(attempt):
            attempts.append(attempt)
            raise ValueError(f"boom {attempt}")

        with pytest.raises(m.RetryExhausted) as ei:
            m.retry_call(fn, retries=4, backoff_s=1.0, growth=3.0, max_backoff_s=5.0,
                         sleep=sleeps.append, describe="unit")
        return attempts, sleeps, ei.value.attempts, type(ei.value.last)

    got = run(retry)
    assert got == run(jretry)
    assert got == ([0, 1, 2, 3], [1.0, 3.0, 5.0], 4, ValueError)


def test_retry_call_succeeds_midway_non_matching_propagates_and_deadline():
    seen = []

    def fn(attempt):
        if attempt < 1:
            raise OSError("transient")
        return "ok"

    assert retry.retry_call(fn, retries=3, sleep=lambda s: None,
                            on_retry=lambda a, e: seen.append((a, str(e)))) == "ok"
    assert seen == [(0, "transient")]
    calls = []

    def bug(attempt):
        calls.append(attempt)
        raise KeyError("deterministic bug")

    with pytest.raises(KeyError):
        retry.retry_call(bug, retries=5, retry_on=(OSError,), sleep=lambda s: None)
    assert calls == [0]
    sleeps = []
    with pytest.raises(retry.RetryExhausted) as ei:
        retry.retry_call(lambda a: (_ for _ in ()).throw(ValueError("x")), retries=10,
                         backoff_s=100.0, deadline_s=1.0, sleep=sleeps.append)
    assert sleeps == [] and ei.value.attempts == 1


def test_checked_subprocess_ok_nonzero_and_timeout():
    r = retry.checked_subprocess([sys.executable, "-c", "print('hi')"], timeout_s=60)
    assert r.stdout.strip() == "hi"
    with pytest.raises(retry.SubprocessFailed) as ei:
        retry.checked_subprocess(
            [sys.executable, "-c",
             "import sys; print('tok api_key=SECRET123', file=sys.stderr); sys.exit(3)"],
            timeout_s=60, describe="unit")
    assert ei.value.kind == "nonzero" and ei.value.returncode == 3
    assert "SECRET123" not in ei.value.stderr_tail and "[redacted]" in ei.value.stderr_tail
    with pytest.raises(retry.SubprocessFailed) as ei:
        retry.checked_subprocess([sys.executable, "-c", "import time; time.sleep(60)"],
                                 timeout_s=0.5, describe="unit")
    assert ei.value.kind == "timeout"
    with pytest.raises(retry.SubprocessFailed, match="empty stdout"):
        retry.checked_subprocess([sys.executable, "-c", "pass"], timeout_s=60,
                                 require_stdout=True)


def test_hang_subprocess_fault_forces_timeout(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "hang_subprocess:1")
    faults.reset_counts()
    try:
        with pytest.raises(retry.SubprocessFailed) as ei:
            retry.checked_subprocess([sys.executable, "-c", "print('fast')"], timeout_s=0.5)
        assert ei.value.kind == "timeout"
        r = retry.checked_subprocess([sys.executable, "-c", "print('fast')"], timeout_s=60)
        assert r.stdout.strip() == "fast"
    finally:
        faults.reset_counts()


@pytest.mark.parametrize("text", [
    "error: Authorization: Bearer abc.def.ghi failed\napi_key=sk-livekeyabcdef12345 "
    "token: topsecret\nplain diagnostic stays",
    b"bytes ok", "", "x" * 1000 + " password=hunter2"])
def test_redacted_tail_matches_jax(text):
    for n in (20, 300, 5000):
        assert retry.redacted_tail(text, n) == jretry.redacted_tail(text, n)
    out = retry.redacted_tail(text, 5000)
    for leak in ("abc.def.ghi", "livekey", "topsecret", "hunter2"):
        assert leak not in out


def test_build_timeout_env(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_BUILD_TIMEOUT", raising=False)
    assert retry.build_timeout_s() == jretry.build_timeout_s() == 300.0
    monkeypatch.setenv("RAFT_TPU_BUILD_TIMEOUT", "42.5")
    assert retry.build_timeout_s() == 42.5
    monkeypatch.setenv("RAFT_TPU_BUILD_TIMEOUT", "soon")
    with pytest.warns(UserWarning, match="RAFT_TPU_BUILD_TIMEOUT"):
        assert retry.build_timeout_s() == 300.0


def test_compiler_jobs_time_out_under_the_hang_fault(tmp_path, monkeypatch):
    """A compiler run through ``nvcc.run_jobs`` that hangs (the
    ``hang_subprocess`` fault) fails as a timeout and publishes nothing."""
    from raft_tpu_torch.core import nvcc

    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "hang_subprocess:1")
    faults.reset_counts()
    so = tmp_path / "libx-0.so"
    try:
        with pytest.raises(retry.SubprocessFailed) as ei:
            nvcc.run_jobs([nvcc.Job("hung", (sys.executable, "-c", "pass"), so)], timeout=0.5)
    finally:
        faults.reset_counts()
    assert ei.value.kind == "timeout" and not so.exists()
    assert list(tmp_path.iterdir()) == []


def test_native_build_retries_then_raises(tmp_path, monkeypatch):
    """The g++ build of the host panel solver runs through ``retry_call``
    (two attempts): one hung compiler is retried and the library is
    built; two exhaust the retries and the build raises (it is never
    skipped).  A one-line source stands in for ``native/bem.cpp``."""
    from raft_tpu_torch.hydro import native_bem

    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny() { return 1; }\n')
    so = tmp_path / "libraft_bem_native-test.so"
    monkeypatch.setattr(native_bem, "SRC", src)
    monkeypatch.setattr(native_bem, "lib_path", lambda: so)
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    monkeypatch.setenv("RAFT_TPU_BUILD_TIMEOUT", "3")
    try:
        monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "hang_subprocess:2")
        faults.reset_counts()
        with pytest.raises(RuntimeError, match="after 2 attempt.*timeout"):
            native_bem.build()
        assert not so.exists()
        monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "hang_subprocess:1")
        faults.reset_counts()
        assert native_bem.build() == so and so.exists()
    finally:
        faults.reset_counts()


# -------------------------------------------------------------- checkpoint


def test_ckpt_root_env_and_store_key(monkeypatch, tmp_path):
    monkeypatch.delenv("RAFT_TPU_CKPT", raising=False)
    assert checkpoint.root() is None and not checkpoint.enabled()
    for off in ("off", "0", "none", "false"):
        monkeypatch.setenv("RAFT_TPU_CKPT", off)
        assert checkpoint.root() is None
    monkeypatch.setenv("RAFT_TPU_CKPT", str(tmp_path / "ck"))
    assert checkpoint.root() == str(tmp_path / "ck")
    st = checkpoint.store_for("t", (np.ones(2),), n_chunks=2, device="cpu")
    assert st is not None and st.dir.startswith(str(tmp_path / "ck"))
    monkeypatch.setenv("RAFT_TPU_CKPT", "off")
    assert checkpoint.store_for("t", (np.ones(2),), n_chunks=2, device="cpu") is None


def test_store_key_separates_devices_values_and_knobs():
    """The store key folds in the device type (a CPU store is never served
    on the card), the constants' values, the argument shapes, the knobs
    and the chunk count; equal inputs give equal keys."""
    c = torch.arange(6.0).reshape(2, 3)
    kw = dict(consts=(c, {"relax": 0.8}), extra=("n_iter", 25), n_chunks=4)
    base = checkpoint.store_key("sweep", (torch.ones(4, 3),), device=torch.device("cpu"), **kw)
    assert base == checkpoint.store_key("sweep", (torch.zeros(4, 3),), device="cpu", **kw)
    others = [
        checkpoint.store_key("sweep", (torch.ones(4, 3),), device=torch.device("cuda"), **kw),
        checkpoint.store_key("sweep", (torch.ones(4, 3),), device="cuda:0", **kw),
        checkpoint.store_key("sweep", (torch.ones(5, 3),), device="cpu", **kw),
        checkpoint.store_key("sweep", (torch.ones(4, 3, dtype=torch.float64),), device="cpu",
                             **kw),
        checkpoint.store_key("sweep", (torch.ones(4, 3),), device="cpu",
                             **{**kw, "consts": (c + 1e-12, {"relax": 0.8})}),
        checkpoint.store_key("sweep", (torch.ones(4, 3),), device="cpu",
                             **{**kw, "extra": ("n_iter", 26)}),
        checkpoint.store_key("sweep", (torch.ones(4, 3),), device="cpu",
                             **{**kw, "n_chunks": 5}),
        checkpoint.store_key("other", (torch.ones(4, 3),), device="cpu", **kw),
    ]
    assert len({base, *others}) == len(others)          # all differ but cuda, cuda:0
    assert others[0] == others[1]                     # the device TYPE decides
    assert checkpoint.source_fingerprint() == checkpoint.source_fingerprint()


@pytest.mark.parametrize("seed", [0, 1])
def test_content_hash_matches_jax(seed):
    rng = np.random.default_rng(seed)
    leaves = [rng.normal(size=(3, 4)), rng.integers(0, 9, 5), np.float64(2.5)]
    assert checkpoint.content_hash(leaves) == jckpt.content_hash(leaves)
    assert checkpoint.content_hash([torch.as_tensor(x) for x in leaves[:2]]) == \
        jckpt.content_hash(leaves[:2])


def test_chunk_store_roundtrip_matches_jax(tmp_path):
    tup = (np.arange(6.0).reshape(2, 3), np.array([4, 5]))
    for m, d in ((checkpoint, tmp_path / "port"), (jckpt, tmp_path / "jax")):
        st = m.ChunkStore("k1", 3, str(d))
        st.save(0, tup)
        st.save(1, np.float64(2.5))
    port = json.loads((tmp_path / "port" / "k1" / "manifest.json").read_text())
    assert port == json.loads((tmp_path / "jax" / "k1" / "manifest.json").read_text())
    st = checkpoint.ChunkStore("k1", 3, str(tmp_path / "port"))
    out = st.load(0)
    np.testing.assert_array_equal(out[0], tup[0])
    np.testing.assert_array_equal(out[1], tup[1])
    assert not isinstance(st.load(1), tuple) and float(st.load(1)) == 2.5
    assert st.load(2) is None and not st.complete()
    st.save(2, tup)
    assert st.complete() and checkpoint.ChunkStore("k1", 3, str(tmp_path / "port")).complete()


def test_chunk_store_detects_truncation_and_bitflips(tmp_path):
    st = checkpoint.ChunkStore("k2", 2, str(tmp_path))
    a = np.linspace(0.0, 1.0, 32).reshape(4, 8)
    st.save(0, (a,))
    st.save(1, (a + 1.0,))
    p0 = st._chunk_path(0)
    with open(p0, "r+b") as f:
        f.truncate(os.path.getsize(p0) // 2)
    with pytest.warns(UserWarning, match="unusable"):
        assert st.load(0) is None
    assert st.corrupt == 1 and not os.path.exists(p0) and st.load(0) is None
    p1 = st._chunk_path(1)
    with open(p1, "r+b") as f:
        f.seek(os.path.getsize(p1) - 20)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.warns(UserWarning, match="unusable"):
        assert st.load(1) is None
    assert st.corrupt == 2 and not st.complete()


def test_chunk_store_concurrent_writers_drop_nothing(tmp_path):
    n_chunks, writers = 32, 4
    st = checkpoint.ChunkStore("krace", n_chunks, str(tmp_path))

    def writer(t):
        for k in range(t, n_chunks, writers):
            st.save(k, (np.full(8, float(k)), np.array([k, k + 1])))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=writer, args=(t,)) for t in range(writers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert st.saved == n_chunks and st.complete()
    st2 = checkpoint.ChunkStore("krace", n_chunks, str(tmp_path))
    for k in range(n_chunks):
        np.testing.assert_array_equal(st2.load(k)[0], np.full(8, float(k)))
    assert st2.corrupt == 0 and st2.resumed == n_chunks


def test_chunk_store_ignores_stale_manifest(tmp_path):
    st = checkpoint.ChunkStore("k3", 2, str(tmp_path))
    st.save(0, np.ones(3))
    assert checkpoint.ChunkStore("k3", 4, str(tmp_path)).load(0) is None
    with open(os.path.join(str(tmp_path), "k3", "manifest.json"), "w") as f:
        f.write("{not json")
    assert checkpoint.ChunkStore("k3", 2, str(tmp_path)).load(0) is None


def test_corrupt_ckpt_fault_is_caught_by_hash(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "corrupt_ckpt:0")
    st = checkpoint.ChunkStore("k4", 1, str(tmp_path))
    st.save(0, np.ones(8))
    monkeypatch.delenv("RAFT_TPU_FAULT_INJECT")
    with pytest.warns(UserWarning, match="unusable"):
        assert st.load(0) is None
    assert st.corrupt == 1


# ------------------------------------------------- pipeline + checkpoint


def _run_counting(ckpt, items=4):
    from raft_tpu_torch.parallel import pipeline

    computed = []

    def fn(x):
        computed.append(float(x))
        return x * 2.0

    results, stats = pipeline.run_pipelined(
        fn, [torch.tensor(float(k)) for k in range(items)], depth=2, ckpt=ckpt, device="cpu")
    return [float(np.asarray(r)) for r in results], stats, computed


def test_pipeline_checkpoint_resume_recomputes_only_missing(tmp_path):
    st = checkpoint.ChunkStore("pk", 4, str(tmp_path))
    res1, stats1, computed1 = _run_counting(st)
    assert res1 == [0.0, 2.0, 4.0, 6.0] and len(computed1) == 4
    assert stats1.chunks_computed == 4 and stats1.chunks_checkpointed == 4
    os.unlink(st._chunk_path(2))
    st2 = checkpoint.ChunkStore("pk", 4, str(tmp_path))
    st2._manifest["chunks"].pop("2")
    res2, stats2, computed2 = _run_counting(st2)
    assert res2 == res1 and computed2 == [2.0]
    assert stats2.chunks_resumed == 3 and stats2.chunks_computed == 1
    res3, stats3, computed3 = _run_counting(checkpoint.ChunkStore("pk", 4, str(tmp_path)))
    assert res3 == res1 and computed3 == [] and stats3.chunks_resumed == 4


def test_pipeline_corrupt_chunk_recomputed_in_stream(tmp_path):
    st = checkpoint.ChunkStore("pc", 3, str(tmp_path))
    res1, _, _ = _run_counting(st, items=3)
    p = st._chunk_path(1)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.warns(UserWarning, match="unusable"):
        res2, stats2, computed2 = _run_counting(checkpoint.ChunkStore("pc", 3, str(tmp_path)),
                                                items=3)
    assert res2 == res1 and computed2 == [1.0]
    assert stats2.ckpt_corrupt == 1 and stats2.chunks_resumed == 2


def test_pipeline_nan_chunk_injection(monkeypatch):
    from raft_tpu_torch.parallel import pipeline

    monkeypatch.setenv("RAFT_TPU_FAULT_INJECT", "nan_chunk:1")
    results, stats = pipeline.run_pipelined(
        lambda x: (x + 1.0, (x > -1).to(torch.int32)),
        [torch.full((2,), float(k)) for k in range(3)], depth=2, device="cpu")
    assert stats.faults_injected == 1
    np.testing.assert_array_equal(results[0][0], [1.0, 1.0])
    assert np.isnan(results[1][0]).all()
    np.testing.assert_array_equal(results[1][1], [1, 1])      # counts untouched
    np.testing.assert_array_equal(results[2][0], [3.0, 3.0])
