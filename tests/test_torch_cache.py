"""The port's warm-start subsystem (``raft_tpu_torch/cache``) against the
JAX package's ``raft_tpu.cache``, on the CPU.

The cache root resolves as the JAX package's does for every spelling; the
staging cache round-trips arrays bit for bit (complex included), treats a
corrupt artifact as a miss and an error and replaces it, and moves with
the port's source fingerprint; ``load_wamit_coeffs`` agrees with the JAX
package's to 1e-12 with the cache on and off and re-keys when either file
changes; ``sweep_sea_states`` with the cache on equals the cache off bit
for bit, stages nothing, and equals the JAX package at 1e-12.  The kernel-library registry, with a
compiler stand-in that writes empty files: one build under 8 contending threads, a
failed leader handed over to a waiter, a library that does not open
rebuilt once (and raising after), ``evict_memory``, a bounded event ring
with exact counts.  Then the two-process smoke, ``python -m
raft_tpu_torch.cache smoke --device cpu``.
"""
import json
import os
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.cache import config as jconfig
from raft_tpu.hydro.bem_io import load_wamit_coeffs as jax_load_wamit_coeffs
from raft_tpu.parallel.sweep import make_wave_states as jax_make_wave_states
from raft_tpu.parallel.sweep import sweep_sea_states as jax_sweep_sea_states

from raft_tpu_torch import cache
from raft_tpu_torch.cache import aot, config, staging, stats
from raft_tpu_torch.core import nvcc
from raft_tpu_torch.hydro.bem_io import load_wamit_coeffs
from raft_tpu_torch.obs import ledger
from raft_tpu_torch.parallel.sweep import make_wave_states, sweep_sea_states
from raft_tpu_torch.resilience import retry

from test_bem_io import synth_wamit
from test_torch_dynamics import _stage

ROOT = Path(__file__).resolve().parents[1]
OFF = ("off", "OFF", "0", "none", "disabled", "Disabled", "false", "no")


@pytest.fixture
def warm(tmp_path):
    """The cache on at a fresh root; off and counters cleared after."""
    root = cache.enable(str(tmp_path / "cache"))
    stats.reset()
    yield root
    cache.disable()
    stats.reset()


# ------------------------------------------------------------- enablement

@pytest.mark.parametrize("spelling", [*OFF, "/some/where", "~/rel/../x", "  /pad/ded  "])
def test_resolve_dir_matches_jax(spelling, monkeypatch):
    monkeypatch.setenv(config.CACHE_ENV, spelling)
    monkeypatch.setenv("RAFT_TPU_CACHE_DIR", spelling)
    assert config.resolve_dir() == jconfig.resolve_dir()
    assert config.resolve_dir(spelling.strip()) == jconfig.resolve_dir(spelling.strip())
    # the explicit argument wins over the env
    assert config.resolve_dir("/else/where") == jconfig.resolve_dir("/else/where")


def test_empty_knob_means_the_default(monkeypatch):
    monkeypatch.setenv(config.CACHE_ENV, "  ")
    monkeypatch.setenv("RAFT_TPU_CACHE_DIR", "  ")
    assert config.resolve_dir() == os.path.abspath(config.default_dir())
    assert jconfig.resolve_dir() == os.path.abspath(jconfig.default_dir())
    assert config.default_dir() == str(ROOT / "raft_tpu_torch" / "_build" / "cache")


def test_enable_off_arms_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(config.CACHE_ENV, "off")
    cache.enable(str(tmp_path / "c"))            # an earlier root is forgotten
    assert cache.enable() is None
    assert not cache.is_enabled() and cache.cache_dir() is None
    assert not ledger.armed() and ledger.root() is None and ledger.flush() == []
    calls = []
    out = staging.cached_arrays("t", ("k",), lambda: (calls.append(1) or np.ones(2),))
    assert calls == [1] and out[0].tolist() == [1.0, 1.0]
    assert not (tmp_path / "c" / "staging").exists()
    # the layers with their own flags stay at the default root
    assert config.cache_root() == Path(config.default_dir())
    with pytest.raises(config.CacheDisabledError):
        config.subdir("staging")


def test_cache_root_follows_the_knob(monkeypatch, tmp_path):
    from raft_tpu_torch.hydro import native_bem, wavetable
    from raft_tpu_torch.obs import export
    from raft_tpu_torch.resilience import checkpoint

    monkeypatch.setenv(config.CACHE_ENV, str(tmp_path / "r"))
    monkeypatch.setenv("RAFT_TPU_OBS", "1")
    monkeypatch.setenv("RAFT_TPU_CKPT", "1")
    root = tmp_path / "r"
    assert wavetable.cache_dir() == root / "wavetable"
    assert export.root() == str(root / "obs") and checkpoint.root() == str(root / "ckpt")
    key = native_bem.result_cache_key("torch-bem", np.zeros((1, 4, 3)), np.ones(2), [0.0], [1.0])
    assert key.parent == root / "torch-bem"
    with cache_at(tmp_path / "e"):               # the enabled root wins
        assert wavetable.cache_dir() == tmp_path / "e" / "wavetable"


class cache_at:
    def __init__(self, root):
        self.root = str(root)

    def __enter__(self):
        return cache.enable(self.root)

    def __exit__(self, *exc):
        cache.disable()


# ---------------------------------------------------------------- staging

def test_staging_roundtrip_hit_and_key(warm):
    calls = []

    def compute():
        calls.append(1)
        return (np.arange(6.0), np.ones((2, 3)) * (1 + 2j), np.arange(4, dtype=np.int32))

    parts = ("tag", np.arange(4.0), 2.5, 7, None)
    first = staging.cached_arrays("t", parts, compute)
    second = staging.cached_arrays("t", parts, compute)       # disk hit
    assert len(calls) == 1
    for a, b in zip(first, second):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert second[1].dtype == np.complex128
    rep = stats.report()
    assert rep["enabled"] and rep["dir"] == warm
    assert rep["staging"]["disk_hits"] == 1 and rep["staging"]["misses"] == 1
    staging.cached_arrays("t", ("tag", np.arange(4.0), 2.5, 8, None), compute)
    assert len(calls) == 2
    assert staging.staging_key("t", *parts) != staging.staging_key(
        "t", "tag", np.arange(4.0), 2.5, 8, None)


def test_staging_corruption_is_a_miss_and_replaced(warm):
    from raft_tpu_torch.obs import metrics

    calls = []

    def compute():
        calls.append(1)
        return (np.full(3, 7.0) + 1j,)

    (out,) = staging.cached_arrays("c", ("k",), compute)
    d = os.path.join(warm, "staging")
    (art,) = [f for f in os.listdir(d) if f.startswith("c-")]
    with open(os.path.join(d, art), "wb") as f:
        f.write(b"truncated garbage")
    errors0 = metrics.snapshot()["counters"].get("cache.staging.error", 0)
    (out2,) = staging.cached_arrays("c", ("k",), compute)      # recomputed
    assert len(calls) == 2 and out2.tobytes() == out.tobytes()
    rep = stats.report()["staging"]
    assert rep["errors"] == 1 and rep["misses"] == 2
    assert metrics.snapshot()["counters"]["cache.staging.error"] == errors0 + 1
    (out3,) = staging.cached_arrays("c", ("k",), compute)      # replaced: a hit again
    assert len(calls) == 2 and out3.tobytes() == out.tobytes()


def test_code_fingerprint_moves_the_keys(warm, monkeypatch):
    """An edit under raft_tpu_torch/ moves every staging key and chunk
    store: a developer iterating on the code is never served pre-edit
    arrays."""
    from raft_tpu_torch.resilience import checkpoint

    fp = config.code_fingerprint()
    assert len(fp) == 16 and fp == config.code_fingerprint()
    k_stage = staging.staging_key("t", np.arange(3.0))
    k_store = checkpoint.store_key("t", (torch.ones(2),), n_chunks=2, device="cpu")
    monkeypatch.setattr(config, "_code_salt", ["deadbeefdeadbeef"])
    assert staging.staging_key("t", np.arange(3.0)) != k_stage
    assert checkpoint.store_key("t", (torch.ones(2),), n_chunks=2, device="cpu") != k_store


@pytest.mark.parametrize("on", [True, False])
def test_load_wamit_coeffs_matches_jax_and_rekeys(tmp_path, on):
    w, A, B, Xre, Xim, p1, p3 = synth_wamit(tmp_path)
    grid = np.linspace(0.25, 0.95, 8)
    want = jax_load_wamit_coeffs(p1, p3, grid)
    try:
        if on:
            cache.enable(str(tmp_path / "cache"))
        stats.reset()
        first = load_wamit_coeffs(p1, p3, grid)
        again = load_wamit_coeffs(p1, p3, grid)
        for got, ref in zip(first, want):
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
        for a, b in zip(first, again):
            assert a.tobytes() == b.tobytes()
        if on:
            assert stats.report()["staging"]["disk_hits"] == 1
        txt = open(p1).read().splitlines()
        with open(p1, "w") as f:
            for ln in txt:
                c = ln.split()
                f.write(f"{c[0]} {c[1]} {c[2]} {float(c[3]) * 2:.12E} {c[4]}\n")
        A3, B3, F3 = load_wamit_coeffs(p1, p3, grid)
        np.testing.assert_allclose(A3, 2 * first[0], rtol=1e-9)
        assert B3.tobytes() == first[1].tobytes()
        if on:
            assert stats.report()["staging"]["misses"] == 2
    finally:
        cache.disable()
        stats.reset()


def test_sweep_sea_states_cache_on_equals_off_and_jax(tmp_path):
    (jm, jrna, jenv, _jw, C), (tm, trna, tenv, _tw, tC) = _stage("OC3spar", 24)
    w = np.linspace(0.05, 2.95, 24)
    rows = [[4.0, 8.0, 0.0], [6.0, 10.0, 0.4], [8.0, 12.0, 0.8], [10.0, 14.0, 1.2]]
    rng = np.random.default_rng(5)
    A = np.tile(np.eye(6)[:, :, None] * 4e6, (1, 1, 24))
    B = np.tile(np.eye(6)[:, :, None] * 2e5, (1, 1, 24))
    F_all = (rng.normal(size=(4, 6, 24)) + 1j * rng.normal(size=(4, 6, 24))) * 2e5
    bem = (np.linspace(0.0, 1.5, 4), F_all, A, B)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        def run():
            return sweep_sea_states(tm, trna, tenv, make_wave_states(w, rows, 320.0,
                                                                     device="cpu"),
                                    tC, bem=bem, device="cpu")

        off = run()
        cache.enable(str(tmp_path / "cache"))
        stats.reset()
        cold, warm_ = run(), run()
        rep = stats.report()
    finally:
        cache.disable()
        stats.reset()
        torch.set_num_threads(n)
    # the heading rows are computed each time: the sweep stages nothing
    assert "staging" not in rep and rep["enabled"]
    for key in ("std dev", "nacelle accel std dev", "Xi_abs2", "iterations"):
        assert off[key].tobytes() == cold[key].tobytes() == warm_[key].tobytes()
    want = jax_sweep_sea_states(jm, jrna, jenv, jax_make_wave_states(w, rows, 320.0), C,
                                bem=bem)
    np.testing.assert_array_equal(off["iterations"], want["iterations"])
    for key in ("std dev", "nacelle accel std dev", "Xi_abs2"):
        ref = np.asarray(want[key])
        assert np.abs(off[key] - ref).max() <= 1e-12 * np.abs(ref).max()


# --------------------------------------------------------------- registry

class _Lib:
    """A stand-in library: its file under ``root``, opened by ``opener``."""

    retries = 1

    def __init__(self, tag, root, opener=None, key="k0"):
        self.tag, self.root, self._key = tag, Path(root), key
        self.opener = opener or (lambda path: ("handle", self.tag, str(path)))

    def key(self):
        return self._key

    def path(self, key=None):
        return self.root / f"lib{self.tag}-{key or self._key}.so"

    def job(self, path):
        return nvcc.Job(self.tag, ("true",), Path(path))

    def open(self, path):
        return self.opener(path)


@pytest.fixture
def registry(monkeypatch):
    """A registry of its own and a compiler stand-in that writes empty files
    (slowly, so contending threads overlap), counting its runs."""
    for name, value in (("_mem", {}), ("_inflight", {}), ("_fresh", set()),
                        ("_compile_counts", aot.Counter()), ("_open_counts", aot.Counter()),
                        ("_compile_events", deque(maxlen=aot._COMPILE_EVENTS_MAX))):
        monkeypatch.setattr(aot, name, value)
    runs = []

    def build(jobs, timeout=None):
        runs.append([j.what for j in jobs])
        time.sleep(0.05)
        for job in jobs:
            job.so.write_bytes(b"")

    monkeypatch.setattr(aot, "_compile", build)
    stats.reset()
    yield runs
    stats.reset()


def _race(fn, n=8):
    barrier = threading.Barrier(n)
    out, errs = [None] * n, [None] * n

    def run(i):
        barrier.wait()
        try:
            out[i] = fn()
        except Exception as e:           # recorded for the assertions
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    return out, errs


def test_registry_one_build_under_contention(registry, tmp_path):
    lib = _Lib("toy", tmp_path)
    other = _Lib("pal", tmp_path)
    out, errs = _race(lambda: aot.library(lib, (lib, other)))
    assert errs == [None] * 8 and len({id(x) for x in out}) == 1
    assert registry == [["toy", "pal"]]            # one run, the batch built together
    assert aot.compile_counts() == {"toy": 1, "pal": 1}
    rep = stats.report()["kernels"]
    assert rep["misses"] == 2 and rep["mem_hits"] == 7 and rep["disk_hits"] == 0
    assert aot.library(other)[1] == "pal"          # built, now opened: no disk hit
    assert stats.report()["kernels"]["disk_hits"] == 0
    side = json.loads(lib.path().with_suffix(".json").read_text())
    assert side["tag"] == "toy" and side["build_s"] > 0


def test_registry_failed_leader_hands_over(registry, tmp_path, monkeypatch):
    lib = _Lib("flaky", tmp_path)
    ok_compile = aot._compile
    failures = []

    def build(jobs, timeout=None):
        if not failures:
            failures.append(1)
            time.sleep(0.05)
            raise retry.SubprocessFailed("build", "nonzero", detail="boom")
        ok_compile(jobs, timeout)

    monkeypatch.setattr(aot, "_compile", build)
    out, errs = _race(lambda: aot.library(lib))
    failed = [e for e in errs if e is not None]
    assert len(failed) == 1 and "after 1 attempt" in str(failed[0]) and "boom" in str(failed[0])
    assert sum(x is not None for x in out) == 7
    assert aot.compile_count("flaky") == 1 and registry == [["flaky"]]


def test_registry_rebuilds_a_library_that_does_not_open_once(registry, tmp_path):
    opens = []

    def opener(path):
        opens.append(path)
        if len(opens) == 1:
            raise OSError("invalid ELF header")
        return "good"

    lib = _Lib("torn", tmp_path, opener)
    lib.path().write_bytes(b"garbage")              # a torn file on disk
    assert aot.library(lib) == "good"
    rep = stats.report()["kernels"]
    assert rep["errors"] == 1 and rep["misses"] == 1 and aot.compile_count("torn") == 1
    assert len(opens) == 2

    bad = _Lib("bad", tmp_path, lambda path: (_ for _ in ()).throw(OSError("no")))
    with pytest.raises(RuntimeError, match="does not open after a rebuild"):
        aot.library(bad)
    assert aot.compile_count("bad") == 2 and not bad.path().exists()


def test_registry_evict_memory_reopens_from_disk(registry, tmp_path):
    a, b = _Lib("a", tmp_path), _Lib("b", tmp_path)
    held = aot.library(a)
    aot.library(b)
    assert aot.evict_memory("a") == 1 and aot.evict_memory("a") == 0
    again = aot.library(a)                          # re-resolved: a disk hit
    assert again == held and aot.compile_counts() == {"a": 1, "b": 1}
    rep = stats.report()["kernels"]
    assert rep["disk_hits"] == 1 and aot.open_counts() == {"a": 2, "b": 1}
    assert aot.evict_memory() == 2
    # a changed source (a new key) is built anew after an eviction
    a2 = _Lib("a", tmp_path, key="k1")
    aot.library(a2)
    assert aot.compile_counts() == {"a": 2, "b": 1}


def test_registry_event_ring_bounded_counts_exact(registry, monkeypatch):
    monkeypatch.setattr(aot, "_compile_events", deque(maxlen=4))
    for i in range(10):
        aot._record_compile("x" if i % 2 else "y")
    assert len(aot.compile_events()) == 4 and aot.compile_count() == 10
    assert aot.compile_counts() == {"x": 5, "y": 5} and aot.compile_count("x") == 5
    assert aot.compile_events("x") == ["x", "x"]
    assert nvcc.build_counts()["x"] == {"compiled": 5, "loaded": 0}
    aot.reset_compile_events()
    assert aot.compile_count() == 0 and aot.compile_events() == []


def test_registry_counts_exact_under_threads(registry):
    def hammer():
        for _ in range(200):
            aot._record_compile("t")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _race(hammer, n=16)
    finally:
        sys.setswitchinterval(switch)
    assert aot.compile_count("t") == 3200


# ------------------------------------------------------- processes, imports

def test_cache_modules_import_nothing_of_jax():
    code = (
        "import sys\n"
        "import raft_tpu_torch.cache, raft_tpu_torch.cache.__main__\n"
        "import raft_tpu_torch.obs.ledger, raft_tpu_torch.utils.profiling\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'raft_tpu'))\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout


def test_cache_smoke_two_processes(tmp_path):
    """The second process finds the staged arrays (disk hits, no miss,
    seconds saved), neither process builds a library (the parent built
    them), and both give the same bits."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.cache", "smoke", "--device",
                           "cpu", "--dir", str(tmp_path / "smoke")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["device"] == "cpu"
    assert out["warm_staging"]["disk_hits"] >= 2 and out["warm_staging"]["misses"] == 0
    assert out["warm_staging"]["saved_s"] > 0 and out["cold_staging"]["misses"] >= 2
    assert out["zero_compiles_both_children"] and out["outputs_bit_identical"]
    assert out["warm_kernels"]["disk_hits"] >= 1
    # without CUDA the default device refuses
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.cache", "smoke"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "CUDA" in proc.stderr and '"ok"' not in proc.stdout
