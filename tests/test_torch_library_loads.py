"""Kernel libraries load once per process: the serving daemon's warm-up
and its solver loop may reach a wrapper's first call together, and each
library must then be built and opened once.  Every library resolves
through the kernel-library registry (``raft_tpu_torch/cache/aot.py``),
whose build counts are the daemon's ``compiles``; here a compiler stand-in writes
empty files and the libraries' ``open`` returns fakes."""
import threading
import time

import pytest

from raft_tpu_torch.cache import aot
from raft_tpu_torch.core import cuda6, cuda_bem, nvcc
from raft_tpu_torch.hydro import native_bem


class _FakeFn:
    def __init__(self):
        self.argtypes = self.restype = None

    def __call__(self, *args):
        return 0


class _FakeLib:
    """A library whose every entry is a callable that accepts argtypes."""

    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def registry(monkeypatch, tmp_path):
    """A registry of its own (memo, flights, counts), libraries under
    ``tmp_path`` and a compiler stand-in that writes empty files."""
    for name, value in (("_mem", {}), ("_inflight", {}), ("_fresh", set()),
                        ("_compile_counts", aot.Counter()), ("_open_counts", aot.Counter())):
        monkeypatch.setattr(aot, name, value)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc.Spec, "key", lambda self: f"k{self.name}")
    monkeypatch.setattr(nvcc, "_nvcc", lambda: "nvcc")

    def build(jobs, timeout=None):
        for job in jobs:
            job.so.write_bytes(b"")

    monkeypatch.setattr(aot, "_compile", build)


def _race(fn, n: int = 8) -> list:
    start = threading.Barrier(n)
    out = [None] * n

    def run(i):
        start.wait()
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    return out


def _slow_counter(calls: list, result):
    def load(*args, **kwargs):
        calls.append(args[0] if args else None)
        time.sleep(0.05)          # wide enough for every thread to arrive
        return result

    return load


def test_cuda6_library_loads_once(monkeypatch, registry):
    calls: list = []
    lib = _FakeLib()
    monkeypatch.setattr(nvcc.Spec, "open", _slow_counter(calls, lib))
    out = _race(cuda6.build)
    assert calls == [cuda6.SPEC]
    assert all(x is lib for x in out)
    assert aot.compile_counts() == {"solve6": 1} and aot.open_counts() == {"solve6": 1}


def test_cuda_bem_libraries_load_once(monkeypatch, registry):
    calls: list = []
    monkeypatch.setattr(nvcc.Spec, "open", _slow_counter(calls, _FakeLib()))
    out = _race(cuda_bem.build)
    assert calls == [cuda_bem.RANKINE, cuda_bem.WAVE]
    assert all(x == out[0] for x in out) and set(out[0]) == {"rankine", "wave"}
    # the first build compiled both libraries in one run
    assert aot.compile_counts() == {"bem_rankine": 1, "bem_wave": 1}


def test_native_library_opens_once(monkeypatch, registry, tmp_path):
    calls: list = []
    lib = _FakeLib()
    so = tmp_path / "libfake-0.so"
    so.write_bytes(b"")
    monkeypatch.setattr(native_bem, "lib_path", lambda: so)
    monkeypatch.setattr(native_bem, "lib_key", lambda: "fake")
    monkeypatch.setattr(native_bem.ctypes, "CDLL", _slow_counter(calls, lib))
    monkeypatch.setattr(native_bem, "table_path", lambda: tmp_path / "table.bin")
    out = _race(native_bem._load)
    assert calls == [str(so)]
    assert all(x is lib for x in out)
    assert aot.compile_count() == 0 and aot.open_counts() == {"raft_bem_native": 1}
