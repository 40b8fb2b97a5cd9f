"""Kernel libraries load once per process: the serving daemon's warm-up
and its solver loop may reach a wrapper's first call together, and each
library must then be built and opened once (``kernel_builds`` counts
them)."""
import threading
import time

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
    return out


def _slow_counter(calls: list, result):
    def load(*args, **kwargs):
        calls.append(args[0] if args else None)
        time.sleep(0.05)          # wide enough for every thread to arrive
        return result

    return load


def test_cuda6_library_loads_once(monkeypatch):
    calls: list = []
    lib = _FakeLib()
    monkeypatch.setattr(cuda6, "_lib", None)
    monkeypatch.setattr(nvcc, "load", _slow_counter(calls, lib))
    out = _race(cuda6.build)
    assert calls == [cuda6.SPEC]
    assert all(x is lib for x in out)


def test_cuda_bem_libraries_load_once(monkeypatch):
    calls: list = []
    monkeypatch.setattr(cuda_bem, "_libs", {})
    monkeypatch.setattr(nvcc, "compile_all", lambda specs: None)
    monkeypatch.setattr(nvcc, "load", _slow_counter(calls, _FakeLib()))
    out = _race(cuda_bem.build)
    assert calls == [cuda_bem.RANKINE, cuda_bem.WAVE]
    assert all(x is out[0] for x in out) and set(out[0]) == {"rankine", "wave"}


def test_native_library_opens_once(monkeypatch, tmp_path):
    calls: list = []
    lib = _FakeLib()
    so = tmp_path / "libfake-0.so"
    monkeypatch.setattr(native_bem, "_lib", None)
    monkeypatch.setattr(native_bem, "build", lambda: so)
    monkeypatch.setattr(native_bem.ctypes, "CDLL", _slow_counter(calls, lib))
    monkeypatch.setattr(nvcc, "note", lambda path, event: None)
    out = _race(native_bem._load)
    assert calls == [str(so)]
    assert all(x is lib for x in out)
