"""The profile's reduction on a synthetic profile: the idle share, the
launches and host syncs per call, the idle gaps named by the host's
activity, the device operations, and the readers built on them."""
from __future__ import annotations

import pytest

from benchmark.harness.profile import CALL, SYNC, Event, Profile
from benchmark.harness import profile
from benchmark.layer_metrics import (device_idle, k1_roofline, launches_per_call,
                                     syncs_per_call)

MS = 1_000_000


def synthetic() -> Profile:
    """Two calls of 10 ms each; kernels busy 2 + 3 ms in the first, 1 ms in
    the second (two of them overlapping); one stream sync and one blocking
    copy inside the calls, one sync of the harness's own."""
    host = [Event(CALL, "user_annotation", 0, 10 * MS),
            Event(CALL, "user_annotation", 10 * MS, 20 * MS),
            Event("aten::mul", "cpu_op", 5 * MS, 8 * MS),
            Event(SYNC, "user_annotation", 19 * MS, 20 * MS)]
    device = [Event("solve6_kernel<float, true, false>", "kernel", 1 * MS, 3 * MS),
              Event("elementwise", "kernel", 2 * MS, 3 * MS),
              Event("Memcpy DtoH", "gpu_memcpy", 8 * MS, 11 * MS),
              Event("solve6_kernel<float, true, false>", "kernel", 12 * MS, 13 * MS)]
    runtime = [Event("cudaStreamSynchronize", "cuda_runtime", 9 * MS, 9 * MS + 10),
               Event("cudaMemcpy", "cuda_runtime", 14 * MS, 14 * MS + 10),
               Event("cudaDeviceSynchronize", "cuda_runtime", 19 * MS + 5, 20 * MS),
               Event("cudaLaunchKernel", "cuda_runtime", 15 * MS, 15 * MS + 10)]
    return Profile(device=device, runtime=runtime, host=host)


def test_busy_idle_and_window():
    p = synthetic()
    assert p.window == (0, 20 * MS)
    assert profile.busy_s(p) == pytest.approx(6e-3)
    assert device_idle.read({"profile": p}, "sweep") == pytest.approx(0.7)


def test_per_call_counts():
    p = synthetic()
    ctx = {"profile": p, "n_calls": 2}
    assert launches_per_call.read(ctx, "sweep") == 1.5
    assert profile.host_syncs(p) == 2
    assert syncs_per_call.read(ctx, "sweep") == 1.0


def test_idle_gaps_and_device_ops():
    p = synthetic()
    gaps = dict(profile.idle_gaps(p))
    assert gaps["aten::mul"] == pytest.approx(5e-3)        # 3 .. 8 ms
    assert sum(gaps.values()) == pytest.approx(14e-3)
    ops = profile.device_ops(p)
    assert ops[0] == ["solve6_kernel<float, true, false>", pytest.approx(3e-3)]


def test_k1_roofline_reader():
    p = synthetic()
    ctx = {"profile": p, "n_calls": 2, "device_kind": "NVIDIA H100 80GB HBM3",
           "counters": {"k1": {"lanes_per_launch": 250, "nw": 200, "dtype": "float32"}}}
    # two launches of 0.00574 ms bound in 3 ms of kernel time
    assert k1_roofline.read(ctx, "sweep") == pytest.approx(100 * 2 * 0.005741e-3 / 3e-3,
                                                           rel=1e-3)
    assert k1_roofline.read({**ctx, "device_kind": "cpu"}, "sweep") is None


def test_from_profiler_reads_the_chrome_trace():
    """A profiler's events come from its exported Chrome trace
    (microseconds, categories as kinds, instant events ignored)."""
    import json

    class Prof:
        @staticmethod
        def export_chrome_trace(path):
            ev = [{"ph": "X", "cat": "user_annotation", "name": CALL, "ts": 0.0, "dur": 10.0},
                  {"ph": "X", "cat": "kernel", "name": "k", "ts": 2.0, "dur": 3.5},
                  {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
                   "ts": 6.0, "dur": 1.0},
                  {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0}]
            with open(path, "w") as f:
                json.dump({"traceEvents": ev}, f)

    p = profile.from_profiler(Prof())
    assert p.window == (0, 10_000)
    assert profile.busy_s(p) == pytest.approx(3.5e-6)
    assert profile.host_syncs(p) == 1
