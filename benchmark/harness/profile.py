"""What a traced run reads from ``torch.profiler``: the device's kernels,
copies and sets, the host's operations, runtime calls and ranges, and the
harness's own ranges around each call (``bench/call``) and its own
synchronisations (``bench/sync``).  The per-layer readers and the
``breakdown`` take their numbers from a :class:`Profile`; a synthetic one
is built from :class:`Event` lists alone."""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field

CALL = "bench/call"
SYNC = "bench/sync"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
HOST_KINDS = ("cpu_op", "user_annotation")
#: host calls that wait for the device: synchronisations and blocking copies
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
              "cuMemcpyDtoH_v2", "cuMemcpyDtoH")


@dataclass(frozen=True)
class Event:
    name: str
    kind: str
    start: int          # ns
    end: int            # ns


@dataclass
class Profile:
    device: list = field(default_factory=list)
    runtime: list = field(default_factory=list)
    host: list = field(default_factory=list)

    def ranges(self, name: str) -> list:
        return sorted((e.start, e.end) for e in self.host
                      if e.kind == "user_annotation" and e.name == name)

    @property
    def calls(self) -> list:
        return self.ranges(CALL)

    @property
    def window(self) -> tuple:
        calls = self.calls
        return calls[0][0], calls[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) * 1e-9


def _add(out: Profile, ev: Event) -> None:
    if ev.kind in DEVICE_KINDS:
        out.device.append(ev)
    elif ev.kind in RUNTIME_KINDS:
        out.runtime.append(ev)
    elif ev.kind in HOST_KINDS:
        out.host.append(ev)


def from_profiler(prof) -> Profile:
    """The events of a finished ``torch.profiler.profile``, from its exported
    Chrome trace (written under the temporary directory, then deleted;
    times in microseconds, categories as kinds)."""
    import json
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    out = Profile()
    for e in trace.get("traceEvents", []):
        if isinstance(e, dict) and e.get("ph") == "X" and "dur" in e:
            start = int(round(float(e["ts"]) * 1e3))
            _add(out, Event(e.get("name", ""), e.get("cat", ""), start,
                            start + int(round(float(e["dur"]) * 1e3))))
    return out


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(p: Profile) -> float:
    """Seconds of the window in which a kernel, copy or set ran."""
    lo, hi = p.window
    return 1e-9 * sum(min(e, hi) - max(s, lo) for s, e in _merged(
        (ev.start, ev.end) for ev in p.device) if e > lo and s < hi)


def kernels(p: Profile, *parts: str) -> list:
    """The kernels whose name holds every one of ``parts``."""
    return [e for e in p.device if e.kind == "kernel" and all(x in e.name for x in parts)]


def device_s(events) -> float:
    return 1e-9 * sum(e.end - e.start for e in events)


def device_ops(p: Profile, top: int = 10) -> list:
    """The device operations that took most time, summed by name."""
    tot = defaultdict(int)
    for e in p.device:
        tot[e.name] += e.end - e.start
    return [[name, ns * 1e-9] for name, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(p: Profile, top: int = 10) -> list:
    """The window's idle time on the device, summed by what the host was
    doing at the middle of each gap (the latest-starting host operation,
    runtime call or range that covers it), largest first."""
    lo, hi = p.window
    gaps, cursor = [], lo
    for s, e in _merged((ev.start, ev.end) for ev in p.device if ev.end > lo and ev.start < hi):
        if s > cursor:
            gaps.append(((cursor + s) // 2, s - cursor))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append(((cursor + hi) // 2, hi - cursor))
    host = sorted((e for e in p.host + p.runtime if e.name != CALL), key=lambda e: e.start)
    heap, j = [], 0
    tot = defaultdict(int)
    for mid, dur in gaps:                       # in time order
        while j < len(host) and host[j].start <= mid:
            heapq.heappush(heap, (-host[j].start, j))
            j += 1
        while heap and host[heap[0][1]].end <= mid:
            heapq.heappop(heap)                 # ended before this gap and every later one
        tot[host[heap[0][1]].name if heap else "host between operations"] += dur
    return [[name, ns * 1e-9] for name, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def host_syncs(p: Profile) -> int:
    """Host calls that waited for the device inside the calls, outside the
    harness's own synchronisations."""
    own = p.ranges(SYNC)
    calls = p.calls

    def inside(t, spans):
        return any(a <= t <= b for a, b in spans)

    return sum(1 for e in p.runtime if e.name in SYNC_CALLS and inside(e.start, calls)
               and not inside(e.start, own))
