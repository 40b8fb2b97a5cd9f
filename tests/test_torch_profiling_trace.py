"""``raft_tpu_torch.utils.profiling.torch_trace`` (the counterpart of the
JAX package's ``xla_trace``) on the CPU: it writes a Chrome trace into its
directory that holds the range of a ``phase(jax_trace=True)`` and the ops
run inside it; a phase without the flag leaves no range, and both feed the
span roll-up."""
import json

import torch

from raft_tpu_torch import utils
from raft_tpu_torch.utils import profiling


def test_torch_trace_holds_the_phase_range(tmp_path):
    profiling.reset()
    log_dir = tmp_path / "trace"
    with utils.torch_trace(str(log_dir)) as path:
        with utils.phase("traced_phase", jax_trace=True):
            x = torch.ones(64, 64)
            (x @ x).sum()
        with utils.phase("untraced_phase"):
            torch.zeros(8).add_(1)
    assert [p.name for p in log_dir.iterdir()] == [path.rsplit("/", 1)[-1]]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "traced_phase" in names and "untraced_phase" not in names
    rng = next(e for e in events if e.get("name") == "traced_phase")
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(rng["ts"] <= e["ts"] <= rng["ts"] + rng["dur"] for e in mm)
    assert {"traced_phase", "untraced_phase"} <= set(profiling.totals())
    profiling.reset()


def test_the_utils_package_exports_the_jax_names():
    assert utils.phase is profiling.phase and utils.torch_trace is profiling.torch_trace
    assert utils.summary is profiling.summary and utils.reset is profiling.reset
    assert "xla_trace" in profiling.torch_trace.__doc__
