"""The SPMD smoke and the CPU worlds it stands on.

``python -m raft_tpu_torch.parallel.spmd_smoke --device cpu`` (2 Gloo
ranks, 8 OC3spar lanes of ``sweep_designs(mesh=)`` against the unsharded
oracle at 1e-9, rank-salted export logs, no torn file under the shared
cache root) exits 0; about 15 s on this CPU.  ``parallel.spmd.cpu_world``
kills the whole world and names the rank when one rank fails, and kills it
at its deadline when a rank hangs, leaving no process behind.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from raft_tpu_torch.parallel import spmd_smoke
from raft_tpu_torch.parallel.spmd import cpu_world

ROOT = Path(__file__).resolve().parents[1]


def _fails(rank, mesh):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one gives up")
    dist.barrier()                    # waits for rank 1, which never comes
    return rank


def _hangs(rank, mesh):
    time.sleep(600)


def _layout(rank, mesh):
    return rank, tuple(mesh.mesh_dim_names), tuple(mesh.shape), list(mesh.get_coordinate())


def test_spmd_smoke_cpu():
    env = {k: v for k, v in os.environ.items() if k != "RAFT_TPU_OBS"}
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.parallel.spmd_smoke",
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=2 * spmd_smoke.WORLD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("[spmd-smoke] ok — 2 ranks (cpu), 8 lanes"), line
    assert "2 rank-salted export logs, no torn files" in line
    assert time.perf_counter() - t0 < 120


def test_spmd_smoke_refuses_a_world_that_splits_no_lanes():
    with pytest.raises(SystemExit):
        spmd_smoke.main(["--device", "cpu", "--world", "3"])


def test_cpu_world_lays_out_the_mesh():
    got = cpu_world(4, _layout, axis_names=("designs", "freq"), shape=(2, 2), timeout=120.0)
    assert [g[0] for g in got] == [0, 1, 2, 3]
    assert all(g[1] == ("designs", "freq") and g[2] == (2, 2) for g in got)
    assert [g[3] for g in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_cpu_world_kills_the_world_when_a_rank_fails():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:(.|\n)*rank one gives up"):
        cpu_world(2, _fails, timeout=120.0)
    assert time.perf_counter() - t0 < 60
    assert not [p for p in __import__("multiprocessing").active_children()]


def test_cpu_world_kills_a_hung_world_at_its_deadline():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="2 of 2 ranks still running after 10 s"):
        cpu_world(2, _hangs, timeout=10.0)
    assert time.perf_counter() - t0 < 40
    assert not [p for p in __import__("multiprocessing").active_children()]
