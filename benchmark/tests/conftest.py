"""Tests of the benchmark's harness, run on the CPU at small sizes:
``python -m pytest benchmark/tests`` from the checkout's root.  Tests that
need the card carry the ``card`` marker and skip without one; the card
runs them as ``python -m pytest benchmark/tests -m card``."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

#: cell parameters small enough for the CPU (float64: the float32 plain
#: solve on the CPU overflows at these designs' full width)
SMALL = {
    "volturnus_s.sweep_bem": {"n_designs": 4, "chunk": 2, "dtype": "float64",
                              "warmup_calls": 1},
    "oc3_spar.sweep_wide": {"n_variants": 6, "dtype": "float64", "warmup_calls": 1,
                            "check_calls": 2, "check_block": 4},
    "volturnus_s.codesign_grad": {"n_variants": 4, "chunk": 2, "dtype": "float64",
                                  "warmup_calls": 1, "check_calls": 1, "check_block": 2},
    "volturnus_s.bem_hull": {"warmup_calls": 1, "check_calls": 2},
}
SMALL_CONFIG = {"nw": 8, "bem": {"nw_bem": 3, "dz_max": 12.0, "da_max": 10.0}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def copy_benchmark(dst: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's folder under ``dst``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return dst


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    """A copy of the benchmark with every cell and configuration cut to a
    CPU size, and the program's nominal-hull mesh as coarse as the
    configuration's."""
    from raft_tpu_torch.hydro import mesh

    root = copy_benchmark(tmp_path)
    for name, over in SMALL.items():
        path = root / "benchmark" / "cells" / f"{name}.json"
        cell = json.loads(path.read_text())
        cell["traffic_params"].update(over)
        cell["trace_calls"] = 1
        path.write_text(json.dumps(cell))
    for path in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["nw"] = SMALL_CONFIG["nw"]
        if "bem" in cfg:
            cfg["bem"] = {**cfg["bem"], **SMALL_CONFIG["bem"]}
        path.write_text(json.dumps(cfg))
    b = SMALL_CONFIG["bem"]
    full = mesh.mesh_design
    monkeypatch.setattr(mesh, "mesh_design", lambda design, **kw: full(
        design, dz_max=b["dz_max"], da_max=b["da_max"]))
    monkeypatch.setenv("RAFT_TPU_TORCH_CACHE_DIR", str(ROOT / "benchmark" / ".cache" / "program"))
    return root
