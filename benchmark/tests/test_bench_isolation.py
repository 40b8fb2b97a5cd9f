"""No run of the benchmark loads the JAX package or JAX, and the reference
loads nothing of the program: checked in fresh processes, by each module's
top-level name compared whole."""
from __future__ import annotations

import json
import subprocess
import sys

from benchmark.harness import isolation
from conftest import ROOT

IMPORT_ALL = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import benchmark
for sub in {subs!r}:
    pkg = importlib.import_module("benchmark." + sub)
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"benchmark.{{sub}}.{{m.name}}")
print(json.dumps(sorted(sys.modules)))
"""


def loaded(subs) -> set:
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL.format(root=str(ROOT), subs=subs)],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_compared_whole():
    assert isolation.forbidden_loaded(["raft_tpu_torch.model", "jaxtyping", "numpy"]) == []
    assert isolation.forbidden_loaded(["raft_tpu.model", "jax.numpy"]) == ["jax", "raft_tpu"]


def test_reference_and_work_load_nothing_of_the_program():
    names = isolation.top_level(loaded(["reference", "work"]))
    assert not names & {"raft_tpu_torch", "jax", "jaxlib", "flax", "raft_tpu"}


def test_harness_drivers_and_readers_load_no_jax():
    assert isolation.forbidden_loaded(loaded(["harness", "drivers", "layer_metrics"])) == []


def test_a_run_loads_no_jax(small_root):
    """A whole CPU run of a cell in a fresh process, then ``sys.modules``."""
    code = f"""
import sys, time, json
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark.harness import isolation, runner
runner.run("oc3_spar.sweep_wide", 5, 0.2, False, time.perf_counter(), device="cpu",
           root=__import__("pathlib").Path({str(small_root)!r}))
print(json.dumps(isolation.forbidden_loaded()))
print(json.dumps(sorted(isolation.top_level(sys.modules))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert "raft_tpu_torch" in json.loads(lines[-1])
