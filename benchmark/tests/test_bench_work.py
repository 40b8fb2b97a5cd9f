"""The frozen work formulas give the hand counts of the kernels' bounds on
the H100 (PERF.md's table of kernels): K1 f32 at 250 x 200, K3 f64 at the
1,024-panel class, K4 f64 on the nominal VolturnUS-S hull's 24 chunks."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.work import bem, k1, peaks
from conftest import ROOT

H100 = "NVIDIA H100 80GB HBM3"


def test_k1_bound_f32_250_lanes():
    w = k1.work(250, 200, 4)
    # 72 drag assembly + 81 pivot magnitudes + 800 elimination + 186 back substitution
    assert k1.flops_per_system() == 72 + 81 + 800 + 186
    assert w["bytes"] == 4 * (50000 * 72 + 50000 * 12 + 50000 * 12 + 200 + 250 * 36)
    assert peaks.bound_s(w["flops"], w["bytes"], H100, "float32") * 1e3 == pytest.approx(
        0.00574, abs=5e-6)


def test_k3_bound_f64_1024():
    assert bem.k3_bytes(1024, 8) == 16976848
    assert peaks.bound_s(0.0, bem.k3_bytes(1024, 8), H100, "float64") * 1e3 == pytest.approx(
        0.00507, abs=5e-6)


def test_k4_bound_nominal_hull():
    import yaml

    from benchmark.reference.mesh import mesh_design

    design = yaml.safe_load((ROOT / "benchmark/configs/designs/VolturnUS-S.yaml").read_text())
    panels = mesh_design(design, dz_max=3.0, da_max=2.0)
    assert len(panels) == 850
    work = bem.hull_work(panels, np.linspace(0.05, 2.95, 48), 200.0, 9.81, torch.float64, "cpu")
    assert len(work["k4"]) == 24
    bounds = [peaks.bound_s(c["flops"], c["bytes"], H100, "float64") for c in work["k4"]]
    assert 1e3 * float(np.mean(bounds)) == pytest.approx(0.0751, abs=5e-4)


def test_unknown_device_has_no_bound():
    assert peaks.bound_s(1.0, 1.0, "cpu", "float64") is None
