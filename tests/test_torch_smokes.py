"""The slice's three smokes on the CPU, one run of each smoke's children:
the hetero smoke (``raft_tpu_torch.build.smoke``), whose sigma also agrees
with the JAX package's ``sweep_designs`` on the same designs and ω at the
tolerance of ``test_torch_sweep_designs.py``; the BEM smoke
(``raft_tpu_torch.hydro.bem_smoke``), whose meshes equal the JAX smoke's
byte for byte; and the obs smoke (``python -m raft_tpu_torch.obs``).
Without CUDA each smoke exits 2 unless given ``--device cpu``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from raft_tpu.hydro import bem_smoke as jax_bem_smoke
from raft_tpu.parallel import sweep_designs as jax_sweep_designs

from raft_tpu_torch.build import smoke as hetero
from raft_tpu_torch.hydro import bem_smoke

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-12            # tests/test_torch_sweep_designs.py
MODULES = {"hetero": ["raft_tpu_torch.build.smoke"],
           "bem": ["raft_tpu_torch.hydro.bem_smoke"],
           "obs": ["raft_tpu_torch.obs"]}


def _run(argv, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("RAFT_TPU_TORCH_CACHE_DIR", None)
    return subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _smoke(name, *args) -> dict:
    r = _run(MODULES[name] + ["--device", "cpu", *args])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_hetero_smoke_on_the_cpu():
    res = _smoke("hetero", "--nw", "24")
    assert res["ok"] and res["solo_max_rel"] <= 1e-5
    assert res["n_designs"] == 3 and res["n_buckets"] == 2
    assert res["builds"] == {"cold": {}, "warm": {}}
    assert res["k1_launches"] == {"cold": 0, "warm": 0}
    ref = jax_sweep_designs(hetero.design_paths(), n_iter=hetero.N_ITER, return_xi=False,
                            **hetero.stage_kw(24))
    got = np.asarray(res["sigma"])
    want = np.asarray(ref["std dev"], dtype=float)
    assert got.shape == want.shape == (3, 6)
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL
    assert res["signatures"] == ref["buckets"]["signatures"]


def test_bem_smoke_on_the_cpu():
    for v in ("a", "b"):
        got, want = bem_smoke.smoke_mesh(v), jax_bem_smoke.smoke_mesh(v)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(bem_smoke.W, jax_bem_smoke._W)
    assert (bem_smoke.RHO, bem_smoke.G, bem_smoke.DEPTH, bem_smoke.BETA) == (
        jax_bem_smoke._RHO, jax_bem_smoke._G, jax_bem_smoke._DEPTH, jax_bem_smoke._BETA)
    res = _smoke("bem")
    assert res["ok"], res
    assert res["legs"] == ["cold", "warm", "novel"] and "plain" in res["plain_legs_only"]
    assert all(res["checks"].values()) and res["checks"]["gxx_never_invoked"]
    assert set(res["builds"].values()) == {0}
    assert max(max(p.values()) for k, p in res["parity"].items() if k != "rtol") <= 3e-3


def test_obs_smoke_on_the_cpu():
    res = _smoke("obs")
    assert res["ok"], res
    assert len(res["dispatch_histograms"]) == res["n_buckets"] == 2
    assert res["chrome_trace"]["events"] >= 3


@pytest.mark.parametrize("name", sorted(MODULES))
def test_smokes_refuse_without_cuda(name):
    r = _run(MODULES[name], timeout=120)
    assert r.returncode == 2 and "CUDA is not available" in r.stderr
    assert r.stdout.strip() == ""
