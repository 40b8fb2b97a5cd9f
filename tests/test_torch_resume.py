"""Kill and resume of a chunked DLC table through real processes, on the
CPU: ``sweep_sea_states(chunk=1, health=True)`` (OC3spar, 4 cases, 8
frequencies, float64) in a child with ``RAFT_TPU_CKPT`` armed and
``RAFT_TPU_FAULT_INJECT=kill_after_chunk:1`` dies with exit code 77 after
storing chunks 0 and 1; a second child resumes them, computes the other
two, and returns the uninterrupted run's bits.  (On the card:
``chip_smoke.py`` phase "operations".)
"""
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OC3 = os.path.join(ROOT, "raft_tpu", "designs", "OC3spar.yaml")

_CHILD = """
import json, sys, numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from raft_tpu_torch.model import stage_design_base
from raft_tpu_torch.parallel.sweep import make_wave_states, sweep_sea_states
design, m, rna, env, wave, C = stage_design_base({oc3!r}, nw=8, Hs=8.0, Tp=12.0, w_min=0.05,
                                                 w_max=2.95, device="cpu")
waves = make_wave_states(wave.w.numpy(), {cases!r}, float(env.depth), device="cpu")
res = sweep_sea_states(m, rna, env, waves, C, n_iter=25, chunk=1, health=True, device="cpu")
np.savez({out!r}, std=res["std dev"], xi=res["Xi_abs2"], it=res["iterations"])
print(json.dumps(res["pipeline"]))
"""


def test_kill_and_resume_through_a_subprocess(tmp_path):
    """A chunked DLC table killed after chunk 1 in a child (exit code 77,
    chunks 0 and 1 stored) resumes in a second child: two chunks resumed,
    two computed, every result the uninterrupted run's bits."""
    cases = [[6.0, 10.0], [7.0, 11.0], [8.0, 12.0], [9.0, 13.0]]
    oc3 = OC3

    def child(tag, **env):
        out = str(tmp_path / f"{tag}.npz")
        code = _CHILD.format(root=ROOT, oc3=oc3, cases=cases, out=out)
        full = {k: v for k, v in os.environ.items()
                if k not in ("RAFT_TPU_CKPT", "RAFT_TPU_FAULT_INJECT")}
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=300, env={**full, **env})
        return r, out

    ref, ref_out = child("ref")
    assert ref.returncode == 0, ref.stderr[-2000:]
    store = str(tmp_path / "ckpt")
    killed, _ = child("kill", RAFT_TPU_CKPT=store, RAFT_TPU_FAULT_INJECT="kill_after_chunk:1")
    assert killed.returncode == 77, killed.stderr[-2000:]
    chunks = sorted(f for _d, _, fs in os.walk(store) for f in fs if f.startswith("chunk_"))
    assert chunks == ["chunk_0.npz", "chunk_1.npz"]
    resumed, res_out = child("resume", RAFT_TPU_CKPT=store)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    stats = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert stats["chunks_resumed"] == 2 and stats["chunks_computed"] == 2
    a, b = np.load(ref_out), np.load(res_out)
    for k in ("std", "xi", "it"):
        np.testing.assert_array_equal(a[k], b[k])
