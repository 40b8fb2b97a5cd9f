"""``python -m raft_tpu_torch.resilience``: the CPU proof of the resilience
paths (port of ``raft_tpu.resilience.smoke``, ``device="cpu"``).

Drives one small chunked OC3 DLC sweep through every resilience path,
with REAL process boundaries (durability across a kill and a resume in
another process cannot be faked in-process):

1. **Reference** — the uninterrupted sweep, in-process, checkpointing
   off.
2. **Kill** — the same sweep in a child with
   ``RAFT_TPU_FAULT_INJECT=kill_after_chunk:0`` and a checkpoint store
   armed: the child must die with the harness's kill exit code AFTER
   persisting chunk 0.
3. **Resume** — the same child command without the fault: it must
   resume chunk 0 from the manifest, recompute ONLY the missing chunk,
   and its results must equal the uninterrupted reference bit for bit.
4. **NaN quarantine + ladder** — the sweep with
   ``RAFT_TPU_FAULT_INJECT=nan_chunk:1``: the poisoned chunk's lanes
   must be quarantined (never silently dropped), salvaged through the
   escalation ladder, reported in the health block, and land within
   convergence tolerance of the reference.

Prints one JSON line; exit code 0 iff every check is green.  About 20 s
on a few CPU cores (each child imports torch).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_CASES = [[6.0, 10.0], [7.0, 11.0], [8.0, 12.0], [9.0, 13.0]]
_NW = 8
_N_ITER = 8
_CHUNK = 2
_ROOT = Path(__file__).resolve().parents[2]


def _run_case():
    """The one tiny OC3 DLC workload every step runs (4 sea states, 2
    chunks, strip theory only — the machinery under proof is quarantine,
    checkpoint and ladder, not panel-solve physics)."""
    from raft_tpu_torch.model import stage_design_base
    from raft_tpu_torch.parallel.sweep import make_wave_states, sweep_sea_states

    design, members, rna, env, wave, C_moor = stage_design_base(
        _ROOT / "raft_tpu" / "designs" / "OC3spar.yaml", nw=_NW, Hs=6.0, Tp=10.0, w_min=0.3,
        w_max=2.1, device="cpu")
    depth = float(design["mooring"]["water_depth"])
    waves = make_wave_states(wave.w.numpy(), _CASES, depth, device="cpu")
    return sweep_sea_states(members, rna, env, waves, C_moor, n_iter=_N_ITER, chunk=_CHUNK,
                            health=True, device="cpu")


def _smoke_child(out_path: str) -> int:
    """Child body: run the smoke sweep under whatever RAFT_TPU_CKPT /
    RAFT_TPU_FAULT_INJECT the parent armed, persist the results, print
    one JSON stats line."""
    res = _run_case()
    np.savez(out_path, std=res["std dev"], a_nac=res["nacelle accel std dev"],
             iters=res["iterations"], xi=res["Xi_abs2"], conv=res["converged"],
             finite=res["finite"])
    print(json.dumps({"pipeline": res["pipeline"], "checkpoint": res.get("checkpoint"),
                      "health": res["health"]}))
    return 0


def _smoke() -> int:
    tmp = tempfile.mkdtemp(prefix="raft_torch_resilience_smoke_")
    try:
        return _smoke_body(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _smoke_body(tmp: str) -> int:
    from raft_tpu_torch.resilience import faults

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(tmp, "ckpt")
    path = os.environ.get("PYTHONPATH", "")
    base_env = {**os.environ, "RAFT_TPU_STRICT": "0", "RAFT_TPU_CKPT": "off",
                "PYTHONPATH": str(_ROOT) + (os.pathsep + path if path else "")}
    base_env.pop("RAFT_TPU_FAULT_INJECT", None)

    # 1. uninterrupted reference, in-process
    os.environ.pop("RAFT_TPU_CKPT", None)
    os.environ.pop("RAFT_TPU_FAULT_INJECT", None)
    ref = _run_case()
    ref_healthy = bool(ref["health"]["n_quarantined"] == 0
                       and np.isfinite(ref["std dev"]).all())
    ref_std = np.asarray(ref["std dev"], dtype=np.float64)
    denom = np.abs(ref_std) + 1e-300

    def run_child(tag, **env_over):
        out_path = os.path.join(tmp, f"{tag}.npz")
        r = subprocess.run([sys.executable, "-m", "raft_tpu_torch.resilience", "--child",
                            out_path], capture_output=True, text=True, timeout=300,
                           env={**base_env, **env_over})
        line = (r.stdout.strip().splitlines() or ["{}"])[-1]
        try:
            stats = json.loads(line)
        except json.JSONDecodeError:
            stats = {}
        return r.returncode, stats, out_path, r.stderr[-800:]

    # 2. kill after chunk 0 (checkpoint store armed)
    rc_kill, _, _, err_kill = run_child("kill", RAFT_TPU_CKPT=ckpt_dir,
                                        RAFT_TPU_FAULT_INJECT="kill_after_chunk:0")
    killed_ok = rc_kill == faults.KILL_EXIT
    # the manifest must already hold chunk 0 — that is what the kill
    # fault is timed to prove (persist first, die second)
    n_ckpt_files = sum(f.startswith("chunk_") for _d, _, fs in os.walk(ckpt_dir) for f in fs)
    persisted_ok = n_ckpt_files >= 1

    # 3. resume: only the missing chunk recomputes; bit-identical results
    rc_res, st_res, out_res, err_res = run_child("resume", RAFT_TPU_CKPT=ckpt_dir)
    resumed = st_res.get("pipeline", {}).get("chunks_resumed", -1)
    computed = st_res.get("pipeline", {}).get("chunks_computed", -1)
    resume_ok = rc_res == 0 and resumed == 1 and computed == 1
    parity = None
    if rc_res == 0:
        z = np.load(out_res)
        parity = float(np.max(np.abs(np.asarray(z["std"], np.float64) - ref_std) / denom))
        resume_ok = bool(resume_ok and np.array_equal(z["std"], ref["std dev"])
                         and np.array_equal(z["xi"], ref["Xi_abs2"]) and bool(z["conv"].all()))

    # 4. NaN chunk -> quarantine -> ladder salvage (no lane dropped)
    rc_nan, st_nan, out_nan, err_nan = run_child("nan", RAFT_TPU_FAULT_INJECT="nan_chunk:1")
    h = st_nan.get("health", {})
    nan_lanes = list(range(_CHUNK, 2 * _CHUNK))      # chunk 1's lanes
    nan_ok = (rc_nan == 0 and h.get("quarantined") == nan_lanes
              and h.get("salvaged") == _CHUNK and not h.get("unsalvaged"))
    salvage_rel = None
    if rc_nan == 0:
        z = np.load(out_nan)
        # every lane finite, within convergence tolerance of the reference
        # (salvaged lanes ran more iterations — tol-level, not bitwise)
        salvage_rel = float(np.max(np.abs(np.asarray(z["std"], np.float64) - ref_std) / denom))
        nan_ok = bool(nan_ok and np.isfinite(z["std"]).all() and np.isfinite(z["xi"]).all()
                      and salvage_rel < 2e-2)

    ok = bool(ref_healthy and killed_ok and persisted_ok and resume_ok and nan_ok)
    print(json.dumps({
        "ok": ok,
        "reference_healthy": ref_healthy,
        "killed_with_expected_rc": killed_ok,
        "chunk0_persisted_before_kill": persisted_ok,
        "resume": {"ok": resume_ok, "chunks_resumed": resumed, "chunks_recomputed": computed,
                   "max_rel_vs_uninterrupted": parity},
        "nan_quarantine": {"ok": nan_ok, "health": h, "max_rel_vs_uninterrupted": salvage_rel},
        "wall_s": round(time.perf_counter() - t0, 2),
        **({} if ok else {"stderr_tails": {"kill": err_kill[-300:], "resume": err_res[-300:],
                                           "nan": err_nan[-300:]}}),
    }))
    return 0 if ok else 1
