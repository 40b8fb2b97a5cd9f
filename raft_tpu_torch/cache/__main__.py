"""Cache smoke: prove that a second process of the port starts warm (port of
``raft_tpu.cache.__main__``).

``python -m raft_tpu_torch.cache smoke [--device cpu] [--dir D]`` makes a
fresh cache root, builds the kernel libraries (on the card: K1/K2, K3, K4
with ``nvcc``; the host panel solver with ``g++`` on either device) and
writes a WAMIT pair (OC3spar-sized coefficients on 200 frequencies, 4
headings) with the port's writers, then runs two child processes on that
root, one after the other.  Each child:

* resolves the kernel libraries through the registry
  (:mod:`raft_tpu_torch.cache.aot`);
* reads the WAMIT pair through :func:`~raft_tpu_torch.hydro.bem_io.
  load_wamit_coeffs`, once per heading (the staging cache's
  ``wamit_coeffs``);
* runs :func:`~raft_tpu_torch.parallel.sweep.sweep_sea_states` of OC3spar
  over 4 cases with their own headings on that heading grid (on the card
  through K1);
* on the card only, solves one ``Model(BEM="jax")`` of the OC3spar hull at
  184 panels (K3 and K4; the panel solver's result cache holds it for the
  next process);
* flushes the performance ledger and prints one JSON line: the warm-start
  report, ``phases_s``, its compile count, its kernel launches and digests
  of its outputs.

The smoke passes when the second child has staging disk hits (at least 2),
no staging miss and saved seconds; neither child built a library; the
second child launched no K3 or K4 (its BEM result was a hit); the two
children's outputs are equal bit for bit; and the ledger's ``solve6_fused``
entries count as many launches as both children's K1 launches.  It prints
one JSON line and exits 0 or 1.  ``python -m raft_tpu_torch.cache child``
is the per-process payload.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_DESIGN = _ROOT / "raft_tpu" / "designs" / "OC3spar.yaml"
NW, NW_FILE = 24, 200
HEADINGS_DEG = (0.0, 30.0, 60.0, 90.0)
CASES = ((4.0, 8.0, 0.0), (6.0, 10.0, 0.4), (8.0, 12.0, 0.8), (10.0, 14.0, 1.2))
# the small hull of the card's panel solve: OC3spar at these panel sizes
DZ_MAX, DA_MAX = 6.0, 4.0


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _wamit_paths(root: str) -> tuple:
    d = os.path.join(root, "wamit")
    return os.path.join(d, "oc3.1"), os.path.join(d, "oc3.3")


def write_wamit_pair(root: str, seed: int = 5) -> tuple:
    """A WAMIT .1/.3 pair of OC3spar-sized coefficients (added mass 4e6,
    damping 2e5 on the diagonal; a random excitation of 2e5 per heading)
    on :data:`NW_FILE` frequencies, written with the port's writers."""
    from raft_tpu_torch.hydro import bem_io

    rng = np.random.default_rng(seed)
    w = np.linspace(0.05, 2.95, NW_FILE)
    A = np.tile(np.eye(6)[:, :, None] * 4e6, (1, 1, NW_FILE))
    B = np.tile(np.eye(6)[:, :, None] * 2e5, (1, 1, NW_FILE))
    shape = (len(HEADINGS_DEG), 6, NW_FILE)
    F = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 2e5
    p1, p3 = _wamit_paths(root)
    os.makedirs(os.path.dirname(p1), exist_ok=True)
    bem_io.write_wamit1(p1, w, A, B)
    bem_io.write_wamit3(p3, w, F, heading=np.asarray(HEADINGS_DEG))
    return p1, p3


def _libraries(dev) -> list:
    """The libraries a process on ``dev`` resolves: the host panel solver,
    and on the card K1/K2, K3, K4 and K5."""
    from raft_tpu_torch.core import cuda6, cuda_bem, cuda_drag
    from raft_tpu_torch.hydro import native_bem

    libs = [native_bem.LIBRARY]
    if dev.type == "cuda":
        libs += [cuda6.SPEC, cuda_bem.RANKINE, cuda_bem.WAVE, cuda_drag.SPEC]
    return libs


def _child(argv) -> None:
    p = argparse.ArgumentParser(prog="raft_tpu_torch.cache child")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    import torch

    from raft_tpu_torch import cache
    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.core import cuda6, cuda_bem
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.obs import ledger
    from raft_tpu_torch.utils import profiling as prof

    cache.enable()                      # RAFT_TPU_TORCH_CACHE_DIR from the parent
    dev = resolve_device(args.device)
    for lib in _libraries(dev):
        aot.library(lib)

    from raft_tpu_torch.build.members import build_member_set, build_rna
    from raft_tpu_torch.core.types import Env
    from raft_tpu_torch.hydro.bem_io import load_wamit_coeffs
    from raft_tpu_torch.model import Model, load_design
    from raft_tpu_torch.mooring.system import mooring_stiffness, parse_mooring
    from raft_tpu_torch.parallel.sweep import make_wave_states, sweep_sea_states

    f64 = torch.float64
    design = load_design(str(_DESIGN))
    depth = float(design["mooring"]["water_depth"])
    w = np.linspace(0.05, 2.95, NW)
    p1, p3 = _wamit_paths(cache.cache_dir())
    rows = [load_wamit_coeffs(p1, p3, w, heading=h) for h in HEADINGS_DEG]
    A, B = rows[0][0], rows[0][1]
    grid = (np.deg2rad(HEADINGS_DEG), np.stack([r[2] for r in rows]), A, B)
    members = build_member_set(design, dev, f64)
    moor = parse_mooring(design["mooring"], dev, f64,
                         yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0))
    C = mooring_stiffness(moor, torch.zeros(6, dtype=f64, device=dev))
    waves = make_wave_states(w, np.asarray(CASES), depth, dtype=f64, device=dev)
    out = sweep_sea_states(members, build_rna(design), Env(Hs=8.0, Tp=12.0, depth=depth), waves,
                           C, bem=grid, dtype=f64, device=dev)
    bem_digest = None
    if dev.type == "cuda":
        m = Model(design, w=w, BEM="jax", dtype=f64, device=dev)
        Ab, Bb, Fb = m.calcBEM(dz_max=DZ_MAX, da_max=DA_MAX)
        bem_digest = _digest(Ab, Bb, Fb)
        torch.cuda.synchronize(dev)
    ledger.flush()
    print(json.dumps({
        "device": str(dev),
        "warm_start": cache.report(),
        "phases_s": {k: round(v, 6) for k, v in prof.totals().items()},
        "compiles": aot.compile_count(),
        "launches": {**cuda6.LAUNCHES, **cuda_bem.LAUNCHES},
        "std0": float(out["std dev"][0, 0]),
        "std_digest": _digest(out["std dev"], out["iterations"]),
        "bem_digest": bem_digest,
    }))


def _run_child(root: str, device, timeout: float) -> dict:
    env = dict(os.environ)
    env["RAFT_TPU_TORCH_CACHE_DIR"] = root
    env["PYTHONPATH"] = str(_ROOT) + (os.pathsep + env["PYTHONPATH"]
                                      if env.get("PYTHONPATH") else "")
    argv = [sys.executable, "-m", "raft_tpu_torch.cache", "child"]
    if device is not None:
        argv += ["--device", device]
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, timeout=timeout, env=env,
                       cwd=str(_ROOT))
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f"cache smoke child failed (rc={r.returncode}):\n"
                         + (r.stderr or r.stdout)[-3000:])
    return {**json.loads(r.stdout.strip().splitlines()[-1]), "wall_s": round(wall, 3)}


def smoke(argv) -> int:
    p = argparse.ArgumentParser(prog="raft_tpu_torch.cache smoke")
    p.add_argument("--device", default=None,
                   help="the children's torch device (default: the card)")
    p.add_argument("--dir", default=None,
                   help="cache root (default: a fresh temporary directory, removed after)")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds per child")
    args = p.parse_args(argv)

    from raft_tpu_torch import cache
    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.obs import ledger

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"raft_tpu_torch.cache smoke: {e}", file=sys.stderr)
        return 2
    d = args.dir or tempfile.mkdtemp(prefix="raft_tpu_torch_cache_smoke_")
    try:
        t0 = time.perf_counter()
        aot.prepare(_libraries(dev))     # the children must find every library built
        build_s = time.perf_counter() - t0
        write_wamit_pair(d)
        cold = _run_child(d, args.device, args.timeout)
        warm = _run_child(d, args.device, args.timeout)
        cache.enable(d)
        k1_entries = [e for e in ledger.entries() if e.get("entry") == "solve6_fused"]
        k1_ledger = sum(int(e["count"]) for e in k1_entries)
        k1_launches = sum(c["launches"]["fused"] + c["launches"]["fused_adjoint"]
                          for c in (cold, warm))
        staging = warm["warm_start"].get("staging", {})
        on_card = dev.type == "cuda"
        checks = {
            "warm_staging_disk_hits": staging.get("disk_hits", 0) >= 2,
            "warm_staging_no_miss": staging.get("misses", 1) == 0,
            "warm_staging_saved_s": staging.get("saved_s", 0.0) > 0.0,
            "zero_compiles_both_children": cold["compiles"] == warm["compiles"] == 0,
            "cold_bem_through_k3_k4": (not on_card or (
                cold["launches"]["rankine"] >= 1 and cold["launches"]["wave"] >= 1)),
            "warm_no_k3_k4": warm["launches"]["rankine"] == warm["launches"]["wave"] == 0,
            "outputs_bit_identical": (cold["std_digest"] == warm["std_digest"]
                                      and cold["std0"] == warm["std0"]
                                      and cold["bem_digest"] == warm["bem_digest"]),
            "ledger_counts_k1_launches": (k1_ledger == k1_launches
                                          and (k1_launches > 0 or not on_card)),
        }
        ok = all(checks.values())
        print(json.dumps({
            "ok": ok, **checks,
            "device": str(dev),
            "parent_build_s": round(build_s, 3),
            "cold_wall_s": cold["wall_s"], "warm_wall_s": warm["wall_s"],
            "cold_staging": cold["warm_start"].get("staging"),
            "warm_staging": staging,
            "warm_staging_by_category": {k.split("/", 1)[1]: v
                                         for k, v in warm["warm_start"].items()
                                         if k.startswith("staging/")},
            "warm_kernels": warm["warm_start"].get("kernels"),
            "cold_phases_s": cold["phases_s"], "warm_phases_s": warm["phases_s"],
            "launches": {"cold": {k: v for k, v in cold["launches"].items() if v},
                         "warm": {k: v for k, v in warm["launches"].items() if v}},
            "k1_ledger_count": k1_ledger, "k1_launches": k1_launches,
            "ledger": [{k: e.get(k) for k in ("entry", "bucket", "count", "best_s",
                                              "roofline_fraction")}
                       for e in ledger.entries()],
            "cache_dir": d,
        }))
        return 0 if ok else 1
    finally:
        cache.disable()
        if args.dir is None:
            shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    argv = sys.argv[1:]
    if argv and argv[0] == "child":
        _child(argv[1:])
        return 0
    if argv and argv[0] == "smoke":
        return smoke(argv[1:])
    print("usage: python -m raft_tpu_torch.cache smoke [--device DEV] [--dir D] "
          "[--timeout S]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
