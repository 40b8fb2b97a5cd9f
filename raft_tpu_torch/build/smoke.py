"""Hetero smoke: a mixed design stream through the shape buckets, across
two processes (port of ``raft_tpu.build.smoke``).

``python -m raft_tpu_torch.build.smoke [--device cpu] [--nw N] [--dir D]``
stages a mixed stream of OC3spar, VolturnUS-S and OC4semi (three member
topologies, read as data files from ``raft_tpu/designs/``) through
:func:`raft_tpu_torch.parallel.sweep.sweep_designs` in two fresh child
processes, one after the other, on one cache root, and checks:

* the stream solves in fewer shape buckets than designs;
* the padded, bucketed results match each design's solo
  :func:`~raft_tpu_torch.parallel.sweep.forward_response` at 1e-5,
  scale-relative: padding must not change the physics;
* process 2 reproduces process 1's results and iteration counts bit for
  bit, with as many K1 launches (the stream's and the solo solves');
* neither child builds a kernel library.

The JAX smoke counts compiles: one executable per bucket in process 1 and
none in process 2 (disk hits of its executable registry).  The port
compiles nothing per bucket: eager PyTorch runs each bucket through the
same kernels, whatever its shapes.  The counterpart is 0 kernel-library
builds in each child (:func:`raft_tpu_torch.cache.aot.compile_counts`;
the parent builds or finds the libraries first, in
``raft_tpu_torch/_build/``), reported with the bucket count and each
child's K1 launches.  On the CPU there is no K1 and its count is 0.

The children run on ``--device`` (the card by default; without CUDA the
smoke exits 2 unless given ``--device cpu``) in float64.  Prints one JSON
line; exit 0 when every check holds, else 1.  ``python -m
raft_tpu_torch.build.smoke child`` is the per-process payload.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

DESIGNS = ("OC3spar", "VolturnUS-S", "OC4semi")
#: the shipped designs, read as data files from the JAX package's tree
DESIGN_DIR = Path(__file__).resolve().parents[2] / "raft_tpu" / "designs"
N_ITER = 30
SOLO_RTOL = 1e-5
#: seconds a child may take (start-up included)
CHILD_TIMEOUT = 600.0


def design_paths() -> list:
    return [str(DESIGN_DIR / f"{n}.yaml") for n in DESIGNS]


def stage_kw(nw: int) -> dict:
    return dict(nw=nw, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)


def _child(argv) -> None:
    p = argparse.ArgumentParser(prog="raft_tpu_torch.build.smoke child")
    p.add_argument("--nw", type=int, default=24)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    import numpy as np

    from raft_tpu_torch import cache
    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.core import cuda6, cuda_drag
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.model import stage_design_base
    from raft_tpu_torch.parallel.sweep import forward_response, response_std, sweep_designs

    cache.enable()                      # RAFT_TPU_TORCH_CACHE_DIR from the parent
    dev = resolve_device(args.device)
    kw = stage_kw(args.nw)
    fnames = design_paths()
    k1 = cuda6.LAUNCHES["fused"]
    out = sweep_designs(fnames, n_iter=N_ITER, return_xi=False, device=dev, **kw)

    # each design's solo solve (unpadded, unbucketed) for the parity check
    errs = []
    for i, fn in enumerate(fnames):
        _, m, rna, env, wv, C = stage_design_base(fn, device=dev, **kw)
        o = forward_response(m, rna, env, wv, C, n_iter=N_ITER, device=dev)
        sig = response_std(o.Xi.abs2(), wv.w).double().cpu().numpy()
        # scale-relative: the unexcited symmetric DOFs are zero-mean noise
        errs.append(float(np.max(np.abs(out["std dev"][i] - sig)) / np.max(np.abs(sig))))

    print(json.dumps({
        "device": str(dev),
        "n_designs": len(fnames),
        "n_buckets": out["buckets"]["n_buckets"],
        "signatures": out["buckets"]["signatures"],
        "promotions": out["buckets"]["promotions"],
        "builds": aot.compile_counts(),
        "k1_launches": cuda6.LAUNCHES["fused"] - k1,
        "solo_max_rel": max(errs),
        "sigma": np.asarray(out["std dev"]).tolist(),
        "iterations": np.asarray(out["iterations"]).tolist(),
    }))


def smoke(argv) -> int:
    p = argparse.ArgumentParser(prog="raft_tpu_torch.build.smoke")
    p.add_argument("--nw", type=int, default=24, help="frequency bins")
    p.add_argument("--device", default=None, help="the children's device (default: the card)")
    p.add_argument("--dir", default=None,
                   help="cache root (default: a fresh temporary directory, removed after)")
    args = p.parse_args(argv)

    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.core import cuda6, cuda_drag
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.evidence import run_child

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"raft_tpu_torch.build.smoke: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        aot.prepare([cuda6.SPEC, cuda_drag.SPEC])   # the children find K1's and K5's built
    d = args.dir or tempfile.mkdtemp(prefix="raft_tpu_torch_hetero_smoke_")
    child_args = ["child", "--nw", str(args.nw)] + (["--device", args.device]
                                                    if args.device else [])
    # the claim is about the default ladder, whatever the caller's environment
    env = {"RAFT_TPU_TORCH_CACHE_DIR": d, "RAFT_TPU_BUCKETS": None}
    try:
        runs = [run_child("raft_tpu_torch.build.smoke", child_args, CHILD_TIMEOUT,
                          f"hetero child {i}", env) for i in (1, 2)]
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)[-3000:]}))
        return 1
    finally:
        if args.dir is None:
            shutil.rmtree(d, ignore_errors=True)
    cold, warm = runs
    on_card = dev.type == "cuda"
    checks = {
        "fewer_buckets_than_designs": cold["n_buckets"] < cold["n_designs"],
        "solo_parity_1e5": cold["solo_max_rel"] <= SOLO_RTOL,
        "zero_builds_both_children": not any(cold["builds"].values())
                                     and not any(warm["builds"].values()),
        "results_identical": (warm["sigma"] == cold["sigma"]
                              and warm["iterations"] == cold["iterations"]),
        "k1_launches_equal": (warm["k1_launches"] == cold["k1_launches"]
                              and (cold["k1_launches"] > 0 or not on_card)),
    }
    ok = all(checks.values())
    print(json.dumps({
        "ok": ok, **checks,
        "device": str(dev), "nw": args.nw,
        "n_designs": cold["n_designs"], "n_buckets": cold["n_buckets"],
        "signatures": cold["signatures"], "promotions": cold["promotions"],
        "builds": {"cold": cold["builds"], "warm": warm["builds"]},
        "k1_launches": {"cold": cold["k1_launches"], "warm": warm["k1_launches"]},
        "solo_max_rel": cold["solo_max_rel"],
        "child_wall_s": {"cold": cold["wall_s"], "warm": warm["wall_s"]},
        "sigma": cold["sigma"],
    }))
    return 0 if ok else 1


def main() -> int:
    argv = sys.argv[1:]
    if argv and argv[0] == "child":
        _child(argv[1:])
        return 0
    return smoke(argv)


if __name__ == "__main__":
    raise SystemExit(main())
