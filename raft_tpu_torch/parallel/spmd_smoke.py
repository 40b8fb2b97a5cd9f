"""SPMD smoke: a world of ranks solves one sharded design batch (port of
``raft_tpu.parallel.spmd_smoke``).

``python -m raft_tpu_torch.parallel.spmd_smoke [--device cpu|cuda]
[--world N]`` (run from the repository's root; the default is 2 ranks on
the card, one card each) proves, end to end:

* **sharded == unsharded**: a world of ``N`` ranks
  (:func:`raft_tpu_torch.parallel.spmd.world`: spawned processes, Gloo on
  the CPU, NCCL on the card, one deadline for all) runs
  :func:`raft_tpu_torch.parallel.sweep.sweep_designs` with ``mesh=`` over
  one global ``("designs",)`` mesh: each rank solves its own block of the
  lanes and gathers the rest.  Every rank returns the gathered response,
  and all must be equal; the parent solves the same batch unsharded in its
  own process and requires agreement at ``PARITY_RTOL`` of the result's
  scale (sharding is a layout decision, never a numerics decision);
* **one shared cache root, no collision**: the ranks and the parent's
  oracle run on one ``RAFT_TPU_TORCH_CACHE_DIR`` (each calls
  ``cache.enable()``), and the ranks' observability sinks
  (``RAFT_TPU_OBS``) publish under it.  Afterwards the parent checks that
  every exported log carries a distinct per-rank name
  (``obs-sweep_designs-p<rank>-<pid>.jsonl``) and that no torn ``*.tmp``
  file survives anywhere under the root.  Every file the port publishes
  goes through a temporary file in the target's own directory and
  ``os.replace``, which is atomic across processes; that holds too for
  the kernel libraries that ranks on the card resolve at first use
  (``core/nvcc.py`` writes each library beside its final name and
  replaces it, and ``cache/aot.py`` publishes the build's note the same
  way), so two ranks building one library at once each publish a whole
  file and neither reads a torn one.  (``cache/aot.py``'s single-flight
  lock is per process: two ranks may build the same library twice, never
  a corrupt one.)

Exit code 0 on success.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]

#: ranks of the world (one device each)
N_PROCESSES = 2
#: the staged batch: 8 lanes of the stock OC3 spar, one shape bucket, the
#: lane count divisible by the world
N_DESIGNS = 8
NW = 6
N_ITER = 4
#: sharded against unsharded, relative to the result's scale: the lanes run
#: the same per-lane arithmetic either way, in blocks of another size
PARITY_RTOL = 1e-9
#: seconds the world may take, start-up included
WORLD_TIMEOUT_S = 300


def _design_paths() -> list:
    return [str(_ROOT / "raft_tpu" / "designs" / "OC3spar.yaml")] * N_DESIGNS


def _solve(device, mesh=None) -> np.ndarray:
    """The batch both sides solve: the std dev of N_DESIGNS OC3 lanes in
    float64, so the parity is pinned at 1e-9 and not at float32 noise."""
    import torch

    from raft_tpu_torch.parallel.sweep import sweep_designs

    out = sweep_designs(_design_paths(), nw=NW, n_iter=N_ITER, return_xi=False, mesh=mesh,
                        dtype=torch.float64, device=device)
    return out["std dev"]


def _rank_solve(rank: int, mesh) -> np.ndarray:
    """One rank of the world: the batch sharded over its mesh."""
    from raft_tpu_torch import cache

    cache.enable()
    return _solve("cpu" if mesh.device_type == "cpu" else None, mesh=mesh)


def _check_exports(obs_dir: str, world: int) -> list:
    """Every export log per rank, salted with the rank, whole."""
    logs = sorted(glob.glob(os.path.join(obs_dir, "obs-sweep_designs-*.jsonl")))
    tags = {os.path.basename(p).split("-p", 1)[1].split("-", 1)[0] for p in logs}
    problems = []
    if len(logs) != world:
        problems.append(f"expected {world} per-rank obs logs, found {len(logs)}: {logs}")
    if tags != {str(i) for i in range(world)}:
        problems.append(f"expected rank salts 0..{world - 1} in export names, found "
                        f"{sorted(tags)}")
    return problems


def _check_no_torn_files(root: str) -> list:
    tmps = glob.glob(os.path.join(root, "**", "*.tmp"), recursive=True)
    return [f"torn tmp artifacts under the shared root: {tmps}"] if tmps else []


def run(device: str, world: int) -> int:
    """The parent: run the world, solve the oracle, check everything."""
    from raft_tpu_torch.parallel import spmd

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spmd_smoke_") as root:
        obs_dir = os.path.join(root, "obs")
        saved = {k: os.environ.get(k) for k in ("RAFT_TPU_TORCH_CACHE_DIR", "RAFT_TPU_OBS")}
        # the ranks inherit this environment: one cache root, obs armed
        os.environ.update(RAFT_TPU_TORCH_CACHE_DIR=root, RAFT_TPU_OBS=obs_dir)
        try:
            stds = spmd.world(world, _rank_solve, device=device, axis_names=("designs",),
                              timeout=WORLD_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as e:
            print(f"[spmd-smoke] FAIL: {e}")
            return 1
        finally:
            # the oracle below runs on the same root, obs unarmed so the
            # census counts exactly the ranks' logs
            os.environ.pop("RAFT_TPU_OBS", None)
        from raft_tpu_torch import cache

        cache.enable()
        try:
            std_ref = _solve("cpu" if device == "cpu" else None)
        finally:
            cache.disable()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        scale = float(np.abs(std_ref).max())
        err = float(np.abs(stds[0] - std_ref).max())
        problems = []
        if not all(np.array_equal(s, stds[0]) for s in stds):
            problems.append("the ranks' gathered results differ")
        if not err <= PARITY_RTOL * scale:
            problems.append(f"sharded != unsharded: max err {err:.3e} vs bound "
                            f"{PARITY_RTOL * scale:.3e}")
        problems += _check_exports(obs_dir, world)
        problems += _check_no_torn_files(root)
        dt = time.perf_counter() - t0
        if problems:
            print("[spmd-smoke] FAIL:")
            for pr in problems:
                print(f"[spmd-smoke]   {pr}")
            return 1
        print(f"[spmd-smoke] ok — {world} ranks ({device}), {N_DESIGNS} lanes sharded over the "
              f"world's mesh; parity err {err:.3e} (bound {PARITY_RTOL * scale:.3e}); {world} "
              f"rank-salted export logs, no torn files; {dt:.1f}s")
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.parallel.spmd_smoke")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--world", type=int, default=N_PROCESSES)
    a = ap.parse_args(argv)
    if N_DESIGNS % a.world != 0:
        ap.error(f"--world must divide the {N_DESIGNS} lanes")
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("CUDA is not available: pass --device cpu", file=sys.stderr)
            return 2
    return run(a.device, a.world)


if __name__ == "__main__":
    sys.exit(main())
