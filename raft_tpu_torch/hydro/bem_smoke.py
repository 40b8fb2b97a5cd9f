"""BEM smoke: a novel geometry solves through the on-device panel BEM in
fresh processes, with the host compiler poisoned (port of
``raft_tpu.hydro.bem_smoke``).

``python -m raft_tpu_torch.hydro.bem_smoke [--device cpu]`` keeps the JAX
smoke's protocol and data: the meshes :func:`novel_mesh` and
:func:`smoke_mesh` ``"a"`` and ``"b"`` (two columns, sizes unlike any
shipped design, 60 panels each, the 64-panel class), ω = linspace(0.4, 1.6, 4),
40 m of water, heading 0.3 rad.

1. The parent solves both geometries with the native oracle
   (``BEM="native"``, ``cache=False``, the real toolchain), builds or finds
   the kernel libraries in ``raft_tpu_torch/_build/`` (on the card K3 and
   K4), and copies the wave tables into the children's fresh cache root.
2. Every child runs with ``RAFT_TPU_BEM=jax``, that root, and ``g++``,
   ``gcc`` and ``c++`` on ``PATH`` replaced by stubs that leave a marker
   file and fail, and solves one geometry through
   :func:`raft_tpu_torch.hydro.torch_bem.solve_bem_jax` (``cache=False``).
   The default route: a cold child on geometry A, then a warm child
   repeating A and a novel child on geometry B side by side.  On the card
   the default route is the kernels (K3/K4), and two more children, cold on
   A and novel on B, pin ``RAFT_TPU_BEM_ASSEMBLY=xla`` (the plain versions)
   beside them.
3. The checks: no marker (nothing asked for the host compiler); every leg
   within :data:`PARITY_RTOL` of the oracle in A, B and F; the refinement
   residual below 1e-4; the warm child's A/B/F the cold child's bit for
   bit; every child built no kernel library; on the card, the kernel legs
   within :data:`INTERP_PARITY_RTOL` of the plain legs on the same
   geometry, K3 and K4 launched in each kernel leg and in no plain leg.

The JAX smoke's "the cold child compiles at least once, the warm and novel
children none" has no counterpart: the port compiles no program per
geometry, and its kernel libraries live in ``raft_tpu_torch/_build/``,
not under the cache root, so every child makes 0 builds.  Nor has its
"warm faster than cold".  On the CPU both routes are the plain version, so
the CPU run has only the three legs of the default route, and its JSON
says so.  Without CUDA the smoke exits 2 unless given ``--device cpu``.

Prints one JSON line; exit 0 when every check holds, else 1.  The
children run ``python -m raft_tpu_torch.hydro.bem_smoke --child VARIANT
OUT [--device D]``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from raft_tpu_torch.evidence import REPO, run_step
from raft_tpu_torch.hydro.torch_bem import PARITY_RTOL, parity_err

#: the kernels against the plain assembly (the JAX package's bound between
#: its assembly routes, ``raft_tpu/core/pallas_bem.py``)
INTERP_PARITY_RTOL = 1e-4
W = np.linspace(0.4, 1.6, 4)
RHO, G, DEPTH, BETA = 1025.0, 9.81, 40.0, 0.3
#: the children's dtype (the JAX smoke solves at its device's default)
DTYPE = "float32"
#: seconds a child may take (start-up included)
CHILD_TIMEOUT = 600.0


def novel_mesh(r: float, draft: float, spacing: float,
               dz_max: float = 1.6, da_max: float = 1.3) -> np.ndarray:
    """A two-column platform mesh whose sizes are unlike any shipped design,
    so that nothing content-cached can match."""
    from raft_tpu_torch.hydro.mesh import mesh_member

    cols = []
    for sx in (-0.5, 0.5):
        cols.append(mesh_member(
            stations=[0.0, draft + 2.0], diameters=[2 * r, 2 * r],
            rA=[sx * spacing, 0.0, -draft], rB=[sx * spacing, 0.0, 2.0],
            dz_max=dz_max, da_max=da_max))
    return np.concatenate(cols, axis=0)


def smoke_mesh(variant: str) -> np.ndarray:
    """Geometries A and B: other radius, draft and spacing, the same panel
    class."""
    if variant == "a":
        return novel_mesh(1.13, 5.7, 7.9)
    if variant == "b":
        return novel_mesh(1.19, 5.9, 8.3)
    raise ValueError(variant)


def _child(variant: str, out_path: str, device) -> int:
    import torch

    from raft_tpu_torch import cache
    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.core import cuda_bem
    from raft_tpu_torch.hydro.torch_bem import solve_bem_jax

    cache.enable()                     # the root from RAFT_TPU_TORCH_CACHE_DIR
    if torch.device(device or "cuda").type == "cpu":
        # children side by side: one intra-op thread each, or their batched
        # LUs contend for the host's cores
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    A, B, F, diag = solve_bem_jax(smoke_mesh(variant), W, rho=RHO, g=G, beta=BETA, depth=DEPTH,
                                  cache=False, return_diagnostics=True,
                                  dtype=getattr(torch, DTYPE), device=device)
    wall = time.perf_counter() - t0
    np.savez(out_path, A=A, B=B, F_re=F.real, F_im=F.imag, wall_s=wall,
             builds=sum(aot.compile_counts().values()), route=diag["route"],
             rankine=cuda_bem.LAUNCHES["rankine"], wave=cuda_bem.LAUNCHES["wave"],
             max_residual=diag["max_residual"], padded=diag["padded"])
    return 0


def _abf(leg: dict) -> tuple:
    return leg["A"], leg["B"], leg["F_re"] + 1j * leg["F_im"]


def _errs(got: dict, ref: tuple) -> dict:
    return {k: parity_err(x, y) for k, x, y in zip("ABF", _abf(got), ref)}


def _poison(ws: str) -> tuple:
    """A directory of failing ``g++``, ``gcc`` and ``c++`` stubs that leave
    a marker file; returns (directory, marker)."""
    poison = os.path.join(ws, "bin")
    os.makedirs(poison, exist_ok=True)
    marker = os.path.join(ws, "gxx-invoked")
    for tool in ("g++", "gcc", "c++"):
        path = os.path.join(poison, tool)
        with open(path, "w") as f:
            f.write("#!/bin/sh\n"
                    f"touch {marker}\n"
                    "echo 'bem-smoke: toolchain poisoned' >&2\n"
                    "exit 1\n")
        os.chmod(path, 0o755)
    return poison, marker


def run(device=None) -> dict:
    """The smoke on ``device`` (None: the card); returns its JSON dict."""
    from raft_tpu_torch.cache import aot
    from raft_tpu_torch.core import cuda_bem
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.hydro import native_bem, wavetable

    t_start = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    ws = tempfile.mkdtemp(prefix="raft-torch-bem-smoke-")
    result: dict = {"ok": False, "device": str(dev)}
    try:
        root = os.path.join(ws, "cache")
        poison, marker = _poison(ws)
        oracle = {v: native_bem.solve_bem(smoke_mesh(v), W, rho=RHO, g=G, beta=BETA,
                                          depth=DEPTH, cache=False) for v in ("a", "b")}
        if on_card:
            aot.prepare([cuda_bem.RANKINE, cuda_bem.WAVE])
        wavetable.load_tables()
        shutil.copytree(wavetable.cache_dir(), os.path.join(root, "wavetable"))

        env = {**os.environ, "PATH": poison + os.pathsep + os.environ.get("PATH", ""),
               "RAFT_TPU_BEM": "jax", "RAFT_TPU_TORCH_CACHE_DIR": root,
               "PYTHONPATH": str(REPO)}
        env.pop("RAFT_TPU_BEM_ASSEMBLY", None)

        def child(variant, tag, assembly=None):
            out = os.path.join(ws, f"{tag}.npz")
            cmd = [sys.executable, "-m", "raft_tpu_torch.hydro.bem_smoke", "--child", variant,
                   out] + (["--device", str(device)] if device is not None else [])
            r = run_step(cmd, CHILD_TIMEOUT, f"bem smoke {tag}",
                         env=env if assembly is None else {**env,
                                                           "RAFT_TPU_BEM_ASSEMBLY": assembly})
            if not r["ok"]:
                raise RuntimeError(f"child {tag} rc={r['rc']}:\n" + "\n".join(r["tail"]))
            with np.load(out) as z:
                return {k: z[k] for k in z.files} | {"child_wall_s": r["elapsed_s"]}

        legs = {"cold": child("a", "cold")}
        later = [("warm", "a", None), ("novel", "b", None)]
        if on_card:
            later += [("plain_cold", "a", "xla"), ("plain_novel", "b", "xla")]
        with ThreadPoolExecutor(len(later)) as pool:
            futs = {tag: pool.submit(child, v, tag, a) for tag, v, a in later}
            legs.update({tag: f.result() for tag, f in futs.items()})

        variant = {"cold": "a", "warm": "a", "novel": "b", "plain_cold": "a", "plain_novel": "b"}
        parity = {tag: _errs(leg, oracle[variant[tag]]) for tag, leg in legs.items()}
        kernel_legs = ("cold", "warm", "novel") if on_card else ()
        plain_legs = ("plain_cold", "plain_novel") if on_card else ("cold", "warm", "novel")
        checks = {
            "gxx_never_invoked": not os.path.exists(marker),
            "parity_all_legs": all(v <= PARITY_RTOL for p in parity.values() for v in p.values()),
            "residual_small": max(float(leg["max_residual"]) for leg in legs.values()) < 1e-4,
            "warm_equals_cold_bits": all(np.array_equal(legs["warm"][k], legs["cold"][k])
                                         for k in ("A", "B", "F_re", "F_im")),
            "zero_builds_all_children": all(int(leg["builds"]) == 0 for leg in legs.values()),
            "routes": (all(str(legs[t]["route"]) == "kernels" for t in kernel_legs)
                       and all(str(legs[t]["route"]) == "plain" for t in plain_legs)),
        }
        cross = {}
        if on_card:
            cross = {"a": _errs(legs["cold"], _abf(legs["plain_cold"])),
                     "b": _errs(legs["novel"], _abf(legs["plain_novel"]))}
            checks["kernels_plain_agree"] = all(v <= INTERP_PARITY_RTOL
                                                for c in cross.values() for v in c.values())
            checks["k3_k4_on_kernel_legs_only"] = (
                all(int(legs[t]["rankine"]) >= 1 and int(legs[t]["wave"]) >= 1
                    for t in kernel_legs)
                and all(int(legs[t]["rankine"]) == int(legs[t]["wave"]) == 0
                        for t in plain_legs))
        result = {
            "ok": all(checks.values()), "checks": checks, "device": str(dev), "dtype": DTYPE,
            "legs": list(legs),
            "plain_legs_only": None if on_card else (
                "on the CPU both routes are the plain version: only the three legs of "
                "the default route run"),
            "parity": {**parity, "rtol": PARITY_RTOL},
            "cross_route": cross, "cross_rtol": INTERP_PARITY_RTOL,
            "launches": {tag: {"rankine": int(leg["rankine"]), "wave": int(leg["wave"])}
                         for tag, leg in legs.items()},
            "builds": {tag: int(leg["builds"]) for tag, leg in legs.items()},
            "solve_s": {tag: float(leg["wall_s"]) for tag, leg in legs.items()},
            "child_wall_s": {tag: leg["child_wall_s"] for tag, leg in legs.items()},
            "padded_panels": int(legs["cold"]["padded"]),
            "panels": {v: int(len(smoke_mesh(v))) for v in ("a", "b")},
            "max_residual": max(float(leg["max_residual"]) for leg in legs.values()),
        }
    except Exception as e:                       # noqa: BLE001 - reported in the JSON line
        result["error"] = f"{type(e).__name__}: {e}"[-3000:]
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    result["wall_s"] = round(time.perf_counter() - t_start, 3)
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        p = argparse.ArgumentParser(prog="raft_tpu_torch.hydro.bem_smoke --child")
        p.add_argument("variant")
        p.add_argument("out")
        p.add_argument("--device", default=None)
        a = p.parse_args(argv[1:])
        return _child(a.variant, a.out, a.device)
    p = argparse.ArgumentParser(prog="raft_tpu_torch.hydro.bem_smoke")
    p.add_argument("--device", default=None, help="the children's device (default: the card)")
    args = p.parse_args(argv)
    from raft_tpu_torch.core.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"raft_tpu_torch.hydro.bem_smoke: {e}", file=sys.stderr)
        return 2
    result = run(args.device)
    print(json.dumps(result))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
