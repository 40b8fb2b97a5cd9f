#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``raft_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure makes the script exit non-zero, and then it prints no
result line):

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles kernel K1 (``raft_tpu_torch/csrc/solve6.cu``) with nvcc;
3. K1 against its plain PyTorch version on the card, numpy-seeded inputs at
   the sweep's call shape (250 designs x 200 frequencies) and at 1,000 x 200,
   in float64 and float32: random systems, a permutation matrix with w = 0
   (forces pivoting) and one singular lane (zero-denominator guard); with
   kernel, plain-version and ``torch.linalg.solve`` times beside the bound;
4. ``run_raft`` on OC3spar, OC4semi and VolturnUS-S on the card in float64
   against the same run on the CPU (plain path);
5. the north-star sweep at full size (1,000 VolturnUS-S variants x 200
   frequencies, float32) -- the main path whose kernel launches are
   counted -- then a 16-lane subset in float64 through the kernel and
   through the plain solve on the card;
6. the same sweep again under ``torch.profiler``: device busy time, idle
   share and the operations that take the device time.

The last lines are the kernel JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DESIGNS = ROOT / "raft_tpu" / "designs"

# H100 SXM peaks: HBM3 bytes/s and non-tensor-core FLOP/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
TOL = {"float64": 1e-12, "float32": 1e-5}


def k1_flops_per_system() -> int:
    """Floating-point operations of one fused assemble+solve, counted from
    solve6.cu: assembly, pivot magnitudes, elimination, back substitution."""
    n = 6
    flops = 2 * n * n                                     # Z.im = Z0.im + w * B
    for k in range(n):
        flops += 3 * (n - k) + 3                          # |.|^2 of candidates, den
        flops += (n - 1 - k) * (8 + 8 * (n - k) + 8)      # factors, row, rhs
    for k in range(n):
        flops += 8 * (n - 1 - k) + 3 + 8                  # back substitution
    return flops


def k1_bound_ms(n_designs: int, nw: int, itemsize: int, dtype_name: str):
    """Least time of one K1 call on the card: each input read once, each
    output written once, against the operations at the type's peak."""
    n = n_designs * nw
    nbytes = itemsize * (n * 36 * 2 + n * 6 * 2 + n * 6 * 2 + nw + n_designs * 36)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = n * k1_flops_per_system() / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.failures: list[str] = []
        self.record: dict = {}
        self.dev = torch.device("cuda")
        self._flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=self.dev)

    # -------------------------------------------------------------- helpers

    def check(self, ok: bool, what: str):
        print(("  ok   " if ok else "  FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def time_ms(self, fn, reps: int = 20) -> float:
        """Mean device time of fn(), each call after an L2 flush (64 MB)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self._flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    # ---------------------------------------------------------------- phases

    def phase_build(self):
        from raft_tpu_torch.core import cuda6

        t0 = time.perf_counter()
        cuda6.build()
        print(f"  K1 built in {time.perf_counter() - t0:.2f} s")
        for line in cuda6.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print("  ptxas:", line.strip())

    def _k1_inputs(self, case: str, B: int, nw: int, dtype, rng):
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        w = np.linspace(0.05, 2.95, nw)
        if case == "random":
            Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
            Zi = rng.normal(size=(B, nw, 6, 6))
            Bd = 0.1 * rng.normal(size=(B, 6, 6))
        elif case == "permutation":
            P = np.zeros((6, 6))
            P[np.arange(6), (np.arange(6) + 1) % 6] = 1.0
            Zr = np.broadcast_to(P, (B, nw, 6, 6)).copy()
            Zi = np.zeros((B, nw, 6, 6))
            Bd = rng.normal(size=(B, 6, 6))
            w = np.zeros(nw)
        else:  # singular: lane (0, 0) is diag(1, 1, 0, 1, 1, 1) at w = 0
            Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
            Zi = rng.normal(size=(B, nw, 6, 6))
            Zr[0, 0] = np.diag([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
            Zi[0, 0] = 0.0
            Bd = 0.1 * rng.normal(size=(B, 6, 6))
            w[0] = 0.0
        Fr = rng.normal(size=(B, nw, 6))
        Fi = rng.normal(size=(B, nw, 6))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.dev).to(dtype)

        return Cx(t(Zr), t(Zi)), t(w), t(Bd), Cx(t(Fr), t(Fi))

    def phase_k1(self):
        from raft_tpu_torch.core import cuda6, linalg6

        torch = self.torch
        rng = np.random.default_rng(20261016)
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            for B in (1000, 250):
                nw = 200
                worst = 0.0
                worst_abs = 0.0
                for case in ("random", "permutation", "singular"):
                    Z0, w, Bd, F = self._k1_inputs(case, B, nw, dtype, rng)
                    xk = cuda6.solve_rao(Z0, w, Bd, F)
                    xp = linalg6.solve_cx_fused(Z0, w, Bd, F)
                    torch.cuda.synchronize()
                    diff = max(float((xk.re - xp.re).abs().max()),
                               float((xk.im - xp.im).abs().max()))
                    scale = max(float(xp.re.abs().max()), float(xp.im.abs().max()))
                    finite = bool(torch.isfinite(xk.re).all() and torch.isfinite(xk.im).all())
                    rel = diff / scale
                    worst, worst_abs = max(worst, rel), max(worst_abs, diff)
                    self.check(finite and rel <= TOL[name],
                               f"K1 {name} {B}x{nw} {case}: scale-relative diff "
                               f"{rel:.3e} (limit {TOL[name]:.0e})")
                    if case == "permutation":
                        # P x = F exactly: x_{(i+1) % 6} = F_i
                        want_r = torch.roll(F.re, 1, dims=-1)
                        self.check(bool((xk.re == want_r).all()),
                                   f"K1 {name} {B}x{nw} permutation solved exactly")
                Z0, w, Bd, F = self._k1_inputs("random", B, nw, dtype, rng)
                Zc = torch.complex(Z0.re, Z0.im + w[:, None, None] * Bd[:, None])
                Fc = torch.complex(F.re, F.im)[..., None]
                ms = self.time_ms(lambda: cuda6.solve_rao(Z0, w, Bd, F))
                plain_ms = self.time_ms(lambda: linalg6.solve_cx_fused(Z0, w, Bd, F), reps=5)
                lib_ms = self.time_ms(lambda: torch.linalg.solve(Zc, Fc), reps=5)
                bound, by = k1_bound_ms(B, nw, torch.finfo(dtype).bits // 8, name)
                print(f"  K1 {name} {B}x{nw}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"torch.linalg.solve {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
                      f"max scale-rel diff {worst:.3e}, max abs diff {worst_abs:.3e}")
                if name == "float32" and B == 250:   # the sweep's call shape
                    self.record = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

    def phase_run_raft(self):
        from raft_tpu_torch.core import cuda6
        from raft_tpu_torch.model import run_raft

        torch = self.torch
        for d in ("OC3spar", "OC4semi", "VolturnUS-S"):
            path = DESIGNS / f"{d}.yaml"
            n0 = cuda6.LAUNCHES
            t0 = time.perf_counter()
            rg = run_raft(path, dtype=torch.float64, device="cuda")
            t_gpu = time.perf_counter() - t0
            grew = cuda6.LAUNCHES - n0
            t0 = time.perf_counter()
            rc = run_raft(path, dtype=torch.float64, device="cpu")
            t_cpu = time.perf_counter() - t0
            fg, fc = rg["eigen"]["frequencies"], rc["eigen"]["frequencies"]
            sg, sc = rg["response"]["std dev"], rc["response"]["std dev"]
            d_f = float(np.max(np.abs(fg - fc) / np.abs(fc)))
            d_s = float(np.max(np.abs(sg - sc)) / np.max(np.abs(sc)))
            ig, ic = rg["response"]["iterations"], rc["response"]["iterations"]
            print(f"  run_raft {d}: card {t_gpu:.2f} s, cpu {t_cpu:.2f} s, "
                  f"iterations {ig}/{ic}, K1 launches {grew}, fn rel diff {d_f:.2e}, "
                  f"std scale-rel diff {d_s:.2e}")
            print(f"    std dev (card): {np.array2string(sg, precision=6)}")
            self.check(d_f <= 1e-9 and d_s <= 1e-9 and ig == ic and grew > 0
                       and rg["response"]["converged"],
                       f"run_raft {d} card == cpu (1e-9, identical iterations, kernel launched)")

    def phase_sweep(self):
        from raft_tpu_torch.core import cuda6, linalg6
        from raft_tpu_torch.parallel.sweep import sweep_north_star_strip
        from raft_tpu_torch.solve import dynamics

        torch = self.torch
        n, nw, chunk = 1000, 200, 250
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda6.LAUNCHES = 0
        t0 = time.perf_counter()
        res = sweep_north_star_strip(n_designs=n, nw=nw, chunk=chunk, n_iter=40,
                                     dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda6.LAUNCHES
        self.record["launches"] = launches
        self.record["sweep_wall_ms"] = 1e3 * wall
        peak = torch.cuda.max_memory_allocated()
        std, it, conv = res["std"], res["n_iter"], res["converged"]
        n_conv = int(conv.sum())
        print(f"  sweep {n} x {nw} float32 (chunk {chunk}): wall {wall:.3f} s, "
              f"{n * nw / wall:.1f} solves/s, max iterations {int(it.max())}, "
              f"mean iterations {float(it.float().mean()):.2f}, K1 launches {launches}, "
              f"peak memory {peak / 2**20:.1f} MiB")
        self.check(n_conv == n and bool(torch.isfinite(std).all()) and launches > 0,
                   f"sweep: {n_conv}/{n} lanes converged, all finite, K1 launched")

        lanes = np.arange(0, n, n // 16)[:16]
        sub_k = sweep_north_star_strip(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                       device="cuda", lanes=lanes)
        orig = dynamics.solve_rao
        dynamics.solve_rao = linalg6.solve_cx_fused      # plain solve, same card
        try:
            sub_p = sweep_north_star_strip(n_designs=n, nw=nw, chunk=16,
                                           dtype=torch.float64, device="cuda", lanes=lanes)
        finally:
            dynamics.solve_rao = orig
        same_it = bool((sub_k["n_iter"] == sub_p["n_iter"]).all())
        d = float((sub_k["std"] - sub_p["std"]).abs().max() / sub_p["std"].abs().max())
        d32 = float((std[lanes].double() - sub_k["std"]).abs().max() / sub_k["std"].abs().max())
        print(f"  16-lane float64 subset: kernel vs plain std scale-rel diff {d:.2e}, "
              f"iterations {sub_k['n_iter'].tolist()}; float32 sweep vs float64 {d32:.2e}")
        self.check(same_it and d <= 1e-10,
                   "16-lane subset: kernel == plain (identical iterations, std 1e-10)")

    def phase_profile(self):
        """Where the sweep's time goes: a second, warm run of the full sweep
        under torch.profiler (its launches are not counted)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from raft_tpu_torch.parallel.sweep import sweep_north_star_strip

        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sweep_north_star_strip(n_designs=1000, nw=200, chunk=250, n_iter=40,
                                   dtype=torch.float32, device="cuda")
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)

        # device-side events only (kernels, copies): the CPU-side aten
        # entries carry their kernels' time too and would count it twice
        rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        n_dev = sum(r[1] for r in rows)
        k1_ms = sum(r[0] for r in rows if "solve6_fused" in r[2]) / 1e3
        wall = self.record.get("sweep_wall_ms", wall_ms)
        print(f"  profiled sweep: wall {wall_ms:.1f} ms with the profiler on, "
              f"{wall:.1f} ms without; device busy {busy_ms:.2f} ms in {n_dev} device "
              f"operations; idle share {1 - busy_ms / wall:.3f} of the unprofiled wall; "
              f"K1 {k1_ms:.3f} ms ({100 * k1_ms / busy_ms:.2f}% of device time)")
        for us, count, key in rows[:10]:
            print(f"    {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
        self.check(busy_ms > 0, "profiler saw device time")

    def run(self) -> int:
        torch = self.torch
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        print("card:", nvidia_smi(), flush=True)
        phases = [("build", self.phase_build), ("K1 vs plain", self.phase_k1),
                  ("run_raft", self.phase_run_raft), ("sweep", self.phase_sweep),
                  ("profile", self.phase_profile)]
        for name, fn in phases:
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:                       # a phase that raises has failed
                traceback.print_exc()
                self.failures.append(f"phase {name} raised")
            print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
        if self.failures:
            print("FAILED: " + "; ".join(self.failures), file=sys.stderr)
            return 1
        kernel = {
            "name": "solve6_fused", "route": "cuda",
            "source": "raft_tpu_torch/csrc/solve6.cu",
            "replaces": "raft_tpu/core/pallas6.py:213",
            "launches": self.record.get("launches", 0),
            **{k: self.record[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
        }
        print(json.dumps({"kernels": [kernel]}))
        print(nvidia_smi())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0


def main() -> int:
    if not (ROOT / "raft_tpu_torch").is_dir() or not DESIGNS.is_dir():
        print("chip_smoke.py must run from the root of a raft_tpu checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    return Smoke().run()


if __name__ == "__main__":
    sys.exit(main())
