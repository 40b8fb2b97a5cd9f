#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``raft_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure makes the script exit non-zero, and then it prints no
result line):

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles kernels K1/K2 (``csrc/solve6.cu``), K3
   (``csrc/bem_rankine.cu``) and K4 (``csrc/bem_wave.cu``) of
   ``raft_tpu_torch`` with one nvcc each, all at once, prints ptxas'
   registers and spills (kept beside each library, so a run that only loads
   a built library prints them too), and builds (or loads) the BEM
   wave-integral tables into ``raft_tpu_torch/_build/``;
3. K1 against its plain PyTorch version on the card, numpy-seeded inputs at
   the sweep's call shape (250 designs x 200 frequencies) and at 1,000 x 200,
   in float64 and float32: random systems, a permutation matrix with w = 0
   (forces pivoting, solved exactly), one singular lane (zero-denominator
   guard) and a pivot-tie batch (equal |.|^2 in the pivot column; float64
   bit for bit); the adjoint mode against the forward mode on materialized
   transposes (bit for bit); with kernel, plain-version and
   ``torch.linalg.solve`` times beside the bound;
4. K2 against its plain version at ``bench.py::pallas6_microbench``'s shape
   (16,384 diagonally dominant systems) in float64 and float32, with the
   same permutation, singular, pivot-tie and adjoint-mode cases; then the
   microbench itself, K2's path, with its launches counted;
5. the adjoints of K1 and K2 (``solve_rao_ad``, ``solve_cx_ad``) against
   autograd through the plain elimination on the card, float64, at the
   sweep's call shape;
6. the gradient guard: K1, K2, K3 and K4 called on the card with an input
   that requires grad raise and name the scan driver, launching nothing,
   as does ``forward_response(method="while")`` under autograd; the
   default driver (scan) differentiates 4 north-star lanes through K1 and
   its adjoint;
7. K3 (Rankine assembly) against its plain version on the VolturnUS-S hull
   (1,024-panel class) and the OC4semi hull with its waterplane lid
   (2,048 class), float64 and float32, with the pairs per subdivision level:
   two calls give the same bits, the kernel's near pass takes as many pairs
   as ``pair_levels`` puts on a level of 36 or more points, and one call
   under the profiler runs K3's kernel alone (no copy, cast or sync);
8. K4 (wave part) against its plain version on the same meshes, on a deep
   (1.5 rad/s) and a finite-depth (0.4 rad/s, 200 m) frequency chunk, and on
   every chunk of the north star's 48-frequency staging grid (one line per
   chunk: frequencies, deep or finite depth, the image evaluations per
   region of the wave integrals, kernel time against the bound); then K3
   and K4 at a panel count off the 64-panel classes (850, the hull
   unpadded);
9. ``run_raft`` on OC3spar, OC4semi and VolturnUS-S on the card in float64
   against the same run on the CPU (plain path);
10. the strip-theory north-star sweep at full size (1,000 VolturnUS-S
   variants x 200 frequencies, float32) with its K1 launches counted, then
   a 16-lane subset in float64 through the kernel and through the plain
   solve on the card;
11. ``Model(BEM="jax")`` on VolturnUS-S and OC4semi at full width in float64,
   once through K3/K4 and once through their plain versions on the card;
   and the VolturnUS-S panel solve in float32 against float64;
12. the BEM-staged north star with the panel solve on the card, whose K1,
   K3 and K4 launches are counted: the nominal hull's panel solve at 48
   frequencies in float64, interpolated to 200 and staged, then the
   1,000 x 200 sweep in float32; then a 16-lane float64 subset through K1
   and through the plain solve;
13. native BEM staging, the north star as ``bench.py`` stages it: the host
   C++ solver (``raft_tpu_torch/native/bem.cpp``, built with g++, its wave
   table built or loaded, both timed) solves the 850-panel hull at 48
   frequencies and 200 m depth cold (no result cache), with the host's
   core count printed; the card's staging (K3/K4) is held against it at
   ``PARITY_RTOL``; then the 1,000 x 200 float32 sweep runs on the
   native-staged coefficients, every lane converged;
14. the co-design gradient, whose K1 forward and adjoint launches are
   counted: ``grad_nacelle_accel_std`` of the 1,000 VolturnUS-S plan-radius
   x draft variants x 200 frequencies (float32, the card-staged BEM, scan
   loop at 25 iterations, chunks of 250), with the forward-only time beside
   it; then a 4-lane float64 subset through the kernels and through the
   plain solve, and against central differences;
15. ``optimize_design`` (6 Adam steps) on VolturnUS-S with the staged BEM,
   and the OC3spar mooring-knob gradient on the card against the CPU;
16. the sweeps and one gradient chunk again under ``torch.profiler``: device
   busy time, idle share and the operations that take the device time; the
   gradient chunk must run at least 75 device operations fewer than the same
   chunk with the adjoint's transposed copies, profiled in the same call.

Every BEM solve here passes ``cache=False``, so each phase runs its
solver and no result is read from the on-disk cache.

``--phases a,b`` runs only the named phases (for debugging; the names are
those printed after ``==``).  The last lines are the kernels JSON record,
the nvidia-smi line and ``{"ok": true, "device": {...}}``.  A kernel's
``ms`` in the record is its mean device time between two events with the
host's time to enqueue the call left out (:meth:`Smoke.time_ms`);
``plain_ms`` and ``library_ms`` are timed the same way.
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

# device clock cycles of the spin queued before each timed call (about 1 ms)
SPIN_CYCLES = 2_000_000
# H100 SXM peaks: HBM3 bytes/s and non-tensor-core FLOP/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
TOL = {"float64": 1e-12, "float32": 1e-5}
# adjoint cotangents and co-design gradients, kernels against autograd
# through the plain elimination (float64): the JAX package's bound between
# its adjoint rule and its differentiated elimination (tests/test_pallas6.py)
TOL_GRAD = 1e-9
# central differences of the scan objective, h = 1e-4 (tests/test_optimize.py)
FD_H, FD_RTOL = 1e-4, 2e-3
# K3 / K4 against their plain versions, scale-relative per output: f64 to
# roundoff; f32 at the JAX package's assembly-route bound INTERP_PARITY_RTOL
TOL_BEM = {"float64": {"rankine": 1e-12, "wave": 1e-10},
           "float32": {"rankine": 1e-4, "wave": 1e-4}}
# floating-point operations of K3's function, each add, subtract,
# multiply, negation, division, sqrt and rsqrt one (a fused multiply-add
# two), counted for the function and not for the kernel's layout: per
# pair of an unmasked source column, the two level selections and the
# store; per subdivision point position and weight, once per (unmasked
# source panel, point of a level that some pair of its column needs); per
# contribution, one point source (potential + normal derivative)
K3_FLOPS_PAIR, K3_FLOPS_POINT, K3_FLOPS_CONTRIB = 22, 28, 22
# a pair with a level of 36 or more points (level ids above 1) is a near
# pair: bem_rankine.cu's kFarLevel, for the check of its near-pass count
K3_FAR_LEVEL = 1
# counted from bem_wave.cu: each add, subtract and multiply is one
# operation (a fused multiply-add two), and so is each division, sqrt,
# rsqrt and transcendental call (exp, log, log1p, atan2; sin and cos one
# each, a sincos pair one); clamps, selects and shuffles are not counted,
# and a sum over the 16 nodes counts its 15 adds.  Per image evaluation of
# the wave integrals by region: near = 16 nodes x 105 (Horner series,
# log, atan2, 1/|zeta|^2, the two weighted node terms) + the two node
# sums + the finish; table, far (Bessel Y0/Y1 asymptotics), deep tail.
# K4_FLOPS_NEAR_PAIR: the 16 nodes' X sin(theta_q) and sincos, once per
# pair and frequency with any near image.  K4_FLOPS_DEEP: the deep-water
# Green function around its one image (region test, e^Y, J0, J1);
# K4_FLOPS_FD: the finite-depth one around its four images (per image 28:
# region test, e^Y, pole part), 46 fit terms x 52, the "1" parts, the
# radiated part and the seabed image; K4_FLOPS_COMBINE: the four outputs;
# K4_FLOPS_PAIR: R, R_eff, once per pair and launch
K4_FLOPS_REGION = {"near": 16 * 105 + 30 + 12, "table": 39, "far": 60, "deep": 11}
K4_FLOPS_NEAR_PAIR = 32
K4_FLOPS_DEEP, K4_FLOPS_FD, K4_FLOPS_COMBINE, K4_FLOPS_PAIR = 90, 277 + 46 * 52, 20, 8


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


def k2_bound_ms(n: int, itemsize: int, dtype_name: str):
    """Least time of one K2 call: 96 values per system (A and b read, x
    written) against K1's operations less the 72 of the drag assembly."""
    t_bytes = itemsize * n * 96 / HBM_BYTES_PER_S
    t_ops = n * (k1_flops_per_system() - 72) / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_work(c, diag, panel_mask, lid_surface, itemsize: int, dtype_name: str) -> dict:
    """Pairs per level (``hist``), contributions per pair, near pairs (a
    level of 36 or more points), operations and bytes of K3's function on
    these inputs, and its bound (``bound_ms``, ``bound_by``)."""
    import torch

    from raft_tpu_torch.hydro import torch_bem

    n = c.shape[0]
    sel_d, sel_i = torch_bem.pair_levels(c, diag, lid_surface)
    count = torch.tensor((0,) + torch_bem.LEVEL_COUNT, device=c.device)   # id -1 -> 0
    cd, ci = count[sel_d.long() + 1], count[sel_i.long() + 1]
    near = (sel_d > K3_FAR_LEVEL) | (sel_i > K3_FAR_LEVEL)
    col = (panel_mask > 0.5)[None, :]
    points = sum(int((((sel_d == lv) | (sel_i == lv)) & col).any(dim=0).sum()) * nq
                 for lv, nq in enumerate(torch_bem.LEVEL_COUNT))
    contribs = int((cd + ci).sum())
    flops = (n * int(col.sum()) * K3_FLOPS_PAIR + points * K3_FLOPS_POINT
             + int(((cd + ci) * col).sum()) * K3_FLOPS_CONTRIB)
    nbytes = itemsize * (12 * n + 3 * n + 3 * n + 4 * n + 3 * 766 + 2 * n * n) + n
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S
    hist = {"direct": torch.bincount(sel_d.flatten().long() + 1, minlength=6).tolist()[1:5],
            "image": torch.bincount(sel_i.flatten().long() + 1, minlength=6).tolist()[1:]}
    return {"hist": hist, "per_pair": contribs / (n * n), "near_pairs": int(near.sum()),
            "near_share": float((cd + ci)[near].sum()) / contribs, "mflop": flops / 1e6,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k4_work(c, area, lid_surface, k, fd, depth: float, itemsize: int, dtype_name: str) -> dict:
    """Operations and bytes of one K4 call on these inputs (each pair's
    region of the wave integrals, per image and frequency), and its bound:
    ``bound_ms``, ``bound_by``, ``ops_ms``, ``bytes_ms`` and ``regions``,
    the image evaluations per region."""
    import torch

    from raft_tpu_torch.hydro import wavetable

    n, nf = c.shape[0], k.shape[0]
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    R = torch.sqrt(dx * dx + dy * dy + 1e-20)
    diag_lid = torch.eye(n, dtype=torch.bool, device=c.device) & lid_surface[None, :]
    R_use = torch.where(diag_lid, 0.4 * torch.sqrt(torch.clamp(area, min=1e-14))[None, :], R)
    zP, zQ = c[:, 2][:, None], c[:, 2][None, :]
    regions = dict.fromkeys(("near", "table", "far", "deep"), 0)

    def split(X, Ys):
        """Region counts of the images Ys at X; pairs with any near image."""
        any_near = torch.zeros_like(X, dtype=torch.bool)
        for Y in Ys:
            rho = torch.sqrt(X * X + Y * Y + 1e-18)
            near = rho < 0.6
            far = ~near & (X >= wavetable.XMAX * (1.0 - 1e-7))
            deep = ~near & ~far & (torch.log1p(-Y) >= wavetable.SMAX * (1.0 - 1e-7))
            for key, sel in (("near", near), ("far", far), ("deep", deep),
                             ("table", ~near & ~far & ~deep)):
                regions[key] += int(sel.sum())
            any_near |= near
        return int(any_near.sum())

    flops = K4_FLOPS_PAIR * n * n
    for i in range(nf):
        if fd is not None and float(fd["active"][i]) > 0.5:
            k0 = float(fd["k0"][i])
            d4 = (-(zP + zQ), 2 * depth - (zP - zQ), 2 * depth + (zP - zQ), 4 * depth + (zP + zQ))
            near_pairs = split(k0 * R_use, [-k0 * d.expand(n, n) for d in d4])
            flops += K4_FLOPS_FD * n * n
        else:
            kk = float(k[i])
            near_pairs = split(kk * R_use, [kk * (zP + zQ)])
            flops += K4_FLOPS_DEEP * n * n
        flops += K4_FLOPS_COMBINE * n * n + K4_FLOPS_NEAR_PAIR * near_pairs
    flops += sum(K4_FLOPS_REGION[key] * cnt for key, cnt in regions.items())
    nbytes = itemsize * (2 * n * n + 9 * n + 2 * wavetable.NX * wavetable.NS + 44
                         + nf * (4 + 2 * 46) + 4 * nf * n * n)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": 1e3 * t_ops, "bytes_ms": 1e3 * t_bytes, "regions": regions}


def tie_systems(n: int, rng) -> np.ndarray:
    """(n, 6, 6) complex systems whose pivot search ties: at column 0 rows 0
    and 1 (the pivot row itself in the tie), at column 2 rows 3 and 5 (row
    2's entry is smaller).  In each pair one entry is the other with re and
    im swapped, so |.|^2 rounds to the same value when each product and sum
    rounds on its own, as in the plain version and the kernel.  Every row
    of the eliminated U keeps at most one entry right of its diagonal, so
    the back substitution's sums are exact in any order: the kernel must
    equal the plain version bit for bit, and a tie broken to the other
    row changes the bits of nearly every lane."""
    def cx():
        return rng.normal(size=n) + 1j * rng.normal(size=n)

    def swap(z):
        return z.imag + 1j * z.real

    A = np.zeros((n, 6, 6), complex)
    p, P = cx(), 2.0 * cx()
    A[:, 0, 0], A[:, 0, 1] = p, cx()
    A[:, 1, 0], A[:, 1, 1] = swap(p), cx()
    A[:, 2, 2], A[:, 2, 3] = 0.3 * P, cx()
    A[:, 3, 2], A[:, 3, 4] = P, cx()
    A[:, 4, 3] = 4.0 * (np.abs(A[:, 2, 3]) + 1.0) * np.exp(1j * rng.uniform(0.0, 2 * np.pi, n))
    A[:, 5, 2], A[:, 5, 5] = swap(P), cx()
    return A


def print_ptxas(name: str, log: str):
    """Registers and spills per kernel entry from a build's ptxas output,
    each entry labelled by its template arguments: the type, and for
    solve6 fused or plain and forward or adjoint."""
    import re

    kind = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"_kernelI([df])(?:Lb([01])E)?(?:Lb([01])E)?", line)
            kind = "" if m is None else ("f64" if m[1] == "d" else "f32")
            if m is not None and m[2] is not None:
                kind += (" fused" if m[2] == "1" else " plain") + (" adjoint" if m[3] == "1" else "")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name} {kind}: {line.split(':', 1)[-1].strip()}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


class Smoke:
    # the north star's full width: the co-design phases run at these sizes
    n_designs, nw, chunk = 1000, 200, 250

    def __init__(self):
        import torch

        self.torch = torch
        self.failures: list[str] = []
        self.record: dict = {}
        self.records: dict = {}
        self.record_bem: dict = {}
        self.main_launches: dict = {}
        self.record_grad: dict = {}
        self.staged = None
        self.staged_std = None
        self.record_native: dict = {}
        self._cases: dict = {}
        self.dev = torch.device("cuda")
        self._flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=self.dev)

    # -------------------------------------------------------------- helpers

    def check(self, ok: bool, what: str):
        print(("  ok   " if ok else "  FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def time_ms(self, fn, reps: int = 20) -> float:
        """Mean device time of fn(), each call after an L2 flush (64 MB) and
        a device spin of SPIN_CYCLES queued ahead of the start event, so the
        host's time to enqueue fn() (its wrapper's checks, small setup ops)
        is not inside the interval and a short kernel is timed alone."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self._flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
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
        from raft_tpu_torch.core import cuda6, cuda_bem, nvcc
        from raft_tpu_torch.hydro import wavetable

        t0 = time.perf_counter()
        nvcc.compile_all([cuda6.SPEC, cuda_bem.RANKINE, cuda_bem.WAVE])
        cuda6.build()
        cuda_bem.build()
        print(f"  K1/K2, K3, K4 built in {time.perf_counter() - t0:.2f} s (one nvcc each, in "
              f"parallel)")
        for spec in (cuda6.SPEC, cuda_bem.RANKINE, cuda_bem.WAVE):
            log = nvcc.build_log(spec)
            if log is None:
                print(f"  ptxas {spec.name}: no log beside {spec.path().name}")
            else:
                print_ptxas(spec.name, log)
        t0 = time.perf_counter()
        tab = wavetable.load_tables()
        print(f"  wave tables {tab['I0'].shape} ready in {time.perf_counter() - t0:.2f} s "
              f"(built, or loaded from raft_tpu_torch/_build/wavetable/)")

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
        elif case == "pivot-tie":
            Z = tie_systems(B * nw, rng).reshape(B, nw, 6, 6)
            Zr, Zi = Z.real, Z.imag
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
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        rng = np.random.default_rng(20261016)
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            for B in (1000, 250):
                nw = 200
                worst = 0.0
                worst_abs = 0.0
                for case in ("random", "permutation", "singular", "pivot-tie"):
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
                    if case == "singular":
                        self.check(float(xk.re[0, 0, 2]) == 0.0 and float(xk.im[0, 0, 2]) == 0.0,
                                   f"K1 {name} {B}x{nw} singular lane takes the "
                                   f"zero-denominator guard")
                    if case == "pivot-tie":
                        same = bool(torch.equal(xk.re, xp.re) and torch.equal(xk.im, xp.im))
                        if name == "float64":
                            self.check(same, f"K1 float64 {B}x{nw} pivot-tie batch: kernel == "
                                       f"plain bit for bit (the lowest row wins the tie)")
                        else:
                            print(f"  K1 float32 {B}x{nw} pivot-tie batch bit for bit: {same}")
                    # the adjoint mode reads Z0^H and -B_drag^T in place: the
                    # same bits as the forward mode on materialized transposes
                    lam = cuda6.solve_rao_adjoint(Z0, w, Bd, F)
                    ZH = Cx(Z0.re.transpose(-1, -2).contiguous(),
                            (-Z0.im.transpose(-1, -2)).contiguous())
                    lam_m = cuda6.solve_rao(ZH, w, (-Bd.transpose(-1, -2)).contiguous(), F)
                    torch.cuda.synchronize()
                    self.check(bool(torch.equal(lam.re, lam_m.re) and torch.equal(lam.im, lam_m.im)),
                               f"K1 {name} {B}x{nw} {case}: adjoint mode == forward mode on the "
                               f"materialized Z0^H, -B_drag^T (bit for bit)")
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

    def _k2_inputs(self, case: str, n: int, dtype, rng):
        """``bench.py::pallas6_microbench``'s systems (diagonally dominant:
        A.re = N(0, 1) + 8 I, A.im = 0.3 N(0, 1)), a permutation batch, or
        the microbench's systems with one singular lane."""
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        if case == "permutation":
            P = np.zeros((6, 6))
            P[np.arange(6), (np.arange(6) + 1) % 6] = 1.0
            Ar = np.broadcast_to(P, (n, 6, 6)).copy()
            Ai = np.zeros((n, 6, 6))
        elif case == "pivot-tie":
            A = tie_systems(n, rng)
            Ar, Ai = A.real, A.imag
        else:
            Ar = rng.normal(size=(n, 6, 6)) + 8.0 * np.eye(6)
            Ai = 0.3 * rng.normal(size=(n, 6, 6))
            if case == "singular":          # lane 0: diag(1, 1, 0, 1, 1, 1)
                Ar[0] = np.diag([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
                Ai[0] = 0.0

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.dev).to(dtype)

        return Cx(t(Ar), t(Ai)), Cx(t(rng.normal(size=(n, 6))), t(rng.normal(size=(n, 6))))

    def phase_k2(self):
        from raft_tpu_torch.core import cuda6, linalg6
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        rng = np.random.default_rng(20261017)
        n = 16384
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            worst, worst_abs = 0.0, 0.0
            for case in ("random", "permutation", "singular", "pivot-tie"):
                A, b = self._k2_inputs(case, n, dtype, rng)
                xk = cuda6.solve_cx(A, b)
                xp = linalg6.solve_cx(A, b)
                torch.cuda.synchronize()
                diff = max(float((xk.re - xp.re).abs().max()), float((xk.im - xp.im).abs().max()))
                scale = max(float(xp.re.abs().max()), float(xp.im.abs().max()))
                finite = bool(torch.isfinite(xk.re).all() and torch.isfinite(xk.im).all())
                worst, worst_abs = max(worst, diff / scale), max(worst_abs, diff)
                self.check(finite and diff / scale <= TOL[name],
                           f"K2 {name} {n} {case}: scale-relative diff {diff / scale:.3e} "
                           f"(limit {TOL[name]:.0e})")
                if case == "permutation":
                    self.check(bool((xk.re == torch.roll(b.re, 1, dims=-1)).all()),
                               f"K2 {name} {n} permutation solved exactly")
                if case == "singular":
                    self.check(float(xk.re[0, 2]) == 0.0 and float(xk.im[0, 2]) == 0.0,
                               f"K2 {name} singular lane takes the zero-denominator guard")
                if case == "pivot-tie":
                    same = bool(torch.equal(xk.re, xp.re) and torch.equal(xk.im, xp.im))
                    if name == "float64":
                        self.check(same, f"K2 float64 {n} pivot-tie batch: kernel == plain bit "
                                   f"for bit (the lowest row wins the tie)")
                    else:
                        print(f"  K2 float32 {n} pivot-tie batch bit for bit: {same}")
                lam = cuda6.solve_cx_adjoint(A, b)
                AH = Cx(A.re.transpose(-1, -2).contiguous(), (-A.im.transpose(-1, -2)).contiguous())
                lam_m = cuda6.solve_cx(AH, b)
                torch.cuda.synchronize()
                self.check(bool(torch.equal(lam.re, lam_m.re) and torch.equal(lam.im, lam_m.im)),
                           f"K2 {name} {n} {case}: adjoint mode == forward mode on the "
                           f"materialized A^H (bit for bit)")
            A, b = self._k2_inputs("random", n, dtype, rng)
            Ac = torch.complex(A.re, A.im)
            bc = torch.complex(b.re, b.im)[..., None]
            ms = self.time_ms(lambda: cuda6.solve_cx(A, b))
            plain_ms = self.time_ms(lambda: linalg6.solve_cx(A, b), reps=5)
            lib_ms = self.time_ms(lambda: torch.linalg.solve(Ac, bc), reps=5)
            bound, by = k2_bound_ms(n, torch.finfo(dtype).bits // 8, name)
            print(f"  K2 {name} {n} systems: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.linalg.solve ({Ac.dtype}) {lib_ms:.4f} ms, bound {bound:.5f} ms "
                  f"({by}); max scale-rel diff {worst:.3e}, max abs diff {worst_abs:.3e}")
            if name == "float32":               # the microbench's shape
                self.records["plain"] = {"max_abs_err": worst_abs, "ms": ms,
                                         "plain_ms": plain_ms, "bound_ms": bound,
                                         "bound_by": by, "library_ms": lib_ms}

    def phase_k2_microbench(self):
        """K2's path: ``bench.py::pallas6_microbench`` on the port -- the
        16,384 solves in float32 through ``cuda6.solve_cx`` against the plain
        elimination, best of 5 on the host clock."""
        from raft_tpu_torch.core import cuda6, linalg6

        torch = self.torch
        A, b = self._k2_inputs("random", 16384, torch.float32, np.random.default_rng(0))
        best = {}
        self.zero_counts()
        for label, fn in (("kernel", cuda6.solve_cx), ("plain", linalg6.solve_cx)):
            x = fn(A, b)
            torch.cuda.synchronize()
            t_best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                x = fn(A, b)
                torch.cuda.synchronize()
                t_best = min(t_best, time.perf_counter() - t0)
            best[label] = (t_best, x)
        launches = self.counts()
        self.main_launches["plain"] = launches["plain"]
        xk, xp = best["kernel"][1], best["plain"][1]
        err = float((xk.re - xp.re).abs().max() + (xk.im - xp.im).abs().max())
        print(f"  microbench 16384 x 6x6 float32: kernel {1e3 * best['kernel'][0]:.4f} ms, "
              f"plain {1e3 * best['plain'][0]:.4f} ms (best of 5, host clock), speedup "
              f"{best['plain'][0] / best['kernel'][0]:.1f}x, max abs diff {err:.3e}; "
              f"launches {launches}")
        self.check(launches["plain"] == 6 and launches["fused"] == 0 and err <= 1e-4,
                   "microbench: K2 launched 6 times, agrees with the plain solve")

    def _adjoint_case(self, fn, arrays):
        """Cotangents of the asymmetric loss sum(xr^2 + 0.7 xi^2 + 0.3 xr xi)
        through ``fn``."""
        torch = self.torch
        ts = [a.clone().requires_grad_(True) for a in arrays]
        x = fn(*ts)
        loss = (x.re**2 + 0.7 * x.im**2 + 0.3 * x.re * x.im).sum()
        return torch.autograd.grad(loss, ts)

    def phase_adjoint(self):
        from raft_tpu_torch.core import cuda6, linalg6
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        rng = np.random.default_rng(20261018)
        Z0, w, Bd, F = self._k1_inputs("random", 250, 200, torch.float64, rng)
        arrays = (Z0.re, Z0.im, w, Bd, F.re, F.im)
        self.zero_counts()
        got = self._adjoint_case(lambda zr, zi, w, bd, fr, fi: cuda6.solve_rao_ad(
            Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
        n_rao = self.counts()
        ref = self._adjoint_case(lambda zr, zi, w, bd, fr, fi: linalg6.solve_cx_fused(
            Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
        errs = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
        print(f"  solve_rao_ad float64 250x200: cotangent scale-rel diffs (Z0.re, Z0.im, w, "
              f"B_drag, F.re, F.im) {', '.join(f'{e:.2e}' for e in errs)}; launches {n_rao}")
        self.check(max(errs) <= TOL_GRAD and n_rao["fused"] == 1 and n_rao["fused_adjoint"] == 1,
                   f"K1 adjoint == autograd through the plain elimination ({TOL_GRAD:.0e}), "
                   f"one forward and one adjoint launch")
        A = Cx(Z0.re.reshape(-1, 6, 6), (Z0.im + w[:, None, None] * Bd[:, None]).reshape(-1, 6, 6))
        b = Cx(F.re.reshape(-1, 6), F.im.reshape(-1, 6))
        arrays = (A.re, A.im, b.re, b.im)
        self.zero_counts()
        got = self._adjoint_case(lambda ar, ai, br, bi: cuda6.solve_cx_ad(Cx(ar, ai), Cx(br, bi)),
                                 arrays)
        n_cx = self.counts()
        ref = self._adjoint_case(lambda ar, ai, br, bi: linalg6.solve_cx(Cx(ar, ai), Cx(br, bi)),
                                 arrays)
        errs = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
        print(f"  solve_cx_ad float64 50000 systems: cotangent scale-rel diffs (A.re, A.im, b.re, "
              f"b.im) {', '.join(f'{e:.2e}' for e in errs)}; launches {n_cx}")
        self.check(max(errs) <= TOL_GRAD and n_cx["plain"] == 1 and n_cx["plain_adjoint"] == 1,
                   f"K2 adjoint == autograd through the plain elimination ({TOL_GRAD:.0e}), "
                   f"one forward and one adjoint launch")

    def _bem_case(self, name: str, lid: bool, dtype):
        """A shipped design's panel mesh (dz_max 3, da_max 2), padded, and
        its geometry on the card: the K3 arguments."""
        from raft_tpu_torch.hydro import mesh, torch_bem
        from raft_tpu_torch.model import load_design

        key = (name, lid, dtype)
        if key not in self._cases:
            torch = self.torch
            design = load_design(DESIGNS / f"{name}.yaml")
            hull = mesh.mesh_design(design, dz_max=3.0, da_max=2.0)
            lid_p = mesh.mesh_lid(design, da_max=2.0) if lid else None
            padded, pm, lm = torch_bem.pad_mesh(hull, lid_p)

            def t(a):
                return torch.as_tensor(a, device=self.dev).to(dtype)

            P, pmt, lmt = t(padded), t(pm), t(lm)
            c, nrm, area, diag = torch_bem.panel_geometry(P)
            ls = (lmt > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
            spot = torch_bem.self_potential(P, c, nrm)
            self._cases[key] = {
                "args": (P, c, nrm, area, diag, pmt, ls, spot), "n": len(padded),
                "quad": torch_bem.stage_quad(dtype, self.dev),
                "label": f"{name}{' + lid' if lid else ''} ({len(hull)} hull + "
                         f"{0 if lid_p is None else len(lid_p)} lid -> {len(padded)})",
                "depth": float(design["mooring"]["water_depth"])}
        return self._cases[key]

    def _errs(self, got, ref):
        """(largest scale-relative, largest absolute) difference over outputs."""
        rel = max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
                  for g, r in zip(got, ref))
        return rel, max(float((g - r).abs().max()) for g, r in zip(got, ref))

    def phase_k3(self):
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem

        torch = self.torch
        for name, lid in (("VolturnUS-S", False), ("OC4semi", True)):
            for dtype in (torch.float64, torch.float32):
                dn = str(dtype).split(".")[-1]
                case = self._bem_case(name, lid, dtype)
                args = case["args"]
                quad = case["quad"]
                near = torch.zeros(1, dtype=torch.int32, device=self.dev)
                got = cuda_bem.rankine_assembly(*args, quad=quad, near_count=near)
                again = cuda_bem.rankine_assembly(*args, quad=quad)
                ref = torch_bem.rankine_plain(*args, quad=quad)
                torch.cuda.synchronize()
                rel, ab = self._errs(got, ref)
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                lim = TOL_BEM[dn]["rankine"]
                self.check(finite and rel <= lim, f"K3 {dn} {case['label']}: scale-relative "
                           f"diff {rel:.3e} (limit {lim:.0e})")
                wk = k3_work(args[1], args[4], args[5], args[6], torch.finfo(dtype).bits // 8, dn)
                same = all(torch.equal(g, h) for g, h in zip(got, again))
                self.check(same and int(near.item()) == wk["near_pairs"],
                           f"K3 {dn} n={case['n']}: two calls give the same bits ({same}); "
                           f"the near pass took {int(near.item())} pairs, pair_levels has "
                           f"{wk['near_pairs']} with a level of 36 or more points")
                ms = self.time_ms(lambda: cuda_bem.rankine_assembly(*args, quad=quad))
                plain_ms = self.time_ms(lambda: torch_bem.rankine_plain(*args, quad=quad), reps=2)
                print(f"  K3 {dn} n={case['n']}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                      f"bound {wk['bound_ms']:.4f} ms ({wk['bound_by']}; {wk['mflop']:.1f} MFLOP); "
                      f"{wk['per_pair']:.2f} contributions per pair, {wk['near_share']:.3f} of "
                      f"them in near pairs; pairs per level (ns 1/3/6/12[/24]) direct "
                      f"{wk['hist']['direct']}, image {wk['hist']['image']}; max abs diff "
                      f"{ab:.3e}")
                if name == "VolturnUS-S" and dtype == torch.float64:   # the staging's call
                    self.records["rankine"] = {"max_abs_err": ab, "ms": ms, "plain_ms": plain_ms,
                                               "bound_ms": wk["bound_ms"],
                                               "bound_by": wk["bound_by"], "library_ms": None}
                    self._k3_alone(args, quad)

    def _k3_alone(self, args, quad):
        """One wrapper call under the profiler: its one device operation is
        K3's kernel (no copy, no cast), and it makes no copy and no stream
        synchronisation on the host side either."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from raft_tpu_torch.core import cuda_bem

        torch = self.torch
        cuda_bem.rankine_assembly(*args, quad=quad)        # outputs' memory is cached now
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cuda_bem.rankine_assembly(*args, quad=quad)
            torch.cuda.synchronize()
        events = prof.events()
        device = [e.name for e in events if e.device_type == DeviceType.CUDA]
        host = sorted({e.name for e in events if e.device_type != DeviceType.CUDA})
        bad = [h for h in host if any(part in h for part in (
            "Memcpy", "Memset", "StreamSynchronize", "EventSynchronize", "aten::copy_",
            "aten::_to_copy"))]
        print(f"  K3 one wrapper call under the profiler: device operations {device}; host "
              f"events {host}")
        self.check(len(device) == 1 and "rankine_kernel" in device[0] and not bad,
                   f"K3's wrapper runs its kernel alone: {len(device)} device operation(s), "
                   f"no copy, cast or stream synchronisation ({bad or 'none'})")

    def phase_k4(self):
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem, wavetable

        torch = self.torch
        tab = wavetable.load_tables()
        for name, lid in (("VolturnUS-S", False), ("OC4semi", True)):
            for dtype in (torch.float64, torch.float32):
                dn = str(dtype).split(".")[-1]
                case = self._bem_case(name, lid, dtype)
                P, c, nrm, area, diag, pm, ls, spot = case["args"]
                R_pot, R_dn = torch_bem.rankine_plain(*case["args"], quad=case["quad"])
                tabd = torch_bem.stage_tables(tab, dtype, self.dev)
                nf = torch_bem.freq_chunk(case["n"], 48)
                depth = case["depth"]
                for label, w0 in (("deep", 1.5), ("finite-depth", 0.4)):
                    ws = w0 + 0.02 * np.arange(nf)
                    fd_np = wavetable.fd_fit_grid(ws, depth, 9.81)
                    want_active = 1.0 if label == "finite-depth" else 0.0
                    if not (fd_np["active"] == want_active).all():
                        self.check(False, f"K4 {label} chunk {ws} has active {fd_np['active']}")
                        continue
                    fd = {k: torch.as_tensor(v, device=self.dev).to(dtype) for k, v in fd_np.items()}
                    k = torch.as_tensor(ws * ws / 9.81, device=self.dev).to(dtype)
                    wargs = (R_pot, R_dn, c, nrm, area, pm, ls, tabd, k, fd)
                    kw = {"finite_depth": True, "depth": depth}
                    got = cuda_bem.wave_assembly(*wargs, **kw)
                    ref = torch_bem.wave_plain(*wargs, **kw)
                    torch.cuda.synchronize()
                    rel, ab = self._errs(got, ref)
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    lim = TOL_BEM[dn]["wave"]
                    self.check(finite and rel <= lim, f"K4 {dn} {case['label']} {label} "
                               f"{nf} x w: scale-relative diff {rel:.3e} (limit {lim:.0e})")
                    ms = self.time_ms(lambda: cuda_bem.wave_assembly(*wargs, **kw))
                    plain_ms = self.time_ms(lambda: torch_bem.wave_plain(*wargs, **kw), reps=2)
                    wk = k4_work(c, area, ls, k, fd, depth, torch.finfo(dtype).bits // 8, dn)
                    print(f"  K4 {dn} n={case['n']} {label} ({nf} x w from {w0}): kernel "
                          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {wk['bound_ms']:.4f} ms "
                          f"({wk['bound_by']}; operations {wk['ops_ms']:.4f} ms, bytes "
                          f"{wk['bytes_ms']:.4f} ms); max abs diff {ab:.3e}")
        self._k4_main_path()
        self._unaligned(tab)

    def _unaligned(self, tab):
        """K3 and K4 at a panel count off the 64-panel classes (the
        VolturnUS-S hull unpadded, 850 panels): the kernels guard the edge
        of the pair grid, and solve_panels launches them at any count."""
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem, wavetable

        torch = self.torch
        case = self._bem_case("VolturnUS-S", False, torch.float64)
        n = int(case["args"][5].sum())
        args = tuple(a[:n] for a in case["args"])
        got = cuda_bem.rankine_assembly(*args, quad=case["quad"])
        ref = torch_bem.rankine_plain(*args, quad=case["quad"])
        rel_r, _ = self._errs(got, ref)
        ws = 0.4 + 0.02 * np.arange(2)
        fd = {k: torch.as_tensor(v, device=self.dev) for k, v in
              wavetable.fd_fit_grid(ws, case["depth"], 9.81).items()}
        k = torch.as_tensor(ws * ws / 9.81, device=self.dev)
        P, c, nrm, area, diag, pm, ls, spot = args
        wargs = (ref[0], ref[1], c, nrm, area, pm, ls,
                 torch_bem.stage_tables(tab, torch.float64, self.dev), k, fd)
        kw = {"finite_depth": True, "depth": case["depth"]}
        rel_w, _ = self._errs(cuda_bem.wave_assembly(*wargs, **kw),
                              torch_bem.wave_plain(*wargs, **kw))
        self.check(n % 64 != 0 and rel_r <= TOL_BEM["float64"]["rankine"]
                   and rel_w <= TOL_BEM["float64"]["wave"],
                   f"K3/K4 float64 at an unaligned count n={n}: scale-relative diff "
                   f"{rel_r:.3e} / {rel_w:.3e}")

    def _staging_chunks(self, dtype):
        """The north star's staging calls of K4 (VolturnUS-S, 1,024 class,
        48 w in 200 m): (inputs, keywords, w of the chunk) per chunk."""
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem, wavetable

        torch = self.torch
        case = self._bem_case("VolturnUS-S", False, dtype)
        P, c, nrm, area, diag, pm, ls, spot = case["args"]
        R_pot, R_dn = cuda_bem.rankine_assembly(*case["args"], quad=case["quad"])
        tabd = torch_bem.stage_tables(wavetable.load_tables(), dtype, self.dev)
        w = np.linspace(0.05, 2.95, 48)
        nf = torch_bem.freq_chunk(case["n"], len(w))
        fd_all = wavetable.fd_fit_grid(w, case["depth"], 9.81)
        kw = {"finite_depth": True, "depth": case["depth"]}
        chunks = []
        for lo in range(0, len(w), nf):
            sl = slice(lo, lo + nf)
            fd = {k: torch.as_tensor(v[sl], device=self.dev).to(dtype) for k, v in fd_all.items()}
            k = torch.as_tensor(w[sl] ** 2 / 9.81, device=self.dev).to(dtype)
            chunks.append(((R_pot, R_dn, c, nrm, area, pm, ls, tabd, k, fd), kw, w[sl]))
        return chunks

    def _k4_main_path(self):
        """K4 at the main path's calls: every chunk of the north star's
        staging (VolturnUS-S, 1,024 class, 48 w, 200 m, float64), one line
        per chunk with its pairs' regions."""
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem

        dtype = self.torch.float64
        depth = self._bem_case("VolturnUS-S", False, dtype)["depth"]
        ms, plain_ms, bound, t_ops, t_bytes, rel, ab, n_fd = [], [], [], 0.0, 0.0, 0.0, 0.0, 0
        for idx, (wargs, kw, wc) in enumerate(self._staging_chunks(dtype)):
            got = cuda_bem.wave_assembly(*wargs, **kw)
            ref = torch_bem.wave_plain(*wargs, **kw)
            r, a = self._errs(got, ref)
            rel, ab = max(rel, r), max(ab, a)
            ms.append(self.time_ms(lambda: cuda_bem.wave_assembly(*wargs, **kw), reps=5))
            plain_ms.append(self.time_ms(lambda: torch_bem.wave_plain(*wargs, **kw), reps=1))
            c, area, ls, k, fd = wargs[2], wargs[4], wargs[6], wargs[8], wargs[9]
            wk = k4_work(c, area, ls, k, fd, depth, 8, "float64")
            bound.append(wk["bound_ms"])
            t_ops, t_bytes = t_ops + wk["ops_ms"], t_bytes + wk["bytes_ms"]
            act = fd["active"].cpu().numpy()
            n_fd += int(act.sum())
            kind = "finite depth" if act.all() else ("deep" if not act.any() else "mixed")
            tot = sum(wk["regions"].values())
            shares = ", ".join(f"{key} {v / tot:.3f}" for key, v in wk["regions"].items())
            print(f"  K4 staging chunk {idx:2d}: w {wc[0]:.4f}-{wc[-1]:.4f} rad/s, {kind}; image "
                  f"evaluations {tot} ({shares}); kernel {ms[-1]:.4f} ms, bound "
                  f"{wk['bound_ms']:.4f} ms ({wk['bound_by']}), {ms[-1] / wk['bound_ms']:.1f}x; "
                  f"scale-rel diff {r:.2e}")
        lim = TOL_BEM["float64"]["wave"]
        self.check(rel <= lim, f"K4 float64 on all {len(ms)} staging chunks: scale-relative "
                   f"diff {rel:.3e} (limit {lim:.0e})")
        print(f"  K4 float64 staging grid ({len(ms)} chunks, {n_fd} of 48 w finite depth): "
              f"kernel {np.mean(ms):.4f} ms per chunk (min {min(ms):.4f}, max {max(ms):.4f}), "
              f"plain {np.mean(plain_ms):.2f} ms, bound {np.mean(bound):.4f} ms (operations "
              f"{t_ops / len(ms):.4f}, bytes {t_bytes / len(ms):.4f}); max abs diff {ab:.3e}")
        self.records["wave"] = {"max_abs_err": ab, "ms": float(np.mean(ms)),
                                "plain_ms": float(np.mean(plain_ms)),
                                "bound_ms": float(np.mean(bound)),
                                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                                "library_ms": None}

    def phase_run_raft(self):
        from raft_tpu_torch.model import run_raft

        torch = self.torch
        for d in ("OC3spar", "OC4semi", "VolturnUS-S"):
            path = DESIGNS / f"{d}.yaml"
            self.zero_counts()
            t0 = time.perf_counter()
            rg = run_raft(path, dtype=torch.float64, device="cuda")
            t_gpu = time.perf_counter() - t0
            grew = self.counts()["fused"]
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
        from raft_tpu_torch.core import linalg6
        from raft_tpu_torch.parallel.sweep import sweep_north_star
        from raft_tpu_torch.solve import dynamics

        torch = self.torch
        n, nw, chunk = 1000, 200, 250
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        res = sweep_north_star(n_designs=n, nw=nw, chunk=chunk, n_iter=40,
                               dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.counts()["fused"]
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
        sub_k = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                 device="cuda", lanes=lanes)
        orig = dynamics.solve_rao
        dynamics.solve_rao = linalg6.solve_cx_fused      # plain solve, same card
        try:
            sub_p = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                     device="cuda", lanes=lanes)
        finally:
            dynamics.solve_rao = orig
        same_it = bool((sub_k["n_iter"] == sub_p["n_iter"]).all())
        d = float((sub_k["std"] - sub_p["std"]).abs().max() / sub_p["std"].abs().max())
        d32 = float((std[lanes].double() - sub_k["std"]).abs().max() / sub_k["std"].abs().max())
        print(f"  16-lane float64 subset: kernel vs plain std scale-rel diff {d:.2e}, "
              f"iterations {sub_k['n_iter'].tolist()}; float32 sweep vs float64 {d32:.2e}")
        self.check(same_it and d <= 1e-10,
                   "16-lane subset: kernel == plain (identical iterations, std 1e-10)")

    def counts(self) -> dict:
        """Every kernel wrapper's launch count, by entry."""
        from raft_tpu_torch.core import cuda6, cuda_bem

        return {**cuda6.LAUNCHES, **cuda_bem.LAUNCHES}

    def zero_counts(self):
        from raft_tpu_torch.core import cuda6, cuda_bem

        for counts in (cuda6.LAUNCHES, cuda_bem.LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))

    def _model(self, design, dtype, full: bool = True):
        """``Model(BEM="jax")`` through run_raft's steps on the card; returns
        the model and the calcBEM wall-clock (ending in a synchronise)."""
        from raft_tpu_torch.model import Model

        torch = self.torch
        m = Model(design, BEM="jax", dtype=dtype, device="cuda")
        m.setEnv(Hs=8.0, Tp=12.0, V=10.0, beta=0.0,
                 Fthrust=float(design.get("turbine", {}).get("Fthrust", 0.0)))
        t0 = time.perf_counter()
        m.calcBEM(cache=False)
        torch.cuda.synchronize()
        t_bem = time.perf_counter() - t0
        if full:
            m.calcSystemProps()
            m.solveEigen()
            m.calcMooringAndOffsets()
            m.solveDynamics()
            m.calcOutputs()
        return m, t_bem

    def phase_model_bem(self):
        from raft_tpu_torch.hydro import torch_bem
        from raft_tpu_torch.model import load_design

        torch = self.torch
        for name in ("VolturnUS-S", "OC4semi"):
            design = load_design(DESIGNS / f"{name}.yaml")
            runs = {}
            for route in ("kernels", "plain"):
                self.zero_counts()
                orig = torch_bem.rankine_assembly, torch_bem.wave_assembly
                if route == "plain":                 # plain assembly, same card
                    torch_bem.rankine_assembly = torch_bem.rankine_plain
                    torch_bem.wave_assembly = torch_bem.wave_plain
                try:
                    t0 = time.perf_counter()
                    m, t_bem = self._model(design, torch.float64)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    torch_bem.rankine_assembly, torch_bem.wave_assembly = orig
                grew = {k: v for k, v in self.counts().items() if k in ("fused", "rankine", "wave")}
                runs[route] = (m, t_bem, wall, grew)
            (mk, tk, wk, gk), (mp, tp, wp, gp) = runs["kernels"], runs["plain"]
            d_abf = max(torch_bem.parity_err(a, b) for a, b in zip(mk.bem, mp.bem))
            fk, fp = mk.results["eigen"]["frequencies"], mp.results["eigen"]["frequencies"]
            sk, sp = mk.results["response"]["std dev"], mp.results["response"]["std dev"]
            d_f = float(np.max(np.abs(fk - fp) / np.abs(fp)))
            d_s = torch_bem.parity_err(sk, sp)
            ik, ip = mk.results["response"]["iterations"], mp.results["response"]["iterations"]
            diag = mk.bem_diagnostics
            print(f"  Model(BEM='jax') {name} float64: {diag['panels']} panels -> "
                  f"{diag['padded']}, {diag['nw']} w; calcBEM {tk:.2f} s with K3/K4, {tp:.2f} s "
                  f"plain; whole run {wk:.2f} s / {wp:.2f} s; launches {gk} (plain run {gp}); "
                  f"A/B/F scale-rel diff {d_abf:.2e}, fn rel diff {d_f:.2e}, std scale-rel diff "
                  f"{d_s:.2e}, iterations {ik}/{ip}, max refinement residual "
                  f"{diag['max_residual']:.2e}")
            print(f"    natural frequencies [Hz]: {np.array2string(fk, precision=5)}; "
                  f"std dev: {np.array2string(sk, precision=5)}")
            self.check(d_abf <= 1e-10 and d_f <= 1e-9 and d_s <= 1e-9 and ik == ip
                       and all(gk[k] > 0 for k in gk) and gp["rankine"] == gp["wave"] == 0
                       and diag["max_residual"] < 1e-4 and mk.results["response"]["converged"],
                       f"Model(BEM='jax') {name}: kernels == plain (A/B/F 1e-10, fn and std "
                       f"1e-9, identical iterations), K1/K3/K4 launched, residual < 1e-4")
            if name == "VolturnUS-S":
                m32, t32 = self._model(design, torch.float32, full=False)
                d32 = max(torch_bem.parity_err(a, b) for a, b in zip(m32.bem, mk.bem))
                print(f"  VolturnUS-S panel solve float32 vs float64: A/B/F scale-rel diff "
                      f"{d32:.3e} (PARITY_RTOL {torch_bem.PARITY_RTOL}); calcBEM {t32:.2f} s; "
                      f"refinement residual {m32.bem_diagnostics['max_residual']:.2e}")
                self.check(d32 <= torch_bem.PARITY_RTOL,
                           f"VolturnUS-S float32 panel solve within PARITY_RTOL of float64")

    def phase_north_star_bem(self):
        from raft_tpu_torch.core import linalg6
        from raft_tpu_torch.parallel.sweep import stage_north_star_bem, sweep_north_star
        from raft_tpu_torch.solve import dynamics

        torch = self.torch
        n, nw, chunk = 1000, 200, 250
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        staged, diag = stage_north_star_bem(nw=nw, nw_bem=48, mode="jax", cache=False,
                                            dtype=torch.float64, device="cuda",
                                            return_diagnostics=True)
        torch.cuda.synchronize()
        t_stage = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = sweep_north_star(n_designs=n, nw=nw, chunk=chunk, n_iter=40, dtype=torch.float32,
                               device="cuda", bem=staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in self.counts().items() if k in ("fused", "rankine", "wave")}
        self.main_launches.update(rankine=launches["rankine"], wave=launches["wave"])
        self.staged = staged
        self.staged_std = res["std"]
        peak = torch.cuda.max_memory_allocated()
        self.record_bem = {"stage_ms": 1e3 * t_stage, "sweep_wall_ms": 1e3 * wall}
        std, it, conv = res["std"], res["n_iter"], res["converged"]
        n_conv = int(conv.sum())
        print(f"  BEM staging: {diag['panels']} panels -> {diag['padded']}, {diag['nw']} w, "
              f"float64, {t_stage:.3f} s (panel solve {diag['seconds']:.3f} s), max refinement "
              f"residual {diag['max_residual']:.2e}")
        print(f"  BEM-staged sweep {n} x {nw} float32 (chunk {chunk}): wall {wall:.3f} s, "
              f"{n * nw / wall:.1f} solves/s, max iterations {int(it.max())}, mean iterations "
              f"{float(it.float().mean()):.2f}, launches {launches}, peak memory "
              f"{peak / 2**20:.1f} MiB")
        self.check(n_conv == n and bool(torch.isfinite(std).all())
                   and launches["fused"] > 0 and launches["rankine"] == 1
                   and launches["wave"] == 24,
                   f"BEM-staged sweep: {n_conv}/{n} lanes converged, all finite, K1 launched, "
                   f"K3 once, K4 once per chunk of 2 w")

        lanes = np.arange(0, n, n // 16)[:16]
        sub_k = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                 device="cuda", bem=staged, lanes=lanes)
        orig = dynamics.solve_rao
        dynamics.solve_rao = linalg6.solve_cx_fused      # plain solve, same card
        try:
            sub_p = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                     device="cuda", bem=staged, lanes=lanes)
        finally:
            dynamics.solve_rao = orig
        same_it = bool((sub_k["n_iter"] == sub_p["n_iter"]).all())
        d = float((sub_k["std"] - sub_p["std"]).abs().max() / sub_p["std"].abs().max())
        d32 = float((std[lanes].double() - sub_k["std"]).abs().max() / sub_k["std"].abs().max())
        print(f"  16-lane float64 subset: kernel vs plain std scale-rel diff {d:.2e}, "
              f"iterations {sub_k['n_iter'].tolist()}; float32 sweep vs float64 {d32:.2e}")
        print(f"    lane 0 std dev: {np.array2string(sub_k['std'][0].cpu().numpy(), precision=5)}")
        self.check(same_it and d <= 1e-10,
                   "BEM 16-lane subset: kernel == plain (identical iterations, std 1e-10)")

    def phase_grad_guard(self):
        """On the card the kernel wrappers refuse gradient work (their
        outputs carry no autograd history) and name the scan driver; the
        scan driver, the default of ``forward_response``, still
        differentiates through K1 and its adjoint."""
        from raft_tpu_torch.core import cuda6, cuda_bem
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.hydro import torch_bem, wavetable
        from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
        from raft_tpu_torch.parallel.sweep import (_volturnus, forward_response, north_star_grid,
                                                   response_std)

        torch = self.torch
        f64 = torch.float64
        rng = np.random.default_rng(20261019)
        Z0, w, Bd, F = self._k1_inputs("random", 4, 200, f64, rng)

        def refuses(name, call):
            self.zero_counts()
            try:
                call()
                msg = None
            except RuntimeError as e:
                msg = str(e)
            launched = {k: v for k, v in self.counts().items() if v}
            self.check(msg is not None and 'method="scan"' in msg and "solve_rao_ad" in msg
                       and not launched,
                       f"{name} with an input that requires grad raises and names the scan "
                       f"driver (launches {launched})")

        def grad(t):
            return t.clone().requires_grad_(True)

        refuses("K1 solve_rao", lambda: cuda6.solve_rao(Cx(grad(Z0.re), Z0.im), w, Bd, F))
        A = Cx(Z0.re.reshape(-1, 6, 6), Z0.im.reshape(-1, 6, 6))
        b = Cx(F.re.reshape(-1, 6), F.im.reshape(-1, 6))
        refuses("K2 solve_cx", lambda: cuda6.solve_cx(A, Cx(grad(b.re), b.im)))
        case = self._bem_case("VolturnUS-S", False, f64)
        args = list(case["args"])
        refuses("K3 rankine_assembly", lambda: cuda_bem.rankine_assembly(
            args[0], grad(args[1]), *args[2:], quad=case["quad"]))
        R_pot, R_dn = cuda_bem.rankine_assembly(*args, quad=case["quad"])
        tabd = torch_bem.stage_tables(wavetable.load_tables(), f64, self.dev)
        k = torch.as_tensor([1.5**2 / 9.81, 1.6**2 / 9.81], dtype=f64, device=self.dev)
        refuses("K4 wave_assembly", lambda: cuda_bem.wave_assembly(
            grad(R_pot), R_dn, *args[1:4], args[5], args[6], tabd, k, None,
            finite_depth=False, depth=0.0))

        _design, members, rna, env, wave, C = _volturnus(self.nw, f64, self.dev)
        draft, plan = make_stretch_draft(members), make_scale_plan(members)
        th = torch.as_tensor(north_star_grid(self.n_designs)[:4], dtype=f64,
                             device=self.dev).requires_grad_(True)
        m = plan(draft(members, th[:, 1]), th[:, 0])
        refuses("forward_response(method='while') under autograd", lambda: forward_response(
            m, rna, env, wave, C, n_iter=40, method="while", device=self.dev))
        self.zero_counts()
        out = forward_response(m, rna, env, wave, C, n_iter=25, device=self.dev)
        g = torch.autograd.grad(response_std(out.Xi.abs2(), wave.w)[:, 4].sum(), th)[0]
        n = self.counts()
        print(f"  default-driver gradient of 4 lanes' pitch std: {g.cpu().numpy().tolist()}; "
              f"launches {n}")
        self.check(bool(torch.isfinite(g).all()) and bool((g != 0).any())
                   and n["fused"] == 25 and n["fused_adjoint"] == 25,
                   "forward_response's default (scan) differentiates on the card: K1 forward "
                   "and adjoint once per step")

    def phase_native_bem(self):
        """The north star's BEM staged as bench.py stages it: the host C++
        solver, cold (no result cache), at 48 w on the full 850-panel mesh
        at 200 m depth, interpolated to 200 w and staged on the card; held
        against the card's staging (K3/K4) at PARITY_RTOL; then the
        1,000 x 200 float32 sweep on the native-staged coefficients."""
        import os

        from raft_tpu_torch.hydro import native_bem, torch_bem
        from raft_tpu_torch.parallel.sweep import stage_north_star_bem, sweep_north_star

        torch = self.torch
        n, nw, chunk = self.n_designs, self.nw, self.chunk
        cores = os.cpu_count()
        t0 = time.perf_counter()
        native_bem.build()
        t_lib = time.perf_counter() - t0
        had_table = native_bem.table_path().exists()
        t0 = time.perf_counter()
        native_bem.wave_integral(1.0, -1.0)              # loads or builds the table
        t_tab = time.perf_counter() - t0
        print(f"  native solver: g++ build {t_lib:.2f} s; wave table "
              f"{'loaded' if had_table else 'built'} in {t_tab:.2f} s "
              f"({native_bem.table_path().name}); host os.cpu_count() = {cores}")

        self.zero_counts()
        t0 = time.perf_counter()
        staged, diag = stage_north_star_bem(nw=nw, nw_bem=48, mode="native", cache=False,
                                            dtype=torch.float64, device=self.dev,
                                            return_diagnostics=True)
        torch.cuda.synchronize()
        t_native = time.perf_counter() - t0
        launched = {k: v for k, v in self.counts().items() if v}
        print(f"  native staging: {diag['panels']} panels x {diag['nw']} w, depth 200 m, f64 on "
              f"the host, cold: {t_native:.3f} s (solve {diag['seconds']:.3f} s) on "
              f"{cores} cores; launches {launched}")
        self.check(diag["route"] == "native" and not diag["cached"] and diag["panels"] == 850
                   and diag["nw"] == 48 and not launched,
                   "native staging: 850 panels x 48 w on the host, cold, no kernel launched")

        self.zero_counts()
        t0 = time.perf_counter()
        _card, diag_c = stage_north_star_bem(nw=nw, nw_bem=48, mode="jax", cache=False,
                                             dtype=torch.float64, device=self.dev,
                                             return_diagnostics=True)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches = self.counts()
        errs = [torch_bem.parity_err(c, h)
                for c, h in zip(diag_c["coeffs"][1:], diag["coeffs"][1:])]
        print(f"  card staging (K3/K4, f64): {t_card:.3f} s, launches K3 {launches['rankine']}, "
              f"K4 {launches['wave']}; against native, scale-relative: A {errs[0]:.3e}, "
              f"B {errs[1]:.3e}, F {errs[2]:.3e} (PARITY_RTOL {torch_bem.PARITY_RTOL})")
        self.check(max(errs) <= torch_bem.PARITY_RTOL and launches["rankine"] == 1
                   and launches["wave"] == 24,
                   "card staging within PARITY_RTOL of the native staging (A, B, F), K3 once, "
                   "K4 once per chunk")

        self.zero_counts()
        t0 = time.perf_counter()
        res = sweep_north_star(n_designs=n, nw=nw, chunk=chunk, n_iter=40, dtype=torch.float32,
                               device=self.dev, bem=staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sweep_launches = {k: v for k, v in self.counts().items() if v}
        std, it, conv = res["std"], res["n_iter"], res["converged"]
        n_conv = int(conv.sum())
        line = (f"  native-staged sweep {n} x {nw} float32 (chunk {chunk}): wall {wall:.3f} s, "
                f"{n * nw / wall:.1f} solves/s, max iterations {int(it.max())}, launches "
                f"{sweep_launches}")
        if self.staged_std is not None:
            d = float((std - self.staged_std).abs().max() / self.staged_std.abs().max())
            line += f"; std against the card-staged sweep: scale-rel diff {d:.3e}"
        print(line)
        self.check(n_conv == n and bool(torch.isfinite(std).all())
                   and sweep_launches.get("fused", 0) > 0
                   and set(sweep_launches) == {"fused"},
                   f"native-staged sweep: {n_conv}/{n} lanes converged, all finite, K1 launched")
        self.record_native = {"stage_s": t_native, "solve_s": diag["seconds"], "cores": cores,
                              "card_stage_s": t_card, "sweep_wall_s": wall}

    def _staged_bem(self):
        """The nominal hull's staged BEM of the BEM-staged north star (solved
        here when that phase did not run)."""
        if self.staged is None:
            from raft_tpu_torch.parallel.sweep import stage_north_star_bem

            self.staged = stage_north_star_bem(nw=self.nw, nw_bem=48, mode="jax", cache=False,
                                               dtype=self.torch.float64,
                                               device=self.dev)
        return self.staged

    def _codesign_setup(self, dtype):
        """The north star's design, sea state, mooring stiffness and staged
        BEM in ``dtype``, and its plan-radius x draft warp as ``apply_fn``."""
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
        from raft_tpu_torch.parallel.sweep import _volturnus

        _design, members, rna, env, wave, C = _volturnus(self.nw, dtype, self.dev)
        A, B, F = self._staged_bem()
        bem = (A.to(dtype), B.to(dtype), Cx(F.re.to(dtype), F.im.to(dtype)))
        draft, plan = make_stretch_draft(members), make_scale_plan(members)

        def apply_fn(m, th):
            return plan(draft(m, th[..., 1]), th[..., 0])

        return members, rna, env, wave, C, bem, apply_fn

    def phase_codesign(self):
        """The slice's main path: d sigma_nacelle / d (plan radius, draft) of
        every north-star variant, through the scan loop (K1 forward and K1
        on the adjoint system in every step)."""
        from raft_tpu_torch.core import linalg6
        from raft_tpu_torch.parallel.optimize import (_make_loss, grad_nacelle_accel_std,
                                                      nacelle_accel_std)
        from raft_tpu_torch.parallel.sweep import north_star_grid
        from raft_tpu_torch.solve import dynamics

        torch = self.torch
        n, chunk, n_iter = self.n_designs, self.chunk, 25
        grid = north_star_grid(n)
        members, rna, env, wave, C, bem, apply_fn = self._codesign_setup(torch.float32)
        thetas = torch.as_tensor(grid, dtype=torch.float32, device=self.dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        grads, chunk_s = [], []
        t_all = time.perf_counter()
        for lo in range(0, n, chunk):
            t0 = time.perf_counter()
            grads.append(grad_nacelle_accel_std(members, rna, env, wave, C, thetas[lo:lo + chunk],
                                                apply_fn=apply_fn, bem=bem, n_iter=n_iter,
                                                dtype=torch.float32, device=self.dev))
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all
        launches = self.counts()
        peak = torch.cuda.max_memory_allocated()
        self.main_launches.update(fused=launches["fused"],
                                  fused_adjoint=launches["fused_adjoint"])
        grad = torch.cat(grads)
        loss = _make_loss(members, rna, env, wave, C, nacelle_accel_std, apply_fn, bem, n_iter,
                          False, dtype=torch.float32, device=self.dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            sigma = loss(thetas[:chunk])
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        self.record_grad = {"chunk_ms": 1e3 * float(np.mean(chunk_s[1:] or chunk_s))}
        n_chunks = len(chunk_s)
        print(f"  co-design gradient {n} x {wave.w.shape[0]} float32 (chunk {chunk}, scan "
              f"{n_iter}): total {total:.3f} s, per chunk "
              f"{', '.join(f'{t:.3f}' for t in chunk_s)} s; forward only {fwd_s:.3f} s per chunk "
              f"(gradient / forward {np.mean(chunk_s[1:] or chunk_s) / fwd_s:.2f}); launches "
              f"{ {k: v for k, v in launches.items() if v} }; peak memory {peak / 2**30:.2f} GiB")
        print(f"    sigma_nacelle of the first chunk: {float(sigma.min()):.5f} .. "
              f"{float(sigma.max()):.5f}; d sigma / d (plan, draft) lane 0: "
              f"{grad[0].tolist()}, lane {n - 1}: {grad[-1].tolist()}")
        self.check(bool(torch.isfinite(grad).all()) and grad.shape == (n, 2)
                   and bool(torch.isfinite(sigma).all())
                   and launches["fused"] == n_iter * n_chunks
                   and launches["fused_adjoint"] == n_iter * n_chunks
                   and launches["plain"] == launches["plain_adjoint"] == 0,
                   f"co-design gradient: every lane finite, K1 {n_iter} forward and {n_iter} "
                   f"adjoint launches per chunk")

        lanes = np.linspace(0, n - 1, 4).astype(int).tolist()
        members, rna, env, wave, C, bem, apply_fn = self._codesign_setup(torch.float64)
        th = torch.as_tensor(grid[lanes], dtype=torch.float64, device=self.dev)
        args = (members, rna, env, wave, C, th)
        kw = dict(apply_fn=apply_fn, bem=bem, n_iter=n_iter, dtype=torch.float64, device=self.dev)
        gk = grad_nacelle_accel_std(*args, **kw)
        orig = dynamics.solve_rao_ad
        dynamics.solve_rao_ad = linalg6.solve_cx_fused   # autograd through the plain solve
        try:
            gp = grad_nacelle_accel_std(*args, **kw)
        finally:
            dynamics.solve_rao_ad = orig
        d_plain = float((gk - gp).abs().max() / gp.abs().max())
        loss = _make_loss(members, rna, env, wave, C, nacelle_accel_std, apply_fn, bem, n_iter,
                          False, dtype=torch.float64, device=self.dev)
        fd = torch.zeros_like(th)
        with torch.no_grad():
            for j in range(2):
                e = torch.zeros_like(th)
                e[:, j] = FD_H
                fd[:, j] = (loss(th + e) - loss(th - e)) / (2 * FD_H)
        d_fd = float(((gk - fd).abs().amax(dim=1) / fd.abs().amax(dim=1)).max())
        d32 = float((grad[lanes].double() - gk).abs().max() / gk.abs().max())
        print(f"  4-lane float64 subset (lanes {lanes}): kernels vs plain solve {d_plain:.2e}, vs "
              f"central differences (h {FD_H}) {d_fd:.2e} per-lane scale-relative; float32 "
              f"gradient vs float64 {d32:.2e}")
        print(f"    gradient {gk.tolist()}; differences {fd.tolist()}")
        self.check(d_plain <= TOL_GRAD and d_fd <= FD_RTOL,
                   f"4-lane float64 gradient: kernels == plain ({TOL_GRAD:.0e}), central "
                   f"differences ({FD_RTOL:.0e})")

    def _oc3(self, nw: int, dev):
        """OC3spar's members, RNA, sea state (JONSWAP Hs 8 m / Tp 12 s on
        ``linspace(0.05, 2.95, nw)``) and mooring system on ``dev``, float64."""
        import yaml

        torch = self.torch
        from raft_tpu_torch.build.members import build_member_set, build_rna
        from raft_tpu_torch.core.types import Env, WaveState
        from raft_tpu_torch.core.waves import jonswap, wave_number
        from raft_tpu_torch.mooring.system import parse_mooring

        dtype = torch.float64
        with open(DESIGNS / "OC3spar.yaml") as f:
            design = yaml.safe_load(f)
        depth = float(design["mooring"]["water_depth"])
        w = torch.as_tensor(np.linspace(0.05, 2.95, nw), dtype=dtype, device=dev)
        wave = WaveState(w=w, k=wave_number(w, depth), zeta=torch.sqrt(jonswap(w, 8.0, 12.0)))
        moor = parse_mooring(design["mooring"], dev, dtype,
                             yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0))
        return (build_member_set(design, dev, dtype), build_rna(design),
                Env(Hs=8.0, Tp=12.0, depth=depth), wave, moor)

    def phase_optimize(self):
        from raft_tpu_torch.mooring.system import scale_mooring
        from raft_tpu_torch.parallel.optimize import _make_loss, nacelle_accel_std, optimize_design
        from raft_tpu_torch.parallel.sweep import _volturnus

        torch = self.torch
        _design, members, rna, env, wave, C = _volturnus(self.nw, torch.float64, self.dev)
        self.zero_counts()
        t0 = time.perf_counter()
        res = optimize_design(members, rna, env, wave, C, theta0=1.0, steps=6,
                              learning_rate=0.02, bounds=(0.8, 1.25), bem=self._staged_bem(),
                              n_iter=25, device=self.dev)
        wall = time.perf_counter() - t0
        launches = self.counts()
        print(f"  optimize_design VolturnUS-S (scale_diameters, staged BEM, float64, 6 Adam "
              f"steps): {wall:.2f} s; objective {np.array2string(res.history, precision=6)}; "
              f"theta {np.array2string(res.thetas, precision=5)}; launches K1 "
              f"{launches['fused']} / adjoint {launches['fused_adjoint']}")
        self.check(bool(np.isfinite(res.history).all()) and res.history[-1] < res.history[0]
                   and 0.8 <= float(res.theta) <= 1.25 and launches["fused_adjoint"] == 7 * 25,
                   "optimize_design: the objective falls, theta stays in bounds, K1 adjoint "
                   "launched every step")

        grads = []
        for dev in (self.dev, torch.device("cpu")):
            members, rna, env, wave, moor = self._oc3(59, dev)
            loss = _make_loss(members, rna, env, wave, None, nacelle_accel_std,
                              lambda m, t: m, None, 25, False, moor=moor,
                              moor_apply_fn=scale_mooring, device=dev)
            th = torch.ones(3, dtype=torch.float64, device=dev, requires_grad=True)
            t0 = time.perf_counter()
            (g,) = torch.autograd.grad(loss(th), th)
            grads.append((g.cpu(), time.perf_counter() - t0))
        (gc, tc), (gh, th_s) = grads
        d = float((gc - gh).abs().max() / gh.abs().max())
        print(f"  OC3spar mooring knobs (L, R, EA) at ones(3), 59 w: d sigma_nacelle / d theta "
              f"card {gc.tolist()} in {tc:.2f} s, cpu {gh.tolist()} in {th_s:.2f} s; scale-rel "
              f"diff {d:.2e}")
        self.check(d <= TOL_GRAD and bool(torch.isfinite(gc).all()) and bool((gc != 0).all()),
                   f"mooring-knob gradient card == cpu ({TOL_GRAD:.0e}), every knob moves")

    def _profile(self, label: str, fn, kernels: dict, wall_key: tuple, split: str | None = None):
        """Where a run's time goes: a second, warm run under torch.profiler
        (its launches are not counted).  ``kernels`` maps a label to the
        substrings of a kernel's name; with ``split``, the name of a
        ``record_function`` range that ``fn`` opens after a synchronise, each
        kernel's time is also split into before and after that range.  Only
        device activity is traced unless ``split`` needs the host's ranges:
        the host's events are most of what the profiler has to process."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if split else [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        t_post = time.perf_counter()

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)

        def matches(name, parts):
            return all(part in name for part in parts)

        # device-side events only (kernels, copies): the CPU-side aten
        # entries carry their kernels' time too and would count it twice
        rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        n_dev = sum(r[1] for r in rows)
        rec, key = wall_key
        wall = sum(rec.get(k, 0.0) for k in key) or wall_ms
        boundary = None
        if split is not None:
            events = prof.events()
            boundary = min(e.time_range.start for e in events if e.name == split)
        shares = []
        for kname, parts in kernels.items():
            k_ms = sum(r[0] for r in rows if matches(r[2], parts)) / 1e3
            share = f"{kname} {k_ms:.3f} ms ({100 * k_ms / busy_ms:.2f}% of device time)"
            if boundary is not None:
                before = after = 0.0
                for e in events:
                    if e.device_type == DeviceType.CUDA and matches(e.name, parts):
                        dur = e.time_range.elapsed_us() / 1e3
                        if e.time_range.start >= boundary:
                            after += dur
                        else:
                            before += dur
                share += (f" [before '{split}' {before:.3f} ms = {100 * before / busy_ms:.2f}%, "
                          f"after {after:.3f} ms = {100 * after / busy_ms:.2f}%]")
            shares.append(share)
        print(f"  profiled {label}: wall {wall_ms:.1f} ms with the profiler on, "
              f"{wall:.1f} ms without; device busy {busy_ms:.2f} ms in {n_dev} device "
              f"operations; idle share {1 - busy_ms / wall:.3f} of the unprofiled wall; "
              + "; ".join(shares)
              + f" (the profiler's processing {time.perf_counter() - t_post:.1f} s)")
        for us, count, name in rows[:10]:
            print(f"    {us / 1e3:9.3f} ms  {count:6d}x  {name[:90]}")
        self.check(busy_ms > 0, f"profiler saw device time ({label})")
        return n_dev

    def phase_profile(self):
        from torch.profiler import record_function

        from raft_tpu_torch.core import cuda6
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.parallel.optimize import _make_loss, nacelle_accel_std
        from raft_tpu_torch.parallel.sweep import (north_star_grid, stage_north_star_bem,
                                                   sweep_north_star)

        torch = self.torch
        # solve6_kernel<T, FUSED, ADJOINT>: K1 is FUSED, forward and adjoint
        K1, K3, K4 = ("solve6_kernel", ", true, "), ("rankine_kernel",), ("wave_kernel",)

        def strip():
            sweep_north_star(n_designs=1000, nw=200, chunk=250, n_iter=40,
                             dtype=torch.float32, device="cuda")

        def bem():
            staged = stage_north_star_bem(nw=200, nw_bem=48, mode="jax", cache=False,
                                          dtype=torch.float64, device="cuda")
            sweep_north_star(n_designs=1000, nw=200, chunk=250, n_iter=40,
                             dtype=torch.float32, device="cuda", bem=staged)

        members, rna, env, wave, C, staged, apply_fn = self._codesign_setup(torch.float32)
        loss = _make_loss(members, rna, env, wave, C, nacelle_accel_std, apply_fn, staged, 25,
                          False, dtype=torch.float32, device=self.dev)
        th = torch.as_tensor(north_star_grid(self.n_designs)[:self.chunk], dtype=torch.float32, device=self.dev)

        def grad_chunk():
            t = th.clone().requires_grad_(True)
            val = loss(t)
            torch.cuda.synchronize()
            with record_function("codesign backward"):
                torch.autograd.grad(val.sum(), t)

        self._profile("strip sweep", strip, {"K1": K1}, (self.record, ("sweep_wall_ms",)))
        self._profile("BEM staging + BEM-staged sweep", bem, {"K1": K1, "K3": K3, "K4": K4},
                      (self.record_bem, ("stage_ms", "sweep_wall_ms")))
        label = f"co-design gradient, one chunk of {self.chunk} x {self.nw}"
        n_dev = self._profile(label, grad_chunk, {"K1": K1}, (self.record_grad, ("chunk_ms",)),
                              split="codesign backward")

        # the same chunk with the adjoint solve on materialized Z0^T, -Z0.im^T
        # and -B_drag^T (what the kernel's adjoint mode reads in place): the
        # count moves by tens between calls, so both runs share this call
        def with_copies(Z0, w, B_drag, G):
            ZH = Cx(Z0.re.transpose(-1, -2).contiguous(), (-Z0.im.transpose(-1, -2)).contiguous())
            return cuda6.solve_rao(ZH, w, (-B_drag.transpose(-1, -2)).contiguous(), G)

        orig = cuda6.solve_rao_adjoint
        cuda6.solve_rao_adjoint = with_copies
        try:
            n_copies = self._profile(label + " with the adjoint's transposed copies", grad_chunk,
                                     {"K1": K1}, (self.record_grad, ("chunk_ms",)),
                                     split="codesign backward")
        finally:
            cuda6.solve_rao_adjoint = orig
        self.check(n_copies - n_dev >= 75,
                   f"gradient chunk: {n_dev} device operations, {n_copies - n_dev} fewer than "
                   f"with the transposed copies ({n_copies}; at least 3 copies x 25 adjoint "
                   f"launches)")

    def run(self, only=None) -> int:
        torch = self.torch
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        print("card:", nvidia_smi(), flush=True)
        self.check(torch.backends.cuda.matmul.allow_tf32 is False,
                   "TF32 matmul is off (PyTorch's default; the port never turns it on)")
        phases = [("build", self.phase_build), ("K1 vs plain", self.phase_k1),
                  ("K2 vs plain", self.phase_k2), ("K2 microbench", self.phase_k2_microbench),
                  ("adjoints", self.phase_adjoint),
                  ("gradient guard", self.phase_grad_guard),
                  ("K3 vs plain", self.phase_k3), ("K4 vs plain", self.phase_k4),
                  ("run_raft", self.phase_run_raft), ("sweep", self.phase_sweep),
                  ("Model(BEM='jax')", self.phase_model_bem),
                  ("BEM-staged north star", self.phase_north_star_bem),
                  ("native BEM staging", self.phase_native_bem),
                  ("co-design gradient", self.phase_codesign),
                  ("optimize_design", self.phase_optimize),
                  ("profile", self.phase_profile)]
        if only is not None:
            unknown = set(only) - {name for name, _ in phases}
            if unknown:
                print(f"unknown phases {sorted(unknown)}", file=sys.stderr)
                return 2
            phases = [(name, fn) for name, fn in phases if name in only]
        t_run = time.perf_counter()
        for name, fn in phases:
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:                       # a phase that raises has failed
                traceback.print_exc()
                self.failures.append(f"phase {name} raised")
            print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
        print(f"all phases: {time.perf_counter() - t_run:.1f} s", flush=True)
        if self.failures:
            print("FAILED: " + "; ".join(self.failures), file=sys.stderr)
            return 1
        if only is not None:
            print("subset of phases run: no result line", file=sys.stderr)
            return 4
        fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels = [
            {"name": "solve6_fused", "route": "cuda", "source": "raft_tpu_torch/csrc/solve6.cu",
             "replaces": "raft_tpu/core/pallas6.py:213",
             "launches": self.main_launches["fused"] + self.main_launches["fused_adjoint"],
             "launches_forward": self.main_launches["fused"],
             "launches_adjoint": self.main_launches["fused_adjoint"],
             **{k: self.record[k] for k in fields}},
            {"name": "solve6_plain", "route": "cuda", "source": "raft_tpu_torch/csrc/solve6.cu",
             "replaces": "raft_tpu/core/pallas6.py:202",
             "launches": self.main_launches["plain"],
             **{k: self.records["plain"][k] for k in fields}},
            {"name": "bem_rankine", "route": "cuda",
             "source": "raft_tpu_torch/csrc/bem_rankine.cu",
             "replaces": "raft_tpu/core/pallas_bem.py:103",
             "launches": self.main_launches["rankine"],
             **{k: self.records["rankine"][k] for k in fields}},
            {"name": "bem_wave", "route": "cuda", "source": "raft_tpu_torch/csrc/bem_wave.cu",
             "replaces": "raft_tpu/core/pallas_bem.py:255",
             "launches": self.main_launches["wave"],
             **{k: self.records["wave"][k] for k in fields}},
        ]
        print(json.dumps({"kernels": kernels}))
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
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        only = [name.strip() for name in sys.argv[2].split(",")]
    elif len(sys.argv) != 1:
        print("usage: python3 chip_smoke.py [--phases name,name,...]", file=sys.stderr)
        return 2
    return Smoke().run(only)


if __name__ == "__main__":
    sys.exit(main())
