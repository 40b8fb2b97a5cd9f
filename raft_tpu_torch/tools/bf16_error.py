"""Where the bf16 assembly's error in the card's staging comes from.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 -m raft_tpu_torch.tools.bf16_error

The bf16 mode (``RAFT_TPU_BEM_PRECISION=bf16``) rounds four things to
bfloat16 before or after the assembly: the panel geometry (vertices,
centroids, normals, areas, diagonals, masks, self potentials), the wave
tables and quadrature, the wavenumbers and finite-depth fit arrays, and
the assembled matrices (R_pot, R_dn, S, Dn).  The kernels' bf16 entries
compute in float32 between, so rounding a chosen subset of those to
bfloat16 and back around the float32 kernels reproduces the mode with only
that subset rounded (all four together is the mode itself, up to the
kernels' float32 differences).  For each subset the tool stages the
nominal VolturnUS-S hull as ``stage_north_star_bem(mode="jax",
dtype=float32)`` does (850 panels, 48 w, 200 m) and prints A, B and F
against the float32 staging (``parity_err``) and F's error per frequency
band.  About half a minute on the card.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

PARTS = ("geometry", "tables", "wavenumbers", "outputs")


@contextlib.contextmanager
def rounded(parts):
    """K3 and K4, as a float32 panel solve calls them, with the inputs and
    outputs of ``parts`` rounded to bfloat16 and back."""
    from raft_tpu_torch.hydro import torch_bem

    orig = torch_bem.rankine_assembly, torch_bem.wave_assembly

    def pick(on, x):
        return torch_bem._cast(torch_bem._cast(x, torch.bfloat16), torch.float32) if on else x

    def rankine(pans, c, nrm, area, diag, mask, lid_surface, self_pot, *, quad):
        geo = pick("geometry" in parts, (pans, c, nrm, area, diag, mask, self_pot))
        out = orig[0](*geo[:6], lid_surface, geo[6], quad=pick("tables" in parts, quad))
        return pick("outputs" in parts, out)

    def wave(R_pot, R_dn, c, nrm, area, mask, lid_surface, tab, k, fd, **kw):
        c, nrm, area, mask = pick("geometry" in parts, (c, nrm, area, mask))
        k, fd = pick("wavenumbers" in parts, (k, fd))
        out = orig[1](R_pot, R_dn, c, nrm, area, mask, lid_surface,
                      pick("tables" in parts, tab), k, fd, **kw)
        return pick("outputs" in parts, out)

    torch_bem.rankine_assembly, torch_bem.wave_assembly = rankine, wave
    try:
        yield
    finally:
        torch_bem.rankine_assembly, torch_bem.wave_assembly = orig


def stage(parts=(), precision="f32"):
    """The nominal hull's coefficients at 48 w (host layout), staged on the
    card in float32 with ``parts`` rounded, and the wall-clock."""
    from raft_tpu_torch.parallel.sweep import stage_north_star_bem

    with rounded(parts):
        t0 = time.perf_counter()
        _staged, diag = stage_north_star_bem(nw=200, nw_bem=48, mode="jax", cache=False,
                                             dtype=torch.float32, device="cuda",
                                             return_diagnostics=True, precision=precision)
        torch.cuda.synchronize()
    return diag["coeffs"], time.perf_counter() - t0


def main() -> int:
    from raft_tpu_torch.hydro.torch_bem import parity_err

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool runs on the card")
        return 2
    ref, _ = stage()
    w, F_ref = ref[0], ref[3]
    scale = np.abs(F_ref).max()
    bands = [(0.0, 0.6), (0.6, 1.2), (1.2, 2.0), (2.0, 3.0)]
    print(f"{'rounded to bf16':<34} {'A':>9} {'B':>9} {'F':>9}   F error / max|F| by w band "
          + " ".join(f"[{lo}, {hi})" for lo, hi in bands))
    cases = [(f"{p} only", (p,), "f32") for p in PARTS]
    cases += [("all but geometry", tuple(p for p in PARTS if p != "geometry"), "f32"),
              ("all four (emulated)", PARTS, "f32"), ("the bf16 mode (kernels)", (), "bf16")]
    for label, parts, prec in cases:
        got, wall = stage(parts, prec)
        errs = [parity_err(g, r) for g, r in zip(got[1:], ref[1:])]
        dF = np.abs(got[3] - F_ref).max(axis=0) / scale            # (nw,)
        band = [dF[(w >= lo) & (w < hi)].max() for lo, hi in bands]
        print(f"{label:<34} {errs[0]:9.3e} {errs[1]:9.3e} {errs[2]:9.3e}   "
              + " ".join(f"{b:9.3e}" for b in band) + f"   ({wall:.2f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
