"""Kernel K3 timed in turns against the port's first K3 source on the card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 -m raft_tpu_torch.tools.k3_compare --old path/to/bem_rankine.cu

K3 (``raft_tpu_torch/csrc/bem_rankine.cu`` through
``cuda_bem.rankine_assembly``) is built as the port builds it, and the
port's first K3 source beside it (``--old``: lid flags in the working
type, no near-pair counter, no workspace; e.g. ``git show
94ae16b:raft_tpu_torch/csrc/bem_rankine.cu``) with the port's flags and
``-fmad=false``, as it was built.

Both run behind a wrapper that stages the quadrature and casts the lid
flags once, outside the timed call, so each timed call is the kernel
alone.  On the VolturnUS-S hull (850 panels, the 1,024 class of the BEM
staging) and the OC4semi hull with its waterplane lid (the 2,048 class),
in float64 and float32, both are held against the plain version and
timed in turns (each in order, then in reverse order; 20 calls each,
after an L2 flush and a device spin queued ahead of the start event).
ptxas' registers and spills are printed per build.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from raft_tpu_torch.core import cuda_bem, nvcc
from raft_tpu_torch.hydro import mesh, torch_bem
from raft_tpu_torch.model import load_design
from raft_tpu_torch.tools.k1_layouts import _nvcc, in_turns

DESIGNS = Path(__file__).resolve().parents[2] / "raft_tpu" / "designs"
P, I = ctypes.c_void_p, ctypes.c_longlong


def bem_case(name: str, lid: bool, dtype, dev):
    """A shipped design's padded panel mesh (dz_max 3, da_max 2) and its
    geometry on ``dev``: the K3 arguments, and a label."""
    design = load_design(DESIGNS / f"{name}.yaml")
    hull = mesh.mesh_design(design, dz_max=3.0, da_max=2.0)
    lid_p = mesh.mesh_lid(design, da_max=2.0) if lid else None
    padded, pm, lm = torch_bem.pad_mesh(hull, lid_p)

    def t(a):
        return torch.as_tensor(a, device=dev).to(dtype)

    pans, pmt, lmt = t(padded), t(pm), t(lm)
    c, nrm, area, diag = torch_bem.panel_geometry(pans)
    ls = (lmt > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
    spot = torch_bem.self_potential(pans, c, nrm)
    label = f"{name}{' + lid' if lid else ''} ({len(hull)} + {0 if lid_p is None else len(lid_p)}" \
            f" -> {len(padded)})"
    return (pans, c, nrm, area, diag, pmt, ls, spot), label


class Older:
    """The port's first K3 library; :meth:`bind` gives a launcher on staged
    inputs that returns (R_pot, R_dn)."""

    def __init__(self, name: str, path: str, work: Path):
        self.name = name
        self.lib = _nvcc(path, work / f"lib{name}.so", ("-fmad=false",))
        for fn in (self.lib.bem_rankine_f32, self.lib.bem_rankine_f64):
            fn.argtypes, fn.restype = [P] * 11 + [I, P, P, P], ctypes.c_int

    def bind(self, kargs, quad):
        dtype, dev = kargs[1].dtype, kargs[1].device
        n = kargs[1].shape[0]
        lids = kargs[6].to(dtype)
        ptrs = ([a.data_ptr() for a in kargs[:6]] + [lids.data_ptr(), kargs[7].data_ptr()]
                + [q.data_ptr() for q in quad])
        fn = self.lib.bem_rankine_f64 if dtype == torch.float64 else self.lib.bem_rankine_f32

        def run():
            R_pot = torch.empty((n, n), dtype=dtype, device=dev)
            R_dn = torch.empty_like(R_pot)
            nvcc.check(fn(*ptrs, n, R_pot.data_ptr(), R_dn.data_ptr(), nvcc.stream_of(dev)),
                       self.name)
            return R_pot, R_dn
        run.lids = lids                       # the cast flags live as long as the launcher
        return run


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs on the card", file=sys.stderr)
        return 2
    if len(sys.argv) != 3 or sys.argv[1] != "--old":
        print("usage: python3 -m raft_tpu_torch.tools.k3_compare --old bem_rankine.cu",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30)
    print("card:", out.stdout.strip())
    cuda_bem.build()
    print("  ptxas K3 (csrc/bem_rankine.cu):", *(
        line.split(":", 1)[-1].strip()
        for line in (nvcc.build_log(cuda_bem.RANKINE) or "").splitlines()
        if "registers" in line or "spill" in line), sep="\n    ")
    old = Older("pr4", sys.argv[2], nvcc.BUILD_DIR / "k3_compare")
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)

    for name, lid in (("VolturnUS-S", False), ("OC4semi", True)):
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).split(".")[-1]
            kargs, label = bem_case(name, lid, dtype, dev)
            quad = torch_bem.stage_quad(dtype, dev)
            fns = {"K3": lambda: cuda_bem.rankine_assembly(*kargs, quad=quad),
                   old.name: old.bind(kargs, quad)}
            ref = torch_bem.rankine_plain(*kargs, quad=quad)
            errs = {key: max(float((g - r).abs().max() / r.abs().max())
                             for g, r in zip(f(), ref)) for key, f in fns.items()}
            print(f"  K3 {dn} {label}: scale-relative diff from the plain version: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            t = in_turns(fns, flush)
            print(f"  K3 {dn} {label} ms: " + ", ".join(f"{k} {v:.5f}" for k, v in t.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
