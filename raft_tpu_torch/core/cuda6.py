"""Kernel K1 on the card: the fused RAO assemble + 6x6 complex solve.

Replaces the TPU kernel ``raft_tpu/core/pallas6.py::_fused_kernel``
(reached through ``solve_rao_pallas``).  The CUDA C++ source is
``raft_tpu_torch/csrc/solve6.cu``: one thread per (design, frequency)
system, the elimination unrolled in registers, with the TPU kernel's pivot
rule and zero-denominator guard.  On an H100 it is bound by bytes: per
call it reads Z0 and F and writes x (72 + 12 + 12 values per lane), about
46 us in f64 and 23 us in f32 at 1,000 x 200 lanes and 3.35 TB/s.

The shared library is built with ``nvcc`` at first use into
``raft_tpu_torch/_build/`` (:mod:`raft_tpu_torch.core.nvcc`, keyed by a
hash of the source and flags) and bound with ``ctypes``.
:func:`solve_rao` dispatches on the tensors' device: CPU tensors take the
plain version (:func:`raft_tpu_torch.core.linalg6.solve_cx_fused`), CUDA
tensors launch the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core import linalg6, nvcc
from raft_tpu_torch.core.cplx import Cx

#: number of times :func:`solve_rao` launched the kernel (never the plain path)
LAUNCHES = 0

SPEC = nvcc.Spec("solve6", "solve6.cu")
_SIGNATURE = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = nvcc.load(SPEC, {"solve6_fused_f32": _SIGNATURE,
                                "solve6_fused_f64": _SIGNATURE})
    return _lib


def _check(Z0: Cx, w, B_drag, F: Cx):
    """Validate the fused-solve arguments; returns (lead shape, nw)."""
    if Z0.re.ndim < 3 or Z0.re.shape[-2:] != (6, 6):
        raise ValueError(f"Z0 must be (..., nw, 6, 6), got {tuple(Z0.re.shape)}")
    lead = tuple(Z0.re.shape[:-2])
    nw = lead[-1]
    want = {"Z0.im": (Z0.im, lead + (6, 6)), "w": (w, (nw,)),
            "B_drag": (B_drag, lead[:-1] + (6, 6)),
            "F.re": (F.re, lead + (6,)), "F.im": (F.im, lead + (6,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    tensors = (Z0.re, Z0.im, w, B_drag, F.re, F.im)
    if len({(t.device, t.dtype) for t in tensors}) != 1:
        raise ValueError("Z0, w, B_drag and F must share one device and dtype")
    if Z0.re.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {Z0.re.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("Z0, w, B_drag and F must be contiguous")
    return lead, nw


def solve_rao(Z0: Cx, w: torch.Tensor, B_drag: torch.Tensor, F: Cx) -> Cx:
    """``x = (Z0 + i w B_drag)^-1 F``, same arguments as
    :func:`raft_tpu_torch.core.linalg6.solve_cx_fused`.

    ``Z0``: (..., nw, 6, 6); ``w``: (nw,) shared by every design;
    ``B_drag``: (..., 6, 6), one per design; ``F``: (..., nw, 6).
    """
    global LAUNCHES
    lead, nw = _check(Z0, w, B_drag, F)
    dev = Z0.re.device
    if dev.type == "cpu":
        return linalg6.solve_cx_fused(Z0, w, B_drag, F)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    xr = torch.empty(lead + (6,), dtype=Z0.re.dtype, device=dev)
    xi = torch.empty_like(xr)
    n = xr.numel() // 6
    if n == 0:
        return Cx(xr, xi)
    lib = build()
    fn = lib.solve6_fused_f64 if Z0.re.dtype == torch.float64 else lib.solve6_fused_f32
    err = fn(Z0.re.data_ptr(), Z0.im.data_ptr(), w.data_ptr(), B_drag.data_ptr(),
             F.re.data_ptr(), F.im.data_ptr(), xr.data_ptr(), xi.data_ptr(),
             n, nw, nvcc.stream_of(dev))
    nvcc.check(err, "solve6_fused")
    LAUNCHES += 1
    return Cx(xr, xi)
