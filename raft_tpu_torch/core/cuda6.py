"""Kernel K1 on the card: the fused RAO assemble + 6x6 complex solve.

Replaces the TPU kernel ``raft_tpu/core/pallas6.py::_fused_kernel``
(reached through ``solve_rao_pallas``).  The CUDA C++ source is
``raft_tpu_torch/csrc/solve6.cu``: one thread per (design, frequency)
system, the elimination unrolled in registers, with the TPU kernel's pivot
rule and zero-denominator guard.  On an H100 it is bound by bytes: per
call it reads Z0 and F and writes x (72 + 12 + 12 values per lane), about
46 us in f64 and 23 us in f32 at 1,000 x 200 lanes and 3.35 TB/s.

The shared library is built with ``nvcc`` at first use into
``raft_tpu_torch/_build/`` (keyed by a hash of the source and flags) and
bound with ``ctypes``.  :func:`solve_rao` dispatches on the tensors'
device: CPU tensors take the plain version
(:func:`raft_tpu_torch.core.linalg6.solve_cx_fused`), CUDA tensors launch
the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from raft_tpu_torch.core import linalg6
from raft_tpu_torch.core.cplx import Cx

#: number of times :func:`solve_rao` launched the kernel (never the plain path)
LAUNCHES = 0
#: the compiler's output (``-Xptxas -v``: registers, spills) of the last build
BUILD_LOG = ""

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "solve6.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel is built on a machine "
                       "with the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libsolve6-{key}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            BUILD_LOG = proc.stderr
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    for name in ("solve6_fused_f32", "solve6_fused_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(Z0.re.data_ptr(), Z0.im.data_ptr(), w.data_ptr(), B_drag.data_ptr(),
             F.re.data_ptr(), F.im.data_ptr(), xr.data_ptr(), xi.data_ptr(),
             n, nw, stream)
    if err != 0:
        raise RuntimeError(f"solve6_fused launch failed: cudaError {err}")
    LAUNCHES += 1
    return Cx(xr, xi)
