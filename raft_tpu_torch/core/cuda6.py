"""Kernels K1 and K2 on the card: the 6x6 complex solve, fused with the RAO
impedance assembly (K1) or plain (K2), and their adjoints.

K1 replaces the TPU kernel ``raft_tpu/core/pallas6.py::_fused_kernel``
(reached through ``solve_rao_pallas``), K2 replaces ``pallas6.py::_kernel``
(reached through ``solve_cx_pallas``).  Both are one CUDA C++ template in
``raft_tpu_torch/csrc/solve6.cu``.  On an H100 both are bound by bytes: per
system they read the matrix and the right-hand side and write x (72 + 12 +
12 values), 5.7 us for K1 at the sweep's 250 x 200 systems in f32 and
1.9 us for K2 at 16,384 systems in f32 (3.35 TB/s).  The kernel gives
each system eight lanes, one row a lane, and stages the block's systems
through shared memory with coalesced loads: the pivot is a shuffle
reduction that keeps the TPU kernels' rule (strict maximum of ``|.|^2``,
the lowest row on a tie), the row exchange relabels the lanes' positions,
the pivot row is a shuffle broadcast, and the zero-denominator guard is
kept.  Built with ``-fmad=false`` so it rounds as the plain versions do.

The shared library is built with ``nvcc`` at first use into
``raft_tpu_torch/_build/`` (:mod:`raft_tpu_torch.core.nvcc`, keyed by a
hash of the source and flags) and bound with ``ctypes``.  :func:`solve_rao`
and :func:`solve_cx` dispatch on the tensors' device: CPU tensors take the
plain versions (:func:`raft_tpu_torch.core.linalg6.solve_cx_fused` and
:func:`~raft_tpu_torch.core.linalg6.solve_cx`), CUDA tensors launch the
kernel or raise.  On the card they also raise when grad mode is on and an
input requires grad (:func:`raft_tpu_torch.core.nvcc.refuse_grad`): the
kernel's outputs carry no autograd history.  :func:`solve_rao_ad` and
:func:`solve_cx_ad` are the differentiable entries; their
``autograd.Function`` calls the wrappers with grad mode off.

:func:`solve_rao_adjoint` and :func:`solve_cx_adjoint` solve with the
conjugate transpose, ``(Z0 + i w B_drag)^H lam = g`` and ``A^H lam = g``.
On the card the kernel's adjoint mode reads the transpose in place (each
lane takes a column of the staged system instead of a row); on CPU
tensors the wrapper builds the transposed system (``Z0^H``,
``-B_drag^T``) for the plain version.  :func:`solve_rao_ad` and
:func:`solve_cx_ad` are the reverse-differentiable entries (the
counterparts of ``solve_rao_pallas_ad`` and ``solve_cx_pallas_ad``): their
backward is one adjoint solve, then the cotangents from ``lam`` and ``x``;
the elimination itself is never differentiated.

``LAUNCHES`` counts kernel launches per entry: ``fused`` and ``plain`` in
the forward solves, ``fused_adjoint`` and ``plain_adjoint`` in the adjoint
ones.  :func:`work` counts a launch's operations and bytes from its shapes
alone; while the cache is enabled each launch is timed into the
per-kernel performance ledger (:mod:`raft_tpu_torch.obs.ledger`, entries
``solve6_fused`` and ``solve6_plain``) with CUDA events, without a wait.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from raft_tpu_torch.core import linalg6, nvcc
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.obs import ledger

#: kernel launches per entry (the plain PyTorch path is never counted)
LAUNCHES = {"fused": 0, "plain": 0, "fused_adjoint": 0, "plain_adjoint": 0}
_launch_lock = threading.Lock()

_FUSED_SIGNATURE = (ctypes.c_void_p,) * 8 + (ctypes.c_longlong,) * 3 + (ctypes.c_void_p,)
_PLAIN_SIGNATURE = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 2 + (ctypes.c_void_p,)
SPEC = nvcc.Spec("solve6", "solve6.cu", ("-fmad=false",), (
    ("solve6_fused_f32", _FUSED_SIGNATURE, None), ("solve6_fused_f64", _FUSED_SIGNATURE, None),
    ("solve6_plain_f32", _PLAIN_SIGNATURE, None), ("solve6_plain_f64", _PLAIN_SIGNATURE, None)))


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


def work(n_designs: int, nw: int, itemsize: int, fused: bool = True) -> dict:
    """Operations and bytes of one launch, from its shapes alone: each
    input read once, each output written once.  K1 (``fused``) solves
    ``n_designs x nw`` systems, reading Z0 and F per system, ``w`` once and
    B_drag per design; K2 solves ``n_designs x nw`` systems of 96 values
    (A and b read, x written) with K1's operations less the 72 of the drag
    assembly."""
    n = n_designs * nw
    if fused:
        return {"flops": float(n * k1_flops_per_system()),
                "bytes_accessed": float(itemsize * (n * 36 * 2 + n * 6 * 2 + n * 6 * 2 + nw
                                                    + n_designs * 36))}
    return {"flops": float(n * (k1_flops_per_system() - 72)),
            "bytes_accessed": float(itemsize * n * 96)}


def build() -> ctypes.CDLL:
    """The kernel library, through the kernel-library registry: built once
    per key, opened once per process (threads that reach it together open
    it once)."""
    from raft_tpu_torch.cache import aot

    return aot.library(SPEC)


def _check_tensors(tensors, names: str):
    """One device and dtype, float32/float64, contiguous."""
    if len({(t.device, t.dtype) for t in tensors}) != 1:
        raise ValueError(f"{names} must share one device and dtype")
    if tensors[0].dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {tensors[0].dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{names} must be contiguous")


def _check_shapes(want: dict):
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _check(Z0: Cx, w, B_drag, F: Cx):
    """Validate the fused-solve arguments; returns (lead shape, nw)."""
    if Z0.re.ndim < 3 or Z0.re.shape[-2:] != (6, 6):
        raise ValueError(f"Z0 must be (..., nw, 6, 6), got {tuple(Z0.re.shape)}")
    lead = tuple(Z0.re.shape[:-2])
    nw = lead[-1]
    _check_shapes({"Z0.im": (Z0.im, lead + (6, 6)), "w": (w, (nw,)),
                   "B_drag": (B_drag, lead[:-1] + (6, 6)),
                   "F.re": (F.re, lead + (6,)), "F.im": (F.im, lead + (6,))})
    _check_tensors((Z0.re, Z0.im, w, B_drag, F.re, F.im), "Z0, w, B_drag and F")
    return lead, nw


def _check_plain(A: Cx, b: Cx):
    """Validate the plain-solve arguments; returns the lead shape."""
    if A.re.ndim < 2 or A.re.shape[-2:] != (6, 6):
        raise ValueError(f"A must be (..., 6, 6), got {tuple(A.re.shape)}")
    lead = tuple(A.re.shape[:-2])
    _check_shapes({"A.im": (A.im, lead + (6, 6)), "b.re": (b.re, lead + (6,)),
                   "b.im": (b.im, lead + (6,))})
    _check_tensors((A.re, A.im, b.re, b.im), "A and b")
    return lead


def _cuda_device(t: torch.Tensor) -> torch.device | None:
    """None for a CPU tensor (take the plain version), the device for a CUDA
    one; any other device is refused."""
    dev = t.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _conj_transpose(A: Cx) -> Cx:
    """``A^H`` of (..., 6, 6) pairs, materialized (the plain versions' input)."""
    return Cx(A.re.transpose(-1, -2).contiguous(), (-A.im.transpose(-1, -2)).contiguous())


def _solve_rao(Z0: Cx, w, B_drag, F: Cx, adjoint: bool = False) -> Cx:
    lead, nw = _check(Z0, w, B_drag, F)
    if Z0.re.device.type != "cpu":
        nvcc.refuse_grad("solve_rao (K1)", Z0.re, Z0.im, w, B_drag, F.re, F.im)
    dev = _cuda_device(Z0.re)
    if dev is None:
        if adjoint:
            Z0, B_drag = _conj_transpose(Z0), (-B_drag.transpose(-1, -2)).contiguous()
        return linalg6.solve_cx_fused(Z0, w, B_drag, F)
    xr = torch.empty(lead + (6,), dtype=Z0.re.dtype, device=dev)
    xi = torch.empty_like(xr)
    n = xr.numel() // 6
    if n == 0:
        return Cx(xr, xi)
    lib = build()
    fn = lib.solve6_fused_f64 if Z0.re.dtype == torch.float64 else lib.solve6_fused_f32
    dt = str(Z0.re.dtype).removeprefix("torch.")
    with ledger.launch("solve6_fused", f"{n // nw}x{nw}:{dt}{':adjoint' * adjoint}", dt, dev,
                       lambda: work(n // nw, nw, Z0.re.element_size())):
        err = fn(Z0.re.data_ptr(), Z0.im.data_ptr(), w.data_ptr(), B_drag.data_ptr(),
                 F.re.data_ptr(), F.im.data_ptr(), xr.data_ptr(), xi.data_ptr(),
                 n, nw, int(adjoint), nvcc.stream_of(dev))
        nvcc.check(err, "solve6_fused")
    with _launch_lock:
        LAUNCHES["fused_adjoint" if adjoint else "fused"] += 1
    return Cx(xr, xi)


def _solve_cx(A: Cx, b: Cx, adjoint: bool = False) -> Cx:
    lead = _check_plain(A, b)
    if A.re.device.type != "cpu":
        nvcc.refuse_grad("solve_cx (K2)", A.re, A.im, b.re, b.im)
    dev = _cuda_device(A.re)
    if dev is None:
        return linalg6.solve_cx(_conj_transpose(A) if adjoint else A, b)
    xr = torch.empty(lead + (6,), dtype=A.re.dtype, device=dev)
    xi = torch.empty_like(xr)
    n = xr.numel() // 6
    if n == 0:
        return Cx(xr, xi)
    lib = build()
    fn = lib.solve6_plain_f64 if A.re.dtype == torch.float64 else lib.solve6_plain_f32
    dt = str(A.re.dtype).removeprefix("torch.")
    with ledger.launch("solve6_plain", f"{n}:{dt}{':adjoint' * adjoint}", dt, dev,
                       lambda: work(n, 1, A.re.element_size(), fused=False)):
        err = fn(A.re.data_ptr(), A.im.data_ptr(), b.re.data_ptr(), b.im.data_ptr(),
                 xr.data_ptr(), xi.data_ptr(), n, int(adjoint), nvcc.stream_of(dev))
        nvcc.check(err, "solve6_plain")
    with _launch_lock:
        LAUNCHES["plain_adjoint" if adjoint else "plain"] += 1
    return Cx(xr, xi)


def solve_rao(Z0: Cx, w: torch.Tensor, B_drag: torch.Tensor, F: Cx) -> Cx:
    """``x = (Z0 + i w B_drag)^-1 F`` (kernel K1), same arguments as
    :func:`raft_tpu_torch.core.linalg6.solve_cx_fused`.

    ``Z0``: (..., nw, 6, 6); ``w``: (nw,) shared by every design;
    ``B_drag``: (..., 6, 6), one per design; ``F``: (..., nw, 6).
    """
    return _solve_rao(Z0, w, B_drag, F)


def solve_rao_adjoint(Z0: Cx, w: torch.Tensor, B_drag: torch.Tensor, G: Cx) -> Cx:
    """``lam = ((Z0 + i w B_drag)^H)^-1 G`` (kernel K1 in its adjoint mode),
    the arguments of :func:`solve_rao`.  The card reads ``Z0^H`` and
    ``-B_drag^T`` in place; CPU tensors take the plain version on the
    materialized transposes."""
    return _solve_rao(Z0, w, B_drag, G, adjoint=True)


def solve_cx(A: Cx, b: Cx) -> Cx:
    """``x = A^-1 b`` (kernel K2), the vector-right-hand-side case of
    :func:`raft_tpu_torch.core.linalg6.solve_cx`.

    ``A``: (..., 6, 6); ``b``: (..., 6) with the same leading axes.
    """
    return _solve_cx(A, b)


def solve_cx_adjoint(A: Cx, b: Cx) -> Cx:
    """``x = (A^H)^-1 b`` (kernel K2 in its adjoint mode), the arguments of
    :func:`solve_cx`; CPU tensors take the plain version on ``A^H``."""
    return _solve_cx(A, b, adjoint=True)


def _materialize(g, like: torch.Tensor) -> torch.Tensor:
    """A cotangent half as a contiguous tensor (zeros for None)."""
    return torch.zeros_like(like) if g is None else g.contiguous()


def _outer_cotangent(lam: Cx, x: Cx) -> Cx:
    """``Abar = -conj(lam) x^T`` in the (re, im) pair algebra
    (``pallas6.py::_solve_ad_bwd``): ``(-(lr xr + li xi), lr xi - li xr)``."""
    lr, li = lam.re[..., :, None], lam.im[..., :, None]
    xr, xi = x.re[..., None, :], x.im[..., None, :]
    return Cx(-(lr * xr + li * xi), lr * xi - li * xr)


class _SolveRaoAD(torch.autograd.Function):
    """K1 with its analytic reverse-mode rule (``solve_rao_pallas_ad``).

    The adjoint solve ``A^H lam = xbar`` is the same fused kernel in its
    adjoint mode (:func:`solve_rao_adjoint`), on the forward's inputs.
    With ``Abar = -conj(lam) x^T``: ``Z0bar = Abar``,
    ``wbar[f] = sum over designs, j, k of B_drag Abar.im`` and
    ``B_dragbar = sum over frequencies of w Abar.im``; ``Fbar = lam``.
    """

    @staticmethod
    def forward(ctx, z0r, z0i, w, b_drag, fr, fi):
        x = _solve_rao(Cx(z0r, z0i), w, b_drag, Cx(fr, fi))
        ctx.save_for_backward(z0r, z0i, w, b_drag, x.re, x.im)
        return x.re, x.im

    @staticmethod
    def backward(ctx, gxr, gxi):
        z0r, z0i, w, b_drag, xr, xi = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need):
            return (None,) * 6
        lam = solve_rao_adjoint(Cx(z0r, z0i), w, b_drag,
                                Cx(_materialize(gxr, xr), _materialize(gxi, xi)))
        g_z0r = g_z0i = g_w = g_bd = None
        if any(need[:4]):
            Abar = _outer_cotangent(lam, Cx(xr, xi))
            if need[0]:
                g_z0r = Abar.re
            if need[1]:
                g_z0i = Abar.im
            if need[2]:
                # (..., nw, 6, 6) against (..., 6, 6): every axis but nw reduces
                g_w = (b_drag[..., None, :, :] * Abar.im).sum(dim=(-2, -1))
                g_w = g_w.reshape(-1, w.shape[0]).sum(dim=0)
            if need[3]:
                g_bd = (w[:, None, None] * Abar.im).sum(dim=-3)
        return (g_z0r, g_z0i, g_w, g_bd,
                lam.re if need[4] else None, lam.im if need[5] else None)


class _SolveCxAD(torch.autograd.Function):
    """K2 with its analytic reverse-mode rule (``solve_cx_pallas_ad``):
    ``lam = (A^H)^-1 xbar`` by K2's adjoint mode, ``Abar = -conj(lam) x^T``,
    ``bbar = lam``."""

    @staticmethod
    def forward(ctx, ar, ai, br, bi):
        x = _solve_cx(Cx(ar, ai), Cx(br, bi))
        ctx.save_for_backward(ar, ai, x.re, x.im)
        return x.re, x.im

    @staticmethod
    def backward(ctx, gxr, gxi):
        ar, ai, xr, xi = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need):
            return (None,) * 4
        lam = solve_cx_adjoint(Cx(ar, ai), Cx(_materialize(gxr, xr), _materialize(gxi, xi)))
        g_ar = g_ai = None
        if need[0] or need[1]:
            Abar = _outer_cotangent(lam, Cx(xr, xi))
            g_ar = Abar.re if need[0] else None
            g_ai = Abar.im if need[1] else None
        return g_ar, g_ai, lam.re if need[2] else None, lam.im if need[3] else None


def solve_rao_ad(Z0: Cx, w: torch.Tensor, B_drag: torch.Tensor, F: Cx) -> Cx:
    """:func:`solve_rao` with the analytic reverse-mode rule: the backward
    launches K1 once more, in its adjoint mode."""
    xr, xi = _SolveRaoAD.apply(Z0.re, Z0.im, w, B_drag, F.re, F.im)
    return Cx(xr, xi)


def solve_cx_ad(A: Cx, b: Cx) -> Cx:
    """:func:`solve_cx` with the analytic reverse-mode rule: the backward
    launches K2 once more, in its adjoint mode."""
    xr, xi = _SolveCxAD.apply(A.re, A.im, b.re, b.im)
    return Cx(xr, xi)
