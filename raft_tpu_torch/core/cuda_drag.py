"""Kernel K5 on the card: one fixed-point step's drag linearization.

K5 replaces no TPU kernel: it replaces the chain of ``jnp`` ops of
``raft_tpu/hydro/strip.py::linearized_drag``, which the port ran as about
240 eager operations a step (:func:`raft_tpu_torch.hydro.strip.
linearized_drag`), materialising (lanes, nodes, nw, 6) intermediates and
concatenating them.  The linearization splits in two:

* the response-independent per-node terms, built once per
  ``solve_dynamics`` call in plain PyTorch
  (:func:`raft_tpu_torch.hydro.strip.drag_coeffs`, packed (..., N, 20))
  and staged with the node kinematics by :func:`plan`;
* the per-step part, which depends on the iterate Xi alone:
  :func:`drag_step` launches K5 (``raft_tpu_torch/csrc/drag.cu``) on CUDA
  tensors, one block a lane, and returns ``B_drag`` (..., 6, 6) and
  ``F_drag`` (..., nw, 6) without writing anything of size (nodes, nw) to
  device memory.  On CPU tensors it takes the plain version
  (:func:`drag_step_plain`), the same arithmetic from the same
  coefficients in PyTorch, which the CPU tests hold to
  ``linearized_drag``.

On an H100 K5 is bound by bytes: per lane and step it reads the
kinematics at the submerged nodes and Xi, and writes F_drag
(:func:`work`).  The library is built and bound as K1's is
(:mod:`raft_tpu_torch.core.nvcc`, the registry of
:mod:`raft_tpu_torch.cache.aot`, ``ctypes``, PyTorch's current stream).
On the card :func:`drag_step` raises when grad mode is on and an input
requires grad (:func:`raft_tpu_torch.core.nvcc.refuse_grad`): the kernel
has no backward, and the differentiable route keeps ``linearized_drag``.

``LAUNCHES["step"]`` counts K5's launches (the plain version is never
counted).  The lanes are ``()`` or ``(B,)`` (any lead shape is flattened);
the coefficients and the kinematics either carry the lanes or are shared
by all of them (one design's nodes under sea-state lanes), and the
kinematics are taken at their own strides, so a shared or transposed view
is never copied per step.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading

import torch

from raft_tpu_torch.core import nvcc
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.transforms import (
    cross, translate_force_3to6, translate_matrix_3to6, vec_outer,
)
from raft_tpu_torch.hydro.strip import _gauss_drag_slope

Tensor = torch.Tensor

#: K5 launches (the plain PyTorch path is never counted)
LAUNCHES = {"step": 0}
_launch_lock = threading.Lock()

#: values a node carries in the packed coefficients (drag.cu's layout)
N_COEF = 20
#: threads a lane at most, and frequencies a thread (drag.cu's PER)
MAX_THREADS = 256
_PERS = (1, 2, 4)
#: the widest frequency grid K5 takes
MAX_NW = MAX_THREADS * _PERS[-1]
#: floating-point operations a (submerged node, frequency) pair, counted from
#: drag.cu: node velocity 30, relative velocity and |.|^2 15, the three
#: moments 18, Bmat u 30, its translation and sums 24
FLOPS_PER_NODE_W = 117

_SIGNATURE = ((ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p)
              + (ctypes.c_longlong,) * 4 + (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 5
              + (ctypes.c_void_p,))
SPEC = nvcc.Spec("drag", "drag.cu", ("-fmad=false",), (
    ("drag_step_f32", _SIGNATURE, None), ("drag_step_f64", _SIGNATURE, None)))

def build() -> ctypes.CDLL:
    """K5's library, through the kernel-library registry (built once per
    key, opened once per process)."""
    from raft_tpu_torch.cache import aot

    return aot.library(SPEC)


def work(lanes: int, n_sub: int, nw: int, itemsize: int, n_nodes: int | None = None,
         kin_lanes: int | None = None, coef_lanes: int | None = None) -> dict:
    """Operations and bytes of one launch from its shapes, each input read
    once and each output written once: the kinematics at the ``n_sub``
    submerged nodes (of ``kin_lanes`` lanes, default ``lanes``; 1 when the
    lanes share them), Xi read and F_drag written (12 values a frequency
    each), B_drag written, the coefficients of ``n_nodes`` nodes (default
    ``n_sub``) of ``coef_lanes`` lanes (default ``lanes``), ``w``."""
    nodes = n_sub if n_nodes is None else n_nodes
    kl = lanes if kin_lanes is None else kin_lanes
    cl = lanes if coef_lanes is None else coef_lanes
    values = kl * n_sub * nw * 6 + lanes * nw * 24 + lanes * 36 + cl * nodes * N_COEF + nw
    return {"flops": float(lanes * n_sub * nw * FLOPS_PER_NODE_W),
            "bytes_accessed": float(itemsize * values)}


@dataclasses.dataclass
class DragPlan:
    """The response-independent inputs of one solve's linearizations, with
    the lanes flattened: ``coef`` (1 or L, N, 20) contiguous, ``u`` the
    node kinematics (1 or L, N, nw, 3) at their own strides (re and im
    alike), ``w`` (nw,), ``lead`` the lanes' shape."""

    coef: Tensor
    u: Cx
    w: Tensor
    lead: tuple


def _lanes(t: Tensor, lead: tuple, rest: int) -> Tensor:
    """``t`` (*lanes, *last ``rest`` axes) with its lanes flattened to one
    axis: of size 1 when it has no lanes (or one), else of size L (a view
    where the strides allow, else one copy, made once per solve)."""
    tail = tuple(t.shape[t.ndim - rest:])
    head = tuple(t.shape[:t.ndim - rest])
    if math.prod(head) == 1:
        return t.reshape((1,) + tail)
    if head != lead:
        t = t.broadcast_to(lead + tail)
    return t.reshape((math.prod(lead),) + tail)


def plan(coef: Tensor, u: Cx, w: Tensor, lead: tuple) -> DragPlan:
    """Stage one solve's linearizations: ``coef`` (..., N, 20) from
    :func:`raft_tpu_torch.hydro.strip.drag_coeffs`, ``u`` the node
    kinematics (..., N, nw, 3), ``w`` (nw,), ``lead`` the lanes of the
    iterate (``()`` or ``(B,)``).  Each of ``coef`` and ``u`` either has
    these lanes or none."""
    ur, ui = _lanes(u.re, lead, 3), _lanes(u.im, lead, 3)
    if ur.stride() != ui.stride():
        ur, ui = ur.contiguous(), ui.contiguous()
    return DragPlan(coef=_lanes(coef, lead, 2).contiguous(), u=Cx(ur, ui), w=w,
                    lead=tuple(lead))


def drag_step_plain(p: DragPlan, Xi: Cx):
    """K5's plain version: ``(B_drag (L, 6, 6), F_drag Cx (L, nw, 6))`` for
    the iterate ``Xi`` (L, nw, 6), in PyTorch."""
    c = p.coef
    sub = c[..., 0]
    q, p1, p2, r = c[..., 8:11], c[..., 11:14], c[..., 14:17], c[..., 17:20]
    rb = r[:, :, None, :]                                   # (Lc, N, 1, 3)

    def disp(x):
        x = x[:, None]                                      # (L, 1, nw, 6)
        return x[..., :3] + cross(x[..., 3:], rb)

    dr = Cx(disp(Xi.re), disp(Xi.im))
    w = p.w[:, None]
    vrel = p.u - Cx(dr.re * w, dr.im * w).mul_i()
    v2 = vrel.re**2 + vrel.im**2

    def moment(unit):
        return (v2 * unit[:, :, None, :] ** 2).sum(dim=(-1, -2))

    s = torch.stack([moment(q), moment(p1), moment(p2)])
    pos = s > 0
    vRMS = torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))
    sl_q = _gauss_drag_slope(c[..., 1], vRMS[0])
    Bq, Bend = sl_q * c[..., 4], sl_q * c[..., 7]
    Bp1 = _gauss_drag_slope(c[..., 2], vRMS[1]) * c[..., 5]
    Bp2 = _gauss_drag_slope(c[..., 3], vRMS[2]) * c[..., 6]
    Bmat = ((Bq + Bend)[..., None, None] * vec_outer(q) + Bp1[..., None, None] * vec_outer(p1)
            + Bp2[..., None, None] * vec_outer(p2))
    Bmat = Bmat * sub[..., None, None]
    B6 = translate_matrix_3to6(r, Bmat).sum(dim=-3)
    BT = Bmat.transpose(-1, -2)
    F6 = Cx(translate_force_3to6(rb, p.u.re @ BT).sum(dim=-3),
            translate_force_3to6(rb, p.u.im @ BT).sum(dim=-3))
    return B6, F6


def _launch_shape(nw: int):
    """(threads a block, frequencies a thread) for ``nw`` frequencies: the
    fewest frequencies a thread, then the fewest threads (a multiple of 32,
    at least 64 so that threads 0..35 hold B6)."""
    if nw > MAX_NW:
        raise ValueError(f"K5 takes at most {MAX_NW} frequencies, got {nw}")
    per = next(p for p in _PERS if p * MAX_THREADS >= nw)
    threads = max(64, 32 * -(-nw // (32 * per)))
    return threads, per


def drag_step(p: DragPlan, Xi: Cx):
    """``(B_drag (..., 6, 6), F_drag Cx (..., nw, 6))``, the drag
    linearized about the iterate ``Xi`` (..., nw, 6): K5 on CUDA tensors,
    :func:`drag_step_plain` on CPU tensors."""
    nw = p.w.shape[0]
    L = math.prod(p.lead)
    if tuple(Xi.re.shape) != p.lead + (nw, 6) or tuple(Xi.im.shape) != p.lead + (nw, 6):
        raise ValueError(f"Xi must have shape {p.lead + (nw, 6)}, got {tuple(Xi.re.shape)}")
    tensors = (p.coef, p.u.re, p.u.im, p.w, Xi.re, Xi.im)
    if len({(t.device, t.dtype) for t in tensors}) != 1:
        raise ValueError("the plan's tensors and Xi must share one device and dtype")
    dtype, dev = p.coef.dtype, p.coef.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    xr, xi = Xi.re.reshape(L, nw, 6).contiguous(), Xi.im.reshape(L, nw, 6).contiguous()
    if dev.type == "cpu":
        B6, F6 = drag_step_plain(p, Cx(xr, xi))
        return B6.reshape(p.lead + (6, 6)), Cx(F6.re.reshape(p.lead + (nw, 6)),
                                               F6.im.reshape(p.lead + (nw, 6)))
    nvcc.refuse_grad("drag_step (K5)", *tensors)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not p.w.is_contiguous():
        raise ValueError("w must be contiguous")
    b6 = torch.empty(p.lead + (6, 6), dtype=dtype, device=dev)
    fr = torch.empty(p.lead + (nw, 6), dtype=dtype, device=dev)
    fi = torch.empty_like(fr)
    n_nodes = p.coef.shape[-2]
    if L == 0 or nw == 0:
        return b6.zero_(), Cx(fr, fi)
    threads, per = _launch_shape(nw)
    ur, ui = p.u.re, p.u.im
    us = ur.stride()
    cs = 0 if p.coef.shape[0] == 1 else n_nodes * N_COEF
    lib = build()
    fn = lib.drag_step_f64 if dtype == torch.float64 else lib.drag_step_f32
    err = fn(p.coef.data_ptr(), cs, ur.data_ptr(), ui.data_ptr(),
             0 if ur.shape[0] == 1 else us[0], us[1], us[2], us[3],
             xr.data_ptr(), xi.data_ptr(), p.w.data_ptr(), b6.data_ptr(), fr.data_ptr(),
             fi.data_ptr(), L, n_nodes, nw, threads, per, nvcc.stream_of(dev))
    nvcc.check(err, "drag_step")
    with _launch_lock:
        LAUNCHES["step"] += 1
    return b6, Cx(fr, fi)
