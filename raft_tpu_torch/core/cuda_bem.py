"""Kernels K3 and K4 on the card: the assembly stage of the panel BEM.

* K3 :func:`rankine_assembly` replaces the TPU kernel
  ``raft_tpu/core/pallas_bem.py::_rankine_kernel``: the Rankine direct +
  free-surface-image panel integrals, ``(R_pot, R_dn)`` (n, n).  Source
  ``raft_tpu_torch/csrc/bem_rankine.cu``: one cooperative launch.  A
  far pass over tiles of 16 field rows x 32 source columns, both sides
  staged in shared memory, computes a lane a pair every pair whose levels
  have at most 9 points (each pair visits only its own levels'
  subdivision points, about 5 contributions a pair on the shipped meshes,
  against 956 in the TPU kernel's masked dense loop) and appends the
  others (36, 144 or 576 points) to near lists in a workspace; after a
  grid-wide barrier every warp of the launch takes near pairs from all
  the lists, one pair a warp.
* K4 :func:`wave_assembly` replaces ``pallas_bem.py::_wave_kernel``: the
  wave part of the Green function for a chunk of frequencies, combined
  into ``(S_re, S_im, Dn_re, Dn_im)`` (nf, n, n).  Source
  ``raft_tpu_torch/csrc/bem_wave.cu``.  Bound by f64 operations, most of
  them in the near quadrature of the wave integrals (the low-frequency
  finite-depth chunks send nearly every image there) and in the 46-term
  exponential fit.  The kernel evaluates the near quadrature's E1 series
  as a Horner polynomial (no divisions) with the node tables staged once
  beside the wave tables (``tab["near"]`` of
  :func:`raft_tpu_torch.hydro.torch_bem.stage_tables`), shares each
  node's sincos between the four images, works through the near pairs a
  warp at a time (one node per lane), builds the fit terms from one
  rsqrt, and loops each thread over the chunk's frequencies.

Each kernel has three entries: float64, float32 and bfloat16 storage
(``RAFT_TPU_BEM_PRECISION=bf16``: the inputs and outputs in bfloat16, the
arithmetic in float32, each output rounded once; the plain versions give
bfloat16 the same meaning).  Their launches are counted apart
(``"rankine_bf16"``, ``"wave_bf16"``).

Both wrappers dispatch on the tensors' device: CPU tensors take the plain
versions (:func:`raft_tpu_torch.hydro.torch_bem.rankine_plain`,
``wave_plain``), CUDA tensors launch the kernel or raise; under grad mode
with an input that requires grad they raise, since neither kernel has a
backward (:func:`raft_tpu_torch.core.nvcc.refuse_grad`).  Each has the
signature of its plain version.  ``LAUNCHES`` counts kernel launches; the
libraries are built by ``nvcc`` at first use (:mod:`raft_tpu_torch.core.nvcc`).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from raft_tpu_torch.core import nvcc

Tensor = torch.Tensor

#: kernel launches per wrapper (never the plain path)
LAUNCHES = {"rankine": 0, "wave": 0, "rankine_bf16": 0, "wave_bf16": 0}
#: the C entries' suffix for each storage dtype
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}

RANKINE = nvcc.Spec("bem_rankine", "bem_rankine.cu")
WAVE = nvcc.Spec("bem_wave", "bem_wave.cu")

_P, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
_RANKINE_SIG = [_P] * 11 + [_I, _P, _P, _P, _I, _P, _P]
_WAVE_SIG = ([_P] * 12 + [_I, _I, _D, _D] + [_P] * 6 + [_I, _I, _I, _I, _D]
             + [_P] * 4 + [_P])
_libs: dict = {}
_libs_lock = threading.Lock()


def build() -> dict:
    """Compile (once per source hash) and load both kernel libraries, once
    per process: threads that reach it together load them once."""
    with _libs_lock:
        if not _libs:
            nvcc.compile_all([RANKINE, WAVE])
            lib = nvcc.load(RANKINE, {f"bem_rankine_{x}": _RANKINE_SIG
                                      for x in _SUFFIX.values()})
            for x in _SUFFIX.values():
                fn = getattr(lib, f"bem_rankine_workspace_{x}")
                fn.argtypes, fn.restype = [_I], _I
            wave = nvcc.load(WAVE, {f"bem_wave_{x}": _WAVE_SIG for x in _SUFFIX.values()})
            _libs.update(rankine=lib, wave=wave)
    return _libs


def _checked(dev: torch.device, dtype, **tensors) -> dict:
    """Contiguous tensors on ``dev`` in ``dtype`` (bools are cast), or raise."""
    if dtype not in _SUFFIX:
        raise ValueError(f"dtype must be float32, float64 or bfloat16, got {dtype}")
    out = {}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, expected {dev}")
        if t.dtype == torch.bool:
            t = t.to(dtype)
        elif t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        out[name] = t.contiguous()
    return out


def _require_cuda(dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


def rankine_assembly(pans: Tensor, c: Tensor, nrm: Tensor, area: Tensor, diag: Tensor,
                     panel_mask: Tensor, lid_surface: Tensor, self_pot: Tensor, *, quad=None,
                     near_count: Tensor | None = None):
    """K3: ``(R_pot, R_dn)`` (n, n); see
    :func:`raft_tpu_torch.hydro.torch_bem.rankine_plain` for the arguments.
    On the card ``quad`` is required: the subdivision points staged once by
    ``torch_bem.stage_tables`` (``tab["quad"]``), so a call copies nothing
    from the host, casts nothing and never waits for the device.
    ``near_count``, a (1,) int32 tensor on the card, has the number of pairs
    the kernel worked through in its near pass added to it (for checks; the
    path passes none)."""
    from raft_tpu_torch.hydro import torch_bem

    dev, dtype = c.device, c.dtype
    if dev.type != "cpu":
        nvcc.refuse_grad("rankine_assembly (K3)", pans, c, nrm, area, diag, panel_mask,
                         self_pot, *(quad or ()))
    if dev.type == "cpu":
        if near_count is not None:
            raise ValueError("near_count counts the kernel's near pass; the plain version has none")
        return torch_bem.rankine_plain(pans, c, nrm, area, diag, panel_mask, lid_surface,
                                       self_pot, quad=quad)
    _require_cuda(dev)
    if quad is None:
        raise ValueError("rankine_assembly on the card takes quad=, the subdivision points "
                         "staged by torch_bem.stage_tables (tab['quad'])")
    us, vs, wf = quad
    if any(t.shape != (torch_bem.LEVEL_START[-1] + torch_bem.LEVEL_COUNT[-1],)
           for t in (us, vs, wf)):
        raise ValueError("quad must be the 766 subdivision points of torch_bem.quad_points")
    n = c.shape[0]
    if pans.shape != (n, 4, 3) or c.shape != (n, 3) or nrm.shape != (n, 3):
        raise ValueError(f"pans (n, 4, 3), c and nrm (n, 3) expected, got "
                         f"{tuple(pans.shape)}, {tuple(c.shape)}, {tuple(nrm.shape)}")
    for name, t in (("area", area), ("diag", diag), ("panel_mask", panel_mask),
                    ("lid_surface", lid_surface), ("self_pot", self_pot)):
        if t.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    if lid_surface.dtype != torch.bool or lid_surface.device != dev:
        raise ValueError(f"lid_surface must be a bool tensor on {dev}")
    if near_count is not None and (near_count.shape != (1,) or near_count.dtype != torch.int32
                                   or near_count.device != dev):
        raise ValueError(f"near_count must be a (1,) int32 tensor on {dev}")
    a = _checked(dev, dtype, pans=pans, c=c, nrm=nrm, area=area, diag=diag, mask=panel_mask,
                 spot=self_pot, us=us, vs=vs, wf=wf)
    lids = lid_surface.contiguous()
    R_pot = torch.empty((n, n), dtype=dtype, device=dev)
    R_dn = torch.empty_like(R_pot)
    lib = build()["rankine"]
    words = getattr(lib, f"bem_rankine_workspace_{_SUFFIX[dtype]}")(n)
    if words < 0:
        raise RuntimeError("bem_rankine: the launch could not be planned on this device")
    work = torch.empty(words, dtype=torch.int32, device=dev)
    fn = getattr(lib, f"bem_rankine_{_SUFFIX[dtype]}")
    err = fn(*(a[k].data_ptr() for k in ("pans", "c", "nrm", "area", "diag", "mask")),
             lids.data_ptr(), *(a[k].data_ptr() for k in ("spot", "us", "vs", "wf")),
             n, R_pot.data_ptr(), R_dn.data_ptr(), work.data_ptr(), words,
             None if near_count is None else near_count.data_ptr(), nvcc.stream_of(dev))
    nvcc.check(err, "bem_rankine")
    LAUNCHES["rankine_bf16" if dtype == torch.bfloat16 else "rankine"] += 1
    return R_pot, R_dn


def wave_assembly(R_pot: Tensor, R_dn: Tensor, c: Tensor, nrm: Tensor, area: Tensor,
                  panel_mask: Tensor, lid_surface: Tensor, tab: dict, k: Tensor,
                  fd: dict | None, *, finite_depth: bool, depth: float):
    """K4: ``(S_re, S_im, Dn_re, Dn_im)`` (nf, n, n) for one frequency chunk;
    see :func:`raft_tpu_torch.hydro.torch_bem.wave_plain` for the arguments."""
    from raft_tpu_torch.hydro import torch_bem, wavetable

    dev, dtype = c.device, c.dtype
    if dev.type != "cpu":
        nvcc.refuse_grad("wave_assembly (K4)", R_pot, R_dn, c, nrm, area, panel_mask, k,
                         tab["I0"], tab["I1"], *(fd.values() if fd else ()))
    if dev.type == "cpu":
        return torch_bem.wave_plain(R_pot, R_dn, c, nrm, area, panel_mask, lid_surface, tab,
                                    k, fd, finite_depth=finite_depth, depth=depth)
    _require_cuda(dev)
    n = c.shape[0]
    nf = k.shape[0]
    if R_pot.shape != (n, n) or R_dn.shape != (n, n):
        raise ValueError(f"R_pot and R_dn must be ({n}, {n})")
    if tab["I0"].shape != (wavetable.NX, wavetable.NS) or tab["I1"].shape != tab["I0"].shape:
        raise ValueError(f"tables must be ({wavetable.NX}, {wavetable.NS})")
    node_s, node_w, coef = tab["near"]
    if node_s.shape != (16,) or node_w.shape != (16,):
        raise ValueError("the near quadrature takes 16 nodes")
    if coef.shape != (torch_bem.N_SERIES,):
        raise ValueError(f"the E1 series takes {torch_bem.N_SERIES} coefficients")
    if finite_depth:
        nl = fd["lam"].shape[-1]
        if nl > 64:
            raise ValueError(f"the kernel takes at most 64 fit terms, got {nl}")
        fit = {key: fd[key] for key in ("k0", "A0", "active", "lam", "a")}
        if any(fit[key].shape != (nf,) for key in ("k0", "A0", "active")) or \
                fit["lam"].shape != (nf, nl) or fit["a"].shape != (nf, nl):
            raise ValueError("fd: k0, A0, active (nf,) and lam, a (nf, NL) expected")
    else:
        nl = 1
        z = torch.zeros(nf, dtype=dtype, device=dev)
        fit = {"k0": z, "A0": z, "active": z, "lam": z[:, None], "a": z[:, None]}
    a = _checked(dev, dtype, Rp=R_pot, Rdn=R_dn, c=c, nrm=nrm, area=area, mask=panel_mask,
                 lids=lid_surface, I0=tab["I0"], I1=tab["I1"], node_s=node_s, node_w=node_w,
                 coef=coef, k=k, **fit)
    outs = [torch.empty((nf, n, n), dtype=dtype, device=dev) for _ in range(4)]
    if nf == 0:
        return tuple(outs)
    lib = build()["wave"]
    fn = getattr(lib, f"bem_wave_{_SUFFIX[dtype]}")
    ptr = {key: t.data_ptr() for key, t in a.items()}
    err = fn(ptr["Rp"], ptr["Rdn"], ptr["c"], ptr["nrm"], ptr["area"], ptr["mask"],
             ptr["lids"], ptr["I0"], ptr["I1"], ptr["node_s"], ptr["node_w"], ptr["coef"],
             wavetable.NX, wavetable.NS, float(wavetable.XMAX), float(wavetable.SMAX),
             ptr["k"], ptr["k0"], ptr["A0"], ptr["active"], ptr["lam"], ptr["a"],
             nl, n, nf, int(bool(finite_depth)), float(depth),
             *(o.data_ptr() for o in outs), nvcc.stream_of(dev))
    nvcc.check(err, "bem_wave")
    LAUNCHES["wave_bf16" if dtype == torch.bfloat16 else "wave"] += 1
    return tuple(outs)
