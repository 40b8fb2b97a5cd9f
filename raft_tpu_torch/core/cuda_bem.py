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
libraries are built by ``nvcc`` at first use through the kernel-library
registry (:mod:`raft_tpu_torch.core.nvcc`, :mod:`raft_tpu_torch.cache.aot`).

:func:`k3_work` and :func:`k4_work` count the operations and bytes of a
launch's function on its inputs (the work depends on the data: each pair's
subdivision level in K3, each image's region of the wave integrals in
K4), and its least time on the card.  While the cache is enabled each
launch is timed into the per-kernel performance ledger
(:mod:`raft_tpu_torch.obs.ledger`) with CUDA events; the counts it reads
(:func:`k3_counts`, :func:`k4_counts`) are computed on the card before the
launch and reach the host without a wait.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from raft_tpu_torch.core import nvcc
from raft_tpu_torch.obs import ledger

Tensor = torch.Tensor

#: kernel launches per wrapper (never the plain path)
LAUNCHES = {"rankine": 0, "wave": 0, "rankine_bf16": 0, "wave_bf16": 0}
_launch_lock = threading.Lock()
#: the C entries' suffix for each storage dtype
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}

_P, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
_RANKINE_SIG = (_P,) * 11 + (_I, _P, _P, _P, _I, _P, _P)
_WAVE_SIG = ((_P,) * 12 + (_I, _I, _D, _D) + (_P,) * 6 + (_I, _I, _I, _I, _D)
             + (_P,) * 4 + (_P,))
RANKINE = nvcc.Spec("bem_rankine", "bem_rankine.cu", (), tuple(
    (f"bem_rankine_{x}", _RANKINE_SIG, None) for x in _SUFFIX.values()) + tuple(
    (f"bem_rankine_workspace_{x}", (_I,), _I) for x in _SUFFIX.values()))
WAVE = nvcc.Spec("bem_wave", "bem_wave.cu", (), tuple(
    (f"bem_wave_{x}", _WAVE_SIG, None) for x in _SUFFIX.values()))


def _lib(spec: nvcc.Spec):
    """One of the two libraries, through the kernel-library registry; a
    build compiles both at once."""
    from raft_tpu_torch.cache import aot

    return aot.library(spec, (RANKINE, WAVE))


def build() -> dict:
    """Both kernel libraries (built once per key, with one ``nvcc`` each
    started together, and opened once per process)."""
    return {"rankine": _lib(RANKINE), "wave": _lib(WAVE)}


# floating-point operations of K3's function, each add, subtract,
# multiply, negation, division, sqrt and rsqrt one (a fused multiply-add
# two), counted for the function and not for the kernel's layout: per
# pair of an unmasked source column, the two level selections and the
# store; per subdivision point position and weight, once per (unmasked
# source panel, point of a level that some pair of its column needs); per
# contribution, one point source (potential + normal derivative)
K3_FLOPS_PAIR, K3_FLOPS_POINT, K3_FLOPS_CONTRIB = 22, 28, 22
# a pair with a level of 36 or more points (level ids above 1) is a near
# pair: bem_rankine.cu's kFarLevel
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


def _bound(flops, nbytes, dtype_name: str) -> dict:
    """The least time of ``flops`` and ``nbytes`` on the card (the ledger's
    H100 peaks)."""
    t_ops = flops / ledger.PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / ledger.HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": 1e3 * t_ops, "bytes_ms": 1e3 * t_bytes}


def k3_bytes(n: int, itemsize: int) -> int:
    """Bytes of one K3 call: its inputs read once (the lid flags a byte
    each), its two (n, n) outputs written once."""
    return itemsize * (12 * n + 3 * n + 3 * n + 4 * n + 3 * 766 + 2 * n * n) + n


def k3_counts(c: Tensor, diag: Tensor, panel_mask: Tensor, lid_surface: Tensor) -> dict:
    """K3's data-dependent counts as tensors on the inputs' device, with no
    wait for it: the pairs' level ids ``sel_d``, ``sel_i``, their points
    per pair ``cd``, ``ci``, the unmasked columns ``col`` and the
    operations ``flops`` (int64)."""
    from raft_tpu_torch.hydro import torch_bem

    n = c.shape[0]
    sel_d, sel_i = torch_bem.pair_levels(c, diag, lid_surface)

    def points_of(sel):                      # level id -1 has no points
        return sum(torch.where(sel == lv, nq, 0) for lv, nq in
                   enumerate(torch_bem.LEVEL_COUNT))

    cd, ci = points_of(sel_d), points_of(sel_i)
    col = (panel_mask > 0.5)[None, :]
    points = sum((((sel_d == lv) | (sel_i == lv)) & col).any(dim=0).sum() * nq
                 for lv, nq in enumerate(torch_bem.LEVEL_COUNT))
    flops = (n * col.sum() * K3_FLOPS_PAIR + points * K3_FLOPS_POINT
             + ((cd + ci) * col).sum() * K3_FLOPS_CONTRIB)
    return {"sel_d": sel_d, "sel_i": sel_i, "cd": cd, "ci": ci, "col": col, "flops": flops}


def k3_work(c, diag, panel_mask, lid_surface, itemsize: int, dtype_name: str) -> dict:
    """Pairs per level (``hist``), contributions per pair, near pairs (a
    level of 36 or more points), operations and bytes of K3's function on
    these inputs, and its bound (``bound_ms``, ``bound_by``).  ``itemsize``
    is the storage's (2 for the bf16 entry), ``dtype_name`` the arithmetic's
    (``"float32"`` for bf16: bf16 storage is computed in float32, so there
    is no bf16 peak to count against).  Reads the counts back to the host."""
    n = c.shape[0]
    k = k3_counts(c, diag, panel_mask, lid_surface)
    sel_d, sel_i, cd, ci = k["sel_d"], k["sel_i"], k["cd"], k["ci"]
    near = (sel_d > K3_FAR_LEVEL) | (sel_i > K3_FAR_LEVEL)
    contribs = int((cd + ci).sum())
    flops = int(k["flops"])
    hist = {"direct": torch.bincount(sel_d.flatten().long() + 1, minlength=6).tolist()[1:5],
            "image": torch.bincount(sel_i.flatten().long() + 1, minlength=6).tolist()[1:]}
    b = _bound(flops, k3_bytes(n, itemsize), dtype_name)
    return {"hist": hist, "per_pair": contribs / (n * n), "near_pairs": int(near.sum()),
            "near_share": float((cd + ci)[near].sum()) / contribs, "mflop": flops / 1e6,
            "flops": flops, "bytes_accessed": k3_bytes(n, itemsize),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}


def k4_bytes(n: int, nf: int, itemsize: int) -> int:
    """Bytes of one K4 call on ``nf`` frequencies: its inputs read once,
    its four (nf, n, n) outputs written once."""
    from raft_tpu_torch.hydro import wavetable

    return itemsize * (2 * n * n + 9 * n + 2 * wavetable.NX * wavetable.NS + 44
                       + nf * (4 + 2 * 46) + 4 * nf * n * n)


#: image evaluations a block of :func:`k4_counts` holds at once (bounds its
#: temporaries to a few hundred MB at the 2,048 class)
K4_COUNT_BLOCK = 1 << 24


def k4_counts(c: Tensor, area: Tensor, lid_surface: Tensor, k: Tensor, fd, depth: float,
              fd_active=None) -> dict:
    """K4's data-dependent counts as int64 tensors on the inputs' device,
    with no wait for it: ``regions``, the image evaluations per region of
    the wave integrals, and ``flops``.  A frequency whose finite-depth fit
    is active (``fd["active"]``) evaluates its four images, the others
    their deep-water image.  ``fd_active``, the same branches as host
    booleans where the caller has them, evaluates only each frequency's
    own branch; without it both are evaluated and weighted on the card.
    Frequencies are evaluated in blocks, a few launches per block."""
    from raft_tpu_torch.hydro import torch_bem, wavetable

    n, nf = c.shape[0], k.shape[0]
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    R = torch.sqrt(dx * dx + dy * dy + 1e-20)
    diag_lid = torch.eye(n, dtype=torch.bool, device=c.device) & lid_surface[None, :]
    R_use = torch.where(diag_lid, 0.4 * torch.sqrt(torch.clamp(area, min=1e-14))[None, :], R)
    zP, zQ = c[:, 2][:, None], c[:, 2][None, :]
    zero = torch.zeros((), dtype=torch.int64, device=c.device)
    regions = dict.fromkeys(("near", "table", "far", "deep"), zero)
    flops = zero + K4_FLOPS_PAIR * n * n
    if fd is None:
        act = None
        fd_active = [False] * nf
    else:
        act = (fd["active"] > 0.5).long()
        d4 = torch.stack((-(zP + zQ), 2 * depth - (zP - zQ), 2 * depth + (zP - zQ),
                          4 * depth + (zP + zQ)))                     # (4, n, n)
    # (lo, hi, branches): "deep", "fd" or both, weighted by act on the card
    runs = ([(0, nf, ("deep", "fd"))] if fd is not None and fd_active is None else
            [(lo, hi, ("fd",) if on else ("deep",))
             for lo, hi, on in torch_bem._runs(fd_active)])

    def split(X, Y, on):
        """Add the region counts of the images Y (m, nimg, n, n) at X
        (m, 1, n, n), frequency m weighted by ``on`` (m,); the near pairs
        of each frequency (m,), any image near."""
        rho = torch.sqrt(X * X + Y * Y + 1e-18)
        near = rho < 0.6
        far = ~near & (X >= wavetable.XMAX * (1.0 - 1e-7))
        deep = ~near & ~far & (torch.log1p(-Y) >= wavetable.SMAX * (1.0 - 1e-7))
        for key, sel in (("near", near), ("far", far), ("deep", deep),
                         ("table", ~near & ~far & ~deep)):
            regions[key] = regions[key] + (sel.sum(dim=(1, 2, 3)) * on).sum()
        return near.any(dim=1).sum(dim=(1, 2)) * on

    for lo, hi, branches in runs:
        for b in ("deep", "fd"):
            if b not in branches:
                continue
            nimg = 1 if b == "deep" else 4
            step = max(1, K4_COUNT_BLOCK // (nimg * n * n))
            for a in range(lo, hi, step):
                sl = slice(a, min(a + step, hi))
                m = sl.stop - sl.start
                ones = torch.ones(m, dtype=torch.int64, device=c.device)
                if b == "deep":
                    on = ones if act is None or len(branches) == 1 else 1 - act[sl]
                    kk = k[sl][:, None, None, None]
                    near_pairs = split(kk * R_use, kk * (zP + zQ)[None, None], on)
                    flops = flops + (on * K4_FLOPS_DEEP * n * n).sum()
                else:
                    on = ones if len(branches) == 1 else act[sl]
                    k0 = fd["k0"][sl][:, None, None, None]
                    near_pairs = split(k0 * R_use, -k0 * d4[None], on)
                    flops = flops + (on * K4_FLOPS_FD * n * n).sum()
                flops = flops + (K4_FLOPS_NEAR_PAIR * near_pairs).sum()
    flops = flops + K4_FLOPS_COMBINE * n * n * nf
    flops = flops + sum(K4_FLOPS_REGION[key] * cnt for key, cnt in regions.items())
    return {"regions": regions, "flops": flops}


def k4_work(c, area, lid_surface, k, fd, depth: float, itemsize: int, dtype_name: str,
            fd_active=None) -> dict:
    """Operations and bytes of one K4 call on these inputs (each pair's
    region of the wave integrals, per image and frequency), and its bound:
    ``bound_ms``, ``bound_by``, ``ops_ms``, ``bytes_ms`` and ``regions``,
    the image evaluations per region.  ``itemsize`` and ``dtype_name`` as in
    :func:`k3_work` (2 and ``"float32"`` for the bf16 entry).  Reads the
    counts back to the host."""
    counts = k4_counts(c, area, lid_surface, k, fd, depth, fd_active)
    flops = int(counts["flops"])
    nbytes = k4_bytes(c.shape[0], k.shape[0], itemsize)
    return {**_bound(flops, nbytes, dtype_name), "flops": flops, "bytes_accessed": nbytes,
            "regions": {key: int(v) for key, v in counts["regions"].items()}}


def _arith(dtype) -> str:
    """The arithmetic's dtype name (bf16 storage computes in float32)."""
    return "float64" if dtype == torch.float64 else "float32"


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
    lib = _lib(RANKINE)
    words = getattr(lib, f"bem_rankine_workspace_{_SUFFIX[dtype]}")(n)
    if words < 0:
        raise RuntimeError("bem_rankine: the launch could not be planned on this device")
    work = torch.empty(words, dtype=torch.int32, device=dev)
    fn = getattr(lib, f"bem_rankine_{_SUFFIX[dtype]}")
    bf16 = dtype == torch.bfloat16

    def counted():
        up = {key: a[key].float() if bf16 else a[key] for key in ("c", "diag", "mask")}
        return {"flops": k3_counts(up["c"], up["diag"], up["mask"], lids)["flops"],
                "bytes_accessed": float(k3_bytes(n, c.element_size()))}

    with ledger.launch("bem_rankine_bf16" if bf16 else "bem_rankine",
                       f"n{n}:{_SUFFIX[dtype]}", _arith(dtype), dev, counted):
        err = fn(*(a[k].data_ptr() for k in ("pans", "c", "nrm", "area", "diag", "mask")),
                 lids.data_ptr(), *(a[k].data_ptr() for k in ("spot", "us", "vs", "wf")),
                 n, R_pot.data_ptr(), R_dn.data_ptr(), work.data_ptr(), words,
                 None if near_count is None else near_count.data_ptr(), nvcc.stream_of(dev))
        nvcc.check(err, "bem_rankine")
    with _launch_lock:
        LAUNCHES["rankine_bf16" if dtype == torch.bfloat16 else "rankine"] += 1
    return R_pot, R_dn


def wave_assembly(R_pot: Tensor, R_dn: Tensor, c: Tensor, nrm: Tensor, area: Tensor,
                  panel_mask: Tensor, lid_surface: Tensor, tab: dict, k: Tensor,
                  fd: dict | None, *, finite_depth: bool, depth: float, fd_active=None):
    """K4: ``(S_re, S_im, Dn_re, Dn_im)`` (nf, n, n) for one frequency chunk;
    see :func:`raft_tpu_torch.hydro.torch_bem.wave_plain` for the arguments
    (``fd_active``, the fit's branches on the host where the caller has
    them, only makes the armed ledger's counts cheaper)."""
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
    lib = _lib(WAVE)
    fn = getattr(lib, f"bem_wave_{_SUFFIX[dtype]}")
    ptr = {key: t.data_ptr() for key, t in a.items()}
    bf16 = dtype == torch.bfloat16

    def counted():
        up = {key: a[key].float() if bf16 else a[key] for key in ("c", "area", "k")}
        fit = ({key: fd[key].float() if bf16 else fd[key] for key in ("active", "k0")}
               if finite_depth else None)
        return {"flops": k4_counts(up["c"], up["area"], lid_surface, up["k"], fit,
                                   float(depth), fd_active if finite_depth else None)["flops"],
                "bytes_accessed": float(k4_bytes(n, nf, c.element_size()))}

    with ledger.launch("bem_wave_bf16" if bf16 else "bem_wave",
                       f"n{n}xf{nf}:{'fd' if finite_depth else 'deep'}:{_SUFFIX[dtype]}",
                       _arith(dtype), dev, counted):
        err = fn(ptr["Rp"], ptr["Rdn"], ptr["c"], ptr["nrm"], ptr["area"], ptr["mask"],
                 ptr["lids"], ptr["I0"], ptr["I1"], ptr["node_s"], ptr["node_w"], ptr["coef"],
                 wavetable.NX, wavetable.NS, float(wavetable.XMAX), float(wavetable.SMAX),
                 ptr["k"], ptr["k0"], ptr["A0"], ptr["active"], ptr["lam"], ptr["a"],
                 nl, n, nf, int(bool(finite_depth)), float(depth),
                 *(o.data_ptr() for o in outs), nvcc.stream_of(dev))
        nvcc.check(err, "bem_wave")
    with _launch_lock:
        LAUNCHES["wave_bf16" if dtype == torch.bfloat16 else "wave"] += 1
    return tuple(outs)
