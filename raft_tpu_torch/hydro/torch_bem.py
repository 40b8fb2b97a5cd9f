"""On-device panel BEM (port of ``raft_tpu.hydro.jax_bem``).

The Hess & Smith constant-source panel method of the JAX package, on
tensors of the model's device and dtype:

* **Green function.** Deep water: G = 1/r + 1/r1 + 2k[I0 - i pi e^Y J0],
  with the principal-value wave integrals I0/I1 read bilinearly from the
  host-built smooth-part tables (:mod:`raft_tpu_torch.hydro.wavetable`)
  plus the singular closed forms; pairs with rho = |(X, Y)| < ``R_NEAR``
  take a 16-node theta quadrature with a 12-term E1 series, far pairs the
  Bessel asymptotics.  Finite depth: four images, a 46-term exponential
  fit (host f64, per frequency) and a seabed image.
* **Rankine parts.** The 1/r and free-surface-image panel integrals by
  ns x ns midpoint subdivision, ns chosen per pair from distance over
  diagonal (direct 1/3/6/12, image 1/3/6/12/24); the direct self term is
  the exact flat-polygon formula.
* **Solve.** One complex system per frequency with 6 radiation + one
  diffraction column per heading, in the real 2n x 2n block form,
  LU-factored once per frequency (``torch.linalg.lu_factor_ex``, one call
  per system: cuSOLVER on the card) with ``N_REFINE`` refinement steps;
  the residual is returned per frequency.  The solve takes tensors staged
  once by its caller (:func:`stage_inputs`, :func:`stage_tables`) and
  copies nothing from the host.
* **Padding.** Panel counts round up to the ``PANEL_CLASSES`` ladder with
  degenerate zero-area panels and explicit masks.

The two assembly stages are kernels on the card (``core/cuda_bem.py``):
K3 :func:`rankine_assembly` (``csrc/bem_rankine.cu``) and K4
:func:`wave_assembly` (``csrc/bem_wave.cu``).  Their plain versions live
here, :func:`rankine_plain` and :func:`wave_plain`: CPU tensors take them,
CUDA tensors launch the kernels at any panel count (the kernels guard the
edge of the pair grid, so the JAX package's rule that sends a count off
its 64-panel tiles to the XLA route has nothing to protect here).  The
plain Rankine sum follows the Pallas kernel's order: per subdivision
point, the direct then the image contribution is added to
``R_pot = pot_d + pot_i`` and to ``R_dn = (grad_d + grad_i) . n_i``
(projected per point).  In f64 it agrees with the XLA route's separate
sums to ~3e-16.

**Gradient.** :func:`make_bem_fn` returns ``theta -> (A, B, F)`` of the
warped hull, differentiable: ``solve_panels(assembly="plain")`` runs the
plain versions, which autograd differentiates, with the frequency chunks,
quadrature points, wave-integral evaluations, near nodes and fit terms
recomputed in the backward pass (``_remat``), and the refined solve has
its implicit-function rule (:func:`solve_refined`).

**Precision.** ``RAFT_TPU_BEM_PRECISION`` (:func:`bem_precision`, or the
``precision=`` argument): ``bf16`` runs the assembly stage (K3, K4 or
their plain versions) on bfloat16 inputs with bfloat16 outputs when the
solve's dtype is float32, as the JAX package's knob does; the factor, the
refinement, the right-hand sides and the contractions stay in the solve's
dtype, and S, Dn are cast up at the same boundary.  A float64 solve
ignores the knob.  The plain versions give bf16 the kernels' meaning:
upcast to float32, compute, round each output once to bfloat16 (the JAX
package's XLA route rounds after every operation instead).

**Routing.** :func:`solve_bem_any` sends a solve to this on-device route
(mode ``"jax"``) or to the host C++ solver
(:mod:`raft_tpu_torch.hydro.native_bem`, mode ``"native"``); ``"auto"``
(the default, through ``RAFT_TPU_BEM``) takes the kernels on the card and
the native solver on the CPU (:func:`resolved_mode`).  Results of both
routes are cached on disk, content-addressed (``cache=True``).  Within the
on-device route, ``RAFT_TPU_BEM_ASSEMBLY`` (:func:`resolved_assembly`;
the JAX package's ``xla`` is ``"plain"`` here, ``pallas`` is
``"kernels"``) picks the assembly: unset, K3/K4 on the card and the plain
versions on the CPU.

The module's name avoids the old one, which names a framework; the
``BEM="jax"`` mode name and :func:`solve_bem_jax` keep the JAX package's
spelling so callers carry across.
"""
from __future__ import annotations

import functools
import hashlib
import math
import os
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raft_tpu_torch.core import bessel
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.cuda_bem import rankine_assembly, wave_assembly
from raft_tpu_torch.core.device import require_on, resolve_device
from raft_tpu_torch.hydro import wavetable
from raft_tpu_torch.obs.trace import span

Tensor = torch.Tensor

#: refinement steps after the factor-once solve
N_REFINE = 2
#: below this rho = |(X, Y)| the wave integrals take the direct quadrature
R_NEAR = 0.6
#: parity tolerance of the JAX package's device solve against its f64
#: native oracle, scale-relative per output (A, B, F)
PARITY_RTOL = 3e-3
#: padded panel-count classes (the JAX package's ``panels`` ladder)
PANEL_CLASSES = (64, 128, 256, 512, 768, 1024, 1536, 2048)
#: subdivision levels of the Rankine integration (ns x ns midpoint)
LEVELS = (1, 3, 6, 12, 24)
#: E1 series terms of the near quadrature
N_SERIES = 12
#: the assembly-precision knob: ``f32`` (default) | ``bf16``
PRECISION_ENV = "RAFT_TPU_BEM_PRECISION"
#: the assembly-route knob: ``xla`` (the plain versions) | ``pallas`` (K3/K4) | ``auto``
ASSEMBLY_ENV = "RAFT_TPU_BEM_ASSEMBLY"

_PI = float(np.pi)
_TWO_PI = float(2.0 * np.pi)
_EULER = 0.5772156649015329

# the 16-node Gauss-Legendre rule of the near quadrature, stored f32 as in
# the JAX package (the kernel dtype cast upcasts them for f64 runs)
GL16_X, GL16_W = (a.astype(np.float32) for a in np.polynomial.legendre.leggauss(16))


def parity_err(got, ref) -> float:
    """max |got - ref| / max |ref|: the scale-relative metric of
    ``PARITY_RTOL`` (componentwise ratios would compare noise to noise in
    the unexcited symmetric DOFs)."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def pad_panel_count(n_total: int) -> int:
    """Smallest ``PANEL_CLASSES`` class admitting ``n_total`` panels."""
    for c in PANEL_CLASSES:
        if c >= n_total:
            return c
    raise ValueError(f"{n_total} panels exceed the largest class "
                     f"{PANEL_CLASSES[-1]}; mesh coarser (dz_max, da_max)")


_precision_warned = False


def bem_precision(env: str | None = None) -> str:
    """The ``RAFT_TPU_BEM_PRECISION`` knob (or ``env`` in its place):
    ``"bf16"`` for bf16 or bfloat16, ``"f32"`` otherwise, as in the JAX
    package.  ``bf16`` runs the assembly stage in bfloat16 on a float32
    solve (:func:`solve_panels`); a value other than empty, f32, float32,
    bf16 or bfloat16 warns once and is ``f32``."""
    global _precision_warned
    raw = os.environ.get(PRECISION_ENV, "") if env is None else env
    val = raw.strip().lower()
    if val in ("", "f32", "float32"):
        return "f32"
    if val in ("bf16", "bfloat16"):
        return "bf16"
    if not _precision_warned:
        _precision_warned = True
        warnings.warn(f"{PRECISION_ENV}={raw!r} is not one of f32|bf16; using f32", stacklevel=2)
    return "f32"


#: the JAX package's route names -> :data:`ASSEMBLIES`
_ASSEMBLY_NAMES = {"xla": "plain", "pallas": "kernels"}
_assembly_lock = threading.Lock()
_assembly_warned = False


def assembly_mode(env: str | None = None) -> str:
    """The ``RAFT_TPU_BEM_ASSEMBLY`` knob (or ``env`` in its place):
    ``"plain"`` for xla, ``"kernels"`` for pallas, ``"auto"`` when unset or
    empty.  Any other value warns once per process and is ``"auto"``, as
    in the JAX package."""
    global _assembly_warned
    raw = os.environ.get(ASSEMBLY_ENV, "") if env is None else env
    val = raw.strip().lower()
    if val in ("", "auto"):
        return "auto"
    if val in _ASSEMBLY_NAMES:
        return _ASSEMBLY_NAMES[val]
    with _assembly_lock:
        warn, _assembly_warned = not _assembly_warned, True
    if warn:
        warnings.warn(f"{ASSEMBLY_ENV}={raw!r} is not one of xla|pallas|auto; using auto",
                      stacklevel=2)
    return "auto"


def resolved_assembly(mode: str | None = None, device=None) -> str:
    """``"kernels"`` (K3/K4) or ``"plain"`` (their plain versions) for a
    solve on ``device`` (None means the card).  An explicit ``mode`` forces
    the route; an explicit ``"auto"`` defers to the knob first, as the JAX
    package's ``resolved_assembly`` does; ``auto`` takes the kernels on a
    CUDA device and the plain versions on the CPU (where the wrappers run
    the plain versions anyway)."""
    m = assembly_mode() if mode is None else assembly_mode(env=mode)
    if m == "auto" and mode is not None:
        m = assembly_mode()
    if m != "auto":
        return m
    return "kernels" if resolve_device(device).type == "cuda" else "plain"


def assembly_dtype(precision: str | None, dtype):
    """The assembly stage's dtype for a solve in ``dtype``: bfloat16 when
    ``precision`` (None reads the knob) resolves to ``bf16`` and the solve
    is float32, else ``dtype`` (the JAX package's rule)."""
    prec = bem_precision(precision)
    return torch.bfloat16 if prec == "bf16" and dtype == torch.float32 else dtype


def model_solve_dtype(dtype):
    """The dtype of ``Model.calcBEM``'s on-device panel solve for a model in
    ``dtype``: float32 when ``RAFT_TPU_BEM_PRECISION`` resolves to ``bf16``
    (a float32 solve with the bf16 assembly, what the JAX package's Model,
    which always solves in float32, does under the knob), else ``dtype``."""
    return torch.float32 if bem_precision() == "bf16" else dtype


def _cast(x, dtype):
    """Tensors in ``x`` (a tensor, or a tuple or dict of them, or None)
    cast to ``dtype``; other leaves as they are."""
    if isinstance(x, Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        return tuple(_cast(v, dtype) for v in x)
    if isinstance(x, dict):
        return {key: _cast(v, dtype) for key, v in x.items()}
    return x


def _remat(fn, *args):
    """``fn(*args)``; when autograd records the call, its intermediates are
    recomputed in the backward pass instead of kept (the JAX package's
    ``jax.checkpoint``).  Without grad it is a plain call, so the forward
    bits do not depend on it."""
    if torch.is_grad_enabled() and any(isinstance(a, Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ------------------------------------------------------------ wave integrals

def _phi_near(zr: Tensor, zi: Tensor):
    """Phi(zeta) = e^zeta [E1(zeta) + i pi] and dPhi = -1/zeta + Phi for
    small |zeta| (short, cancellation-free series)."""
    az2 = zr * zr + zi * zi
    az2 = torch.clamp(az2, min=1e-14)
    log_re = 0.5 * torch.log(az2)
    log_im = torch.atan2(zi, zr)
    tr, ti = -zr, -zi
    sr, si = -tr, -ti
    for n in range(2, N_SERIES + 1):
        tr, ti = (tr * (-zr) - ti * (-zi)) / n, (tr * (-zi) + ti * (-zr)) / n
        sr = sr - tr / n
        si = si - ti / n
    e1r = -_EULER - log_re + sr
    e1i = -log_im + si
    ez = torch.exp(zr)
    cr, ci = torch.cos(zi), torch.sin(zi)
    phr = ez * (cr * e1r - ci * (e1i + _PI))
    phi = ez * (cr * (e1i + _PI) + ci * e1r)
    inv = 1.0 / az2
    return phr, phi, phr - zr * inv, phi + zi * inv


def _near_node(X: Tensor, Y: Tensor, x_q: Tensor, w_q: Tensor):
    """One node's terms of the near quadrature: (w Phi.re, w sin(theta) dPhi.im)."""
    th = 0.5 * _PI + 0.5 * _PI * x_q
    s = torch.sin(th)
    w = w_q * 0.5 * _PI
    phr, _phi, _dphr, dphi = _phi_near(Y, X * s)
    return w * phr, w * s * dphi


def _near_integrals(X: Tensor, Y: Tensor, nodes):
    """(I0, I1) by direct theta quadrature, valid for rho <= R_NEAR."""
    glx, glw = nodes
    acc0 = torch.zeros_like(X)
    accX = torch.zeros_like(X)
    for q in range(glx.shape[0]):
        t0, tX = _remat(_near_node, X, Y, glx[q], glw[q])
        acc0 = acc0 + t0
        accX = accX - tX
    i0 = acc0 / _PI
    dI0_dX = accX / _PI
    rr = torch.sqrt(torch.clamp(X * X + Y * Y, min=1e-14))
    pos = X > 1e-9
    xs = torch.where(pos, X, torch.ones_like(X))
    C1 = torch.where(pos, (1.0 / xs) * (1.0 - (-Y) / rr), torch.zeros_like(X))
    i1 = torch.where(pos, -C1 - dI0_dX, torch.zeros_like(X))
    return i0, i1


def _sing_i0(X, Y):
    return -0.5 * torch.log(torch.clamp(X * X + Y * Y, min=1e-30))


def _sing_i1(X, Y):
    r2 = torch.clamp(X * X + Y * Y, min=1e-30)
    pos = X > 1e-9
    xs = torch.where(pos, X, torch.ones_like(X))
    C1 = torch.where(pos, (1.0 / xs) * (1.0 - (-Y) / torch.sqrt(r2)), torch.zeros_like(X))
    return -C1 + X / r2


def eval_wave_integrals(X: Tensor, Y: Tensor, tab: dict):
    """(I0, I1) at any X >= 0, Y <= 0: near quadrature, bilinear table,
    far-field Bessel or the deep 1/rho tail, every region evaluated
    densely and selected with ``where`` (the JAX package's split).

    ``tab``: ``{"I0", "I1"}`` (NX, NS) tensors and ``"nodes"``, the GL
    node and weight tensors, all on X's device in X's dtype."""
    return _remat(_wave_integrals, X, Y, tab)


def _wave_integrals(X: Tensor, Y: Tensor, tab: dict):
    NXm1, NSm1 = wavetable.NX - 1, wavetable.NS - 1
    rho = torch.sqrt(X * X + Y * Y + 1e-18)
    near = rho < R_NEAR
    Xn = torch.where(near, X, torch.full_like(X, 0.1))
    Yn = torch.where(near, Y, torch.full_like(Y, -0.1))
    i0_near, i1_near = _near_integrals(Xn, Yn, tab["nodes"])
    s = torch.log1p(-Y)
    fx = torch.clamp(X, 0.0, wavetable.XMAX) / (wavetable.XMAX / NXm1)
    ix = torch.clamp(fx.to(torch.int32), 0, NXm1 - 1).long()
    tx = fx - ix.to(X.dtype)
    fs = torch.clamp(s, 0.0, wavetable.SMAX) / (wavetable.SMAX / NSm1)
    is_ = torch.clamp(fs.to(torch.int32), 0, NSm1 - 1).long()
    ts = fs - is_.to(X.dtype)

    def lerp(T):
        a = T[ix, is_]
        b = T[ix + 1, is_]
        c = T[ix, is_ + 1]
        d = T[ix + 1, is_ + 1]
        return (1 - tx) * ((1 - ts) * a + ts * c) + tx * ((1 - ts) * b + ts * d)

    i0_tab = lerp(tab["I0"]) + _sing_i0(X, Y)
    i1_tab = lerp(tab["I1"]) + _sing_i1(X, Y)
    eY = torch.exp(Y)
    Xf = torch.clamp(X, min=1.0)
    i0_far = -_PI * eY * bessel.y0(Xf)
    i1_far = -_PI * eY * bessel.y1(Xf)
    rr = torch.clamp(rho, min=1e-30)
    i0_deep = -1.0 / rr
    pos = X > 1e-9
    xs = torch.where(pos, X, torch.ones_like(X))
    i1_deep = torch.where(pos, -(1.0 / xs) * (1.0 - (-Y) / rr), torch.zeros_like(X))
    far = X >= wavetable.XMAX * (1.0 - 1e-7)
    deep = s >= wavetable.SMAX * (1.0 - 1e-7)
    i0 = torch.where(near, i0_near, torch.where(far, i0_far, torch.where(deep, i0_deep, i0_tab)))
    i1 = torch.where(near, i1_near, torch.where(far, i1_far, torch.where(deep, i1_deep, i1_tab)))
    return i0, i1


# ------------------------------------------------------------------ geometry

def _safe_norm(x: Tensor) -> Tensor:
    """sqrt(x0^2 + x1^2 + x2^2 + 1e-20) over the last axis of length 3."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2] + 1e-20)


def panel_geometry(pans: Tensor):
    """Centroids, unit normals, areas and diagonals of (n, 4, 3) panels
    (cross-diagonal rule; degenerate padding gets zero normals)."""
    d1 = pans[:, 2] - pans[:, 0]
    d2 = pans[:, 3] - pans[:, 1]
    c = pans.mean(dim=1)
    nvec = 0.5 * torch.linalg.cross(d1, d2)
    area = _safe_norm(nvec)
    big = area > 1e-9
    inv = torch.where(big, 1.0 / torch.where(big, area, torch.ones_like(area)),
                      torch.zeros_like(area))
    nrm = nvec * inv[:, None]
    diag = torch.maximum(_safe_norm(d1), _safe_norm(d2))
    return c, nrm, area, diag


def self_potential(pans: Tensor, c: Tensor, nrm: Tensor) -> Tensor:
    """Exact Int 1/r dS over each flat panel, field point at its centroid."""
    tot = torch.zeros(pans.shape[0], dtype=pans.dtype, device=pans.device)
    for e in range(4):
        a = pans[:, e]
        b = pans[:, (e + 1) % 4]
        ab = b - a
        s = _safe_norm(ab)
        ok = s > 1e-9
        s_safe = torch.where(ok, s, torch.ones_like(s))
        ca = a - c
        cb = b - c
        ra = _safe_norm(ca)
        rb = _safe_norm(cb)
        cr = torch.linalg.cross(ca, ab)
        d = (cr[:, 0] * nrm[:, 0] + cr[:, 1] * nrm[:, 1] + cr[:, 2] * nrm[:, 2]) / s_safe
        num = ra + rb + s
        den = torch.clamp(ra + rb - s, min=1e-12)
        tot = tot + torch.where(ok, d * torch.log(num / den), torch.zeros_like(d))
    return torch.abs(tot)


def quad_points(levels=LEVELS):
    """Host constants: every ns x ns midpoint subdivision point of the
    given levels, level by level -- (u, v, weight fraction, level id),
    stored f32 as in the JAX package.  The main levels (1, 3, 6, 12) carry
    the direct and the image integral; the fine level 24 only the image."""
    us, vs, wf, lev = [], [], [], []
    for ns in levels:
        lid = LEVELS.index(ns)
        for iu in range(ns):
            for iv in range(ns):
                us.append((iu + 0.5) / ns)
                vs.append((iv + 0.5) / ns)
                wf.append(1.0 / (ns * ns))
                lev.append(lid)
    return (np.asarray(us, dtype=np.float32), np.asarray(vs, dtype=np.float32),
            np.asarray(wf, dtype=np.float32), np.asarray(lev, dtype=np.int32))


#: first point index and point count of each level in :func:`quad_points`
LEVEL_START = tuple(int(sum(n * n for n in LEVELS[:i])) for i in range(len(LEVELS)))
LEVEL_COUNT = tuple(n * n for n in LEVELS)
#: main-level points (direct + image) precede the fine image-only level
NQ_MAIN = LEVEL_START[-1]


def level_select_direct(rel: Tensor) -> Tensor:
    """Direct-integral level id: rel < 1 -> ns 12, < 2 -> 6, < 6 -> 3, else 1."""
    one = torch.ones_like(rel, dtype=torch.int32)
    out = torch.where(rel < 6.0, one, 0 * one)
    out = torch.where(rel < 2.0, 2 * one, out)
    return torch.where(rel < 1.0, 3 * one, out)


def level_select_image(rel: Tensor) -> Tensor:
    """Image-integral level id: as the direct one plus ns 24 below 0.5."""
    out = level_select_direct(rel)
    return torch.where(rel < 0.5, torch.full_like(out, 4), out)


def pair_levels(c: Tensor, diag: Tensor, lid_surface: Tensor):
    """(sel_d, sel_i) (n, n) int32 level ids of every (field i, source j)
    pair; -1 drops the numeric direct self term (exact instead) and the
    numeric image self term of a lid panel at z = 0."""
    n = c.shape[0]
    dist = _safe_norm(c[:, None, :] - c[None, :, :])
    cI = torch.stack([c[:, 0], c[:, 1], -c[:, 2]], dim=-1)
    distI = _safe_norm(c[:, None, :] - cI[None, :, :])
    ok = diag > 1e-9
    diag_safe = torch.where(ok, diag, torch.ones_like(diag))
    big = torch.full_like(dist, 1e9)
    rel = torch.where(ok[None, :], dist / diag_safe[None, :], big)
    relI = torch.where(ok[None, :], distI / diag_safe[None, :], big)
    sel_d = level_select_direct(rel)
    sel_i = level_select_image(relI)
    eye = torch.eye(n, dtype=torch.bool, device=c.device)
    sel_d = torch.where(eye, torch.full_like(sel_d, -1), sel_d)
    sel_i = torch.where(eye & lid_surface[None, :], torch.full_like(sel_i, -1), sel_i)
    return sel_d, sel_i


# ------------------------------------------------------- K3: Rankine, plain

def rankine_plain(pans: Tensor, c: Tensor, nrm: Tensor, area: Tensor, diag: Tensor,
                  panel_mask: Tensor, lid_surface: Tensor, self_pot: Tensor, *, quad=None):
    """Plain version of kernel K3: ``(R_pot, R_dn)`` (n, n) with
    ``R_pot = pot_d + pot_i`` and ``R_dn = (grad_d + grad_i) . n_i``.

    The dense masked loop over all 766 subdivision points: at each point
    only the pairs whose level is the point's level contribute (the
    others add exact zeros).  Field side i = rows, source side j =
    columns; ``self_pot`` is the exact self potential, on the diagonal
    (doubled for a lid panel at z = 0); masked-out source columns are 0.
    ``quad``: the subdivision points ``(us, vs, wf)`` staged by
    :func:`stage_tables` (``tab["quad"]``), or None to stage them here.

    bfloat16 inputs (the ``bf16`` assembly of :func:`solve_panels`) are
    cast up to float32, summed there and the two outputs rounded once to
    bfloat16, as kernel K3's bf16 entry does."""
    dtype, dev = c.dtype, c.device
    if dtype == torch.bfloat16:
        quad = stage_quad(dtype, dev) if quad is None else quad
        f32 = _cast((pans, c, nrm, area, diag, panel_mask, lid_surface, self_pot), torch.float32)
        return _cast(rankine_plain(*f32, quad=_cast(quad, torch.float32)), torch.bfloat16)
    n = c.shape[0]
    sel_d, sel_i = pair_levels(c, diag, lid_surface)
    lv = quad_points()[3]
    us, vs, wf = stage_quad(dtype, dev) if quad is None else quad

    def contrib(pt, dA, sel, level):
        d = c[:, None, :] - pt[None, :, :]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        ok = (sel == level) & (r2 > 1e-12)
        r2s = torch.where(ok, r2, torch.ones_like(r2))
        ir = 1.0 / torch.sqrt(r2s)
        ir3 = ir / r2s
        zero = torch.zeros_like(r2)
        pot = torch.where(ok, dA[None, :] * ir, zero)
        dsn = (d[..., 0] * nrm[:, 0][:, None] + d[..., 1] * nrm[:, 1][:, None]
               + d[..., 2] * nrm[:, 2][:, None])
        return pot, torch.where(ok, -dA[None, :] * ir3, zero) * dsn

    def point(q, pans, area):
        """The direct (main levels only) and image contributions of point q."""
        u, v = us[q], vs[q]
        pt = ((1 - u) * (1 - v) * pans[:, 0] + u * (1 - v) * pans[:, 1]
              + u * v * pans[:, 2] + (1 - u) * v * pans[:, 3])
        dA = area * wf[q]
        level = int(lv[q])
        ptI = torch.stack([pt[:, 0], pt[:, 1], -pt[:, 2]], dim=-1)
        image = contrib(ptI, dA, sel_i, level)
        return (contrib(pt, dA, sel_d, level) + image) if q < NQ_MAIN else image

    pot = torch.zeros((n, n), dtype=dtype, device=dev)
    dn = torch.zeros_like(pot)
    for q in range(us.shape[0]):
        parts = _remat(point, q, pans, area)
        for p, g in zip(parts[::2], parts[1::2]):
            pot, dn = pot + p, dn + g
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    lids = torch.where(lid_surface, torch.ones_like(self_pot), torch.zeros_like(self_pot))
    pot = pot + torch.where(eye, (self_pot * (1.0 + lids))[None, :], torch.zeros_like(pot))
    colm = panel_mask[None, :]
    return pot * colm, dn * colm


# ----------------------------------------------------- K4: wave part, plain

def _wave_deep(k, R, dx, dy, v, area_j, diag_lid, tab):
    """Deep-water free-surface wave part: G (Cx) and its gradient (Cx each)
    w.r.t. the field point.  ``k``: (nf, 1, 1); pair arrays (n, n).  Lid
    self pairs evaluate at R_eff = 0.4 sqrt(area)."""
    R_eff = 0.4 * torch.sqrt(torch.clamp(area_j, min=1e-14))[None, :]
    R_use = torch.where(diag_lid, R_eff, R)
    X = k * R_use
    Y = k * v
    i0, i1 = eval_wave_integrals(X, Y, tab)
    eY = torch.exp(Y)
    J0 = bessel.j0(X)
    J1 = bessel.j1(X)
    G = Cx(2.0 * k * i0, 2.0 * k * (-_PI * eY * J0))
    rr = torch.sqrt(R_use * R_use + v * v + 1e-20)
    dG_dv = Cx(2.0 * k * (1.0 / rr + k * i0), 2.0 * k * (-_PI * k * eY * J0))
    pos = R_use > 1e-12
    Rs = torch.where(pos, R_use, torch.ones_like(R_use))
    C1 = torch.where(pos, (1.0 / Rs) * (1.0 - (-v) / rr), torch.zeros_like(R_use))
    dG_dR = Cx(2.0 * k * (-(C1 + k * i1)), 2.0 * k * (_PI * k * eY * J1))
    posR = R > 1e-12
    Rs0 = torch.where(posR, R, torch.ones_like(R))
    zero = torch.zeros_like(R)
    ux = torch.where(diag_lid, torch.ones_like(R), torch.where(posR, dx / Rs0, zero))
    uy = torch.where(diag_lid, zero, torch.where(posR, dy / Rs0, zero))
    return G, dG_dR * ux, dG_dR * uy, dG_dv


def _sum4(t):
    return t[0] + t[1] + t[2] + t[3]


def _wave_fd(k0, A0, lam, a_fit, h, R, dx, dy, zP, zQ, area_j, diag_lid, tab):
    """Finite-depth wave part: four images (pole + exponential fit +
    radiated) and the seabed image, excluding 1/r and 1/r1.  ``k0``,
    ``A0``: (nf, 1, 1); ``lam``, ``a_fit``: (nf, NL) host-f64 fit."""
    R_eff = 0.4 * torch.sqrt(torch.clamp(area_j, min=1e-14))[None, :]
    R_use = torch.where(diag_lid, R_eff, R)
    d4 = [-(zP + zQ), 2.0 * h - (zP - zQ), 2.0 * h + (zP - zQ), 4.0 * h + (zP + zQ)]
    sgn = (-1.0, -1.0, 1.0, 1.0)
    X = k0 * R_use
    J0 = bessel.j0(X)
    J1 = bessel.j1(X)
    R2 = R_use * R_use
    gre = gre_R = gre_z = None
    for i in range(1, 4):                   # the "1" parts of images 2..4
        rr2 = torch.clamp(R2 + d4[i] * d4[i], min=1e-12)
        rr = torch.sqrt(rr2)
        t3 = 1.0 / (rr2 * rr)
        tg, tR, tz = 1.0 / rr, (-R_use) * t3, (-d4[i]) * t3 * sgn[i]
        gre = tg if gre is None else gre + tg
        gre_R = tR if gre_R is None else gre_R + tR
        gre_z = tz if gre_z is None else gre_z + tz
    p0, pR, pz = [], [], []
    for i in range(4):                      # pole parts: 2 A0 I0(k0 R, -k0 d_i)
        Y4 = -k0 * d4[i]
        i0_4, i1_4 = eval_wave_integrals(X, Y4, tab)
        rxy = torch.sqrt(X * X + Y4 * Y4 + 1e-20)
        pos = X > 1e-12
        Xs = torch.where(pos, X, torch.ones_like(X))
        C1 = torch.where(pos, (1.0 / Xs) * (1.0 - (-Y4) / rxy), torch.zeros_like(X))
        p0.append(2.0 * A0 * i0_4)
        pR.append(2.0 * A0 * k0 * (-(C1 + i1_4)))
        pz.append(2.0 * A0 * (-k0 * sgn[i]) * (1.0 / rxy + i0_4))
    gre = gre + _sum4(p0)
    gre_R = gre_R + _sum4(pR)
    gre_z = gre_z + _sum4(pz)

    def fit_term(lam_j, a_j, R_use, R2, *d4):
        t0, tR, tz = [], [], []
        for i in range(4):
            cc = d4[i] + lam_j
            rr2 = torch.clamp(R2 + cc * cc, min=1e-12)
            rr = torch.sqrt(rr2)
            t3 = a_j / (rr2 * rr)
            t0.append(a_j / rr)
            tR.append(-R_use * t3)
            tz.append(-cc * t3 * sgn[i])
        return _sum4(t0), _sum4(tR), _sum4(tz)

    g0 = gR = gz = torch.zeros_like(X)
    for j in range(lam.shape[-1]):          # exponential-fit part
        t0, tR, tz = _remat(fit_term, lam[:, j][:, None, None], a_fit[:, j][:, None, None],
                            R_use, R2, *d4)
        g0, gR, gz = g0 + t0, gR + tR, gz + tz
    gre, gre_R, gre_z = gre + g0, gre_R + gR, gre_z + gz
    e4 = [torch.exp(-k0 * d) for d in d4]
    gim = _sum4([-_TWO_PI * A0 * e * J0 for e in e4])
    gim_R = _sum4([_TWO_PI * A0 * k0 * e * J1 for e in e4])
    gim_z = _sum4([_TWO_PI * A0 * k0 * sgn[i] * e4[i] * J0 for i in range(4)])
    v2 = zP + zQ + 2.0 * h                  # seabed image 1/r2
    rr2 = torch.clamp(R2 + v2 * v2, min=1e-12)
    rr = torch.sqrt(rr2)
    t3 = 1.0 / (rr2 * rr)
    gre = gre + 1.0 / rr
    gre_R = gre_R - R_use * t3
    gre_z = gre_z - v2 * t3
    pos = R_use > 1e-12
    Rs = torch.where(pos, R_use, torch.ones_like(R_use))
    zero = torch.zeros_like(R_use)
    ux = torch.where(pos, dx / Rs, zero)
    uy = torch.where(pos, dy / Rs, zero)
    dG_dR = Cx(gre_R, gim_R)
    return Cx(gre, gim), dG_dR * ux, dG_dR * uy, Cx(gre_z, gim_z)


def _runs(flags):
    """(lo, hi, flag) of each maximal run of equal flags."""
    out, lo = [], 0
    for i in range(1, len(flags) + 1):
        if i == len(flags) or flags[i] != flags[lo]:
            out.append((lo, i, bool(flags[lo])))
            lo = i
    return out


def wave_plain(R_pot: Tensor, R_dn: Tensor, c: Tensor, nrm: Tensor, area: Tensor,
               panel_mask: Tensor, lid_surface: Tensor, tab: dict, k: Tensor,
               fd: dict | None, *, finite_depth: bool, depth: float, fd_active=None):
    """Plain version of kernel K4: one frequency chunk's wave part combined
    with the Rankine parts into ``(S_re, S_im, Dn_re, Dn_im)``, each
    (nf, n, n).

    ``k``: (nf,) deep-water wavenumbers; ``fd``: the chunk's finite-depth
    fit ``{"k0", "A0", "active"}`` (nf,) and ``{"lam", "a"}`` (nf, NL), or
    None in deep water.  Each frequency takes the 4-image branch where
    ``active`` and the deep branch elsewhere (the JAX package's
    ``lax.cond``); within a branch every region of the wave integrals is
    evaluated densely and selected with ``where``.  ``fd_active``, the
    chunk's branches as host booleans (:func:`stage_inputs`), spares the
    read of ``fd["active"]`` from the device.  The -2 pi diagonal shift and
    the lid-row swap stay with the caller.

    bfloat16 inputs are cast up to float32, computed there and the four
    outputs rounded once to bfloat16, as kernel K4's bf16 entry does."""
    if c.dtype == torch.bfloat16:
        up = _cast((R_pot, R_dn, c, nrm, area, panel_mask, lid_surface, tab, k, fd),
                   torch.float32)
        return _cast(wave_plain(*up, finite_depth=finite_depth, depth=depth,
                                fd_active=fd_active), torch.bfloat16)
    n = c.shape[0]
    nf = k.shape[0]
    dev = c.device
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    R = torch.sqrt(dx * dx + dy * dy + 1e-20)
    zP = c[:, 2][:, None].expand(n, n)
    zQ = c[:, 2][None, :].expand(n, n)
    v = zP + zQ
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    diag_lid = eye & lid_surface[None, :]
    if fd_active is None:
        fd_active = (fd["active"] > 0.5).tolist() if finite_depth else [False] * nf
    runs = []                               # (G, gx, gy, gz) of each run of one branch
    for lo, hi, is_fd in _runs(fd_active):
        if is_fd:
            col = lambda key: fd[key][lo:hi][:, None, None]     # noqa: E731
            parts = _wave_fd(col("k0"), col("A0"), fd["lam"][lo:hi], fd["a"][lo:hi], depth,
                             R, dx, dy, zP, zQ, area, diag_lid, tab)
        else:
            parts = _wave_deep(k[lo:hi][:, None, None], R, dx, dy, v, area, diag_lid, tab)
        runs.append([Cx(p.re.expand(hi - lo, n, n), p.im.expand(hi - lo, n, n))
                     for p in parts])
    G, gx, gy, gz = (Cx(torch.cat([r[i].re for r in runs]), torch.cat([r[i].im for r in runs]))
                     for i in range(4))
    area_row = area[None, :]
    colm = panel_mask[None, :]
    n0, n1, n2 = (nrm[:, i][:, None] for i in range(3))
    S_re = (R_pot + G.re * area_row) * colm
    S_im = (G.im * area_row) * colm
    proj_re = gx.re * n0 + gy.re * n1 + gz.re * n2
    proj_im = gx.im * n0 + gy.im * n1 + gz.im * n2
    Dn_re = (R_dn + proj_re * area_row) * colm
    Dn_im = (proj_im * area_row) * colm
    return S_re, S_im, Dn_re, Dn_im


def _staged(a, dtype, device) -> Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)


def stage_quad(dtype, device):
    """The subdivision points of :func:`quad_points` on ``device`` in
    ``dtype``: ``(us, vs, wf)``, each (766,), the rows of one (3, 766)
    array staged by one copy."""
    us, vs, wf = _staged(np.stack(quad_points()[:3]), dtype, device)
    return us, vs, wf


def stage_tables(tab: dict, dtype, device) -> dict:
    """Host tables -> the kernel-input dict on ``device`` in ``dtype``:
    ``I0``/``I1`` (NX, NS), the GL ``nodes`` ``(x_q, w_q)`` on (-1, 1);
    ``near``, what K4's near quadrature reads: ``sin(theta_q)`` at
    ``theta_q = pi/2 + pi/2 x_q``, the weights ``w_q pi/2`` and the E1
    series' Horner coefficients ``(-1)^(m+1) / (m m!)``, m = 1..N_SERIES;
    and ``quad``, K3's subdivision points (:func:`stage_quad`).  Staged
    once by the caller of :func:`solve_panels` (once per solve, once per
    :func:`make_bem_fn`), so neither the solve nor a kernel wrapper copies
    from the host."""
    def t(a):
        return _staged(a, dtype, device)

    glx, glw = t(GL16_X), t(GL16_W)
    half_pi = 0.5 * _PI
    coef = t([(-1.0) ** (m + 1) / (m * math.factorial(m)) for m in range(1, N_SERIES + 1)])
    return {"I0": t(tab["I0"]), "I1": t(tab["I1"]), "nodes": (glx, glw),
            "near": (torch.sin(half_pi + half_pi * glx), glw * half_pi, coef),
            "quad": stage_quad(dtype, device)}


def stage_inputs(pans, panel_mask, lid_mask, w, betas, fd: dict, *, finite_depth: bool,
                 dtype, device) -> dict:
    """One panel solve's host arrays -> the keyword arguments ``pans``,
    ``panel_mask``, ``lid_mask``, ``w``, ``betas``, ``fd`` and ``fd_active``
    of :func:`solve_panels`: each array copied once to ``device`` in
    ``dtype``; ``fd_active`` is the per-frequency branch of the finite-depth
    fit as host booleans (``fd["active"] > 0.5`` when ``finite_depth``),
    read here so the plain assembly never reads it back from the device."""
    dev = resolve_device(device)
    nw = len(np.atleast_1d(w))
    active = (tuple(bool(a > 0.5) for a in np.asarray(fd["active"])) if finite_depth
              else (False,) * nw)
    return {"pans": _staged(pans, dtype, dev), "panel_mask": _staged(panel_mask, dtype, dev),
            "lid_mask": _staged(lid_mask, dtype, dev), "w": _staged(w, dtype, dev),
            "betas": _staged(betas, dtype, dev),
            "fd": {key: _staged(val, dtype, dev) for key, val in fd.items()},
            "fd_active": active}


def _require_staged(dev, dtype, **tensors):
    """Every argument a tensor on ``dev`` in ``dtype``: :func:`solve_panels`
    copies nothing from the host."""
    for name, t in tensors.items():
        if not isinstance(t, Tensor):
            raise TypeError(f"solve_panels: {name} is a {type(t).__name__}, not a tensor; stage "
                            "the inputs with stage_inputs and the tables with stage_tables")
    require_on(dev, dtype, **tensors)


def _refined(M2: Tensor, LU: Tensor, piv: Tensor, B2: Tensor, adjoint: bool = False) -> Tensor:
    """Solve ``M2 x = B2`` (``M2^T x = B2`` with ``adjoint``; pass ``M2`` as
    given) on the factors of ``M2``, then ``N_REFINE`` refinement steps."""
    M = M2.mT if adjoint else M2
    x = torch.linalg.lu_solve(LU, piv, B2, adjoint=adjoint)
    for _ in range(N_REFINE):
        x = x + torch.linalg.lu_solve(LU, piv, B2 - M @ x, adjoint=adjoint)
    return x


def _lu_factor(M2: Tensor):
    """LU factors of a batch of systems, one ``lu_factor_ex`` call per
    system: a single matrix goes to cuSOLVER's getrf on the card, where a
    batch goes to MAGMA's batched getrf, which allocates and frees its
    workspace with the device in every call (``cudaFree`` waits for the
    device).  On the CPU both are LAPACK's getrf per matrix.

    A singular system raises on CPU tensors.  On the card its error code is
    not read back (that would wait for the device): its factors hold inf or
    NaN, which the solve's residual ``resid`` reports, as in the JAX
    package."""
    mats = M2.reshape(-1, *M2.shape[-2:])
    parts = [torch.linalg.lu_factor_ex(m) for m in mats]
    if M2.device.type == "cpu":
        # tolist reads the CPU tensor's memory and dispatches no op, so the
        # lint's audit counts no sync the card would not make
        infos = torch.stack([p[2] for p in parts]).tolist()
        bad = [i for i, info in enumerate(infos) if info != 0]
        if bad:
            raise torch.linalg.LinAlgError(f"solve_panels: block systems {bad} are singular "
                                           "(getrf's info is nonzero)")
    return (torch.stack([p[0] for p in parts]).reshape(M2.shape),
            torch.stack([p[1] for p in parts]).reshape(M2.shape[:-1]))


class _SolveRefined(torch.autograd.Function):
    """The refined solve of the block systems with its implicit-function
    rule (the JAX package's ``custom_vjp`` ``_solve_refined``): for
    ``M2 x = B2``, ``lam = M2^-T xbar`` by the same refined solver (on the
    forward's factors, ``lu_solve(adjoint=True)``, refined against
    ``M2^T``), ``M2bar = -lam x^T`` and ``B2bar = lam``.  The refinement
    loop itself is never differentiated."""

    @staticmethod
    def forward(ctx, M2, B2):
        with span("factor"):
            LU, piv = _lu_factor(M2)
        with span("refine"):
            x = _refined(M2, LU, piv, B2)
        ctx.save_for_backward(M2, LU, piv, x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        M2, LU, piv, x = ctx.saved_tensors
        lam = _refined(M2, LU, piv, xbar.contiguous(), adjoint=True)
        return -lam @ x.mT, lam


def solve_refined(M2: Tensor, B2: Tensor) -> Tensor:
    """``x = M2^-1 B2`` for a batch of real systems: LU factored once per
    system (:func:`_lu_factor`: a singular system raises on the CPU and shows
    on the card only in the residual), one solve and ``N_REFINE`` refinement
    steps;
    reverse-differentiable by the implicit function theorem
    (:class:`_SolveRefined`)."""
    return _SolveRefined.apply(M2, B2)


# ------------------------------------------------------------- the solve

def freq_chunk(n: int, nw: int) -> int:
    """Frequencies per assembly + factor batch; shrinks with the padded
    panel class so a chunk's working set stays about constant."""
    return max(1, min(nw, 8, 2048 // max(n, 1)))


ASSEMBLIES = ("kernels", "plain")


def solve_panels(pans, panel_mask, lid_mask, w, betas, fd: dict, tab: dict, *, fd_active,
                 rho: float = 1025.0, g: float = 9.81, depth: float = 0.0,
                 finite_depth: bool = False, assembly: str = "kernels",
                 precision: str | None = None, dtype=torch.float64, device=None):
    """Padded panels -> ``(A, B, F, resid)`` (port of ``jax_bem.solve_panels``).

    Every input is a tensor already on ``device`` in ``dtype``, the solve's
    precision: ``pans`` (n, 4, 3) padded vertices (hull, lid, degenerate
    padding), ``panel_mask``/``lid_mask`` (n,), ``w`` (nw,) rad/s, ``betas``
    (nb,) headings [rad] and ``fd``, the :func:`wavetable.fd_fit_grid`
    arrays, as :func:`stage_inputs` stages them (with ``fd_active``, the
    fit's branches on the host); ``tab`` as :func:`stage_tables` stages it.
    Host arrays or tensors elsewhere raise: the solve stages nothing.

    ``assembly`` (the JAX package's ``assembly=``): ``"kernels"`` launches
    K3 and K4 on CUDA tensors (their wrappers raise under autograd) and
    takes their plain versions on CPU tensors; ``"plain"`` runs
    :func:`rankine_plain` and :func:`wave_plain` on any device, the route
    :func:`make_bem_fn` differentiates.  Under autograd each frequency
    chunk, each quadrature point of the Rankine sum, each wave-integral
    evaluation, near-quadrature node and fit term is recomputed in the
    backward pass rather than kept, and the refined solve has its
    implicit-function rule (:func:`solve_refined`).

    ``precision`` (``"f32"`` | ``"bf16"`` | None, which reads
    ``RAFT_TPU_BEM_PRECISION``): with ``bf16`` and a float32 solve the
    assembly stage runs in bfloat16 (:func:`assembly_dtype`).  The panel
    geometry, the self potentials and the lid flags are computed in
    ``dtype`` and cast down, with the tables (once per call), the
    wavenumbers and the fit arrays; K3/K4 (or their plain versions) take
    and return bfloat16, and S, Dn are cast up to ``dtype`` before the
    factor, so the LU, the refinement, the right-hand sides and the
    contractions run in ``dtype``.

    Returns A, B (nw, 6, 6) with [j, k] = force j per unit mode-k motion,
    F a Cx (nw, nb, 6), and resid (nw,), the largest relative residual of
    the block system after refinement.

    Spans: ``rankine`` (the Rankine assembly), then one ``chunk`` per
    frequency chunk with ``wave`` (its wave assembly), ``factor`` (the LU)
    and ``refine`` (the solve and its refinement) inside.  Under autograd
    the backward pass recomputes a chunk, and its spans, on autograd's
    thread."""
    dev = resolve_device(device)
    if assembly not in ASSEMBLIES:
        raise ValueError(f"assembly {assembly!r}: expected one of {ASSEMBLIES}")
    _require_staged(dev, dtype, pans=pans, panel_mask=panel_mask, lid_mask=lid_mask, w=w,
                    betas=betas, **{f"fd[{key!r}]": val for key, val in fd.items()},
                    **{f"tab[{key!r}]": val for key, val in tab.items() if key in ("I0", "I1")},
                    **{f"tab[{key!r}][{i}]": val for key in ("nodes", "near", "quad")
                       for i, val in enumerate(tab[key])})
    nw = w.shape[0]
    if len(fd_active) != nw:
        raise ValueError(f"fd_active has {len(fd_active)} entries for {nw} frequencies")
    n = pans.shape[0]

    c, nrm, area, diag = panel_geometry(pans)
    hull_mask = panel_mask * (1.0 - lid_mask)
    lid_surface = (lid_mask > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
    self_pot = self_potential(pans, c, nrm)
    a_dtype = assembly_dtype(precision, dtype)
    # the assembly stage's inputs, cast down once in the bf16 mode (a no-op otherwise)
    pans_a, c_a, nrm_a, area_a, diag_a, mask_a, spot_a, tab_a = _cast(
        (pans, c, nrm, area, diag, panel_mask, self_pot, tab), a_dtype)
    rankine = rankine_assembly if assembly == "kernels" else rankine_plain
    with span("rankine"):
        R_pot, R_dn = rankine(pans_a, c_a, nrm_a, area_a, diag_a, mask_a, lid_surface, spot_a,
                              quad=tab_a["quad"])

    nvec6 = torch.cat([nrm, torch.linalg.cross(c, nrm)], dim=1)      # (n, 6)
    Wn = nvec6 * (hull_mask * area)[:, None]                          # (n, 6)
    rad = nvec6 * hull_mask[:, None]                                   # (n, 6)
    eye = torch.eye(n, dtype=dtype, device=dev)
    lid_row = (lid_mask > 0.5)[:, None]
    lid_col = (lid_mask > 0.5)[None, None, :]
    cb = torch.cos(betas)[None, :, None]
    sb = torch.sin(betas)[None, :, None]
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]

    def one_chunk(sl, R_pot, R_dn):
        om = w[sl]
        nf = om.shape[0]
        k = om * om / g
        fd_c = _cast({key: val[sl] for key, val in fd.items()}, a_dtype) if finite_depth else None
        wargs = (R_pot, R_dn, c_a, nrm_a, area_a, mask_a, lid_surface, tab_a, k.to(a_dtype), fd_c)
        with span("wave"):
            if assembly == "kernels":
                parts = wave_assembly(*wargs, finite_depth=finite_depth, depth=depth,
                                      fd_active=fd_active[sl])
            else:
                parts = wave_plain(*wargs, finite_depth=finite_depth, depth=depth,
                                   fd_active=fd_active[sl])
        # the assembly -> solve dtype boundary (the bf16 mode casts up here)
        S_re, S_im, Dn_re, Dn_im = (x.to(dtype) for x in parts)
        M_re = torch.where(lid_row, S_re, Dn_re - _TWO_PI * eye)
        M_im = torch.where(lid_row, S_im, Dn_im)

        # incident wave at the centroids, per heading: (nf, nb, n)
        kw = fd["kw"][sl][:, None, None]
        omc = om[:, None, None]
        if finite_depth:
            act = fd["active"][sl][:, None, None] > 0.5
            zph = torch.clamp(cz + depth, max=depth)
            e2h = torch.exp(-2.0 * kw * depth)
            ez = torch.exp(kw * torch.clamp(cz, max=0.0))
            ee = torch.exp(-2.0 * kw * torch.clamp(zph, min=0.0))
            Zr = torch.where(act, ez * (1.0 + ee) / (1.0 + e2h), ez)
            Zs = torch.where(act, ez * (1.0 - ee) / (1.0 + e2h), ez)
        else:
            Zr = Zs = torch.exp(kw * torch.clamp(cz, max=0.0))
        ang = -kw * (cx * cb + cy * sb)
        zero = torch.zeros_like(ang)
        amp = (g / omc) * Zr
        ph = Cx(zero, amp.expand_as(ang)) * Cx.expi(ang)
        ddx = ph * Cx(zero, (-kw * cb).expand_as(ang))
        ddy = ph * Cx(zero, (-kw * sb).expand_as(ang))
        ddz = Cx(zero, ((g / omc) * kw * Zs).expand_as(ang)) * Cx.expi(ang)
        dn = ddx * nrm[:, 0] + ddy * nrm[:, 1] + ddz * nrm[:, 2]

        # RHS: 6 radiation columns + nb diffraction columns, (nf, n, 6 + nb)
        diff_re = torch.where(lid_col, -ph.re, -dn.re) * panel_mask
        diff_im = torch.where(lid_col, -ph.im, -dn.im) * panel_mask
        B_re = torch.cat([rad.expand(nf, n, 6), diff_re.transpose(1, 2)], dim=2)
        B_im = torch.cat([torch.zeros_like(rad).expand(nf, n, 6), diff_im.transpose(1, 2)], dim=2)

        M2 = torch.cat([torch.cat([M_re, -M_im], dim=2), torch.cat([M_im, M_re], dim=2)], dim=1)
        B2 = torch.cat([B_re, B_im], dim=1)
        x2 = solve_refined(M2, B2)
        with torch.no_grad():
            r2 = B2 - M2 @ x2
            resid = r2.abs().amax(dim=(1, 2)) / torch.clamp(B2.abs().amax(dim=(1, 2)), min=1e-30)
        xr, xi = x2[:, :n], x2[:, n:]

        # panel potentials phi = S sigma, then the pressure integrals
        P_re = S_re @ xr - S_im @ xi                                   # (nf, n, m)
        P_im = S_re @ xi + S_im @ xr
        acc_re = P_re[:, :, :6].transpose(1, 2) @ Wn                   # (nf, kk, j)
        acc_im = P_im[:, :, :6].transpose(1, 2) @ Wn
        tot = ph + Cx(P_re[:, :, 6:].transpose(1, 2), P_im[:, :, 6:].transpose(1, 2))
        exc_re = tot.re @ Wn                                           # (nf, nb, j)
        exc_im = tot.im @ Wn
        return (-rho * acc_re.transpose(1, 2), rho * omc * acc_im.transpose(1, 2),
                -rho * omc * exc_im, rho * omc * exc_re, resid)

    chunk = freq_chunk(n, nw)
    outs = []
    for lo in range(0, nw, chunk):
        with span("chunk"):
            outs.append(_remat(one_chunk, slice(lo, min(lo + chunk, nw)), R_pot, R_dn))
    A, B, Fr, Fi, resid = (torch.cat(parts) for parts in zip(*outs))
    return A, B, Cx(Fr, Fi), resid


def scale_radially(pans: Tensor, theta: Tensor) -> Tensor:
    """The default warp of :func:`make_bem_fn`: x and y scaled by ``theta``
    (a scalar, or one scale each) about the z axis; degenerate padding
    panels stay degenerate under it."""
    scale = torch.cat([theta.expand(2), torch.ones(1, dtype=pans.dtype, device=pans.device)])
    return pans * scale


def make_bem_fn(panels, w, *, rho: float = 1025.0, g: float = 9.81, depth: float = 0.0,
                beta: float = 0.0, lid=None, warp_fn=None, dtype=torch.float32, device=None):
    """``theta -> (A (nw, 6, 6), B (nw, 6, 6), F Cx (nw, 6))``, the
    differentiable geometry -> coefficients hook of
    :func:`raft_tpu_torch.parallel.optimize.optimize_design` (``bem_fn=``;
    port of ``jax_bem.make_bem_fn``).

    ``warp_fn(padded_panels, theta) -> padded_panels`` parameterizes the
    geometry (default :func:`scale_radially`).  The mesh, its masks, the
    frequencies, the finite-depth fit and the tables are staged on
    ``device`` in ``dtype`` here, once; each call warps the staged panels
    and solves with ``assembly="plain"`` (the kernels have no backward, as
    the JAX package's Pallas tiles have none), so gradients flow through
    the panel geometry, the influence assembly and the refined solve.  Its
    solve leaves ``precision`` to ``RAFT_TPU_BEM_PRECISION``, as the JAX
    package's does: under ``bf16`` a float32 ``bem_fn`` assembles in
    bfloat16, and the gradient passes through the casts."""
    dev = resolve_device(device)
    padded, panel_mask, lid_mask = pad_mesh(panels, lid)
    w_np = np.ascontiguousarray(np.atleast_1d(w), dtype=np.float64)
    depth_f = float(depth) if depth and depth > 0 else -1.0
    finite_depth = depth_f > 0
    staged = stage_inputs(padded, panel_mask, lid_mask, w_np, [float(beta)],
                          wavetable.fd_fit_grid(w_np, depth_f, g), finite_depth=finite_depth,
                          dtype=dtype, device=dev)
    pans0 = staged.pop("pans")
    tab = stage_tables(wavetable.load_tables(), dtype, dev)
    warp = scale_radially if warp_fn is None else warp_fn

    def bem_fn(theta):
        theta = torch.as_tensor(theta, dtype=dtype, device=dev)
        A, B, F, _resid = solve_panels(
            warp(pans0, theta), tab=tab, **staged, rho=float(rho), g=float(g),
            depth=float(depth_f if finite_depth else 0.0), finite_depth=finite_depth,
            assembly="plain", dtype=dtype, device=dev)
        return A, B, Cx(F.re[:, 0], F.im[:, 0])

    return bem_fn


# ------------------------------------------------------------ host wrappers

def pad_mesh(panels: np.ndarray, lid: np.ndarray | None):
    """Pad (hull, lid) to its panel class with degenerate zero-area panels
    (all four vertices at the first hull centroid).  Returns (padded,
    panel_mask, lid_mask) as f64 numpy."""
    panels = np.asarray(panels, dtype=np.float64)
    n_h = len(panels)
    n_l = 0 if lid is None else len(lid)
    n_tot = n_h + n_l
    if n_tot == 0:
        raise ValueError("empty mesh")
    n_pad = pad_panel_count(n_tot)
    out = np.zeros((n_pad, 4, 3))
    out[:n_h] = panels
    if n_l:
        out[n_h:n_tot] = np.asarray(lid, dtype=np.float64)
    if n_pad > n_tot:
        out[n_tot:] = panels[0].mean(axis=0)[None, None, :]
    idx = np.arange(n_pad)
    panel_mask = (idx < n_tot).astype(float)
    lid_mask = ((idx >= n_h) & (idx < n_tot)).astype(float)
    return out, panel_mask, lid_mask


@functools.cache
def _route_sources_digest() -> str:
    """Hash of the sources the on-device route runs (K3/K4 and their plain
    versions, the wave tables, the Bessel functions): a salt of its result
    cache."""
    pkg = Path(__file__).resolve().parents[1]
    h = hashlib.sha256()
    for rel in ("csrc/bem_rankine.cu", "csrc/bem_wave.cu", "core/cuda_bem.py",
                "core/bessel.py", "hydro/torch_bem.py", "hydro/wavetable.py"):
        h.update((pkg / rel).read_bytes())
    return h.hexdigest()[:16]


def _table_digest(tab: dict) -> str:
    h = hashlib.sha256(np.ascontiguousarray(tab["I0"]).tobytes())
    h.update(np.ascontiguousarray(tab["I1"]).tobytes())
    return h.hexdigest()[:16]


def solve_bem_jax(panels: np.ndarray, w, rho: float = 1025.0, g: float = 9.81,
                  beta=0.0, depth: float = 0.0, lid: np.ndarray | None = None,
                  cache: bool = True, dtype=torch.float64, device=None,
                  return_diagnostics: bool = False, precision: str | None = None,
                  assembly: str | None = None):
    """On-device panel solve with the JAX package's ``solve_bem_jax``
    contract: returns numpy (A[6, 6, nw], B[6, 6, nw], F), F[6, nw] complex
    for a scalar heading or F[nb, 6, nw] for a grid.  With
    ``return_diagnostics`` a fourth item gives the panel counts, the
    largest refinement residual, the assembly route, the precision and the
    assembly's dtype, whether the result came from the cache and the
    wall-clock (ending in a device synchronisation).  ``precision``: see
    :func:`solve_panels` (None reads ``RAFT_TPU_BEM_PRECISION``).
    ``assembly``: the route of :func:`resolved_assembly` (None reads
    ``RAFT_TPU_BEM_ASSEMBLY``; unset, the kernels on the card and the plain
    versions on the CPU).

    With ``cache`` results are content-cached on disk in the ``torch-bem-jax``
    namespace of :func:`raft_tpu_torch.hydro.native_bem.result_cache_key`,
    salted with the route, the device type, the dtype, the resolved
    precision, ``N_REFINE``, the wave tables and the hash of the route's
    sources: a result of the plain version is never served to a call on the
    card's kernels, nor a bf16 result to an f32 call.  Nothing here asks for
    the host compiler (the native solver's keys name ``g++``'s version).
    The span ``bem_stage`` times the staging of the padded mesh, the
    inputs and the tables on ``device``."""
    from raft_tpu_torch.hydro import native_bem

    dev = resolve_device(device)
    t0 = time.perf_counter()
    panels = np.ascontiguousarray(panels, dtype=np.float64)
    w_np = np.ascontiguousarray(np.atleast_1d(w), dtype=np.float64)
    scalar_beta = np.ndim(beta) == 0
    betas = np.ascontiguousarray(np.atleast_1d(beta), dtype=np.float64)
    depth_f = float(depth) if depth and depth > 0 else -1.0
    finite_depth = depth_f > 0
    route = resolved_assembly(assembly, dev)
    prec = bem_precision(precision)
    a_dtype = assembly_dtype(prec, dtype)
    tab = wavetable.load_tables()
    n_lid = 0 if lid is None else len(lid)

    def diagnostics(resid_max: float, cached: bool) -> dict:
        return {"route": route, "cached": cached, "panels": int(len(panels)),
                "padded": pad_panel_count(len(panels) + n_lid), "lid": int(n_lid),
                "nw": int(len(w_np)), "headings": int(len(betas)),
                "refine_iters": N_REFINE, "max_residual": resid_max,
                "finite_depth": finite_depth, "dtype": str(dtype), "precision": prec,
                "assembly_dtype": str(a_dtype), "seconds": time.perf_counter() - t0}

    key = None
    if cache:
        key = native_bem.result_cache_key(
            "torch-bem-jax", panels, w_np, betas, (rho, g, depth_f, 0.0, float(n_lid)),
            salt=(route, dev.type, str(dtype), prec, N_REFINE, wavetable.TABLE_VERSION,
                  _table_digest(tab), _route_sources_digest()),
            extra_bytes=np.asarray(lid, dtype=np.float64).tobytes() if n_lid else b"")
        hit = native_bem.result_cache_load(key, ("A", "B", "F", "resid"))
        if hit is not None:
            out = (hit["A"], hit["B"], hit["F"][0] if scalar_beta else hit["F"])
            if return_diagnostics:
                return out + (diagnostics(float(hit["resid"].max()), True),)
            return out

    with span("bem_stage"):
        padded, panel_mask, lid_mask = pad_mesh(panels, lid)
        staged = stage_inputs(padded, panel_mask, lid_mask, w_np, betas,
                              wavetable.fd_fit_grid(w_np, depth_f, g),
                              finite_depth=finite_depth, dtype=dtype, device=dev)
        tab_d = stage_tables(tab, dtype, dev)
    A6, B6, F_cx, resid = solve_panels(
        **staged, tab=tab_d, rho=float(rho), g=float(g),
        depth=float(depth_f if finite_depth else 0.0), finite_depth=finite_depth,
        assembly=route, precision=prec, dtype=dtype, device=dev)
    A = A6.double().cpu().numpy().transpose(1, 2, 0)              # (6, 6, nw)
    B = B6.double().cpu().numpy().transpose(1, 2, 0)
    F = (F_cx.re.double().cpu().numpy()
         + 1j * F_cx.im.double().cpu().numpy()).transpose(1, 2, 0)   # (nb, 6, nw)
    resid = resid.double().cpu().numpy()
    if key is not None:
        native_bem.result_cache_store(key, {"A": A, "B": B, "F": F, "resid": resid})
    out = (A, B, F[0] if scalar_beta else F)
    if return_diagnostics:
        return out + (diagnostics(float(resid.max()), False),)
    return out


# ------------------------------------------------------------------ routing

#: the environment knob of the BEM route: ``native`` | ``jax`` | ``auto``
ENV_VAR = "RAFT_TPU_BEM"
MODES = ("native", "jax", "auto")


def bem_mode(env: str | None = None) -> str:
    """The ``RAFT_TPU_BEM`` knob (or ``env`` in its place): unset or empty
    is ``auto``; a value other than native, jax or auto warns and is
    ``auto``, as in the JAX package."""
    raw = os.environ.get(ENV_VAR, "") if env is None else env
    val = raw.strip().lower()
    if val in ("", "auto"):
        return "auto"
    if val in ("native", "jax"):
        return val
    warnings.warn(f"{ENV_VAR}={raw!r} is not one of native|jax|auto; using auto",
                  stacklevel=2)
    return "auto"


def resolved_mode(mode: str | None = None, device=None) -> str:
    """``"native"`` (the host C++ solver) or ``"jax"`` (the on-device panel
    solve) for a call with ``mode`` on ``device``.

    An explicit ``"native"`` or ``"jax"`` wins.  ``None`` or ``"auto"``
    defers to ``RAFT_TPU_BEM``; if that is ``auto`` too, the device decides,
    the JAX package's rule of the device route only on the accelerator:
    the kernels (K3/K4) when ``device`` resolves to CUDA (``None`` means
    the card, and raises without one), the native solver on the CPU."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"BEM mode {mode!r}: expected 'native', 'jax' or 'auto'")
    m = mode if mode in ("native", "jax") else bem_mode()
    if m != "auto":
        return m
    return "jax" if resolve_device(device).type == "cuda" else "native"


def solve_bem_any(panels, w, rho=1025.0, g=9.81, beta=0.0, depth=0.0, lid=None,
                  mode: str | None = None, cache: bool = True, nthreads: int = 0,
                  dtype=torch.float64, device=None, return_diagnostics: bool = False,
                  precision: str | None = None):
    """The BEM staging entry: the host C++ solver
    (:func:`raft_tpu_torch.hydro.native_bem.solve_bem`, f64, ``nthreads``
    OpenMP threads, 0 for its default) or the on-device panel solve
    (:func:`solve_bem_jax` on ``device`` in ``dtype``), as
    :func:`resolved_mode` decides from ``mode`` and ``device``.  The same
    return contract either way; the diagnostics of the native route give
    its route, counts and wall-clock.  ``precision`` reaches the on-device
    route only (:func:`solve_panels`); the native solver is f64 always."""
    route = resolved_mode(mode, device)
    if route == "jax":
        return solve_bem_jax(panels, w, rho=rho, g=g, beta=beta, depth=depth, lid=lid,
                             cache=cache, dtype=dtype, device=device,
                             return_diagnostics=return_diagnostics, precision=precision)
    from raft_tpu_torch.hydro import native_bem

    t0 = time.perf_counter()
    hits = native_bem.CACHE_STATS["hit"]
    out = native_bem.solve_bem(panels, w, rho=rho, g=g, beta=beta, depth=depth,
                               nthreads=nthreads, cache=cache, lid=lid)
    if not return_diagnostics:
        return out
    return out + ({"route": "native", "cached": native_bem.CACHE_STATS["hit"] > hits,
                   "panels": int(len(panels)), "lid": int(0 if lid is None else len(lid)),
                   "nw": int(np.size(w)), "headings": int(np.size(beta)),
                   "seconds": time.perf_counter() - t0},)
