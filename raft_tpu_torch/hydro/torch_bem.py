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
  LU-factored once per frequency (``torch.linalg.lu_factor``, batched over
  a frequency chunk) with ``N_REFINE`` refinement steps; the residual is
  returned per frequency.
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

**Routing.** :func:`solve_bem_any` sends a solve to this on-device route
(mode ``"jax"``) or to the host C++ solver
(:mod:`raft_tpu_torch.hydro.native_bem`, mode ``"native"``); ``"auto"``
(the default, through ``RAFT_TPU_BEM``) takes the kernels on the card and
the native solver on the CPU (:func:`resolved_mode`).  Results of both
routes are cached on disk, content-addressed (``cache=True``).

The module's name avoids the old one, which names a framework; the
``BEM="jax"`` mode name and :func:`solve_bem_jax` keep the JAX package's
spelling so callers carry across.
"""
from __future__ import annotations

import functools
import hashlib
import math
import os
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from raft_tpu_torch.core import bessel
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.cuda_bem import rankine_assembly, wave_assembly
from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.hydro import wavetable

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


def _near_integrals(X: Tensor, Y: Tensor, nodes):
    """(I0, I1) by direct theta quadrature, valid for rho <= R_NEAR."""
    glx, glw = nodes
    acc0 = torch.zeros_like(X)
    accX = torch.zeros_like(X)
    for q in range(glx.shape[0]):
        th = 0.5 * _PI + 0.5 * _PI * glx[q]
        s = torch.sin(th)
        w = glw[q] * 0.5 * _PI
        phr, _phi, _dphr, dphi = _phi_near(Y, X * s)
        acc0 = acc0 + w * phr
        accX = accX - w * s * dphi
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
    :func:`stage_tables` (``tab["quad"]``), or None to stage them here."""
    dtype, dev = c.dtype, c.device
    n = c.shape[0]
    sel_d, sel_i = pair_levels(c, diag, lid_surface)
    lv = quad_points()[3]
    us, vs, wf = stage_quad(dtype, dev) if quad is None else quad
    ci = c[:, None, :]

    def contrib(pt, dA, sel, level):
        d = ci - pt[None, :, :]
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

    pot = torch.zeros((n, n), dtype=dtype, device=dev)
    dn = torch.zeros_like(pot)
    for q in range(us.shape[0]):
        u, v = us[q], vs[q]
        pt = ((1 - u) * (1 - v) * pans[:, 0] + u * (1 - v) * pans[:, 1]
              + u * v * pans[:, 2] + (1 - u) * v * pans[:, 3])
        dA = area * wf[q]
        level = int(lv[q])
        if q < NQ_MAIN:
            p, g = contrib(pt, dA, sel_d, level)
            pot, dn = pot + p, dn + g
        ptI = torch.stack([pt[:, 0], pt[:, 1], -pt[:, 2]], dim=-1)
        p, g = contrib(ptI, dA, sel_i, level)
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
    g0 = gR = gz = torch.zeros_like(X)
    for j in range(lam.shape[-1]):          # exponential-fit part
        lam_j = lam[:, j][:, None, None]
        a_j = a_fit[:, j][:, None, None]
        t0, tR, tz = [], [], []
        for i in range(4):
            cc = d4[i] + lam_j
            rr2 = torch.clamp(R2 + cc * cc, min=1e-12)
            rr = torch.sqrt(rr2)
            t3 = a_j / (rr2 * rr)
            t0.append(a_j / rr)
            tR.append(-R_use * t3)
            tz.append(-cc * t3 * sgn[i])
        g0, gR, gz = g0 + _sum4(t0), gR + _sum4(tR), gz + _sum4(tz)
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


def wave_plain(R_pot: Tensor, R_dn: Tensor, c: Tensor, nrm: Tensor, area: Tensor,
               panel_mask: Tensor, lid_surface: Tensor, tab: dict, k: Tensor,
               fd: dict | None, *, finite_depth: bool, depth: float):
    """Plain version of kernel K4: one frequency chunk's wave part combined
    with the Rankine parts into ``(S_re, S_im, Dn_re, Dn_im)``, each
    (nf, n, n).

    ``k``: (nf,) deep-water wavenumbers; ``fd``: the chunk's finite-depth
    fit ``{"k0", "A0", "active"}`` (nf,) and ``{"lam", "a"}`` (nf, NL), or
    None in deep water.  Each frequency takes the 4-image branch where
    ``active`` and the deep branch elsewhere; within a branch every region
    of the wave integrals is evaluated densely and selected with ``where``.
    The -2 pi diagonal shift and the lid-row swap stay with the caller."""
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
    shape = (nf, n, n)
    G = Cx(torch.empty(shape, dtype=c.dtype, device=dev),
           torch.empty(shape, dtype=c.dtype, device=dev))
    gx, gy, gz = (Cx(torch.empty_like(G.re), torch.empty_like(G.re)) for _ in range(3))
    active = (fd["active"] > 0.5) if finite_depth else torch.zeros(nf, dtype=torch.bool, device=dev)
    for sel, is_fd in ((~active, False), (active, True)):
        idx = torch.nonzero(sel).flatten()
        if idx.numel() == 0:
            continue
        if is_fd:
            col = lambda key: fd[key][idx][:, None, None]     # noqa: E731
            parts = _wave_fd(col("k0"), col("A0"), fd["lam"][idx], fd["a"][idx], depth,
                             R, dx, dy, zP, zQ, area, diag_lid, tab)
        else:
            parts = _wave_deep(k[idx][:, None, None], R, dx, dy, v, area, diag_lid, tab)
        for out, part in zip((G, gx, gy, gz), parts):
            out.re[idx] = part.re.expand(idx.numel(), n, n)
            out.im[idx] = part.im.expand(idx.numel(), n, n)
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
    once per solve, so neither kernel wrapper copies from the host."""
    def t(a):
        return _staged(a, dtype, device)

    glx, glw = t(GL16_X), t(GL16_W)
    half_pi = 0.5 * _PI
    coef = t([(-1.0) ** (m + 1) / (m * math.factorial(m)) for m in range(1, N_SERIES + 1)])
    return {"I0": t(tab["I0"]), "I1": t(tab["I1"]), "nodes": (glx, glw),
            "near": (torch.sin(half_pi + half_pi * glx), glw * half_pi, coef),
            "quad": stage_quad(dtype, device)}


# ------------------------------------------------------------- the solve

def freq_chunk(n: int, nw: int) -> int:
    """Frequencies per assembly + factor batch; shrinks with the padded
    panel class so a chunk's working set stays about constant."""
    return max(1, min(nw, 8, 2048 // max(n, 1)))


def solve_panels(pans, panel_mask, lid_mask, w, betas, fd: dict, tab: dict, *,
                 rho: float = 1025.0, g: float = 9.81, depth: float = 0.0,
                 finite_depth: bool = False, dtype=torch.float64, device=None):
    """Padded panels -> ``(A, B, F, resid)`` (port of ``jax_bem.solve_panels``).

    ``pans`` (n, 4, 3) padded vertices (hull, lid, degenerate padding);
    ``panel_mask``/``lid_mask`` (n,); ``w`` (nw,) rad/s; ``betas`` (nb,)
    headings [rad]; ``fd`` the :func:`wavetable.fd_fit_grid` arrays;
    ``tab`` ``{"I0", "I1"}`` host tables.  Everything is taken to
    ``device`` in ``dtype``, the solve's precision.

    Returns A, B (nw, 6, 6) with [j, k] = force j per unit mode-k motion,
    F a Cx (nw, nb, 6), and resid (nw,), the largest relative residual of
    the block system after refinement."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               device=dev).to(dtype)

    pans, panel_mask, lid_mask, w, betas = (t(x) for x in (pans, panel_mask, lid_mask, w, betas))
    fd = {key: t(val) for key, val in fd.items()}
    tab_d = stage_tables(tab, dtype, dev)
    n = pans.shape[0]
    nb = betas.shape[0]

    c, nrm, area, diag = panel_geometry(pans)
    hull_mask = panel_mask * (1.0 - lid_mask)
    lid_surface = (lid_mask > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
    self_pot = self_potential(pans, c, nrm)
    R_pot, R_dn = rankine_assembly(pans, c, nrm, area, diag, panel_mask, lid_surface, self_pot,
                                   quad=tab_d["quad"])

    nvec6 = torch.cat([nrm, torch.linalg.cross(c, nrm)], dim=1)      # (n, 6)
    Wn = nvec6 * (hull_mask * area)[:, None]                          # (n, 6)
    rad = nvec6 * hull_mask[:, None]                                   # (n, 6)
    eye = torch.eye(n, dtype=dtype, device=dev)
    lid_row = (lid_mask > 0.5)[:, None]
    lid_col = (lid_mask > 0.5)[None, None, :]
    cb = torch.cos(betas)[None, :, None]
    sb = torch.sin(betas)[None, :, None]
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]

    nw = w.shape[0]
    chunk = freq_chunk(n, nw)
    A_out, B_out, Fr_out, Fi_out, res_out = [], [], [], [], []
    for lo in range(0, nw, chunk):
        sl = slice(lo, min(lo + chunk, nw))
        om = w[sl]
        nf = om.shape[0]
        k = om * om / g
        fd_c = {key: val[sl] for key, val in fd.items()} if finite_depth else None
        S_re, S_im, Dn_re, Dn_im = wave_assembly(
            R_pot, R_dn, c, nrm, area, panel_mask, lid_surface, tab_d, k, fd_c,
            finite_depth=finite_depth, depth=depth)
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
        LU, piv = torch.linalg.lu_factor(M2)
        x2 = torch.linalg.lu_solve(LU, piv, B2)
        for _ in range(N_REFINE):
            x2 = x2 + torch.linalg.lu_solve(LU, piv, B2 - M2 @ x2)
        r2 = B2 - M2 @ x2
        resid = r2.abs().amax(dim=(1, 2)) / torch.clamp(B2.abs().amax(dim=(1, 2)), min=1e-30)
        xr, xi = x2[:, :n], x2[:, n:]

        # panel potentials phi = S sigma, then the pressure integrals
        P_re = S_re @ xr - S_im @ xi                                   # (nf, n, m)
        P_im = S_re @ xi + S_im @ xr
        acc_re = P_re[:, :, :6].transpose(1, 2) @ Wn                   # (nf, kk, j)
        acc_im = P_im[:, :, :6].transpose(1, 2) @ Wn
        A_out.append(-rho * acc_re.transpose(1, 2))
        B_out.append(rho * omc * acc_im.transpose(1, 2))
        tot = ph + Cx(P_re[:, :, 6:].transpose(1, 2), P_im[:, :, 6:].transpose(1, 2))
        exc_re = tot.re @ Wn                                           # (nf, nb, j)
        exc_im = tot.im @ Wn
        Fr_out.append(-rho * omc * exc_im)
        Fi_out.append(rho * omc * exc_re)
        res_out.append(resid)
    return (torch.cat(A_out), torch.cat(B_out),
            Cx(torch.cat(Fr_out), torch.cat(Fi_out)), torch.cat(res_out))


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
                  return_diagnostics: bool = False):
    """On-device panel solve with the JAX package's ``solve_bem_jax``
    contract: returns numpy (A[6, 6, nw], B[6, 6, nw], F), F[6, nw] complex
    for a scalar heading or F[nb, 6, nw] for a grid.  With
    ``return_diagnostics`` a fourth item gives the panel counts, the
    largest refinement residual, the route (``"kernels"`` on the card,
    ``"plain"`` on the CPU), whether the result came from the cache and the
    wall-clock (ending in a device synchronisation).

    With ``cache`` results are content-cached on disk in the ``torch-bem-jax``
    namespace of :func:`raft_tpu_torch.hydro.native_bem.result_cache_key`,
    salted with the route, the dtype, ``N_REFINE``, the wave tables and the
    hash of the route's sources: a result of the plain version is never
    served to a call on the card."""
    from raft_tpu_torch.hydro import native_bem

    dev = resolve_device(device)
    t0 = time.perf_counter()
    panels = np.ascontiguousarray(panels, dtype=np.float64)
    w_np = np.ascontiguousarray(np.atleast_1d(w), dtype=np.float64)
    scalar_beta = np.ndim(beta) == 0
    betas = np.ascontiguousarray(np.atleast_1d(beta), dtype=np.float64)
    depth_f = float(depth) if depth and depth > 0 else -1.0
    finite_depth = depth_f > 0
    route = "kernels" if dev.type == "cuda" else "plain"
    tab = wavetable.load_tables()
    n_lid = 0 if lid is None else len(lid)

    def diagnostics(resid_max: float, cached: bool) -> dict:
        return {"route": route, "cached": cached, "panels": int(len(panels)),
                "padded": pad_panel_count(len(panels) + n_lid), "lid": int(n_lid),
                "nw": int(len(w_np)), "headings": int(len(betas)),
                "refine_iters": N_REFINE, "max_residual": resid_max,
                "finite_depth": finite_depth, "dtype": str(dtype),
                "seconds": time.perf_counter() - t0}

    key = None
    if cache:
        key = native_bem.result_cache_key(
            "torch-bem-jax", panels, w_np, betas, (rho, g, depth_f, 0.0, float(n_lid)),
            salt=(route, str(dtype), N_REFINE, wavetable.TABLE_VERSION, _table_digest(tab),
                  _route_sources_digest()),
            extra_bytes=np.asarray(lid, dtype=np.float64).tobytes() if n_lid else b"")
        hit = native_bem.result_cache_load(key, ("A", "B", "F", "resid"))
        if hit is not None:
            out = (hit["A"], hit["B"], hit["F"][0] if scalar_beta else hit["F"])
            if return_diagnostics:
                return out + (diagnostics(float(hit["resid"].max()), True),)
            return out

    padded, panel_mask, lid_mask = pad_mesh(panels, lid)
    fd = wavetable.fd_fit_grid(w_np, depth_f, g)
    A6, B6, F_cx, resid = solve_panels(
        padded, panel_mask, lid_mask, w_np, betas, fd, tab, rho=float(rho), g=float(g),
        depth=float(depth_f if finite_depth else 0.0), finite_depth=finite_depth,
        dtype=dtype, device=dev)
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
                  dtype=torch.float64, device=None, return_diagnostics: bool = False):
    """The BEM staging entry: the host C++ solver
    (:func:`raft_tpu_torch.hydro.native_bem.solve_bem`, f64, ``nthreads``
    OpenMP threads, 0 for its default) or the on-device panel solve
    (:func:`solve_bem_jax` on ``device`` in ``dtype``), as
    :func:`resolved_mode` decides from ``mode`` and ``device``.  The same
    return contract either way; the diagnostics of the native route give
    its route, counts and wall-clock."""
    route = resolved_mode(mode, device)
    if route == "jax":
        return solve_bem_jax(panels, w, rho=rho, g=g, beta=beta, depth=depth, lid=lid,
                             cache=cache, dtype=dtype, device=device,
                             return_diagnostics=return_diagnostics)
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
