"""Unrolled 6x6 linear algebra in plain PyTorch (port of
``raft_tpu.core.linalg6``, lines 80-258).

Everything broadcasts over leading batch axes.  :func:`solve_cx_fused` is
the plain version of kernel K1 (:mod:`raft_tpu_torch.core.cuda6`): the CPU
path of the RAO fixed point, and what the kernel is held against on the
card.  The blocked large-matrix LU of the JAX module belongs to the BEM
slice and is not ported here.
"""
from __future__ import annotations

import torch

from raft_tpu_torch.core.cplx import Cx

Tensor = torch.Tensor


def _pivot_rows(col_mag: Tensor, k: int, n: int) -> Tensor:
    """(..., n) gather indices swapping row k with the max-magnitude row
    >= k (first maximum on a tie, so a tie keeps the lowest row)."""
    rows = torch.arange(n, device=col_mag.device)
    masked = torch.where(rows >= k, col_mag, torch.full_like(col_mag, -1.0))
    piv = torch.argmax(masked, dim=-1, keepdim=True)
    idx = rows.expand(masked.shape)
    return torch.where(idx == k, piv, torch.where(idx == piv, torch.full_like(idx, k), idx))


def _gather_rows(A: Tensor, idx: Tensor) -> Tensor:
    """Gather rows of (..., n, m) by (..., n) indices."""
    return torch.gather(A, -2, idx[..., None].expand(*idx.shape, A.shape[-1]))


def solve_cx(A: Cx, b: Cx, n: int = 6) -> Cx:
    """Solve complex A x = b, A: (..., n, n), b: (..., n) or (..., n, m).

    Gaussian elimination with partial pivoting (strict maximum of |.|^2,
    lowest row on a tie); a zero pivot has its denominator replaced by 1.
    """
    vec = b.re.ndim == A.re.ndim - 1
    shape = torch.broadcast_shapes(A.re.shape[:-2], b.re.shape[:-1 if vec else -2])
    Ar = A.re.expand(*shape, n, n)
    Ai = A.im.expand(*shape, n, n)
    br = b.re[..., None] if vec else b.re
    bi = b.im[..., None] if vec else b.im
    br = br.expand(*shape, *br.shape[-2:])
    bi = bi.expand(*shape, *bi.shape[-2:])
    below_all = torch.arange(n, device=Ar.device)
    for k in range(n):
        mag = Ar[..., :, k] ** 2 + Ai[..., :, k] ** 2
        idx = _pivot_rows(mag, k, n)
        Ar = _gather_rows(Ar, idx)
        Ai = _gather_rows(Ai, idx)
        br = _gather_rows(br, idx)
        bi = _gather_rows(bi, idx)
        den = Ar[..., k, k] ** 2 + Ai[..., k, k] ** 2
        den = torch.where(den != 0, den, torch.ones_like(den))
        fr = (Ar[..., :, k] * Ar[..., k:k + 1, k] + Ai[..., :, k] * Ai[..., k:k + 1, k]) / den[..., None]
        fi = (Ai[..., :, k] * Ar[..., k:k + 1, k] - Ar[..., :, k] * Ai[..., k:k + 1, k]) / den[..., None]
        below = below_all > k
        fr = torch.where(below, fr, torch.zeros_like(fr))
        fi = torch.where(below, fi, torch.zeros_like(fi))
        Ar, Ai = (
            Ar - (fr[..., None] * Ar[..., k:k + 1, :] - fi[..., None] * Ai[..., k:k + 1, :]),
            Ai - (fr[..., None] * Ai[..., k:k + 1, :] + fi[..., None] * Ar[..., k:k + 1, :]),
        )
        br, bi = (
            br - (fr[..., None] * br[..., k:k + 1, :] - fi[..., None] * bi[..., k:k + 1, :]),
            bi - (fr[..., None] * bi[..., k:k + 1, :] + fi[..., None] * br[..., k:k + 1, :]),
        )
    # back substitution row by row, without writing into a tensor, so that
    # autograd can differentiate the plain elimination
    rows_r = [None] * n
    rows_i = [None] * n
    for k in range(n - 1, -1, -1):
        sr, si = br[..., k, :], bi[..., k, :]
        if k + 1 < n:
            xr_t = torch.stack(rows_r[k + 1:], dim=-2)
            xi_t = torch.stack(rows_i[k + 1:], dim=-2)
            sr = sr - (torch.einsum("...j,...jm->...m", Ar[..., k, k + 1:], xr_t)
                       - torch.einsum("...j,...jm->...m", Ai[..., k, k + 1:], xi_t))
            si = si - (torch.einsum("...j,...jm->...m", Ar[..., k, k + 1:], xi_t)
                       + torch.einsum("...j,...jm->...m", Ai[..., k, k + 1:], xr_t))
        den = Ar[..., k, k] ** 2 + Ai[..., k, k] ** 2
        den = torch.where(den != 0, den, torch.ones_like(den))[..., None]
        rows_r[k] = (sr * Ar[..., k, k][..., None] + si * Ai[..., k, k][..., None]) / den
        rows_i[k] = (si * Ar[..., k, k][..., None] - sr * Ai[..., k, k][..., None]) / den
    xr = torch.stack(rows_r, dim=-2)
    xi = torch.stack(rows_i, dim=-2)
    if vec:
        return Cx(xr[..., 0], xi[..., 0])
    return Cx(xr, xi)


def assemble_impedance(Z0: Cx, w: Tensor, B_drag: Tensor) -> Cx:
    """``Z = Z0 + i w B_drag``: Z0 (..., nw, 6, 6), w broadcastable to
    (..., nw), B_drag (..., 6, 6) shared over the frequency axis."""
    return Cx(Z0.re, Z0.im + w[..., None, None] * B_drag[..., None, :, :])


def solve_cx_fused(Z0: Cx, w: Tensor, B_drag: Tensor, F: Cx, n: int = 6) -> Cx:
    """Plain fused RAO assemble+solve ``x = (Z0 + i w B_drag)^-1 F``."""
    return solve_cx(assemble_impedance(Z0, w, B_drag), F, n=n)


def solve_re(A: Tensor, b: Tensor, n: int = 6) -> Tensor:
    """Real A x = b via the complex solve (zero imaginary part)."""
    return solve_cx(Cx(A, torch.zeros_like(A)), Cx(b, torch.zeros_like(b)), n=n).re


def cholesky(M: Tensor, n: int = 6) -> Tensor:
    """Unrolled Cholesky factor L (lower) of SPD M: (..., n, n)."""
    L = torch.zeros_like(M)
    for j in range(n):
        s = M[..., j, j] - torch.einsum("...k,...k->...", L[..., j, :j], L[..., j, :j])
        ljj = torch.sqrt(torch.clamp(s, min=1e-30))
        L[..., j, j] = ljj
        for i in range(j + 1, n):
            s = M[..., i, j] - torch.einsum("...k,...k->...", L[..., i, :j], L[..., j, :j])
            L[..., i, j] = s / ljj
    return L


def solve_lower(L: Tensor, b: Tensor, n: int = 6) -> Tensor:
    """Solve L y = b with L lower-triangular, b: (..., n) or (..., n, m)."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.zeros_like(b)
    for i in range(n):
        s = b[..., i, :] - torch.einsum("...k,...km->...m", L[..., i, :i], y[..., :i, :])
        y[..., i, :] = s / L[..., i, i][..., None]
    return y[..., 0] if vec else y


def solve_upper(U: Tensor, b: Tensor, n: int = 6) -> Tensor:
    """Solve U y = b with U upper-triangular."""
    vec = b.ndim == U.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        s = b[..., i, :] - torch.einsum("...k,...km->...m", U[..., i, i + 1:], y[..., i + 1:, :])
        y[..., i, :] = s / U[..., i, i][..., None]
    return y[..., 0] if vec else y


def eigh_jacobi(M: Tensor, n: int = 6, sweeps: int = 12):
    """Symmetric eigendecomposition by fixed-sweep cyclic Jacobi rotations:
    (eigvals (..., n), eigvecs (..., n, n) as columns)."""
    A = M.clone()
    V = (torch.zeros_like(M) + torch.eye(n, dtype=M.dtype, device=M.device)).contiguous()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                theta = 0.5 * torch.atan2(2.0 * A[..., p, q], A[..., q, q] - A[..., p, p])
                c = torch.cos(theta)[..., None]
                s = torch.sin(theta)[..., None]
                rowp = A[..., p, :].clone()
                rowq = A[..., q, :].clone()
                A[..., p, :] = c * rowp - s * rowq
                A[..., q, :] = s * rowp + c * rowq
                colp = A[..., :, p].clone()
                colq = A[..., :, q].clone()
                A[..., :, p] = c * colp - s * colq
                A[..., :, q] = s * colp + c * colq
                vp = V[..., :, p].clone()
                vq = V[..., :, q].clone()
                V[..., :, p] = c * vp - s * vq
                V[..., :, q] = s * vp + c * vq
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def generalized_eigh(K: Tensor, M: Tensor, n: int = 6, sweeps: int = 12):
    """K x = lambda M x for symmetric K, SPD M, by Cholesky reduction +
    Jacobi: (lambda (..., n), modes (..., n, n) as columns)."""
    L = cholesky(M, n=n)
    Y = solve_lower(L, K, n=n)
    Z = solve_lower(L, Y.transpose(-1, -2), n=n)
    A = 0.5 * (Z + Z.transpose(-1, -2))
    lam, V = eigh_jacobi(A, n=n, sweeps=sweeps)
    X = solve_upper(L.transpose(-1, -2), V, n=n)
    return lam, X
