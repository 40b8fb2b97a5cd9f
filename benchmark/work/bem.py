"""Work of kernels K3 (the Rankine panel integrals,
``raft_tpu_torch/csrc/bem_rankine.cu``) and K4 (the wave part of the Green
function, ``csrc/bem_wave.cu``): a frozen copy of the program's counts.

The work depends on the data: each pair's subdivision level in K3, each
image's region of the wave integrals in K4.  It is counted for the panels
the program was given, each input byte read once and each output byte
written once, whatever implements the kernel."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import panel, wavetable

# K3: operations per pair of an unmasked source column (level selections,
# store), per subdivision point position and weight, per contribution
K3_FLOPS_PAIR, K3_FLOPS_POINT, K3_FLOPS_CONTRIB = 22, 28, 22
# K4: per image evaluation by region of the wave integrals; per pair and
# frequency with a near image; the deep and finite-depth Green functions
# around their images; the four outputs; R, R_eff once per pair and launch
K4_FLOPS_REGION = {"near": 16 * 105 + 30 + 12, "table": 39, "far": 60, "deep": 11}
K4_FLOPS_NEAR_PAIR = 32
K4_FLOPS_DEEP, K4_FLOPS_FD, K4_FLOPS_COMBINE, K4_FLOPS_PAIR = 90, 277 + 46 * 52, 20, 8


def k3_bytes(n: int, itemsize: int) -> int:
    """Inputs read once (the lid flags a byte each), two (n, n) outputs."""
    return itemsize * (12 * n + 3 * n + 3 * n + 4 * n + 3 * 766 + 2 * n * n) + n


def k3_flops(c, diag, panel_mask, lid_surface) -> int:
    n = c.shape[0]
    sel_d, sel_i = panel.pair_levels(c, diag, lid_surface)

    def points_of(sel):
        return sum(torch.where(sel == lv, nq, 0) for lv, nq in enumerate(panel.LEVEL_COUNT))

    cd, ci = points_of(sel_d), points_of(sel_i)
    col = (panel_mask > 0.5)[None, :]
    points = sum((((sel_d == lv) | (sel_i == lv)) & col).any(dim=0).sum() * nq
                 for lv, nq in enumerate(panel.LEVEL_COUNT))
    return int(n * col.sum() * K3_FLOPS_PAIR + points * K3_FLOPS_POINT
               + ((cd + ci) * col).sum() * K3_FLOPS_CONTRIB)


def k4_bytes(n: int, nf: int, itemsize: int) -> int:
    """Inputs read once, four (nf, n, n) outputs written once."""
    return itemsize * (2 * n * n + 9 * n + 2 * wavetable.NX * wavetable.NS + 44
                       + nf * (4 + 2 * 46) + 4 * nf * n * n)


def k4_flops(c, area, lid_surface, k, fd, depth: float, fd_active) -> int:
    """Operations of one K4 launch on the frequencies of ``k``: each image of
    each pair in its region, the frequency's own branch (deep water, or the
    four finite-depth images where the fit is active)."""
    n, nf = c.shape[0], k.shape[0]
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    R = torch.sqrt(dx * dx + dy * dy + 1e-20)
    diag_lid = torch.eye(n, dtype=torch.bool, device=c.device) & lid_surface[None, :]
    R_use = torch.where(diag_lid, 0.4 * torch.sqrt(torch.clamp(area, min=1e-14))[None, :], R)
    zP, zQ = c[:, 2][:, None], c[:, 2][None, :]
    regions = dict.fromkeys(("near", "table", "far", "deep"), 0)
    flops = K4_FLOPS_PAIR * n * n
    d4 = torch.stack((-(zP + zQ), 2 * depth - (zP - zQ), 2 * depth + (zP - zQ),
                      4 * depth + (zP + zQ)))

    def split(X, Y):
        rho = torch.sqrt(X * X + Y * Y + 1e-18)
        near = rho < 0.6
        far = ~near & (X >= wavetable.XMAX * (1.0 - 1e-7))
        deep = ~near & ~far & (torch.log1p(-Y) >= wavetable.SMAX * (1.0 - 1e-7))
        for key, sel in (("near", near), ("far", far), ("deep", deep),
                         ("table", ~near & ~far & ~deep)):
            regions[key] += int(sel.sum())
        return int(near.any(dim=0).sum())

    for f in range(nf):
        if fd is not None and fd_active[f]:
            k0 = fd["k0"][f]
            near_pairs = split((k0 * R_use)[None], -k0 * d4)
            flops += K4_FLOPS_FD * n * n
        else:
            kk = k[f]
            near_pairs = split((kk * R_use)[None], (kk * (zP + zQ))[None])
            flops += K4_FLOPS_DEEP * n * n
        flops += K4_FLOPS_NEAR_PAIR * near_pairs
    flops += K4_FLOPS_COMBINE * n * n * nf
    flops += sum(K4_FLOPS_REGION[key] * cnt for key, cnt in regions.items())
    return int(flops)


def hull_work(panels: np.ndarray, w, depth: float, g: float, dtype, device) -> dict:
    """K3's and each K4 launch's operations and bytes for one panel solve of
    ``panels`` at frequencies ``w``, in the solve's chunks of frequencies."""
    pans, mask, lid_mask = panel.pad_mesh(panels, None)
    n = pans.shape[0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    pt = torch.as_tensor(pans, device=device).to(dtype)
    c, _nrm, area, diag = panel.panel_geometry(pt)
    lid_surface = torch.zeros(n, dtype=torch.bool, device=device)
    mask_t = torch.as_tensor(mask, device=device).to(dtype)
    w = np.asarray(w, dtype=np.float64)
    finite = depth and depth > 0
    fd_host = wavetable.fd_fit_grid(w, float(depth) if finite else -1.0, g)
    active = [bool(a > 0.5) for a in np.asarray(fd_host["active"])] if finite else [False] * len(w)
    fd = {"k0": torch.as_tensor(np.asarray(fd_host["k0"]), device=device).to(dtype)}
    k = torch.as_tensor(w * w / g, device=device).to(dtype)
    chunk = panel.freq_chunk(n, len(w))
    k4 = []
    for lo in range(0, len(w), chunk):
        sl = slice(lo, min(lo + chunk, len(w)))
        k4.append({"flops": float(k4_flops(c, area, lid_surface, k[sl],
                                           {"k0": fd["k0"][sl]} if finite else None,
                                           float(depth) if finite else 0.0, active[sl])),
                   "bytes": float(k4_bytes(n, sl.stop - sl.start, itemsize))})
    return {"k3": {"flops": float(k3_flops(c, diag, mask_t, lid_surface)),
                   "bytes": float(k3_bytes(n, itemsize))},
            "k4": k4, "dtype": "float64" if dtype == torch.float64 else "float32"}
