"""Frequency-grid interpolation of BEM coefficients (the port's own copy of
``raft_tpu.hydro.bem_io.interp_to_grid``, host numpy).

The WAMIT/Nemoh readers of the JAX package come with a later slice
(ROADMAP.md, queue 1)."""
from __future__ import annotations

import numpy as np


def interp_to_grid(w_src, arr, w_dst):
    """Interpolate coefficient arrays (..., nw_src) onto w_dst.

    Raises ValueError if w_dst extends beyond the source grid."""
    w_src = np.asarray(w_src)
    w_dst = np.asarray(w_dst)
    if w_dst.min() < w_src.min() - 1e-9 or w_dst.max() > w_src.max() + 1e-9:
        raise ValueError(
            f"requested grid [{w_dst.min():.3f}, {w_dst.max():.3f}] outside "
            f"source data range [{w_src.min():.3f}, {w_src.max():.3f}]"
        )
    out = np.empty(arr.shape[:-1] + (len(w_dst),), dtype=arr.dtype)
    flat = arr.reshape(-1, arr.shape[-1])
    oflat = out.reshape(-1, len(w_dst))
    for i in range(flat.shape[0]):
        if np.iscomplexobj(arr):
            oflat[i] = np.interp(w_dst, w_src, flat[i].real) + 1j * np.interp(
                w_dst, w_src, flat[i].imag
            )
        else:
            oflat[i] = np.interp(w_dst, w_src, flat[i])
    return out
