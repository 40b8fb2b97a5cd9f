"""Work of kernel K1 (the fused 6x6 complex assemble and solve,
``raft_tpu_torch/csrc/solve6.cu``), from its shapes alone: a frozen copy
of the program's formula."""
from __future__ import annotations


def flops_per_system() -> int:
    """Operations of one assemble + solve: the drag assembly, the pivot
    magnitudes, the elimination and the back substitution."""
    n = 6
    flops = 2 * n * n                                     # Z.im = Z0.im + w * B
    for k in range(n):
        flops += 3 * (n - k) + 3                          # |.|^2 of candidates, den
        flops += (n - 1 - k) * (8 + 8 * (n - k) + 8)      # factors, row, rhs
    for k in range(n):
        flops += 8 * (n - 1 - k) + 3 + 8                  # back substitution
    return flops


def work(n_designs: int, nw: int, itemsize: int) -> dict:
    """Operations and bytes of one launch on ``n_designs`` x ``nw`` systems:
    Z0 and F read and x written per system, ``w`` once, B_drag per design."""
    n = n_designs * nw
    return {"flops": float(n * flops_per_system()),
            "bytes": float(itemsize * (n * 36 * 2 + n * 6 * 2 + n * 6 * 2 + nw
                                       + n_designs * 36))}
