"""Kernels launched on the card per call of the entry, from the profile."""


def read(ctx, tag):
    p = ctx["profile"]
    lo, hi = p.window
    n = sum(1 for e in p.device if e.kind == "kernel" and lo <= e.start <= hi)
    return n / ctx["n_calls"]
