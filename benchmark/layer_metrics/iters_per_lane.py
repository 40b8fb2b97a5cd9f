"""Mean fixed-point iterations per lane over the traced calls, from the
iteration counts the entry returns."""
import numpy as np


def read(ctx, tag):
    it = ctx["counters"].get("iters")
    if it is None or len(it) == 0:
        return None
    return float(np.mean(it))
