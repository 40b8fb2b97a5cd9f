"""Milliseconds of ``mesh_design`` per hull, by the harness's host clock
around the call."""
import numpy as np


def read(ctx, tag):
    t = ctx["counters"].get("mesh_s")
    if not t:
        return None
    return 1e3 * float(np.mean(t))
