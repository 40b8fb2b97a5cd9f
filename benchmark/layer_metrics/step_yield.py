"""Useful share of the fixed-point loop's steps: the mean iterations a
lane needed (the entry's iteration counts, as ``iters_per_lane`` reads
them) over the loop's steps per solve (the spans ``dynamics/step`` over
the spans ``dynamics``).  1 when every solve stops as its slowest lane
converges; below it the loop steps lanes that have converged (a scan at
a fixed count, or lanes that converge early beside a slow one)."""
import numpy as np

from benchmark.layer_metrics.rebuild_ms import spans


def read(ctx, tag):
    it = ctx["counters"].get("iters")
    p = ctx["profile"]
    steps, solves = spans(p, "dynamics/step"), spans(p, "dynamics")
    if it is None or len(it) == 0 or not steps or not solves:
        return None
    return float(np.mean(it)) / (len(steps) / len(solves))
