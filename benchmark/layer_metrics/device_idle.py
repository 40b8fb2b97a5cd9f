"""Share of the traced window in which no kernel, copy or set ran on the
card (``fraction``)."""
from benchmark.harness import profile


def read(ctx, tag):
    p = ctx["profile"]
    return 1.0 - profile.busy_s(p) / p.window_s
