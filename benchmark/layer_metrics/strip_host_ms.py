"""Milliseconds of host time per call in the strip hydro and the drag
linearization: the spans ``forward/strip`` (kinematics, added mass,
excitation) and every ``drag`` of ``solve_dynamics``, on the profiler's
clock; spans inside a ``backward`` span (a recomputed step of the
reverse pass) are left out, so the gradient cell reads its forward pass
alone."""
from benchmark.layer_metrics.rebuild_ms import ms_per_call, spans


def read(ctx, tag):
    p = ctx["profile"]
    back = [(e.start, e.end) for e in spans(p, "backward")]
    events = [e for e in spans(p, "forward/strip") + spans(p, "drag")
              if not any(a <= e.start and e.end <= b for a, b in back)]
    return ms_per_call(ctx, events)
