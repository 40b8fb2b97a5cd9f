"""Milliseconds per hull of ``mesh_design``'s own host work: the span
``mesh`` less the part of it its child spans cover, on the profiler's
clock (one hull a call)."""
from benchmark.harness import profile
from benchmark.layer_metrics.rebuild_ms import spans


def read(ctx, tag):
    p = ctx["profile"]
    meshes = spans(p, "mesh")
    if not meshes:
        return None
    own = 0
    for m in meshes:
        kids = [(e.start, e.end) for e in p.host if e.kind == "user_annotation"
                and e.name.startswith(m.name + "/") and m.start <= e.start and e.end <= m.end]
        own += (m.end - m.start) - sum(e - s for s, e in profile._merged(kids))
    return 1e-6 * own / ctx["n_calls"]
