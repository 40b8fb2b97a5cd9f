"""Milliseconds per call of the north star's per-call set-up (the span
``rebuild`` of ``sweep_north_star``: the design, its mooring stiffness,
the BEM cast, the draft and plan warps, the grid), on the profiler's
clock.

The program's spans are ``user_annotation`` ranges named by their full
paths while the profiler records; the span readers (``strip_host_ms``,
``exit_wait_ms``, ``step_yield``, ``mesh_self_ms``) match them here by
the last segments of those paths."""


def spans(p, suffix: str) -> list:
    """The program's spans whose path ends in the segments ``suffix``
    (``"forward/strip"`` matches ``forward/strip`` and
    ``pipeline/dispatch/forward/strip``), inside the ``bench/call``
    ranges."""
    calls = p.calls
    return [e for e in p.host if e.kind == "user_annotation"
            and (e.name == suffix or e.name.endswith("/" + suffix))
            and any(a <= e.start and e.end <= b for a, b in calls)]


def ms_per_call(ctx, events) -> float | None:
    """The summed durations of ``events`` in milliseconds per call; None
    without any."""
    if not events:
        return None
    return 1e-6 * sum(e.end - e.start for e in events) / ctx["n_calls"]


def read(ctx, tag):
    return ms_per_call(ctx, spans(ctx["profile"], "rebuild"))
