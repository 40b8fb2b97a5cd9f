"""Milliseconds per call that the ``while`` loop's exit tests take (the
spans ``exit_test`` of ``solve_dynamics``, one per pass of the loop: the
host's wait for the step's answer), on the profiler's clock."""
from benchmark.layer_metrics.rebuild_ms import ms_per_call, spans


def read(ctx, tag):
    return ms_per_call(ctx, spans(ctx["profile"], "exit_test"))
