"""Synthetic open-loop load generator for the resident solver service
(port of ``raft_tpu.serve.loadgen``, the same schedule).

OPEN loop: request ``i`` is submitted at its scheduled instant whether or
not earlier requests completed — the arrival process never adapts to the
server (closed-loop generators hide overload by self-throttling; see any
coordinated-omission discussion).  The schedule is CLOSED-FORM — design,
sea state, and arrival offset are pure functions of the request index,
zero wall-clock randomness — so two runs issue byte-identical request
streams and a load run is reproducible:

* ``design(i)``: cycles the mixed stream (default OC3 spar -> OC4 semi ->
  VolturnUS-S — two shape buckets under the stock ladder);
* ``Hs(i) = 6 + 0.5 * (i mod 5)``, ``Tp(i) = 10 + 0.25 * (i mod 7)``
  (35 distinct sea states, exercising the staging memo without
  unbounded growth);
* ``arrival_s(i) = i / rate``.

Latency accounting: per request, ``t_done - t_sched`` (completion wall
instant minus the SCHEDULED arrival) — the number a client shows a user,
queueing delay included.  Quantiles are deterministic rank statistics
(sorted, ``ceil(q*n)-1``), the same rule as
:meth:`raft_tpu_torch.obs.metrics.Histogram.quantile`.

The sequential baseline (`run_sequential`) issues the SAME request
stream one-at-a-time (submit, wait, next) — the one-shot-process usage
pattern the daemon exists to beat.
"""
from __future__ import annotations

import math
import time

DEFAULT_DESIGNS = ("oc3", "oc4", "volturnus")


def schedule(i: int, rate: float, designs=DEFAULT_DESIGNS,
             n_hs: int = 5, n_tp: int = 7):
    """Request ``i`` of the closed-form stream ->
    ``(design, Hs, Tp, arrival_s)``.  ``n_hs``/``n_tp`` bound the
    sea-state variety (``n_hs * n_tp`` distinct states): the default 35
    exercises the staging memo hard; a load run uses a smaller product so
    a measured pass runs against a WARM memo (one staging per distinct
    state, amortized in the warm pass)."""
    return (designs[i % len(designs)],
            6.0 + 0.5 * (i % n_hs),
            10.0 + 0.25 * (i % n_tp),
            i / float(rate))


def quantile(xs, q: float) -> float:
    """Deterministic rank quantile (sorted, ``ceil(q*n)-1``)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def _summary(lat, n: int, wall_s: float) -> dict:
    return {
        "n_requests": n,
        "wall_s": round(wall_s, 4),
        "solves_per_s": round(n / wall_s, 2) if wall_s > 0 else None,
        "latency_p50_s": round(quantile(lat, 0.50), 4),
        "latency_p99_s": round(quantile(lat, 0.99), 4),
        "latency_mean_s": round(sum(lat) / len(lat), 4) if lat else None,
    }


def run_open_loop(client, n: int, rate: float, designs=DEFAULT_DESIGNS,
                  timeout_s: float = 600.0, **sched_kw):
    """Drive ``n`` scheduled requests through an open
    :class:`~raft_tpu_torch.serve.client.SolveClient`; block for every
    response; returns ``(summary, responses)``.  Raises on any failed
    response (a load test that drops errors measures nothing)."""
    done_t = [None] * n
    futs = []
    t0 = time.perf_counter()
    for i in range(n):
        design, Hs, Tp, arr = schedule(i, rate, designs, **sched_kw)
        delay = t0 + arr - time.perf_counter()
        if delay > 0:
            time.sleep(delay)             # open loop: schedule, not ack
        fut = client.submit({"op": "solve", "design": design,
                             "Hs": Hs, "Tp": Tp})

        def _stamp(f, i=i):
            done_t[i] = time.perf_counter()

        fut.add_done_callback(_stamp)
        futs.append(fut)
    results = [f.result(timeout_s) for f in futs]
    t_end = max(done_t)
    bad = [r for r in results if not r.get("ok")]
    if bad:
        raise RuntimeError(f"{len(bad)}/{n} requests failed; first: "
                           f"{bad[0].get('error')}")
    lat = [done_t[i] - (t0 + schedule(i, rate, designs, **sched_kw)[3])
           for i in range(n)]
    out = _summary(lat, n, t_end - t0)
    out["rate_req_per_s"] = rate
    out["mode"] = "open_loop"
    return out, results


def run_sequential(client, n: int, rate: float, designs=DEFAULT_DESIGNS,
                   timeout_s: float = 600.0, **sched_kw) -> dict:
    """The SAME request stream, one at a time (submit -> wait -> next):
    the one-shot usage pattern.  ``rate`` only selects the identical
    request parameters; arrivals are completion-driven by construction."""
    lat = []
    t0 = time.perf_counter()
    for i in range(n):
        design, Hs, Tp, _arr = schedule(i, rate, designs, **sched_kw)
        t_s = time.perf_counter()
        r = client.call({"op": "solve", "design": design,
                         "Hs": Hs, "Tp": Tp}, timeout=timeout_s)
        if not r.get("ok"):
            raise RuntimeError(f"sequential request {i} failed: "
                               f"{r.get('error')}")
        lat.append(time.perf_counter() - t_s)
    out = _summary(lat, n, time.perf_counter() - t0)
    out["mode"] = "sequential"
    return out
