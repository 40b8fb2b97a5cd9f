"""Fleet-smoke: cross-process proof of the fault-tolerant serving tier
(port of ``raft_tpu.serve.fleet_smoke``).

``python -m raft_tpu_torch.serve fleet-smoke [--device cpu] [--keep]``
runs the real fleet (supervisor and router in this process, real daemon
children over real sockets, all on the shared kernel build directory)
and proves the robustness contract in three phases:

* **Phase A (reference)**: a 1-replica fleet serves the mixed 3-design
  stream through the router; its rows become the bit-identical
  reference, and the single replica builds no kernel library.  A caller
  that already holds the rows of the same stream at the same
  configuration (the chip smoke's "serve" phase, or
  :func:`raft_tpu_torch.serve.smoke.solo_reference`) passes them to
  :func:`run` and phase A is skipped.
* **Phase B (failover)**: a 2-replica fleet starts (both replicas with
  zero kernel builds at ready).  Mid-stream, the counted
  ``kill_replica:1`` fault SIGKILLs the replica the router just picked:
  every request is still answered exactly once, the rows are
  bit-identical to phase A's, at least one response carries a
  ``resubmits`` count, and the supervisor restarts the dead replica
  (zero kernel builds at ready) with the router re-admitting it only
  after a passing probe.
* **Phase C (shed-then-recover)**: a 1-replica fleet with ``queue_max=1``
  and a short forward deadline; ``stall_replica:1`` wedges the first
  request in flight, so a burst of 7 more is shed with typed
  ``Overloaded`` responses carrying ``retry_after_ms`` hints.  The stalled
  request is recovered by the forward deadline (answered, with a
  resubmit), and every shed request succeeds when submitted again.

Each replica's ready time is reported, and the K1 launches the live
replicas made after their ready lines (a killed replica's launches die
with its process).  :func:`run` takes ``full_width=True`` for replicas
at the daemon's defaults (see :func:`raft_tpu_torch.serve.smoke.serve_args`).
Prints one JSON line; rc 0 iff all checks hold.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

from raft_tpu_torch.resilience import faults
from raft_tpu_torch.serve.smoke import child_env, serve_args

#: the mixed stream: 3 designs x 4 rounds = 12 solve requests (the serve
#: smoke's stream, one round longer: the kill fires mid-stream with work on
#: both sides of it)
STREAM = [(d, 6.0 + 0.5 * (i % 3), 10.0 + 0.5 * (i % 2))
          for i, d in enumerate(["oc3", "oc4", "volturnus"] * 4)]


def _mk_fleet(tmp: str, tag: str, device: str | None, full_width: bool, **cfg_overrides):
    from raft_tpu_torch.serve.fleet import Fleet, FleetConfig

    cfg = FleetConfig.from_env(socket_path=os.path.join(tmp, f"fleet-{tag}.sock"),
                               **cfg_overrides)
    run_dir = os.path.join(tmp, f"run-{tag}")
    os.makedirs(run_dir, exist_ok=True)
    # the replicas inherit no fault arming: the parent arms faults for the
    # router, and a child inheriting them would fire them twice
    return Fleet(cfg, serve_args=serve_args(device, full_width), child_env=child_env(),
                 run_dir=run_dir)


def _counters(fleet) -> dict:
    return dict(fleet.router.telemetry()["counters"])


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _ready_s(ready: dict) -> list:
    return [r.get("ready_s") for r in ready["replicas"].values()]


def _drive(sock: str, arm_kill_after: int | None = None):
    """Submit the stream open-loop through the router; optionally arm
    ``kill_replica:1`` after the first ``arm_kill_after`` responses have
    landed (the kill strikes mid-stream, between two requests).  Returns
    ``(rows, responses)``, ``rows`` as ``(std_dev, iterations)``."""
    from raft_tpu_torch.serve.client import SolveClient

    with SolveClient(sock, connect_timeout=30.0) as cl:
        head = STREAM if arm_kill_after is None else STREAM[:arm_kill_after]
        tail = [] if arm_kill_after is None else STREAM[arm_kill_after:]
        futs = [cl.submit({"op": "solve", "design": d, "Hs": Hs, "Tp": Tp})
                for d, Hs, Tp in head]
        resps = [f.result(300.0) for f in futs]
        if tail:
            faults.reset_counts()
            os.environ["RAFT_TPU_FAULT_INJECT"] = "kill_replica:1"
            try:
                futs = [cl.submit({"op": "solve", "design": d, "Hs": Hs, "Tp": Tp})
                        for d, Hs, Tp in tail]
                resps += [f.result(300.0) for f in futs]
            finally:
                os.environ.pop("RAFT_TPU_FAULT_INJECT", None)
                faults.reset_counts()
    bad = [r for r in resps if not r.get("ok")]
    if bad:
        raise RuntimeError(f"{len(bad)} requests failed: {bad[0]}")
    rows = [(r["results"][0]["std_dev"], r["results"][0]["iterations"]) for r in resps]
    return rows, resps


def _replica_solver_stats(fleet) -> list:
    """Per-replica ``stats`` over a direct connection to each replica
    socket (kernel build and launch counts are per-process truths the
    router cannot fake), each with ``k1_launches_served``: the replica's K1
    launches since its last ready line."""
    from raft_tpu_torch.serve.client import SolveClient

    out = []
    for rep in fleet.telemetry()["supervisor"]["replicas"]:
        with SolveClient(rep["socket"], connect_timeout=10.0) as cl:
            stats = cl.stats()["solver"]
        at_ready = fleet._replicas[rep["idx"]].ready["kernel_launches_at_ready"]
        stats["k1_launches_served"] = stats["kernel_launches"]["fused"] - at_ready["fused"]
        out.append(stats)
    return out


def _wait_restarted(fleet, first_ready: dict, timeout_s: float = 300.0) -> bool:
    """Wait until some replica was restarted, every restarted replica has
    printed a new ready line, and the router holds every replica healthy.
    (A restarted daemon binds its socket before its warm-up, so the router
    may re-admit it before its ready line: healthy alone is not enough.)"""
    n = len(fleet._replicas)
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        restarted = [r for r in fleet._replicas if r.restarts > 0]
        if (restarted and all(r.ready is not first_ready[r.idx] for r in restarted)
                and fleet.router.telemetry()["healthy"] >= n):
            return True
        time.sleep(0.25)
    return False


def run(device: str | None, tmp: str, reference_rows=None, full_width: bool = False) -> tuple:
    """Phases A (unless ``reference_rows`` is given), B and C; returns
    ``(checks, info)``."""
    checks: dict = {}
    info: dict = {"ready_s": {}, "k1_launches": 0}
    os.environ.pop("RAFT_TPU_FAULT_INJECT", None)
    faults.reset_counts()
    try:
        # ---- Phase A: 1-replica reference through the router ----
        if reference_rows is None:
            fleet = _mk_fleet(tmp, "a", device, full_width, replicas=1)
            try:
                info["ready_s"]["a"] = _ready_s(fleet.start())
                c0 = _counters(fleet)
                reference_rows, _ = _drive(fleet.router.socket_path)
                d = _delta(_counters(fleet), c0)
                solver_a = _replica_solver_stats(fleet)[0]
            finally:
                fleet.stop()
            info["k1_launches"] += solver_a["k1_launches_served"]
            checks["phase_a_zero_compiles"] = solver_a["compiles"] == 0
            checks["phase_a_all_relayed"] = d["relayed"] == len(STREAM) and d["failover"] == 0
            info["n_buckets"] = len(solver_a["buckets"])

        # ---- Phase B: 2 replicas; kill one mid-stream ----
        fleet = _mk_fleet(tmp, "b", device, full_width, replicas=2)
        try:
            ready = fleet.start()
            first_ready = {r.idx: r.ready for r in fleet._replicas}
            info["ready_s"]["b"] = _ready_s(ready)
            checks["fleet_zero_compiles_at_ready"] = [
                r.get("compiles_at_ready") for r in ready["replicas"].values()] == [0, 0]
            c0 = _counters(fleet)
            rows_b, resps_b = _drive(fleet.router.socket_path, arm_kill_after=4)
            d = _delta(_counters(fleet), c0)
            resubmitted = [r for r in resps_b if r.get("resubmits")]
            checks["kill_all_answered_exactly_once"] = (
                len(resps_b) == len(STREAM) and all(r.get("ok") for r in resps_b)
                and d["relayed"] == len(STREAM))
            checks["kill_failover_fired"] = d["failover"] >= 1 and len(resubmitted) >= 1
            checks["kill_rows_bit_identical"] = rows_b == reference_rows
            restarted = _wait_restarted(fleet, first_ready)
            checks["dead_replica_restarted_and_readmitted"] = restarted
            killed = [r.idx for r in fleet._replicas if r.restarts > 0]
            admissions = {r["idx"]: r["admissions"]
                          for r in fleet.router.telemetry()["replicas"]}
            checks["readmitted_after_probe"] = (
                len(killed) == 1 and admissions[killed[0]] == 2)
            checks["restart_counter_fired"] = (
                _counters(fleet)["restart"] - c0["restart"] >= 1 and len(killed) == 1)
            checks["restarted_replica_zero_compiles"] = all(
                fleet._replicas[i].ready.get("compiles_at_ready") == 0 for i in killed)
            info["ready_s"]["b_restart"] = [fleet._replicas[i].ready.get("ready_s")
                                            for i in killed]
            solver_b = _replica_solver_stats(fleet) if restarted else []
            checks["replicas_zero_compiles"] = (
                bool(solver_b) and all(s["compiles"] == 0 for s in solver_b))
            info["k1_launches"] += sum(s["k1_launches_served"] for s in solver_b)
        finally:
            fleet.stop()
        info["failover_requests"] = d["failover"]
        info["resubmitted_responses"] = len(resubmitted)
        info["killed_replica"] = killed

        # ---- Phase C: forced overload -> typed shed -> recover ----
        from raft_tpu_torch.serve.client import SolveClient

        fleet = _mk_fleet(tmp, "c", device, full_width, replicas=1, queue_max=1,
                          request_timeout_s=2.0)
        try:
            info["ready_s"]["c"] = _ready_s(fleet.start())
            c0 = _counters(fleet)
            with SolveClient(fleet.router.socket_path, connect_timeout=30.0) as cl:
                faults.reset_counts()
                os.environ["RAFT_TPU_FAULT_INJECT"] = "stall_replica:1"
                try:
                    stalled = cl.submit({"op": "solve", "design": "oc3", "Hs": 6.0, "Tp": 10.0})
                    burst = [cl.submit({"op": "solve", "design": d, "Hs": Hs, "Tp": Tp})
                             for d, Hs, Tp in STREAM[1:8]]
                    shed = [f.result(60.0) for f in burst]
                finally:
                    os.environ.pop("RAFT_TPU_FAULT_INJECT", None)
                    faults.reset_counts()
                checks["overload_sheds_typed"] = all(
                    r.get("ok") is False and r.get("shed") is True
                    and r.get("error", {}).get("class") == "Overloaded"
                    and r.get("retry_after_ms", 0) > 0 for r in shed)
                stalled_resp = stalled.result(120.0)
                checks["stalled_request_recovered"] = (
                    stalled_resp.get("ok") is True and stalled_resp.get("resubmits", 0) >= 1)
                redo = [cl.call({"op": "solve", "design": d, "Hs": Hs, "Tp": Tp},
                                timeout=120.0) for d, Hs, Tp in STREAM[1:8]]
                checks["shed_requests_recover"] = all(r.get("ok") for r in redo)
            d = _delta(_counters(fleet), c0)
            # exactly the 7 burst requests shed (dispatch is sequential on
            # the conn reader, so admission sees each one's predecessor)
            checks["shed_counter_deterministic"] = d["shed"] == 7
            checks["forward_deadline_counter_fired"] = d["timeouts"] >= 1
            info["k1_launches"] += sum(s["k1_launches_served"]
                                       for s in _replica_solver_stats(fleet))
        finally:
            fleet.stop()
        info["shed_count"] = d["shed"]
    finally:
        os.environ.pop("RAFT_TPU_FAULT_INJECT", None)
        faults.reset_counts()
    return checks, info


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="raft_tpu_torch.serve fleet-smoke")
    p.add_argument("--device", default=None,
                   help="torch device of every replica (default: the card)")
    p.add_argument("--keep", action="store_true", help="keep the temporary directory")
    args = p.parse_args(argv)
    from raft_tpu_torch.core.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"raft_tpu_torch.serve fleet-smoke: {e}", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="raft_tpu_torch_fleet_smoke_")
    try:
        checks, info = run(args.device, tmp)
        ok = all(checks.values())
        print(json.dumps({"ok": ok, **checks, **info, "n_requests": len(STREAM),
                          "wall_s": round(time.perf_counter() - t_all, 2),
                          **({"dir": tmp} if args.keep else {})}))
        return 0 if ok else 1
    finally:
        if not args.keep:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":                                # pragma: no cover
    sys.exit(main())
