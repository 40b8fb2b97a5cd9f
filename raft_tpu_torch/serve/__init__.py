"""Resident solver service: continuous deadline-bounded request batching
(port of ``raft_tpu.serve``).

Every other entry point of the port is a one-shot process: stage, build
or load the kernels, solve, exit.  This subsystem keeps that machinery
resident (staged design lanes on the device, the loaded kernel
libraries, a warm CUDA context) inside a long-lived daemon on a local
socket, and amortizes it across an arbitrary stream of independent
clients.

The moving parts, one module each:

``config``
    :class:`ServeConfig`: every knob the serve loop consults, snapshotted
    once at arm time (``RAFT_TPU_SERVE_BATCH_DEADLINE_MS`` /
    ``RAFT_TPU_SERVE_BATCH_MAX`` / ``RAFT_TPU_SERVE_SOCKET``), plus the
    port's ``device`` (lanes are staged and solved in float64).
``protocol``
    Length-prefixed JSON framing over a local stream socket, plus request
    validation: ``solve`` (one design x one sea state = one lane),
    ``dlc`` (one design x N sea states = N lanes), ``sweep`` (N designs x
    one sea state = N lanes, possibly spanning buckets), ``ping`` /
    ``stats`` / ``refresh`` / ``shutdown``.
``batcher``
    :class:`~raft_tpu_torch.serve.batcher.MicroBatcher`: the deterministic
    deadline-or-capacity micro-batching core on an injectable clock.
``solver``
    :class:`~raft_tpu_torch.serve.solver.SolverCore` (the staging memo:
    design x sea state -> bucket-padded lane tensors on the device) and
    :func:`~raft_tpu_torch.serve.solver.solve_batch`: pad a closed batch
    to the fixed lane capacity, solve it through
    :func:`~raft_tpu_torch.parallel.sweep.sweep_designs` (health and
    quarantine per lane; kernel K1 in every iteration on the card), and
    slice per-lane rows back to their owning requests.
``server``
    The daemon: accept loop, per-connection reader threads, one solver
    loop draining the batcher, graceful SIGTERM drain.
``client``
    :class:`~raft_tpu_torch.serve.client.SolveClient`: async submit and
    collect over the socket, typed transport failures
    (``ServeTimeout`` / ``ServeConnectionLost``), bounded reconnects.
``fleet`` / ``router``
    :class:`~raft_tpu_torch.serve.fleet.Fleet` supervises N daemon
    replicas on the shared kernel build directory (storm-bounded
    restarts) behind a :class:`~raft_tpu_torch.serve.router.FleetRouter`:
    the same wire protocol on one socket, bucket-affinity routing,
    heartbeat probes, failover resubmission and error-budget load
    shedding with typed ``Overloaded`` responses.
``loadgen``
    Open-loop load generator with a closed-form arrival schedule and
    deterministic p50/p99 accounting.
``smoke`` / ``fleet_smoke``
    ``python -m raft_tpu_torch.serve smoke`` and ``fleet-smoke``: the
    cross-process proofs (``--device cpu`` off the card).

Why per-request results cannot depend on batch-mates: every dispatch is
padded to ``batch_max`` lanes (unused lanes tile the real ones), so a
bucket always solves at one shape, and no operation on the lane path
reduces across lanes: the same request returns bit-identical results
whether it shared its batch with zero, three or seven strangers.
"""
# lazy exports (PEP 562): the fleet tier (router, supervisor, smoke
# parents) imports serve submodules without loading the solver stack;
# attribute access resolves on demand
_EXPORTS = {
    "ServeConfig": "raft_tpu_torch.serve.config",
    "Lane": "raft_tpu_torch.serve.batcher",
    "MicroBatcher": "raft_tpu_torch.serve.batcher",
    "SolverCore": "raft_tpu_torch.serve.solver",
    "solve_batch": "raft_tpu_torch.serve.solver",
    "SolveClient": "raft_tpu_torch.serve.client",
    "SolverServer": "raft_tpu_torch.serve.server",
    "Fleet": "raft_tpu_torch.serve.fleet",
    "FleetConfig": "raft_tpu_torch.serve.fleet",
    "FleetRouter": "raft_tpu_torch.serve.router",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
