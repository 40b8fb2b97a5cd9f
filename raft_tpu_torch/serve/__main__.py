"""CLI of the resident solver service (port of ``raft_tpu.serve.__main__``).

``python -m raft_tpu_torch.serve [daemon] [flags]``
    Run the daemon in the foreground: snapshot the ``RAFT_TPU_SERVE_*``
    knobs, optionally pre-warm a design list (stage a lane of each and
    solve one padded batch per bucket, so the kernel libraries are built
    or loaded and the device's first work is done), print ONE ``{"ready":
    true, ...}`` JSON line, then serve until SIGTERM/SIGINT (graceful
    drain: queued requests are answered).  It runs on the card unless
    ``--device`` names another torch device; without CUDA it refuses to
    start (exit 2).

``python -m raft_tpu_torch.serve smoke [--device cpu]``
    The cross-process proof; see :mod:`raft_tpu_torch.serve.smoke`.

``python -m raft_tpu_torch.serve fleet [flags]``
    Run the supervised replica fleet in the foreground: N daemon children
    on the shared kernel build directory behind the failover router, one
    ``{"ready": true, ...}`` JSON line, serve until SIGTERM/SIGINT.  The
    ``RAFT_TPU_FLEET_*`` knobs govern; flags override.

``python -m raft_tpu_torch.serve fleet-smoke [--device cpu]``
    The fleet robustness proof; see :mod:`raft_tpu_torch.serve.fleet_smoke`.

The daemon first enables the cache (:func:`raft_tpu_torch.cache.enable`,
``RAFT_TPU_TORCH_CACHE_DIR`` governs), as the JAX daemon does, so its
staging and its kernels' ledger follow the cache root, and the ready line
reports ``compiles_at_ready`` (the nvcc and g++ builds this process ran,
0 once ``raft_tpu_torch/_build/`` is warm).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time


def _daemon(argv) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(prog="raft_tpu_torch.serve")
    p.add_argument("--socket", default=None,
                   help="AF_UNIX socket path (default: RAFT_TPU_SERVE_SOCKET or the per-uid "
                        "tmp path)")
    p.add_argument("--nw", type=int, default=None, help="frequency bins (default 100)")
    p.add_argument("--n-iter", type=int, default=None,
                   help="fixed-point iterations per solve (default 25)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="override RAFT_TPU_SERVE_BATCH_DEADLINE_MS")
    p.add_argument("--batch-max", type=int, default=None,
                   help="override RAFT_TPU_SERVE_BATCH_MAX")
    p.add_argument("--warm", default=None,
                   help="comma-separated designs to pre-arm (e.g. 'oc3,oc4,volturnus'): a "
                        "padded batch of each bucket is solved before the ready line prints")
    p.add_argument("--no-escalate", action="store_true",
                   help="quarantine bad lanes without ladder salvage")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: the card; 'cpu' runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    from raft_tpu_torch.serve.config import ServeConfig
    from raft_tpu_torch.serve.server import SolverServer
    from raft_tpu_torch import cache
    from raft_tpu_torch.serve.solver import compiles, kernel_launches

    cache.enable()           # warm-start layers; RAFT_TPU_TORCH_CACHE_DIR governs

    # unset flags leave ServeConfig's defaults (the JAX daemon's) in force
    overrides: dict = {"escalate": not args.no_escalate, "device": args.device}
    if args.nw is not None:
        overrides["nw"] = args.nw
    if args.n_iter is not None:
        overrides["n_iter"] = args.n_iter
    if args.deadline_ms is not None:
        overrides["batch_deadline_s"] = max(0.0, args.deadline_ms) / 1e3
    if args.batch_max is not None:
        overrides["batch_max"] = args.batch_max
    cfg = ServeConfig.from_env(**overrides)
    try:
        server = SolverServer(cfg, socket_path=args.socket)
    except RuntimeError as e:          # no CUDA and no --device
        print(f"raft_tpu_torch.serve: {e}", file=sys.stderr)
        return 2

    def _term(_sig, _frm):
        # stop() blocks on the solver drain — never inside a signal frame
        threading.Thread(target=server.stop, name="serve-sigterm", daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    server.start()
    warm = {}
    if args.warm:
        warm = server.warmup([s for s in args.warm.split(",") if s.strip()])
    print(json.dumps({
        "ready": True,
        "socket": server.socket_path,
        "ready_s": round(time.perf_counter() - t0, 3),
        "warm": warm,
        "batch_max": cfg.batch_max,
        "batch_deadline_ms": round(cfg.batch_deadline_s * 1e3, 3),
        "device": str(server.core.device),
        "compiles_at_ready": compiles(),
        "kernel_launches_at_ready": kernel_launches(),
    }), flush=True)
    server.wait()
    print(json.dumps({"exit": True, "stats": server.core.stats(),
                      "queue": server.batcher.counters()}), flush=True)
    return 0


def _fleet(argv) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(prog="raft_tpu_torch.serve fleet")
    p.add_argument("--replicas", type=int, default=None,
                   help="replica count (default: RAFT_TPU_FLEET_REPLICAS)")
    p.add_argument("--socket", default=None,
                   help="front-end AF_UNIX socket path (default: RAFT_TPU_FLEET_SOCKET or the "
                        "per-uid tmp path)")
    p.add_argument("--nw", type=int, default=None, help="frequency bins (default 100)")
    p.add_argument("--n-iter", type=int, default=None,
                   help="fixed-point iterations per solve (default 25)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-replica RAFT_TPU_SERVE_BATCH_DEADLINE_MS")
    p.add_argument("--batch-max", type=int, default=None,
                   help="per-replica RAFT_TPU_SERVE_BATCH_MAX")
    p.add_argument("--warm", default=None,
                   help="comma-separated designs every replica pre-arms")
    p.add_argument("--device", default=None,
                   help="every replica's torch device (default: the card)")
    args = p.parse_args(argv)

    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.serve.fleet import Fleet, FleetConfig

    try:
        resolve_device(args.device)    # refuse before any replica starts
    except RuntimeError as e:
        print(f"raft_tpu_torch.serve fleet: {e}", file=sys.stderr)
        return 2
    overrides: dict = {}
    if args.replicas is not None:
        overrides["replicas"] = args.replicas
    if args.socket is not None:
        overrides["socket_path"] = args.socket
    cfg = FleetConfig.from_env(**overrides)
    serve_args = []
    for flag, val in (("--nw", args.nw), ("--n-iter", args.n_iter),
                      ("--deadline-ms", args.deadline_ms), ("--batch-max", args.batch_max),
                      ("--warm", args.warm), ("--device", args.device)):
        if val is not None:
            serve_args += [flag, str(val)]
    fleet = Fleet(cfg, serve_args=serve_args)

    stopped = threading.Event()

    def _term(_sig, _frm):
        # stop() blocks on child SIGTERM drains — never in a signal frame
        def _run():
            fleet.stop()
            stopped.set()

        threading.Thread(target=_run, name="fleet-sigterm", daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    ready = fleet.start()
    print(json.dumps({
        "ready": True,
        "socket": ready["socket"],
        "replicas": ready["replicas"],
        "ready_s": round(time.perf_counter() - t0, 3),
    }), flush=True)
    stopped.wait()
    print(json.dumps({"exit": True, "telemetry": fleet.telemetry()}), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "smoke":
        from raft_tpu_torch.serve import smoke

        return smoke.main(argv[1:])
    if argv and argv[0] == "fleet-smoke":
        from raft_tpu_torch.serve import fleet_smoke

        return fleet_smoke.main(argv[1:])
    if argv and argv[0] == "fleet":
        return _fleet(argv[1:])
    if argv and argv[0] == "daemon":
        argv = argv[1:]
    return _daemon(argv)


if __name__ == "__main__":
    sys.exit(main())
