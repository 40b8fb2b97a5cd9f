"""Worlds of ranks on one host: the single construction point for the
port's multi-process runs (counterpart of
``raft_tpu.parallel.spmd.forced_cpu_mesh``).

The JAX package fakes N devices inside one process with XLA flags and
gives the SPMD consumers one mesh over them.  PyTorch has one process per
device, so the counterpart spawns the processes: :func:`cpu_world` starts
``n`` ranks, joins them in a Gloo world on a free loopback port, lays the
world out as a ``DeviceMesh`` and runs ``fn(rank, mesh, *args)`` in each;
:func:`world` does the same on the host's cards (NCCL, one card a rank).
Every rank's result comes back to the caller.  A world has one deadline:
when a rank fails, dies or the deadline passes, every rank is killed and
the caller gets the error, so a hung collective fails one call instead of
hanging the caller.

The XLA-flag machinery of the JAX module (``MeshShortfall``,
``with_host_device_flag``, ``config_cpu_devices``, ``cpu_device_plan``,
``force_cpu_devices``) has no counterpart: a rank is a process, and no
flag makes a process hold more devices.
"""
from __future__ import annotations

import multiprocessing
import pickle
import queue
import time
import traceback

#: default seconds a world may take, start-up included
WORLD_TIMEOUT_S = 180.0


def _rank_main(rank, n, port, device, axis_names, shape, timeout, fn, args, results):
    """One rank: join the world, build the mesh, run ``fn``, send back its
    pickled result (or the traceback)."""
    try:
        import torch
        import torch.distributed as dist

        from raft_tpu_torch.parallel.multihost import global_mesh, init_multihost

        if device == "cpu":
            torch.set_num_threads(1)        # n ranks share the host's cores
        init_multihost(f"127.0.0.1:{port}", n, rank, device=None if device == "cuda" else device,
                       timeout=timeout)
        try:
            out = fn(rank, global_mesh(axis_names, shape), *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, pickle.dumps(out)))
    except BaseException:                   # reported to the parent, which kills the world
        results.put(("error", rank, traceback.format_exc()))


def cpu_world(n: int, fn, *args, axis_names=("world",), shape=None,
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """Run ``fn(rank, mesh, *args)`` on ``n`` Gloo ranks of a fresh CPU
    world and return the ranks' results in rank order.

    ``fn`` and ``args`` are pickled into spawned processes (``fn`` by its
    import path: a module-level function); results come back pickled, so
    return numpy arrays or tensors, not views into shared state.  The
    ranks inherit this process's environment.  The mesh is
    ``global_mesh(axis_names, shape)`` (1-D over the ranks by default);
    ``fn`` may build others (every rank in the same order).  Each rank
    runs one intra-op thread.  ``timeout`` (seconds) bounds the whole
    world; on a rank's failure or death, or at the deadline, every rank is
    killed and ``RuntimeError`` (``TimeoutError`` at the deadline) names
    the rank and carries its traceback."""
    return world(n, fn, *args, device="cpu", axis_names=axis_names, shape=shape,
                 timeout=timeout)


def world(n: int, fn, *args, device: str = "cuda", axis_names=("world",), shape=None,
          timeout: float = WORLD_TIMEOUT_S) -> list:
    """:func:`cpu_world` on ``device``: ``"cuda"`` gives each rank its own
    card (rank ``r`` on ``cuda:r``) in an NCCL world, ``"cpu"`` is
    :func:`cpu_world`."""
    from raft_tpu_torch.parallel.multihost import free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, device, tuple(axis_names), shape, timeout, fn,
                               args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: dict = {}
    try:
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world: {n - len(got)} of {n} ranks still running after "
                                   f"{timeout:.0f} s; the world was killed")
            try:
                kind, rank, body = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"world: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without a result") from None
                continue
            if kind == "error":
                raise RuntimeError(f"world: rank {rank} of {n} failed:\n{body}")
            got[rank] = pickle.loads(body)
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(n)]
