"""Worlds of processes on a device mesh (port of
``raft_tpu.parallel.multihost``).

The JAX package runs one program per host over a global ``jax.sharding.Mesh``
and lets XLA insert the collectives.  PyTorch's idiom is one process (a
*rank*) per device: every rank runs the same program on its own card, the
ranks join one ``torch.distributed`` world, and a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions lays the
world out (``("freq",)``, ``("designs",)``, ``("designs", "freq")``).  A
collective over one dimension of the mesh runs on that dimension's process
group: the port's ``psum`` and ``pmax`` are ``dist.all_reduce(..., op=SUM |
MAX, group=mesh.get_group(dim))``.

NCCL is the backend on the card and Gloo on the CPU; nothing falls back
from one to the other.  Each rank's card is ``cuda:{LOCAL_RANK}``
(torchrun's variable; the rank modulo the visible cards when it is unset).

* :func:`init_multihost` joins the world (``env://`` from torchrun's
  variables, or ``tcp://`` to an explicit coordinator);
* :func:`global_mesh` lays the world out as a named mesh;
* :func:`stage_global` keeps each rank's own block of host-replicated
  inputs;
* :func:`lane_block` and :func:`block` give each rank its block of an
  axis split over the mesh;
* :func:`psum`, :func:`pmax` and :func:`all_gather`, the collectives of
  the sharded solves, live in :mod:`raft_tpu_torch.core.collectives` (the
  solver layers below this one use them) and are re-exported here.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import numpy as np
import torch

from raft_tpu_torch.core.collectives import all_gather, axis_group, pmax, psum  # noqa: F401
from raft_tpu_torch.core.device import resolve_device

#: seconds a collective or the rendezvous waits for a peer before it fails
TIMEOUT_S = 300.0


def backend_for(device: torch.device) -> str:
    """NCCL for the card, Gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device=None,
                   timeout: float = TIMEOUT_S) -> torch.device:
    """Join this process to the world and return its device.

    Without arguments the rendezvous is ``env://`` (torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``).  With
    ``coordinator_address`` (``host:port`` of rank 0) it is ``tcp://``, and
    ``num_processes`` and ``process_id`` are required.  ``device=None`` (or
    ``"cuda"``) means this rank's card, ``cuda:{LOCAL_RANK}``, and raises
    without CUDA;
    ``device="cpu"`` joins a Gloo world on the CPU.  ``timeout`` (seconds)
    bounds the rendezvous and every collective."""
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "num_processes/process_id were given without a coordinator_address — the "
                "env:// rendezvous would silently ignore them; pass the coordinator's "
                "host:port too")
        init, world, rank = "env://", None, None
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id too")
        init, world, rank = f"tcp://{coordinator_address}", int(num_processes), int(process_id)
    dev = resolve_device(device)                               # raises without CUDA
    if dev.type == "cuda":
        if dev.index is None:                                  # this rank's card
            r = rank if rank is not None else int(os.environ.get("RANK", "0"))
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          r % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    import torch.distributed as dist

    ranks = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend_for(dev), init_method=init,
                            timeout=datetime.timedelta(seconds=float(timeout)), **ranks)
    return dev


def global_mesh(axis_names=("freq",), shape=None):
    """The world as a ``DeviceMesh`` with ``axis_names`` (1-D over every
    rank by default; ``shape`` lays it out, e.g. ``(2, 2)`` for
    ``("designs", "freq")``).  Every rank must call it, in the same order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def is_multiprocess(mesh) -> bool:
    """True when the mesh spans more than one rank (process)."""
    return mesh.size() > 1


def check_mesh(mesh, what: str, dev: torch.device | None = None):
    """Raise unless ``mesh`` is a ``DeviceMesh`` (over ``dev``'s device
    type, when given) with named dimensions."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh must be a torch.distributed.device_mesh.DeviceMesh "
                        f"(make_mesh or global_mesh), got {type(mesh).__name__}")
    if mesh.mesh_dim_names is None:
        raise ValueError(f"{what}: the mesh needs mesh_dim_names")
    if dev is not None and mesh.device_type != torch.device(dev).type:
        raise ValueError(f"{what}: the mesh lies on {mesh.device_type} devices but the solve "
                         f"runs on {dev}")
    return mesh


def block(mesh, dim: str, n: int, what: str, message: str | None = None) -> slice:
    """This rank's block of an axis of length ``n`` split over the mesh
    dimension ``dim``; ``ValueError`` unless ``n`` is divisible by its size
    (``message``, formatted with ``n``, ``size`` and ``dim``, replaces the
    default text after ``what``)."""
    size = mesh.size(mesh.mesh_dim_names.index(dim))
    if n % size != 0:
        text = (message or "{n} not divisible by mesh axis {dim!r} size {size}").format(
            n=n, size=size, dim=dim)
        raise ValueError(f"{what}: {text}")
    c = mesh.get_local_rank(dim)
    step = n // size
    return slice(c * step, (c + 1) * step)


def lane_block(mesh, n: int, what: str, message: str | None = None) -> slice:
    """This rank's block of ``n`` independent lanes (designs, cases,
    turbines) on a data-parallel mesh, which must be 1-D; the divisibility
    check and ``message`` as in :func:`block`."""
    if mesh.ndim != 1:
        raise ValueError(f"{what} expects a 1-D mesh; got shape {tuple(mesh.shape)}")
    return block(mesh, mesh.mesh_dim_names[0], n, what, message)


def stage_global(tree, mesh, specs):
    """Each rank's own block of a host-replicated tree.

    Every rank holds the same values (it built or loaded identical inputs);
    each keeps the block the mesh assigns it.  ``specs`` mirrors ``tree``:
    at each array or tensor leaf a tuple with, per leading axis, the mesh
    dimension name that axis is split over or None (``("freq",)``,
    ``(None, "freq")``, ``()`` replicated); ``None`` leaves of ``tree`` pass
    through and a ``None`` spec keeps its subtree whole.  Tuples, lists and
    dataclasses (``WaveState``, ``MemberSet``,
    ``Cx``) are walked field by field.  Blocks are views."""

    def put(x, spec):
        if x is None or spec is None:              # absent, or replicated whole
            return x
        if isinstance(x, (torch.Tensor, np.ndarray)):
            for ax, dim in enumerate(spec or ()):
                if dim is not None:
                    sl = block(mesh, dim, x.shape[ax], "stage_global")
                    x = x[(slice(None),) * ax + (sl,)]
            return x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: put(getattr(x, f.name), getattr(spec, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, (tuple, list)):
            return type(x)(put(a, s) for a, s in zip(x, spec))
        return x

    return put(tree, specs)
