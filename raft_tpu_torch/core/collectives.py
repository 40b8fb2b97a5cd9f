"""The collectives of the sharded solves, over one dimension of a
``torch.distributed.device_mesh.DeviceMesh`` (or a process group).

An ``axis`` is a process group, or ``(mesh, dim name)`` for the group of
that mesh dimension.  :func:`psum` and :func:`pmax` are ``dist.all_reduce``
with ``SUM`` and ``MAX``; each reduces a copy, so the caller's tensor is
never written.  :func:`psum` carries autograd (its backward is the SUM
all-reduce of the cotangents), so a sharded scan differentiates;
:func:`pmax` carries none (the drivers reduce only their convergence
errors).  :func:`all_gather` gives every rank the whole of a sharded axis.

The solver layers (``hydro.strip``, ``solve.dynamics``) import these; the
world and its mesh are made in ``parallel.multihost``, which re-exports
them.
"""
from __future__ import annotations

import torch


def axis_group(axis):
    """The process group of ``axis``: a group itself, or ``(mesh, dim
    name)``."""
    if isinstance(axis, tuple):
        mesh, dim = axis
        return mesh.get_group(dim)
    return axis


def _reduced(t: torch.Tensor, op, group) -> torch.Tensor:
    """A contiguous copy of ``t`` all-reduced with ``op`` over ``group``."""
    import torch.distributed as dist

    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    """SUM all-reduce whose backward is the SUM all-reduce of the
    cotangents: on every rank, the gradient of the sum of all ranks' losses
    through the reduced value."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        return _reduced(t, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        return _reduced(g, dist.ReduceOp.SUM, ctx.group), None


def psum(t: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``axis``, a new tensor (``t`` is not
    written); differentiable when ``t`` records a gradient."""
    import torch.distributed as dist

    group = axis_group(axis)
    if torch.is_grad_enabled() and t.requires_grad:
        return _PSum.apply(t, group)
    return _reduced(t, dist.ReduceOp.SUM, group)


def pmax(t: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the ranks of ``axis``, a new
    tensor without gradient (``t`` is not written)."""
    import torch.distributed as dist

    return _reduced(t, dist.ReduceOp.MAX, axis_group(axis))


def all_gather(t: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of ``t`` concatenated along ``dim`` in rank order
    of ``axis`` (every rank gets the whole; bool goes as uint8)."""
    import torch.distributed as dist

    group = axis_group(axis)
    src = t.detach()
    is_bool = src.dtype == torch.bool
    if is_bool:
        src = src.to(torch.uint8)
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if is_bool else out
