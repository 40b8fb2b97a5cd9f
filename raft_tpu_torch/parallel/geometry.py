"""Value-only geometry warps for design sweeps (port of
``raft_tpu.parallel.geometry``).

``x' = o + D (x - o)`` with a diagonal ``D`` applied to the substructure
members: positions warp, member frames follow the warp, lengths pick up
the member's own stretch, cross-sections stay.  The scale ``s`` may be a
scalar or a (B,) tensor of per-design scales, which gives a design batch
with a leading axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.core.device import to_device
from raft_tpu_torch.core.transforms import cross
from raft_tpu_torch.core.types import MemberSet

Tensor = torch.Tensor


def _safe_normalize(v: Tensor, fallback_axis: int):
    """Normalize v over the last axis; zero rows (padding) become a fixed
    unit vector with norm 1."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    ok = n2 > 0
    unit = torch.zeros_like(v)
    unit[..., fallback_axis] = 1.0
    v_s = torch.where(ok, v, unit)
    n = torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return v_s / n, torch.where(ok[..., 0], n[..., 0], torch.ones_like(n[..., 0]))


def _warp_frame(q: Tensor, p1: Tensor, D: Tensor):
    """Member frame through the diagonal map D (..., 3): (q', p1', p2', stretch)."""
    qn, f = _safe_normalize(q * D, 2)
    p1D = p1 * D
    p1t = p1D - torch.sum(p1D * qn, dim=-1, keepdim=True) * qn
    p1n, _ = _safe_normalize(p1t, 0)
    p2n = cross(qn, p1n)
    return qn, p1n, p2n, f


_TRAIL = {"seg_rA": 1, "seg_q": 1, "seg_R": 2, "seg_l": 0, "seg_l_fill": 0,
          "node_r": 1, "node_q": 1, "node_p1": 1, "node_p2": 1, "node_dls": 0}


def affine_warp(members: MemberSet, scale3: Tensor, origin: Tensor,
                seg_sel: Tensor, node_sel: Tensor) -> MemberSet:
    """Apply ``x' = o + D (x - o)`` to the selected segments / nodes.

    ``scale3``: (3,) or (B, 3).  A batch of scales on a single design gives
    every field a leading design axis (unwarped fields as broadcast views).
    End caps keep their thickness ``seg_l``.
    """
    dt = members.seg_rA.dtype
    D = scale3.to(dt)[..., None, :]           # broadcast over the S / N axis
    o = origin.to(dt)

    def pos(r):
        return o + D * (r - o)

    p1 = members.seg_R[..., :, 0]
    q_n, p1_n, p2_n, f_seg = _warp_frame(members.seg_q, p1, D)
    stretch = torch.where(members.seg_is_cap, torch.ones_like(f_seg), f_seg)
    qn_n, p1n_n, p2n_n, f_node = _warp_frame(members.node_q, members.node_p1, D)
    new = {
        "seg_rA": pos(members.seg_rA),
        "seg_q": q_n,
        "seg_R": torch.stack([p1_n, p2_n, q_n], dim=-1),
        "seg_l": members.seg_l * stretch,
        "seg_l_fill": members.seg_l_fill * stretch,
        "node_r": pos(members.node_r),
        "node_q": qn_n,
        "node_p1": p1n_n,
        "node_p2": p2n_n,
        "node_dls": members.node_dls * f_node,
    }
    fields = {}
    for name, val in new.items():
        sel = seg_sel if name.startswith("seg_") else node_sel
        fields[name] = torch.where(sel[(...,) + (None,) * _TRAIL[name]], val,
                                   getattr(members, name))
    if scale3.ndim == 2 and members.seg_l.ndim == 1:
        B = scale3.shape[0]
        for f in dataclasses.fields(members):
            v = getattr(members, f.name)
            if f.name not in fields and v is not None:
                fields[f.name] = v.expand(B, *v.shape)
    return dataclasses.replace(members, **fields)


def substructure_masks(members: MemberSet):
    """Host-side (S,) / (N,) masks of the substructure members (type > 1),
    built once on the nominal design."""
    seg_member = members.seg_member.cpu().numpy()
    seg_type = members.seg_type.cpu().numpy()
    seg_mask = members.seg_mask.cpu().numpy()
    n_mem = int(seg_member[seg_mask].max()) + 1
    mem_type = np.zeros(n_mem, dtype=int)
    mem_type[seg_member[seg_mask]] = seg_type[seg_mask]
    seg_sel = (seg_type > 1) & seg_mask
    node_member = np.clip(members.node_member.cpu().numpy(), 0, n_mem - 1)
    node_sel = (mem_type[node_member] > 1) & members.node_mask.cpu().numpy()
    dev = members.seg_rA.device
    return torch.as_tensor(seg_sel, device=dev), torch.as_tensor(node_sel, device=dev)


def make_stretch_draft(members: MemberSet, anchor: float = 0.0):
    """Draft-stretch knob ``fn(members, s)``: scales the substructure's
    vertical extent about z = anchor (default the waterline)."""
    seg_sel, node_sel = substructure_masks(members)

    def fn(m: MemberSet, s) -> MemberSet:
        s = torch.as_tensor(s, dtype=m.seg_rA.dtype, device=m.seg_rA.device)
        one = torch.ones_like(s)
        D = torch.stack([one, one, s], dim=-1)
        o = to_device([0.0, 0.0, anchor], s.dtype, s.device)
        return affine_warp(m, D, o, seg_sel, node_sel)

    return fn


def make_scale_plan(members: MemberSet):
    """Column-radius knob ``fn(members, s)``: scales the substructure's plan
    (x, y) layout about the platform centerline."""
    seg_sel, node_sel = substructure_masks(members)

    def fn(m: MemberSet, s) -> MemberSet:
        s = torch.as_tensor(s, dtype=m.seg_rA.dtype, device=m.seg_rA.device)
        D = torch.stack([s, s, torch.ones_like(s)], dim=-1)
        return affine_warp(m, D, torch.zeros(3, dtype=s.dtype, device=s.device),
                           seg_sel, node_sel)

    return fn
