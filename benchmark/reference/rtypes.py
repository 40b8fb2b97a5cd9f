# A frozen copy of raft_tpu_torch/core/types.py for the benchmark's reference;
# it imports nothing of the program.
"""Container types of the port (counterparts of ``raft_tpu.core.types``).

Plain ``dataclasses`` of tensors; ``dataclasses.replace`` takes the place
of ``flax.struct``'s ``.replace``.  A design batch is the same dataclass
with a leading batch axis on every per-design tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


def per_lane(x, n: int):
    """``x`` with ``n`` trailing unit axes when it is a tensor with a lane
    axis (a (B,) field of a design batch's Env or RNA), else unchanged: so a
    per-lane scalar broadcasts against per-lane arrays with ``n`` more
    axes."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x.reshape(x.shape + (1,) * n)
    return x


@dataclasses.dataclass
class Env:
    """Environmental conditions (sea state + wind + constants).

    Fields are Python floats or 0-d tensors; either broadcasts like the
    JAX package's weakly-typed scalars.  In a design batch
    (``model.stage_designs``) every field is a (B,) tensor, one entry per
    lane."""

    rho: float = 1025.0
    g: float = 9.81
    Hs: float = 1.0
    Tp: float = 10.0
    V: float = 10.0
    beta: float = 0.0
    depth: float = 300.0
    current: float = 0.0
    current_heading: float = 0.0
    current_exp: float = 0.0


@dataclasses.dataclass
class MemberSet:
    """All platform + tower members of one design as flat stacked tensors.

    Same fields, shapes and meaning as ``raft_tpu.core.types.MemberSet``:
    axis S is one entry per segment (inertia + hydrostatics), axis N one
    entry per strip-theory node (Morison added mass, excitation, drag).
    """

    seg_rA: Tensor
    seg_q: Tensor
    seg_R: Tensor
    seg_l: Tensor
    seg_dA: Tensor
    seg_dB: Tensor
    seg_diA: Tensor
    seg_diB: Tensor
    seg_l_fill: Tensor
    seg_rho_fill: Tensor
    seg_rho_shell: Tensor
    seg_circ: Tensor
    seg_is_cap: Tensor
    seg_member: Tensor
    seg_type: Tensor
    seg_mask: Tensor
    node_r: Tensor
    node_q: Tensor
    node_p1: Tensor
    node_p2: Tensor
    node_ds: Tensor
    node_drs: Tensor
    node_dls: Tensor
    node_Cd_q: Tensor
    node_Cd_p1: Tensor
    node_Cd_p2: Tensor
    node_Cd_end: Tensor
    node_Ca_q: Tensor
    node_Ca_p1: Tensor
    node_Ca_p2: Tensor
    node_Ca_end: Tensor
    node_circ: Tensor
    node_member: Tensor
    node_mask: Tensor
    node_potmod: Optional[Tensor] = None


@dataclasses.dataclass
class RNA:
    """Lumped rotor-nacelle-assembly properties (floats or 0-d tensors; (B,)
    tensors in a design batch)."""

    mRNA: float = 0.0
    IxRNA: float = 0.0
    IrRNA: float = 0.0
    xCG_RNA: float = 0.0
    hHub: float = 100.0
    Fthrust: float = 0.0
    yaw_stiffness: float = 0.0


@dataclasses.dataclass
class RigidBodyCoeffs:
    """6-DOF rigid-body coefficient set about the PRP (statics output)."""

    M_struc: Tensor
    C_struc: Tensor
    W_struc: Tensor
    C_hydro: Tensor
    W_hydro: Tensor
    mass: Tensor
    rCG: Tensor
    V: Tensor
    rCB: Tensor
    AWP: Tensor
    IWPx: Tensor
    IWPy: Tensor
    zMeta: Tensor
    m_tower: Tensor
    rCG_tower: Tensor
    m_sub: Tensor
    rCG_sub: Tensor
    m_shell: Tensor
    m_ballast: Tensor
    I44: Tensor
    I55: Tensor
    I66: Tensor
    I44B: Tensor
    I55B: Tensor


@dataclasses.dataclass
class WaveState:
    """Discretized sea state on the frequency grid.

    ``beta``: optional heading overriding ``Env.beta``; ``freq_mask``:
    optional (nw,) bool, False at bucket-padded bins (zero seed there).  In
    a design batch ``k``, ``zeta`` and ``freq_mask`` are (B, nw) over the
    one shared (nw,) grid ``w``: each lane has its own water depth."""

    w: Tensor
    k: Tensor
    zeta: Tensor
    beta: Optional[Tensor] = None
    freq_mask: Optional[Tensor] = None

