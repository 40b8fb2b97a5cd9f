"""Carry parameter state of the JAX package across to the port.

The JAX package's parameter pytrees (``MemberSet``, ``RNA``, ``Env``,
``WaveState``, ``MooringSystem``, ``LinearCoeffs``, ``StripKin``, ``Cx``)
arrive as dicts of numpy arrays, one entry per dataclass field
(``{f.name: np.asarray(getattr(x, f.name))}``); a nested dataclass field
(``MooringSystem.props``, the ``Cx`` fields) is itself such a dict.  No JAX
object crosses: the port imports nothing of the JAX package.

For the panel BEM, :func:`wave_tables`, :func:`padded_mesh` and
:func:`bem_tuple` carry across the JAX package's wave-integral tables, a
padded mesh with its masks, and a raw ``(A, B, F)`` coefficient tuple, so
both packages can be fed identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.types import Env, MemberSet, RNA, WaveState
from raft_tpu_torch.hydro.strip import StripKin
from raft_tpu_torch.mooring.catenary import LineProps
from raft_tpu_torch.mooring.system import MooringSystem
from raft_tpu_torch.solve.dynamics import LinearCoeffs

KINDS = {cls.__name__: cls for cls in (
    MemberSet, RNA, Env, WaveState, MooringSystem, LineProps, LinearCoeffs,
    StripKin, Cx)}

_NESTED = {("MooringSystem", "props"): "LineProps", ("LinearCoeffs", "F"): "Cx",
           ("StripKin", "u"): "Cx", ("StripKin", "ud"): "Cx", ("StripKin", "pDyn"): "Cx"}


def _tensor(value, device, dtype) -> torch.Tensor:
    a = np.asarray(value)
    t = torch.as_tensor(a, device=device)
    return t.to(dtype) if a.dtype.kind == "f" else t


def from_numpy(kind: str, fields: dict, device, dtype=torch.float64):
    """Build the port's ``kind`` dataclass from a dict of numpy arrays on
    ``device``: floating arrays in ``dtype``, ints and bools as they are.
    Fields missing from the dict keep the dataclass default."""
    cls = KINDS[kind]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        value = fields[f.name]
        sub = _NESTED.get((kind, f.name))
        if value is None:
            kw[f.name] = None
        elif sub is not None:
            kw[f.name] = from_numpy(sub, value, device, dtype)
        else:
            kw[f.name] = _tensor(value, device, dtype)
    return cls(**kw)


def to_numpy(obj) -> dict:
    """Inverse of :func:`from_numpy`: a dict of numpy arrays per field."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = None if v is None else np.asarray(v)
    return out


def wave_tables(tab: dict) -> dict:
    """The JAX package's ``wavetable.load_tables()`` dict -> the port's
    ``{"I0", "I1", "meta"}`` f64 numpy tables (what
    :func:`raft_tpu_torch.hydro.wavetable.load_tables` returns)."""
    out = {k: np.array(tab[k], dtype=np.float64) for k in ("I0", "I1")}
    out["meta"] = np.array(tab.get("meta", [out["I0"].shape[0], out["I0"].shape[1], 0, 0]),
                           dtype=np.float64)
    return out


def padded_mesh(padded, panel_mask, lid_mask, device, dtype=torch.float64):
    """A padded panel mesh (n, 4, 3) and its (n,) masks -> tensors on
    ``device`` in ``dtype``."""
    return tuple(_tensor(a, device, dtype) for a in (padded, panel_mask, lid_mask))


def bem_tuple(bem) -> tuple:
    """A raw (A[6, 6, nw], B[6, 6, nw], F[6, nw] or F[nb, 6, nw]) tuple ->
    host numpy in f64 / complex128, the layout ``Model(BEM=...)`` and
    :func:`raft_tpu_torch.parallel.sweep.stage_bem` take."""
    A, B, F = bem
    return (np.asarray(A, dtype=np.float64), np.asarray(B, dtype=np.float64),
            np.asarray(F, dtype=np.complex128))
