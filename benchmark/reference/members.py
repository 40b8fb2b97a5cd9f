# A frozen copy of raft_tpu_torch/build/members.py for the benchmark's reference;
# it imports nothing of the program.
"""Design dict -> :class:`~raft_tpu_torch.core.types.MemberSet` (host-side).

The port's own copy of the host accumulation in ``raft_tpu.build.members``
(plain numpy); :func:`build_member_set` then returns tensors on the
requested device.

This replaces the reference's per-object ``Member`` construction
(raft/raft.py:37-201) and heading-replication loop (raft/raft.py:1770-1783)
with a flat, stacked, masked-array build: the entire platform+tower becomes
one set of fixed-shape tensors, which a design batch stacks batch-leading.

Behavioral parity notes (validated against the reference's recipe):
  * Station positions are normalized to [0, l] exactly as raft/raft.py:86.
  * Heading rotation uses the reference's clockwise-convention matrix
    (raft/raft.py:71-77) so replicated member patterns land identically.
  * Strip discretization matches raft/raft.py:147-191: max spacing
    ``dls_max`` (reference hard-codes 10.0 m), node at each strip midpoint,
    a zero-length "end disk" node at end A, and zero-length nodes at flat
    transitions.  The reference has no end-B disk node; we reproduce that by
    default (``include_end_b=False``) for output parity — flip it on for
    flat-topped fully-submerged members where the missing top-face pressure
    term matters.
  * End caps/bulkheads become extra "cap segments" with the hole as inner
    dims, using the same interpolated-diameter rules as raft/raft.py:484-633.

Deviation from the reference (documented in DEVIATIONS.md): the reference
translates each cap's inertia matrix by the *previous submember's* center
instead of the cap's own center (stale variable at raft/raft.py:633); here
the cap's own center is used.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .schema import get_from_dict


@dataclass
class _Accum:
    """Plain-numpy accumulator for segment and node rows."""

    seg: dict = field(default_factory=lambda: {k: [] for k in _SEG_KEYS})
    node: dict = field(default_factory=lambda: {k: [] for k in _NODE_KEYS})


_SEG_KEYS = [
    "rA", "q", "R", "l", "dA", "dB", "diA", "diB",
    "l_fill", "rho_fill", "rho_shell", "circ", "is_cap", "member", "type",
]
_NODE_KEYS = [
    "r", "q", "p1", "p2", "ds", "drs", "dls",
    "Cd_q", "Cd_p1", "Cd_p2", "Cd_end", "Ca_q", "Ca_p1", "Ca_p2", "Ca_end",
    "circ", "member", "potmod",
]


def _orientation(rA, rB, gamma_deg):
    """q/p1/p2 unit vectors + Z1Y2Z3 rotation matrix (cf. raft/raft.py:205-242).

    float64 numpy twin of core.transforms.member_orientation: the host build
    stays double precision whatever dtype the tensors are built in.
    """
    rAB = rB - rA
    l = np.linalg.norm(rAB)
    q = rAB / l
    beta = np.arctan2(q[1], q[0])
    phi = np.arctan2(np.sqrt(q[0] ** 2 + q[1] ** 2), q[2])
    s1, c1 = np.sin(beta), np.cos(beta)
    s2, c2 = np.sin(phi), np.cos(phi)
    g = np.deg2rad(gamma_deg)
    s3, c3 = np.sin(g), np.cos(g)
    R = np.array(
        [
            [c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3, c1 * s2],
            [c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3, s1 * s2],
            [-c3 * s2, s2 * s3, c2],
        ]
    )
    p1 = R @ np.array([1.0, 0.0, 0.0])
    p2 = np.cross(q, p1)
    return q, p1, p2, R


def _as_pairs(d, n, circ):
    """Normalize a diameter spec to (n,2) side-length pairs.

    Follows the reference's semantics: circular members read 'd' as per-station
    diameters (shape=n, raft/raft.py:92); rectangular members read it as
    side-length pairs (shape=[n,2], raft/raft.py:99), where a single 1-D
    ``[len, wid]`` pair broadcasts to every station — so a length-2 list is a
    pair even when n == 2.
    """
    d = np.asarray(d, dtype=float)
    if circ:
        if d.ndim == 0:
            d = np.tile(d, n)
        if d.ndim == 1 and d.shape[0] == n:
            return np.stack([d, d], axis=-1)
        raise ValueError("circular member 'd' must be a scalar or per-station list")
    if d.ndim == 0:
        return np.tile(d, (n, 2))
    if d.ndim == 1 and d.shape[0] == 2:
        return np.tile(d, (n, 1))
    if d.shape == (n, 2):
        return d
    raise ValueError("rectangular member 'd' must be [len,wid] or an (n,2) list of pairs")


def _interp_pairs(x, xs, pairs):
    """Interpolate an (n,2) pair profile at scalar x."""
    return np.array(
        [np.interp(x, xs, pairs[:, 0]), np.interp(x, xs, pairs[:, 1])]
    )


def _cap_hole_pairs(d_in, ncap, circ):
    """Normalize 'cap_d_in' to (ncap,2) hole side-length pairs.

    Mirrors the `_as_pairs` convention: circular members read a 1-D list as
    per-cap hole diameters; rectangular members read a length-2 1-D list as
    one [len, wid] hole pair broadcast to every cap (a pair even when
    ncap == 2), or an (ncap,2) array of per-cap pairs.
    """
    d_in = np.asarray(d_in, dtype=float)
    if d_in.ndim == 0:
        return np.tile(d_in, (ncap, 2))
    if d_in.ndim == 1:
        if not circ and d_in.shape[0] == 2:
            return np.tile(d_in, (ncap, 1))
        if d_in.shape[0] == ncap:
            return np.stack([d_in, d_in], axis=-1)
        if d_in.shape[0] == 1:
            return np.tile(d_in[0], (ncap, 2))
        raise ValueError("'cap_d_in' must be scalar, per-cap, or a rect [len,wid] pair")
    if d_in.shape == (ncap, 2):
        return d_in
    raise ValueError("'cap_d_in' must be scalar, per-cap, or an (ncap,2) pair list")


def add_member(acc: _Accum, mi: dict, member_id: int, dls_max: float = 10.0,
               include_end_b: bool = False) -> None:
    """Parse one member dict (one heading already applied) into the accumulator."""
    mtype = int(mi["type"])
    rA = np.array(mi["rA"], dtype=float)
    rB = np.array(mi["rB"], dtype=float)
    shape_str = str(mi["shape"])
    circ = shape_str[0].lower() == "c"
    if not circ and shape_str[0].lower() != "r":
        raise ValueError("member 'shape' must start with 'c' (circular) or 'r' (rectangular)")

    heading = get_from_dict(mi, "heading", default=0.0)
    if heading != 0.0:
        c, s = np.cos(np.deg2rad(heading)), np.sin(np.deg2rad(heading))
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        rA = rot @ rA
        rB = rot @ rB

    l = np.linalg.norm(rB - rA)
    stations_raw = np.array(mi["stations"], dtype=float)
    n = len(stations_raw)
    if n < 2:
        raise ValueError("at least two 'stations' entries are required")
    stations = (stations_raw - stations_raw[0]) / (stations_raw[-1] - stations_raw[0]) * l

    d = _as_pairs(mi["d"], n, circ)                         # (n,2) outer dims
    t = get_from_dict(mi, "t", shape=n)                     # (n,) wall thickness
    di = np.maximum(d - 2.0 * t[:, None], 0.0)              # (n,2) inner dims

    gamma = get_from_dict(mi, "gamma", default=0.0) if not circ else 0.0
    rho_shell = get_from_dict(mi, "rho_shell", default=8500.0)
    l_fill = get_from_dict(mi, "l_fill", shape=-1, default=0.0)
    rho_fill = get_from_dict(mi, "rho_fill", shape=-1, default=0.0)

    # hydro coefficient profiles (per station; interpolated onto nodes below).
    # 'Cd'/'Ca' apply to both transverse directions; the optional
    # 'Cd_p1'/'Cd_p2'/'Ca_p1'/'Ca_p2' keys override per direction (p1 is the
    # vertical transverse direction of a horizontal member) — needed for flat
    # rectangular pontoons whose vertical added mass far exceeds the lateral.
    Cd_q = get_from_dict(mi, "Cd_q", shape=n, default=0.0)
    Cd_p = get_from_dict(mi, "Cd", shape=n, default=0.6)
    Cd_p1 = get_from_dict(mi, "Cd_p1", shape=n, default=Cd_p)
    Cd_p2 = get_from_dict(mi, "Cd_p2", shape=n, default=Cd_p)
    Cd_end = get_from_dict(mi, "CdEnd", shape=n, default=0.6)
    Ca_q = get_from_dict(mi, "Ca_q", shape=n, default=0.0)
    Ca_p = get_from_dict(mi, "Ca", shape=n, default=0.97)
    Ca_p1 = get_from_dict(mi, "Ca_p1", shape=n, default=Ca_p)
    Ca_p2 = get_from_dict(mi, "Ca_p2", shape=n, default=Ca_p)
    Ca_end = get_from_dict(mi, "CaEnd", shape=n, default=0.6)

    q, p1, p2, R = _orientation(rA, rB, gamma)

    def push_seg(rA_s, l_s, dA, dB, diA, diB, lf, rf, is_cap):
        acc.seg["rA"].append(rA_s)
        acc.seg["q"].append(q)
        acc.seg["R"].append(R)
        acc.seg["l"].append(l_s)
        acc.seg["dA"].append(dA)
        acc.seg["dB"].append(dB)
        acc.seg["diA"].append(diA)
        acc.seg["diB"].append(diB)
        acc.seg["l_fill"].append(lf)
        acc.seg["rho_fill"].append(rf)
        acc.seg["rho_shell"].append(rho_shell)
        acc.seg["circ"].append(circ)
        acc.seg["is_cap"].append(is_cap)
        acc.seg["member"].append(member_id)
        acc.seg["type"].append(mtype)

    # ---- shell segments (station spans), cf. raft/raft.py:346-477 ----
    for i in range(1, n):
        l_s = stations[i] - stations[i - 1]
        if l_s <= 0.0:
            continue
        lf = l_fill if np.isscalar(l_fill) else l_fill[i - 1]
        rf = rho_fill if np.isscalar(rho_fill) else rho_fill[i - 1]
        push_seg(
            rA + q * stations[i - 1], l_s,
            d[i - 1], d[i], di[i - 1], di[i],
            float(lf), float(rf), False,
        )

    # ---- cap/bulkhead segments, cf. raft/raft.py:484-633 ----
    cap_stations_raw = get_from_dict(mi, "cap_stations", shape=-1, default=[])
    cap_stations_raw = np.atleast_1d(np.asarray(cap_stations_raw, dtype=float))
    if cap_stations_raw.size:
        ncap = cap_stations_raw.shape[0]
        cap_t = np.atleast_1d(get_from_dict(mi, "cap_t", shape=ncap))
        cap_d_in = _cap_hole_pairs(
            np.asarray(get_from_dict(mi, "cap_d_in", shape=-1, default=0.0), dtype=float),
            ncap, circ,
        )
        cap_L = (cap_stations_raw - stations_raw[0]) / (stations_raw[-1] - stations_raw[0]) * l

        for ci in range(cap_L.shape[0]):
            L, h = cap_L[ci], cap_t[ci]
            hole = cap_d_in[ci]
            # skip bulkheads within one thickness of either member end — the
            # interior-cap interpolation below would reach past the end.  The
            # reference has the same guard (raft/raft.py:504-508) but its
            # top-end clause is always-false (`L > stations[-1] + h`, should
            # be `- h`); the intended both-ends form is used here (DEVIATIONS.md).
            near_A = stations[0] < L < stations[0] + h and not np.isclose(L, stations[0])
            near_B = stations[-1] - h < L < stations[-1] and not np.isclose(L, stations[-1])
            if near_A or near_B:
                continue
            if np.isclose(L, stations[0]):
                dA_c = di[0]
                dB_c = _interp_pairs(L + h, stations, di)
                diA_c = hole
                diB_c = dB_c * np.divide(diA_c, dA_c, out=np.zeros(2), where=dA_c > 0)
                base = L
            elif np.isclose(L, stations[-1]):
                dA_c = _interp_pairs(L - h, stations, di)
                dB_c = di[-1]
                diB_c = hole
                diA_c = dA_c * np.divide(diB_c, dB_c, out=np.zeros(2), where=dB_c > 0)
                base = L - h
            else:
                dA_c = _interp_pairs(L - h / 2, stations, di)
                dB_c = _interp_pairs(L + h / 2, stations, di)
                dM = _interp_pairs(L, stations, di)
                frac = np.divide(hole, dM, out=np.zeros(2), where=dM > 0)
                diA_c = dA_c * frac
                diB_c = dB_c * frac
                base = L - h / 2
            push_seg(rA + q * base, float(h), dA_c, dB_c, diA_c, diB_c, 0.0, 0.0, True)

    # ---- strip-theory nodes, cf. raft/raft.py:147-191 ----
    ls = [0.0]
    dls = [0.0]
    ds = [0.5 * d[0]]
    drs = [0.5 * d[0]]
    for i in range(1, n):
        lstrip = stations[i] - stations[i - 1]
        if lstrip > 0.0:
            ns = int(np.ceil(lstrip / dls_max))
            dlstrip = lstrip / ns
            m = 0.5 * (d[i] - d[i - 1]) / dlstrip
            for j in range(ns):
                ls.append(stations[i - 1] + dlstrip * (0.5 + j))
                dls.append(dlstrip)
                ds.append(d[i - 1] + dlstrip * m * (0.5 + j))
                drs.append(dlstrip * m)
        else:
            ls.append(stations[i - 1])
            dls.append(0.0)
            ds.append(0.5 * (d[i - 1] + d[i]))
            drs.append(0.5 * (d[i] - d[i - 1]))
    if include_end_b:
        # end-B disk node (not present in the reference; see module docstring)
        ls.append(l)
        dls.append(0.0)
        ds.append(0.5 * d[-1])
        drs.append(-0.5 * d[-1])

    rAB = rB - rA
    for li, dlsi, dsi, drsi in zip(ls, dls, ds, drs):
        acc.node["r"].append(rA + (li / l) * rAB)
        acc.node["q"].append(q)
        acc.node["p1"].append(p1)
        acc.node["p2"].append(p2)
        acc.node["ds"].append(np.asarray(dsi, dtype=float).reshape(-1)[:2]
                              if np.ndim(dsi) else np.array([dsi, dsi]))
        acc.node["drs"].append(np.asarray(drsi, dtype=float).reshape(-1)[:2]
                               if np.ndim(drsi) else np.array([drsi, drsi]))
        acc.node["dls"].append(dlsi)
        acc.node["Cd_q"].append(np.interp(li, stations, Cd_q))
        acc.node["Cd_p1"].append(np.interp(li, stations, Cd_p1))
        acc.node["Cd_p2"].append(np.interp(li, stations, Cd_p2))
        acc.node["Cd_end"].append(np.interp(li, stations, Cd_end))
        acc.node["Ca_q"].append(np.interp(li, stations, Ca_q))
        acc.node["Ca_p1"].append(np.interp(li, stations, Ca_p1))
        acc.node["Ca_p2"].append(np.interp(li, stations, Ca_p2))
        acc.node["Ca_end"].append(np.interp(li, stations, Ca_end))
        acc.node["circ"].append(circ)
        acc.node["member"].append(member_id)
        acc.node["potmod"].append(bool(mi.get("potMod", False)))


def _accumulate(design: dict, dls_max: float = 10.0,
                include_end_b: bool = False) -> _Accum:
    """Heading-replicated platform+tower accumulation (one parse of the
    member list)."""
    acc = _Accum()
    member_id = 0
    for mi in design["platform"]["members"]:
        headings = get_from_dict(mi, "heading", shape=-1, default=0.0)
        for heading in np.atleast_1d(headings):
            mi_h = dict(mi)
            mi_h["heading"] = float(heading)
            add_member(acc, mi_h, member_id, dls_max=dls_max, include_end_b=include_end_b)
            member_id += 1
    if "turbine" in design and "tower" in design["turbine"]:
        add_member(acc, design["turbine"]["tower"], member_id, dls_max=dls_max,
                   include_end_b=include_end_b)
        member_id += 1
    return acc


#: MemberSet fields by kind: (name, accumulator key, trailing shape, numpy
#: type, padding value); "l" is the segment length (padding 1, so divisions
#: stay defined in masked rows)
_SEG_FIELDS = (
    ("seg_rA", "rA", (3,), np.float64, 0), ("seg_q", "q", (3,), np.float64, 0),
    ("seg_R", "R", (3, 3), np.float64, 0), ("seg_l", "l", (), np.float64, 1),
    ("seg_dA", "dA", (2,), np.float64, 0), ("seg_dB", "dB", (2,), np.float64, 0),
    ("seg_diA", "diA", (2,), np.float64, 0), ("seg_diB", "diB", (2,), np.float64, 0),
    ("seg_l_fill", "l_fill", (), np.float64, 0), ("seg_rho_fill", "rho_fill", (), np.float64, 0),
    ("seg_rho_shell", "rho_shell", (), np.float64, 0), ("seg_circ", "circ", (), bool, 0),
    ("seg_is_cap", "is_cap", (), bool, 0), ("seg_member", "member", (), np.int32, -1),
    ("seg_type", "type", (), np.int32, 0),
)
_NODE_FIELDS = (
    ("node_r", "r", (3,), np.float64, 0), ("node_q", "q", (3,), np.float64, 0),
    ("node_p1", "p1", (3,), np.float64, 0), ("node_p2", "p2", (3,), np.float64, 0),
    ("node_ds", "ds", (2,), np.float64, 0), ("node_drs", "drs", (2,), np.float64, 0),
    ("node_dls", "dls", (), np.float64, 0), ("node_Cd_q", "Cd_q", (), np.float64, 0),
    ("node_Cd_p1", "Cd_p1", (), np.float64, 0), ("node_Cd_p2", "Cd_p2", (), np.float64, 0),
    ("node_Cd_end", "Cd_end", (), np.float64, 0), ("node_Ca_q", "Ca_q", (), np.float64, 0),
    ("node_Ca_p1", "Ca_p1", (), np.float64, 0), ("node_Ca_p2", "Ca_p2", (), np.float64, 0),
    ("node_Ca_end", "Ca_end", (), np.float64, 0), ("node_circ", "circ", (), bool, 0),
    ("node_member", "member", (), np.int32, -1), ("node_potmod", "potmod", (), bool, 0),
)


def member_arrays(design: dict, dls_max: float = 10.0, pad_segments: int | None = None,
                  pad_nodes: int | None = None, include_end_b: bool = False,
                  _acc=None) -> dict:
    """The padded :class:`MemberSet` of a design as host numpy arrays, by
    field name (floats float64, ids int32 with padding -1, flags and masks
    bool; padded segments get length 1).  A design batch stacks these on
    the host and copies each field to the card once
    (:func:`member_set_from_arrays`).  ``_acc``: this design's
    :func:`_accumulate` result, when the caller (the bucket layer) has
    already parsed the member list to measure it."""
    acc = (_acc if _acc is not None
           else _accumulate(design, dls_max=dls_max, include_end_b=include_end_b))
    S = len(acc.seg["l"])
    N = len(acc.node["dls"])
    Sp = pad_segments if pad_segments is not None else S
    Np = pad_nodes if pad_nodes is not None else N
    if Sp < S or Np < N:
        raise ValueError(f"padding too small: need >= ({S} segments, {N} nodes)")
    out = {}
    for rows, n, n_pad, fields in ((acc.seg, S, Sp, _SEG_FIELDS), (acc.node, N, Np, _NODE_FIELDS)):
        for name, key, tail, dt, pad in fields:
            a = np.full((n_pad, *tail), pad, dtype=dt)
            a[:n] = np.array(rows[key])
            out[name] = a
    out["seg_mask"] = np.arange(Sp) < S
    out["node_mask"] = np.arange(Np) < N
    return out


def member_set_from_arrays(arrays: dict, device, dtype=torch.float64):
    """Host arrays of :func:`member_arrays` (one design, or a batch stacked
    along a leading axis) -> :class:`MemberSet` on ``device``, floats in
    ``dtype``: one copy per field."""
    from .rtypes import MemberSet

    def put(a):
        t = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return t.to(dtype) if a.dtype == np.float64 else t

    return MemberSet(**{name: put(a) for name, a in arrays.items()})


def build_member_set(design: dict, device, dtype=torch.float64,
                     dls_max: float = 10.0, pad_segments: int | None = None,
                     pad_nodes: int | None = None, include_end_b: bool = False,
                     _acc=None):
    """Build the platform+tower :class:`MemberSet` of a design dict on
    ``device``.

    Same rows, padding and dtypes as ``raft_tpu.build.members.
    build_member_set``: floats in ``dtype``, ids as int32 (padding -1),
    flags and masks as bool; padded segments get length 1.  ``_acc``: see
    :func:`member_arrays`.
    """
    return member_set_from_arrays(
        member_arrays(design, dls_max=dls_max, pad_segments=pad_segments, pad_nodes=pad_nodes,
                      include_end_b=include_end_b, _acc=_acc), device, dtype)


def build_rna(design: dict):
    """Lumped RNA properties of a design (Python floats)."""
    from .rtypes import RNA

    t = design["turbine"]
    yaw = t.get("yaw_stiffness", t.get("yaw stiffness", 0.0))
    return RNA(
        mRNA=float(t["mRNA"]),
        IxRNA=float(t["IxRNA"]),
        IrRNA=float(t["IrRNA"]),
        xCG_RNA=float(t["xCG_RNA"]),
        hHub=float(t["hHub"]),
        Fthrust=float(t.get("Fthrust", 0.0)),
        yaw_stiffness=float(yaw),
    )
