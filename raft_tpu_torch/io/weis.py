"""WEIS/OpenMDAO adapter (the port's own copy of ``raft_tpu.io.weis``, host
numpy).

Translates the array-style turbine and platform description that a WEIS
optimization loop carries (member joint coordinates, outer diameters, wall
thicknesses, RNA scalars, mooring node and line tables) into the design
dict that :class:`raft_tpu_torch.model.Model` and
:func:`raft_tpu_torch.model.load_design` consume, so the port can serve as
the dynamics inner loop of a co-design study.
"""
from __future__ import annotations

import numpy as np


def member_from_arrays(name: str, joint1, joint2, diameters, thicknesses, stations=None,
                       shape: str = "circ", mtype: int = 2, **kwargs) -> dict:
    """One member dict from WEIS-style arrays.

    ``stations`` defaults to an even grid over the member span;
    ``diameters`` and ``thicknesses`` are scalars or one value per station.
    Further fields (Morison coefficients, ballast, ...) pass through
    ``kwargs``."""
    joint1 = np.asarray(joint1, dtype=float)
    joint2 = np.asarray(joint2, dtype=float)
    d = np.atleast_1d(np.asarray(diameters, dtype=float))
    t = np.atleast_1d(np.asarray(thicknesses, dtype=float))
    if stations is not None:
        n = len(stations)
    else:
        n = max(len(d), len(t), 2)
        stations = np.linspace(0.0, 1.0, n)
    if len(d) == 1:
        d = np.full(n, d[0])
    if len(t) == 1:
        t = np.full(n, t[0])
    if len(d) != n or len(t) != n:
        raise ValueError(f"member {name!r}: d (len {len(d)}) and t (len {len(t)}) must be "
                         f"scalar or match the {n} stations")
    member = {"name": name, "type": mtype, "rA": joint1.tolist(), "rB": joint2.tolist(),
              "shape": shape, "stations": np.asarray(stations, dtype=float).tolist(),
              "d": d.tolist(), "t": t.tolist()}
    member.update(kwargs)
    return member


def mooring_from_arrays(water_depth: float, anchor_xyz, fairlead_xyz, line_lengths,
                        diameter: float, mass_density: float, stiffness: float,
                        line_type: str = "main") -> dict:
    """Mooring dict from node and line tables: one line of ``line_type``
    from each anchor to its fairlead (``line_lengths`` a scalar or one per
    line)."""
    anchor_xyz = np.atleast_2d(np.asarray(anchor_xyz, dtype=float))
    fairlead_xyz = np.atleast_2d(np.asarray(fairlead_xyz, dtype=float))
    nl = len(anchor_xyz)
    if len(fairlead_xyz) != nl:
        raise ValueError(f"{nl} anchors but {len(fairlead_xyz)} fairleads")
    lengths = np.broadcast_to(np.atleast_1d(np.asarray(line_lengths, dtype=float)), (nl,))
    points, lines = [], []
    for i, (a, f, L) in enumerate(zip(anchor_xyz, fairlead_xyz, lengths), 1):
        points.append({"name": f"anchor{i}", "type": "fixed", "location": a.tolist(),
                       "anchor_type": "default"})
        points.append({"name": f"fairlead{i}", "type": "vessel", "location": f.tolist()})
        lines.append({"name": f"line{i}", "endA": f"anchor{i}", "endB": f"fairlead{i}",
                      "type": line_type, "length": float(L)})
    return {
        "water_depth": float(water_depth),
        "points": points,
        "lines": lines,
        "line_types": [{
            "name": line_type, "diameter": float(diameter),
            "mass_density": float(mass_density), "stiffness": float(stiffness),
            "breaking_load": 1e8, "cost": 100.0, "transverse_added_mass": 1.0,
            "tangential_added_mass": 0.0, "transverse_drag": 1.6, "tangential_drag": 0.1,
        }],
        "anchor_types": [{"name": "default", "mass": 1e3, "cost": 1e4,
                          "max_vertical_load": 0.0, "max_lateral_load": 1e5}],
    }


def design_from_weis(platform_members: list, tower: dict, rna: dict, mooring: dict,
                     name: str = "weis design") -> dict:
    """The full design dict of :class:`raft_tpu_torch.model.Model`.

    ``rna`` keys: mRNA, IxRNA, IrRNA, xCG_RNA, hHub, Fthrust, yaw_stiffness
    (scalars)."""
    turbine = dict(rna)
    turbine["tower"] = tower
    return {"type": "input file for RAFT", "name": name, "turbine": turbine,
            "platform": {"members": list(platform_members)}, "mooring": mooring}
