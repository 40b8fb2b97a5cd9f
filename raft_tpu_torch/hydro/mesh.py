"""Axisymmetric panel mesher for potential-flow (BEM) members.

The port's own copy of ``raft_tpu.hydro.mesh`` (host numpy, no torch):
the panel arrays it returns are the on-device BEM's input, and must equal
the JAX package's exactly.

Host-side preprocessing, the capability of the reference's ``member2pnl``
(raft/member2pnl.py:8-509) re-designed around plain (n,4,3) numpy panel
arrays instead of growing Python lists: build each ``potMod`` member's
wetted surface as a revolved station profile (sides + end caps), transform
by member pose, clip at the waterline, and emit HAMS ``.pnl`` / WAMIT
``.gdf`` files or hand the panels straight to the native BEM solver.

Panels are quads with vertices ordered so the normal points INTO the fluid
(outward from the body); triangles are stored as degenerate quads (last
vertex repeated), the convention both HAMS and WAMIT accept.
"""
from __future__ import annotations

import numpy as np

from raft_tpu_torch.obs.trace import span


def _profile(stations: np.ndarray, radii: np.ndarray, dz_max: float):
    """Refine a station profile so no axial span exceeds dz_max."""
    zs, rs = [float(stations[0])], [float(radii[0])]
    for i in range(1, len(stations)):
        dz = stations[i] - stations[i - 1]
        if dz <= 0:
            # radius jump at equal station: keep both points (vertical flange)
            zs.append(float(stations[i]))
            rs.append(float(radii[i]))
            continue
        n = max(1, int(np.ceil(dz / dz_max)))
        for j in range(1, n + 1):
            f = j / n
            zs.append(float(stations[i - 1] + f * dz))
            rs.append(float(radii[i - 1] + f * (radii[i] - radii[i - 1])))
    return np.array(zs), np.array(rs)


def _cap_rings(r_outer: float, da_max: float):
    """Radii for end-cap rings from r_outer down toward the axis."""
    if r_outer <= 0:
        return np.array([0.0])
    n = max(1, int(np.ceil(r_outer / da_max)))
    return np.linspace(r_outer, 0.0, n + 1)


def _naz_levels(radii, da_max: float, naz_min: int = 4, naz_max: int = 512):
    """Adaptive azimuthal sector counts, one per ring radius.

    The capability of the reference mesher's azimuthal doubling/halving
    (raft/member2pnl.py:177-242), designed as a per-member power-of-two
    family: every ring gets the smallest count ``base * 2^k`` satisfying
    the arc-length bound ``2 pi r / naz <= da_max``, with ``base`` chosen
    from {4..7} to minimize the member's total sector count.  Adjacent
    rings then differ by exactly 1:2 (or equal), so bands stitch with
    watertight transition triangles — and large end caps coarsen toward
    the axis instead of inheriting the outer ring's count.
    """
    radii = np.asarray(radii, dtype=float)
    targets = 2.0 * np.pi * np.clip(radii, 0.0, None) / da_max

    def level(base, t):
        n = base
        while n < t and n < naz_max:
            n *= 2
        return n

    best, best_cost = None, None
    for base in (4, 5, 6, 7):
        ns = np.array([level(base, max(t, naz_min)) for t in targets])
        cost = ns.sum()
        if best_cost is None or cost < best_cost:
            best, best_cost = ns, cost
    # clamp jumps to one level between consecutive rings so every band is
    # either conforming (1:1) or a single 1:2 transition
    ns = best.astype(int)
    for i in range(1, len(ns)):
        ns[i] = min(ns[i], ns[i - 1] * 2)
    for i in range(len(ns) - 2, -1, -1):
        ns[i] = min(ns[i], ns[i + 1] * 2)
    return ns


def _band_panels(ring_a, ring_b):
    """Panels between two rings with naz_a, naz_b in {equal, 1:2, 2:1}.

    Vertex order (a_j, a_j+1, b_j+1, b_j) — the same cyclic sense as a
    conforming quad strip — so outward orientation is preserved; 1:2
    transitions emit three triangles per coarse sector (stored as
    degenerate quads), keeping the surface watertight.
    """
    na, nb = len(ring_a) - 1, len(ring_b) - 1
    out = []
    if na == nb:
        a0, a1 = ring_a[:-1], ring_a[1:]
        b0, b1 = ring_b[:-1], ring_b[1:]
        out.append(np.stack([a0, a1, b1, b0], axis=1))
    elif nb == 2 * na:
        for j in range(na):
            aj, aj1 = ring_a[j], ring_a[j + 1]
            f0, f1, f2 = ring_b[2 * j], ring_b[2 * j + 1], ring_b[2 * j + 2]
            out.append(np.stack([
                np.stack([aj, aj1, f1, f1]),
                np.stack([aj, f1, f0, f0]),
                np.stack([aj1, f2, f1, f1]),
            ]))
    elif na == 2 * nb:
        for j in range(nb):
            bj, bj1 = ring_b[j], ring_b[j + 1]
            c0, c1, c2 = ring_a[2 * j], ring_a[2 * j + 1], ring_a[2 * j + 2]
            out.append(np.stack([
                np.stack([c0, c1, bj, bj]),
                np.stack([c1, bj1, bj, bj]),
                np.stack([c1, c2, bj1, bj1]),
            ]))
    else:
        raise ValueError(f"non-stitchable ring counts {na}:{nb}")
    return out


def mesh_member(
    stations,
    diameters,
    rA,
    rB,
    dz_max: float = 3.0,
    da_max: float = 2.0,
    endA: bool = True,
    endB: bool = True,
) -> np.ndarray:
    """Mesh one circular member: returns (np, 4, 3) panel vertex array.

    ``stations`` are along-axis positions (member frame, 0 at end A),
    ``diameters`` the matching outer diameters; ``rA``/``rB`` the global end
    positions.  Sides are revolved bands with adaptive azimuthal counts
    (see :func:`_naz_levels`); flat end caps are ring fans coarsening
    toward the axis (cf. the reference's radial end fill + azimuthal
    refinement, raft/member2pnl.py:149-242).
    """
    stations = np.asarray(stations, dtype=float)
    diameters = np.asarray(diameters, dtype=float)
    rA = np.asarray(rA, dtype=float)
    rB = np.asarray(rB, dtype=float)

    zs, rs = _profile(stations, 0.5 * diameters, dz_max)

    # assemble the full ring sequence: cap A (axis -> rim), sides, cap B
    # (rim -> axis), so adaptive counts are consistent across the seams
    ring_r, ring_z = [], []
    if endA and rs[0] > 0:
        rrA = _cap_rings(rs[0], da_max)[::-1]          # axis ... rim
        ring_r.extend(rrA[:-1])
        ring_z.extend([zs[0]] * (len(rrA) - 1))
    ring_r.extend(rs)
    ring_z.extend(zs)
    if endB and rs[-1] > 0:
        rrB = _cap_rings(rs[-1], da_max)
        ring_r.extend(rrB[1:])
        ring_z.extend([zs[-1]] * (len(rrB) - 1))
    ring_r = np.array(ring_r)
    ring_z = np.array(ring_z)
    naz = _naz_levels(ring_r, da_max)

    def ring(i):
        n = naz[i]
        th = np.linspace(0.0, 2.0 * np.pi, n + 1)
        return np.stack(
            [ring_r[i] * np.cos(th), ring_r[i] * np.sin(th),
             np.full(n + 1, ring_z[i])], axis=-1,
        )

    # orientation falls out of the ring ordering: lower-z ring (or the
    # inner ring of a same-z annulus pair ordered inner->outer) in the
    # first slot gives outward normals for sides, caps, and flange
    # shoulders alike (cross-diagonal rule on [a_j, a_j+1, b_j+1, b_j])
    panels = []
    for i in range(len(ring_r) - 1):
        same_z = abs(ring_z[i + 1] - ring_z[i]) < 1e-12
        if same_z and ring_r[i + 1] == ring_r[i]:
            continue
        panels.extend(_band_panels(ring(i), ring(i + 1)))

    pans = np.concatenate(panels, axis=0)

    # pose: local +z axis -> member axis q
    axis = rB - rA
    L = np.linalg.norm(axis)
    q = axis / L
    # scale local z from profile coordinate (already along-axis length)
    z_hat = np.array([0.0, 0.0, 1.0])
    v = np.cross(z_hat, q)
    c = float(np.dot(z_hat, q))
    if np.linalg.norm(v) < 1e-12:
        R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx * ((1 - c) / (np.linalg.norm(v) ** 2))
    pans = pans @ R.T + rA

    return clip_waterline(pans)


def clip_waterline(panels: np.ndarray, z_surface: float = 0.0) -> np.ndarray:
    """Drop panels fully above the surface; clamp crossing vertices to z=0
    (the reference's makePanel clip, raft/member2pnl.py:8-35).  Panels left
    with zero area (all vertices clamped) are removed."""
    z = panels[..., 2]
    keep = (z < z_surface - 1e-9).any(axis=1)
    pans = panels[keep].copy()
    pans[..., 2] = np.minimum(pans[..., 2], z_surface)
    area = panel_areas(pans)
    return pans[area > 1e-10]


def panel_centroids(panels: np.ndarray) -> np.ndarray:
    return panels.mean(axis=1)


def panel_normals_areas(panels: np.ndarray):
    """Normals (unit) and areas of quad panels via the cross-diagonal rule."""
    d1 = panels[:, 2] - panels[:, 0]
    d2 = panels[:, 3] - panels[:, 1]
    n = 0.5 * np.cross(d1, d2)
    area = np.linalg.norm(n, axis=-1)
    unit = n / np.where(area > 1e-12, area, 1.0)[:, None]
    return unit, area


def panel_areas(panels: np.ndarray) -> np.ndarray:
    return panel_normals_areas(panels)[1]


def mesh_volume(panels: np.ndarray) -> float:
    """Enclosed volume by the divergence theorem, outward normals (the
    z=0 waterplane lid contributes zero): V = sum(z * n_z * dA)."""
    n, a = panel_normals_areas(panels)
    zc = panel_centroids(panels)[:, 2]
    return float((zc * n[:, 2] * a).sum())



def _iter_potmod_members(design: dict):
    """Yield (stations, diameters, rA, rB) for every heading-replicated
    potMod circular member — the shared selection/pose logic of
    :func:`mesh_design` and :func:`mesh_lid`."""
    from raft_tpu_torch.io.schema import get_from_dict

    for mi in design["platform"]["members"]:
        if not mi.get("potMod", False):
            continue
        if str(mi["shape"])[0].lower() != "c":
            continue                      # rect members stay on the Morison path
        stations = np.asarray(mi["stations"], dtype=float)
        stations = stations - stations[0]
        d = np.asarray(mi["d"], dtype=float)
        if d.ndim == 0:
            d = np.full(len(stations), float(d))
        headings = np.atleast_1d(get_from_dict(mi, "heading", shape=-1, default=0.0))
        for h in headings:
            rA = np.asarray(mi["rA"], dtype=float)
            rB = np.asarray(mi["rB"], dtype=float)
            if h != 0.0:
                c, s = np.cos(np.deg2rad(h)), np.sin(np.deg2rad(h))
                rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
                rA, rB = rot @ rA, rot @ rB
            yield stations, d, rA, rB


def disk_panels(center, r_outer: float, da_max: float = 2.0, z: float = 0.0):
    """Horizontal disk fan at height ``z`` (adaptive ring counts) — used for
    interior waterplane lids in irregular-frequency removal."""
    rr = _cap_rings(r_outer, da_max)[::-1]             # axis -> rim
    naz = _naz_levels(rr, da_max)
    cx, cy = float(center[0]), float(center[1])

    def ring(i):
        n = naz[i]
        th = np.linspace(0.0, 2.0 * np.pi, n + 1)
        return np.stack(
            [cx + rr[i] * np.cos(th), cy + rr[i] * np.sin(th),
             np.full(n + 1, z)], axis=-1,
        )

    panels = []
    for i in range(len(rr) - 1):
        if rr[i + 1] == rr[i]:
            continue
        panels.extend(_band_panels(ring(i), ring(i + 1)))
    return np.concatenate(panels, axis=0)


def mesh_lid(design: dict, da_max: float = 2.0) -> np.ndarray:
    """Interior waterplane lid for every surface-piercing potMod circular
    member: the extended-boundary-integral surface that removes irregular
    frequencies from the native BEM solve (the reference's HAMS `irr`
    option, hams/pyhams.py:200,284).  Returns (n,4,3) panels at z=0."""
    lids = []
    for stations, d, rA, rB in _iter_potmod_members(design):
        if not (min(rA[2], rB[2]) < 0.0 <= max(rA[2], rB[2])):
            continue                                 # not surface-piercing
        t = (0.0 - rA[2]) / (rB[2] - rA[2])
        L = np.linalg.norm(rB - rA)
        r_wl = float(np.interp(t * L, stations, 0.5 * d))
        if r_wl <= 0:
            continue
        center = rA + t * (rB - rA)
        lids.append(disk_panels(center, r_wl, da_max=da_max))
    if not lids:
        return np.zeros((0, 4, 3))
    return np.concatenate(lids, axis=0)


class _MemberSolid:
    """Implicit solid of one circular member for interior-panel tests."""

    def __init__(self, stations, radii, rA, rB):
        self.rA = np.asarray(rA, dtype=float)
        axis = np.asarray(rB, dtype=float) - self.rA
        self.L = float(np.linalg.norm(axis))
        self.q = axis / self.L
        self.ts = np.asarray(stations, dtype=float)
        self.rs = np.asarray(radii, dtype=float)

    def contains(self, pts: np.ndarray, tol: float = 1e-3) -> np.ndarray:
        """True for points inside or on the member surface (within tol)."""
        rel = pts - self.rA
        t = rel @ self.q
        radial = np.linalg.norm(rel - t[:, None] * self.q[None, :], axis=-1)
        r_at = np.interp(t, self.ts, self.rs)
        return (t >= -tol) & (t <= self.L + tol) & (radial <= r_at + tol)


def trim_interior_panels(panel_groups, solids, tol: float = 1e-3) -> np.ndarray:
    """Drop panels lying inside (or on) ANOTHER member's solid.

    Members meshed independently overlap where they join (e.g. an upper
    column seated flush on a base column leaves two coincident interior
    disks at the interface).  Such interior surfaces are not wetted hull;
    left in, they pollute the radiation solve.  The reference mesher has no
    equivalent (it meshes members independently and never trims,
    raft/member2pnl.py:73-275) — interior trimming is required the moment
    the BEM actually runs, which the reference never does.
    """
    kept = []
    for gi, pans in enumerate(panel_groups):
        if len(pans) == 0:
            continue
        cent = panel_centroids(pans)
        interior = np.zeros(len(pans), dtype=bool)
        for si, solid in enumerate(solids):
            if si == gi:
                continue
            interior |= solid.contains(cent, tol=tol)
        kept.append(pans[~interior])
    if not kept:
        return np.zeros((0, 4, 3))
    return np.concatenate(kept, axis=0)


def mesh_design(design: dict, dz_max: float = 3.0, da_max: float = 2.0,
                trim: bool = True) -> np.ndarray:
    """Mesh every ``potMod`` circular member of a design dict
    (cf. FOWT.calcBEM, raft/raft.py:2016-2047).  Heading replication matches
    the member builder; panels interior to adjoining members are trimmed.
    Timed in the span ``mesh``."""
    with span("mesh"):
        groups, solids = [], []
        for stations, d, rA, rB in _iter_potmod_members(design):
            groups.append(
                mesh_member(stations, d, rA, rB, dz_max=dz_max, da_max=da_max)
            )
            solids.append(_MemberSolid(stations, 0.5 * d, rA, rB))
        if not groups:
            return np.zeros((0, 4, 3))
        if trim:
            return trim_interior_panels(groups, solids)
        return np.concatenate(groups, axis=0)


# ------------------------------------------------------------- file output


def write_pnl(path: str, panels: np.ndarray, x_sym: int = 0, y_sym: int = 0):
    """HAMS hull-mesh file (cf. writeMesh, raft/member2pnl.py:279-305)."""
    verts = panels.reshape(-1, 3)
    # deduplicate vertices
    uniq, inv = np.unique(np.round(verts, 6), axis=0, return_inverse=True)
    conn = inv.reshape(-1, 4)
    with open(path, "w") as f:
        f.write("    --------------Hull Mesh File---------------\n\n")
        f.write("    # Number of Panels, Nodes, X-Symmetry and Y-Symmetry\n")
        f.write(f"    {len(conn):>8}    {len(uniq):>8}    {x_sym:>8}    {y_sym:>8}\n\n")
        f.write("    # Start Definition of Node Coordinates     ! node_number   x   y   z\n")
        for i, v in enumerate(uniq, 1):
            f.write(f"    {i:<8}{v[0]:>14.6f}{v[1]:>18.6f}{v[2]:>18.6f}\n")
        f.write("    # Start Definition of Node Relations   ! panel_number  number_of_vertices   Vertex1_ID   Vertex2_ID   Vertex3_ID   (Vertex4_ID)\n")
        for i, c in enumerate(conn, 1):
            ids = [int(x) + 1 for x in c]
            # drop any duplicated consecutive vertex (axis fans degenerate on
            # the first edge for cap A, the last for cap B)
            uniq_ids = [v for j, v in enumerate(ids) if v != ids[j - 1]]
            if len(uniq_ids) == 3:
                f.write(
                    f"    {i:<8}3    {uniq_ids[0]:>8}{uniq_ids[1]:>8}{uniq_ids[2]:>8}\n"
                )
            else:
                f.write(f"    {i:<8}4    {ids[0]:>8}{ids[1]:>8}{ids[2]:>8}{ids[3]:>8}\n")
        f.write("    --------------End Hull Mesh File---------------\n")


def write_gdf(path: str, panels: np.ndarray, ulen: float = 1.0, g: float = 9.80665):
    """WAMIT low-order .gdf file (cf. writeMeshToGDF, raft/member2pnl.py:496-509)."""
    with open(path, "w") as f:
        f.write("gdf mesh written by raft_tpu\n")
        f.write(f"{ulen:>10.4f}{g:>10.5f}\n")
        f.write("0  0\n")
        f.write(f"{len(panels)}\n")
        for p in panels:
            for v in p:
                f.write(f"{v[0]:>14.6f}{v[1]:>14.6f}{v[2]:>14.6f}\n")


def read_pnl(path: str) -> np.ndarray:
    """Read a HAMS .pnl mesh back into an (np,4,3) panel array."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    counts = None
    i = 0
    for i, ln in enumerate(lines):
        if ln.startswith("#") and "Number of Panels" in ln:
            counts = [int(x) for x in lines[i + 1].split()]
            break
    if counts is None:
        raise ValueError(f"{path}: no panel-count header found")
    n_pan, n_node = counts[0], counts[1]
    nodes = np.zeros((n_node, 3))
    j = i + 2
    seen = 0
    while seen < n_node:
        parts = lines[j].split()
        j += 1
        if len(parts) == 4 and not lines[j - 1].startswith("#"):
            nodes[int(parts[0]) - 1] = [float(parts[1]), float(parts[2]), float(parts[3])]
            seen += 1
    panels = np.zeros((n_pan, 4, 3))
    seen = 0
    while seen < n_pan:
        parts = lines[j].split()
        j += 1
        if not parts or lines[j - 1].startswith("#") or lines[j - 1].startswith("-"):
            continue
        nv = int(parts[1])
        ids = [int(x) - 1 for x in parts[2 : 2 + nv]]
        if nv == 3:
            ids.append(ids[2])
        panels[int(parts[0]) - 1] = nodes[ids]
        seen += 1
    return panels
