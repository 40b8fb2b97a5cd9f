"""Kernel K3's redesign, checked on the CPU.

The kernel (``raft_tpu_torch/csrc/bem_rankine.cu``) is one cooperative
launch of G blocks.  Block b works through tiles b, b + G, ... of 16
field rows x 32 source columns (the far pass): it decides each pair's
levels with individually rounded operations, computes a pair whose two
levels have at most 9 points a lane each, in the plain version's order,
and appends every other pair to its own near list, coded by the tile's
place in its sequence and the pair's place in the tile.  After a
grid-wide barrier every warp takes near pairs of all the lists in turn
(the near pass): the pair's contributions, the direct level's points
then the image level's, are dealt to the 32 lanes in turn, each lane
sums its own in order, and a shuffle tree (xor 16, 8, 4, 2, 1) adds the
lanes.  Each contribution takes 1/sqrt(r2) and ir^3 = ir ir ir.  A torch
transcription of that arithmetic and of the lists' coding, on the
quadrature staged by ``torch_bem.stage_tables``, is held here against
the plain version and the JAX package's Pallas kernel in interpret mode:
1e-12 scale-relative in f64 (1e-4 in f32, the JAX package's bound
between its assembly routes).  The mesh is the 64-panel test cylinder of
``test_torch_bem_kernels.py`` with its waterplane lid.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.core import pallas_bem
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import mesh as jmesh

from raft_tpu_torch.core import cuda_bem
from raft_tpu_torch.hydro import torch_bem

TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
SOURCE = (Path(cuda_bem.__file__).parent.parent / "csrc" / "bem_rankine.cu").read_text()


def _constant(name: str) -> str:
    m = re.search(rf"\b{name}\b(?:\[\d+\])? = ([^;]+);", SOURCE)
    assert m is not None, name
    return m[1].strip()


ROWS, COLS, WARPS = (int(_constant(name)) for name in ("kRows", "kCols", "kWarps"))
FAR_LEVEL = int(_constant("kFarLevel"))


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cylinder():
    hull = jmesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                             rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)
    lid = jmesh.disk_panels([0.0, 0.0, 0.0], 1.15, da_max=1.3)
    return jax_bem._pad_mesh(hull, lid)


def _args(padded, pm, lm, dtype, n=None):
    """The K3 arguments of the first ``n`` panels (all by default)."""
    P = torch.as_tensor(padded).to(dtype)[:n]
    c, nrm, area, diag = torch_bem.panel_geometry(P)
    lmt = torch.as_tensor(lm).to(dtype)[:n]
    ls = (lmt > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
    spot = torch_bem.self_potential(P, c, nrm)
    return P, c, nrm, area, diag, torch.as_tensor(pm).to(dtype)[:n], ls, spot


def kernel_levels(c, diag, lid_surface):
    """The kernel's level decision per (field i, source j) pair: dx, dy
    shared by the direct and image distance, the image's dz as ciz + cjz,
    each operation rounded on its own, then rel = dist / diag."""
    n = c.shape[0]
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    dz = c[:, None, 2] - c[None, :, 2]
    dzI = c[:, None, 2] + c[None, :, 2]
    xy = dx * dx + dy * dy
    dist = torch.sqrt(xy + dz * dz + 1e-20)
    distI = torch.sqrt(xy + dzI * dzI + 1e-20)
    ok = (diag > 1e-9)[None, :]
    big = torch.full_like(dist, 1e9)
    sel_d = torch_bem.level_select_direct(torch.where(ok, dist / diag[None, :], big))
    sel_i = torch_bem.level_select_image(torch.where(ok, distI / diag[None, :], big))
    eye = torch.eye(n, dtype=torch.bool)
    sel_d = torch.where(eye, torch.full_like(sel_d, -1), sel_d)
    sel_i = torch.where(eye & lid_surface[None, :], torch.full_like(sel_i, -1), sel_i)
    return sel_d, sel_i


def near_lists(sel_d, sel_i, blocks):
    """The far pairs, and each block's near list as the kernel builds it
    with ``blocks`` blocks: tiles b, b + G, ... in turn, per warp and
    field row the near lanes appended by ballot, each coded as
    k << 16 | row | col << 5 | (sel_d + 1) << 10 | (sel_i + 1) << 13 with
    k the tile's place in the block's sequence."""
    n = sel_d.shape[0]
    near = (sel_d > FAR_LEVEL) | (sel_i > FAR_LEVEL)
    tiles_j = -(-n // COLS)
    tiles = tiles_j * -(-n // ROWS)
    lists = [[] for _ in range(blocks)]
    for b in range(blocks):
        for k, tile in enumerate(range(b, tiles, blocks)):
            i0, j0 = (tile // tiles_j) * ROWS, (tile % tiles_j) * COLS
            for kr in range(ROWS // WARPS):
                for warp in range(WARPS):
                    r = warp + WARPS * kr
                    if i0 + r >= n:
                        continue
                    for lane in range(min(COLS, n - j0)):
                        i, j = i0 + r, j0 + lane
                        if near[i, j]:
                            lists[b].append(k << 16 | r | lane << 5
                                            | int(sel_d[i, j] + 1) << 10
                                            | int(sel_i[i, j] + 1) << 13)
    return ~near, lists


def near_pairs(lists, n):
    """The near pass's reading of the lists: near pair e of all lists in
    turn, found by a search of the lists' starts, decoded to
    (i, j, sel_d, sel_i)."""
    blocks = len(lists)
    tiles_j = -(-n // COLS)
    start = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    out = []
    for e in range(int(start[-1])):
        lo = int(np.searchsorted(start, e, side="right")) - 1
        code = lists[lo][e - start[lo]]
        tile = lo + (code >> 16) * blocks
        out.append(((tile // tiles_j) * ROWS + (code & 31),
                    (tile % tiles_j) * COLS + ((code >> 5) & 31),
                    ((code >> 10) & 7) - 1, ((code >> 13) & 7) - 1))
    return out


def _point(quad, pans, q, j):
    """Positions and weights of points q of source panels j (broadcast)."""
    us, vs, wf = quad
    u, v = us[q], vs[q]
    c00, c10, c11, c01 = (1 - u) * (1 - v), u * (1 - v), u * v, (1 - u) * v
    p = pans[j]
    pt = (c00[..., None] * p[..., 0, :] + c10[..., None] * p[..., 1, :]
          + c11[..., None] * p[..., 2, :] + c01[..., None] * p[..., 3, :])
    return pt, wf[q]


def _contrib(ci, ni, pt, dA, live):
    """One point source per entry: (pot, dn) with 1/sqrt and ir^3 = ir ir ir,
    exact zeros where not ``live`` or r2 <= 1e-12."""
    d = ci - pt
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    ok = live & (r2 > 1e-12)
    ir = 1.0 / torch.sqrt(torch.where(ok, r2, torch.ones_like(r2)))
    ir3 = ir * ir * ir
    dsn = d[..., 0] * ni[..., 0] + d[..., 1] * ni[..., 1] + d[..., 2] * ni[..., 2]
    zero = torch.zeros_like(r2)
    return torch.where(ok, dA * ir, zero), torch.where(ok, (-dA * ir3) * dsn, zero)


def _flip(pt, image):
    return torch.stack([pt[..., 0], pt[..., 1], torch.where(image, -pt[..., 2], pt[..., 2])], -1)


def k3_transcription(pans, c, nrm, area, diag, mask, lid_surface, spot, quad, blocks=2):
    """(R_pot, R_dn, times each pair was computed, near mask) as the kernel
    computes them with ``blocks`` blocks."""
    n, dtype = c.shape[0], c.dtype
    sel_d, sel_i = kernel_levels(c, diag, lid_surface)
    far, lists = near_lists(sel_d, sel_i, blocks)
    done = torch.zeros((n, n), dtype=torch.int64)
    pot = torch.zeros((n, n), dtype=dtype)
    dn = torch.zeros_like(pot)

    # far pass: levels ascending, points in order, direct before image
    cols = torch.arange(n)
    for lv in range(FAR_LEVEL + 1):
        q0 = torch_bem.LEVEL_START[lv]
        for q in range(q0, q0 + torch_bem.LEVEL_COUNT[lv]):
            pt, w = _point(quad, pans, torch.tensor(q), cols)
            dA = area * w
            for sel, zsign in ((sel_d, 1.0), (sel_i, -1.0)):
                pz = pt * torch.tensor([1.0, 1.0, zsign], dtype=dtype)
                p, g = _contrib(c[:, None, :], nrm[:, None, :], pz[None, :, :], dA[None, :],
                                far & (sel == lv))
                pot, dn = pot + p, dn + g
    done += far.long()

    # near pass: each pair's contributions dealt to 32 lanes, a shuffle tree
    entries = near_pairs(lists, n)
    if entries:
        ii, jj, sd, si = (torch.tensor(a) for a in zip(*entries))
        count = torch.tensor((0,) + torch_bem.LEVEL_COUNT)
        start = torch.tensor((0,) + torch_bem.LEVEL_START)
        nd, nt = count[sd + 1], count[sd + 1] + count[si + 1]
        trips = (int(nt.max()) + 31) // 32
        k = torch.arange(32 * trips)[None, :]
        image = k >= nd[:, None]
        q = torch.where(image, start[si + 1][:, None] + k - nd[:, None], start[sd + 1][:, None] + k)
        live = k < nt[:, None]
        q = torch.where(live, q, torch.zeros_like(q))
        pt, w = _point(quad, pans, q, jj[:, None])
        p, g = _contrib(c[ii][:, None, :], nrm[ii][:, None, :], _flip(pt, image),
                        area[jj][:, None] * w, live)
        lanes_p = torch.zeros((len(entries), 32), dtype=dtype)
        lanes_g = torch.zeros_like(lanes_p)
        for t in range(trips):
            lanes_p = lanes_p + p[:, 32 * t:32 * (t + 1)]
            lanes_g = lanes_g + g[:, 32 * t:32 * (t + 1)]
        for off in (16, 8, 4, 2, 1):
            lanes_p = lanes_p[:, :off] + lanes_p[:, off:2 * off]
            lanes_g = lanes_g[:, :off] + lanes_g[:, off:2 * off]
        pot[ii, jj], dn[ii, jj] = lanes_p[:, 0], lanes_g[:, 0]
        done.index_put_((ii, jj), torch.ones_like(ii), accumulate=True)

    eye = torch.eye(n, dtype=torch.bool)
    lids = torch.where(lid_surface, torch.ones_like(spot), torch.zeros_like(spot))
    pot = pot + torch.where(eye, (spot * (1.0 + lids))[None, :], torch.zeros_like(pot))
    return pot * mask[None, :], dn * mask[None, :], done, ~far


def _rel(got, ref):
    ref = torch.as_tensor(np.array(ref, dtype=np.float64))
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_transcription_matches_plain_and_jax(cylinder, dtype):
    padded, pm, lm = cylinder
    args = _args(padded, pm, lm, dtype)
    quad = torch_bem.stage_tables({"I0": np.zeros((2, 2)), "I1": np.zeros((2, 2))}, dtype,
                                  "cpu")["quad"]
    R_pot, R_dn, _done, near = k3_transcription(*args, quad)
    assert int(near.sum()) > 0 and int((~near).sum()) > 0
    ref = torch_bem.rankine_plain(*args, quad=quad)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    P = jnp.asarray(padded, jdt)
    c, nrm, area, diag = jax_bem.panel_geometry(P)
    ls = (jnp.asarray(lm, jdt) > 0.5) & (jnp.abs(c[:, 2]) < 1e-6 * jnp.maximum(diag, 1e-9))
    ref_j = pallas_bem.rankine_assembly(P, c, nrm, area, diag, jnp.asarray(pm, jdt), ls,
                                        jax_bem.self_potential(P, c, nrm), interpret=True)
    for got, r, rj in zip((R_pot, R_dn), ref, ref_j):
        assert bool(torch.isfinite(got).all())
        assert _rel(got, r) <= TOL[dtype] and _rel(got, rj) <= TOL[dtype]


@pytest.mark.parametrize("n,blocks", [(None, 1), (None, 3), (42, 2), (37, 1)],
                         ids=["padded-64-1", "padded-64-3", "unpadded-42-2", "ragged-37-1"])
def test_split_covers_every_pair_once(cylinder, n, blocks):
    """Every pair is computed once, by the far or the near pass, whatever
    the number of blocks; the near set is the pairs with a level of 36 or
    more points in pair_levels; the kernel's level decision equals
    pair_levels'; at a count off the tiles the result still equals the
    plain version."""
    padded, pm, lm = cylinder
    args = _args(padded, pm, lm, torch.float64, n)
    quad = torch_bem.stage_quad(torch.float64, "cpu")
    R_pot, R_dn, done, near = k3_transcription(*args, quad, blocks)
    assert bool((done == 1).all())
    sel_d, sel_i = torch_bem.pair_levels(args[1], args[4], args[6])
    kd, ki = kernel_levels(args[1], args[4], args[6])
    assert torch.equal(kd, sel_d) and torch.equal(ki, sel_i)
    count = torch.tensor((0,) + torch_bem.LEVEL_COUNT)
    assert torch.equal(near, (count[sel_d.long() + 1] >= 36) | (count[sel_i.long() + 1] >= 36))
    ref = torch_bem.rankine_plain(*args, quad=quad)
    assert _rel(R_pot, ref[0]) <= TOL[torch.float64] and _rel(R_dn, ref[1]) <= TOL[torch.float64]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_staged_quadrature_equals_quad_points(dtype):
    """``tab["quad"]`` holds quad_points' (u, v, weight) in the working
    type, and rankine_plain gives the same bits with it as without."""
    tab = torch_bem.stage_tables({"I0": np.zeros((2, 2)), "I1": np.zeros((2, 2))}, dtype, "cpu")
    ref = torch_bem.quad_points()
    assert len(tab["quad"]) == 3
    for got, r in zip(tab["quad"], ref[:3]):
        assert got.dtype == dtype and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), r.astype(got.numpy().dtype))


def test_kernel_constants_match_the_port():
    """The level offsets and counts, the point count and the far pass's
    last level compiled into the kernel are the port's."""
    starts = ", ".join(str(q) for q in torch_bem.LEVEL_START)
    counts = ", ".join(str(q) for q in torch_bem.LEVEL_COUNT)
    assert _constant("kLevelStart") == f"{{{starts}}}"
    assert _constant("kLevelCount") == f"{{{counts}}}"
    assert int(_constant("kNQ")) == len(torch_bem.quad_points()[0]) == 766
    assert int(_constant("kNQFar")) == torch_bem.LEVEL_START[FAR_LEVEL + 1]
    assert torch_bem.LEVEL_COUNT[FAR_LEVEL] < 36 <= torch_bem.LEVEL_COUNT[FAR_LEVEL + 1]
    assert ROWS % WARPS == 0 and ROWS <= 32 and COLS == 32 and int(_constant("kMaxBlocks")) >= 1
