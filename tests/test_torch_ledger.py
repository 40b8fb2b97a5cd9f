"""The port's per-kernel performance ledger (``raft_tpu_torch/obs/ledger.py``)
against the JAX package's ``raft_tpu.obs.ledger``, on the CPU.

``_derived`` gives the JAX package's fields and numbers on the same
aggregates under each package's roofline override (and, from the port's
own peak table, a roofline fraction equal to the least time over the best
time); two flushes with a reset between merge on disk (count summed, best
the minimum); a corrupt entry file is skipped; the ledger is a no-op with
the cache off and on CPU tensors.  The kernels' work counts moved from
``chip_smoke.py`` into ``core/cuda6.py`` and ``core/cuda_bem.py`` give the
counts the smoke gave before the move (its code kept here as the
reference).  CUDA events time launches only on the card.
"""
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu.obs import ledger as jledger

from raft_tpu_torch import cache
from raft_tpu_torch.core import cuda6, cuda_bem
from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.obs import ledger


@pytest.fixture
def armed(tmp_path):
    cache.enable(str(tmp_path / "c"))
    ledger.reset()
    ledger._reset_peak_cache()
    yield ledger
    ledger.reset()
    ledger._reset_peak_cache()
    cache.disable()


def _agg(**kw):
    base = {"entry": "solve6_fused", "bucket": "250x200:float32", "topology": ["gpu", "X", "1"],
            "device_kind": "NVIDIA H100 80GB HBM3", "dtype": "float32", "flops": 1.3e8,
            "bytes_accessed": 1.9e7, "count": 5, "total_s": 1.7e-4, "best_s": 3.3e-5}
    return {**base, **kw}


@pytest.mark.parametrize("agg", [
    _agg(),
    _agg(flops=7.0e12, bytes_accessed=1.0e9, best_s=0.25, count=1, total_s=0.25),
    _agg(device_kind="cpu", dtype="float64", best_s=1.0, total_s=3.0, count=3),
])
@pytest.mark.parametrize("override", ["1e12:1e11", "34e12:3.35e12"])
def test_derived_matches_jax_field_for_field(agg, override, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_ROOFLINE", override)
    monkeypatch.setenv(ledger.ROOFLINE_ENV, override)
    ledger._reset_peak_cache()
    jledger._reset_peak_cache()
    try:
        got, want = ledger._derived(dict(agg)), jledger._derived(dict(agg))
    finally:
        ledger._reset_peak_cache()
        jledger._reset_peak_cache()
    assert got == want and got["peak"]["source"] == "env"


def test_roofline_fraction_is_bound_over_best(monkeypatch):
    """From the port's own table: an H100 entry's fraction is the least
    time for its work (the smoke's ``bound_ms``) over its best time."""
    monkeypatch.delenv(ledger.ROOFLINE_ENV, raising=False)
    ledger._reset_peak_cache()
    work = cuda6.work(250, 200, 4)
    agg = _agg(flops=work["flops"], bytes_accessed=work["bytes_accessed"])
    bound, by = ledger.bound_s(work["flops"], work["bytes_accessed"], agg["device_kind"],
                               "float32")
    assert by == "bytes" and bound == pytest.approx(5.74e-6, rel=1e-2)
    assert abs(ledger.fraction(agg) - bound / agg["best_s"]) <= 1e-12
    d = ledger._derived(agg)
    assert d["peak"] == {"flops_per_s": 67e12, "bytes_per_s": 3.35e12, "source": "builtin:h100"}
    assert d["roofline_fraction"] == pytest.approx(bound / agg["best_s"], rel=1e-5)
    f64 = ledger._derived(_agg(dtype="float64"))
    assert f64["peak"]["flops_per_s"] == 34e12
    assert ledger._derived(_agg(device_kind="cpu"))["peak"]["source"] == "builtin:cpu"


def test_two_flushes_merge_and_reset(armed):
    assert armed.record("solve6_fused", "250x200:float32", "NVIDIA H100", "float32",
                        1e8, 2e7, 4e-5)["count"] == 1
    armed.record("solve6_fused", "250x200:float32", "NVIDIA H100", "float32", 1e8, 2e7, 3e-5)
    paths = armed.flush()
    assert len(paths) == 1 and armed.stat()["pending"] == 0
    armed.record("solve6_fused", "250x200:float32", "NVIDIA H100", "float32", 1e8, 2e7, 2e-5)
    armed.reset()                                # dropped before a flush: not persisted
    armed.record("solve6_fused", "250x200:float32", "NVIDIA H100", "float32", 1e8, 2e7, 5e-5)
    assert armed.flush() == paths
    (e,) = armed.entries()
    assert e["count"] == 3 and e["best_s"] == 3e-5 and e["total_s"] == pytest.approx(1.2e-4)
    assert armed.summary()["n_entries"] == 1 and armed.summary()["entries"][0]["count"] == 3
    st = armed.stat()
    assert st["n_entries"] == 1 and st["dir"] == armed.root() and st["pending"] == 0
    armed.record("bem_wave", "n1024xf8:fd:f64", "NVIDIA H100", "float64", 1e10, 2e8, 1e-3)
    assert len(armed.flush()) == 1
    assert [x["entry"] for x in armed.entries()] == ["bem_wave", "solve6_fused"]


def test_corrupt_entry_file_skipped(armed):
    armed.record("solve6_plain", "16384:float64", "NVIDIA H100", "float64", 1e8, 1e7, 1e-5)
    (path,) = armed.flush()
    d = os.path.dirname(path)
    with open(os.path.join(d, "solve6_plain-bad-0000.json"), "w") as f:
        f.write('{"entry": "solve6_pl')
    assert [e["file"] for e in armed.entries()] == [os.path.basename(path)]
    with open(path, "w") as f:                   # a corrupt previous record starts afresh
        f.write("torn")
    armed.record("solve6_plain", "16384:float64", "NVIDIA H100", "float64", 1e8, 1e7, 2e-5)
    armed.flush()
    (e,) = armed.entries()
    assert e["count"] == 1 and e["best_s"] == 2e-5


def test_ledger_off_and_on_cpu_tensors(tmp_path):
    cache.disable()
    ledger.reset()
    assert ledger.root() is None and ledger.flush() == [] and not ledger.armed()
    with ledger.launch("solve6_fused", "b", "float32", torch.device("cuda"),
                       lambda: pytest.fail("work is counted only when armed")):
        pass
    cache.enable(str(tmp_path / "c"))
    try:
        # a CPU tensor takes the plain version: nothing is launched or timed
        Z0 = Cx(torch.eye(6, dtype=torch.float64).expand(2, 3, 6, 6).contiguous(),
                torch.zeros(2, 3, 6, 6, dtype=torch.float64))
        F = Cx(torch.ones(2, 3, 6, dtype=torch.float64), torch.zeros(2, 3, 6, dtype=torch.float64))
        cuda6.solve_rao(Z0, torch.zeros(3, dtype=torch.float64),
                        torch.zeros(2, 6, 6, dtype=torch.float64), F)
        assert ledger.stat()["queued"] == 0 and ledger.pending() == [] and ledger.flush() == []
    finally:
        cache.disable()


# --------------------------------------------- work counts (moved, unchanged)

def _old_k1_flops_per_system() -> int:
    n = 6
    flops = 2 * n * n
    for k in range(n):
        flops += 3 * (n - k) + 3
        flops += (n - 1 - k) * (8 + 8 * (n - k) + 8)
    for k in range(n):
        flops += 8 * (n - 1 - k) + 3 + 8
    return flops


def _old_k1_bound_ms(n_designs, nw, itemsize, dtype_name):
    n = n_designs * nw
    nbytes = itemsize * (n * 36 * 2 + n * 6 * 2 + n * 6 * 2 + nw + n_designs * 36)
    t_bytes = nbytes / 3.35e12
    t_ops = n * _old_k1_flops_per_system() / {"float32": 67e12, "float64": 34e12}[dtype_name]
    return 1e3 * max(t_bytes, t_ops)


@pytest.mark.parametrize("shape", [(250, 200, 4, "float32"), (1000, 200, 8, "float64"),
                                   (16384, 1, 4, "float32")])
def test_cuda6_work_matches_the_smokes_count(shape):
    B, nw, itemsize, dt = shape
    assert cuda6.k1_flops_per_system() == _old_k1_flops_per_system() == 1139
    w = cuda6.work(B, nw, itemsize)
    assert w["flops"] == B * nw * 1139
    bound, _by = ledger.bound_s(w["flops"], w["bytes_accessed"], "NVIDIA H100", dt)
    assert 1e3 * bound == pytest.approx(_old_k1_bound_ms(B, nw, itemsize, dt), rel=1e-15)
    k2 = cuda6.work(B * nw, 1, itemsize, fused=False)
    assert k2 == {"flops": B * nw * (1139 - 72), "bytes_accessed": itemsize * B * nw * 96}


def _old_k3_work(c, diag, panel_mask, lid_surface, itemsize, dtype_name):
    from raft_tpu_torch.hydro import torch_bem

    n = c.shape[0]
    sel_d, sel_i = torch_bem.pair_levels(c, diag, lid_surface)
    count = torch.tensor((0,) + torch_bem.LEVEL_COUNT, device=c.device)
    cd, ci = count[sel_d.long() + 1], count[sel_i.long() + 1]
    near = (sel_d > 1) | (sel_i > 1)
    col = (panel_mask > 0.5)[None, :]
    points = sum(int((((sel_d == lv) | (sel_i == lv)) & col).any(dim=0).sum()) * nq
                 for lv, nq in enumerate(torch_bem.LEVEL_COUNT))
    contribs = int((cd + ci).sum())
    flops = (n * int(col.sum()) * 22 + points * 28 + int(((cd + ci) * col).sum()) * 22)
    nbytes = itemsize * (12 * n + 3 * n + 3 * n + 4 * n + 3 * 766 + 2 * n * n) + n
    t_ops = flops / {"float32": 67e12, "float64": 34e12}[dtype_name]
    t_bytes = nbytes / 3.35e12
    return {"near_pairs": int(near.sum()), "per_pair": contribs / (n * n),
            "mflop": flops / 1e6, "bound_ms": 1e3 * max(t_ops, t_bytes)}


def _old_k4_work(c, area, lid_surface, k, fd, depth, itemsize, dtype_name):
    from raft_tpu_torch.hydro import wavetable

    n, nf = c.shape[0], k.shape[0]
    dx = c[:, None, 0] - c[None, :, 0]
    dy = c[:, None, 1] - c[None, :, 1]
    R = torch.sqrt(dx * dx + dy * dy + 1e-20)
    diag_lid = torch.eye(n, dtype=torch.bool) & lid_surface[None, :]
    R_use = torch.where(diag_lid, 0.4 * torch.sqrt(torch.clamp(area, min=1e-14))[None, :], R)
    zP, zQ = c[:, 2][:, None], c[:, 2][None, :]
    regions = dict.fromkeys(("near", "table", "far", "deep"), 0)

    def split(X, Ys):
        any_near = torch.zeros_like(X, dtype=torch.bool)
        for Y in Ys:
            rho = torch.sqrt(X * X + Y * Y + 1e-18)
            near = rho < 0.6
            far = ~near & (X >= wavetable.XMAX * (1.0 - 1e-7))
            deep = ~near & ~far & (torch.log1p(-Y) >= wavetable.SMAX * (1.0 - 1e-7))
            for key, sel in (("near", near), ("far", far), ("deep", deep),
                             ("table", ~near & ~far & ~deep)):
                regions[key] += int(sel.sum())
            any_near |= near
        return int(any_near.sum())

    flops = 8 * n * n
    for i in range(nf):
        if fd is not None and float(fd["active"][i]) > 0.5:
            k0 = float(fd["k0"][i])
            d4 = (-(zP + zQ), 2 * depth - (zP - zQ), 2 * depth + (zP - zQ), 4 * depth + (zP + zQ))
            near_pairs = split(k0 * R_use, [-k0 * d.expand(n, n) for d in d4])
            flops += (277 + 46 * 52) * n * n
        else:
            kk = float(k[i])
            near_pairs = split(kk * R_use, [kk * (zP + zQ)])
            flops += 90 * n * n
        flops += 20 * n * n + 32 * near_pairs
    reg = {"near": 16 * 105 + 30 + 12, "table": 39, "far": 60, "deep": 11}
    flops += sum(reg[key] * cnt for key, cnt in regions.items())
    return {"regions": regions, "flops": flops}


def _hull(n=48, seed=3):
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                                  rng.uniform(-20, 0, n)], axis=1))
    c[: n // 8, 2] = 0.0                         # lid panels at the waterline
    diag = torch.as_tensor(rng.uniform(0.5, 3.0, n))
    mask = torch.ones(n, dtype=torch.float64)
    mask[-3:] = 0.0                              # padding columns
    lid = torch.zeros(n, dtype=torch.bool)
    lid[: n // 8] = True
    area = torch.as_tensor(rng.uniform(0.2, 4.0, n))
    return c, diag, mask, lid, area


def test_cuda_bem_k3_work_matches_the_smokes_count():
    c, diag, mask, lid, _area = _hull()
    for itemsize, dt in ((8, "float64"), (2, "float32")):
        got = cuda_bem.k3_work(c, diag, mask, lid, itemsize, dt)
        want = _old_k3_work(c, diag, mask, lid, itemsize, dt)
        for key in want:
            assert got[key] == want[key], key
        assert int(cuda_bem.k3_counts(c, diag, mask, lid)["flops"]) == got["flops"]


@pytest.mark.parametrize("finite_depth", [False, True])
def test_cuda_bem_k4_work_matches_the_smokes_count(finite_depth):
    from raft_tpu_torch.hydro import wavetable

    c, _diag, _mask, lid, area = _hull()
    depth = 30.0
    ws = np.array([0.3, 0.4, 1.2, 1.5, 2.5])
    k = torch.as_tensor(ws * ws / 9.81)
    fd = None
    if finite_depth:
        fd_np = wavetable.fd_fit_grid(ws, depth, 9.81)
        assert 0 < fd_np["active"].sum() < len(ws)      # both branches in one chunk
        fd = {key: torch.as_tensor(v) for key, v in fd_np.items()}
    got = cuda_bem.k4_work(c, area, lid, k, fd, depth, 8, "float64")
    want = _old_k4_work(c, area, lid, k, fd, depth, 8, "float64")
    assert got["regions"] == want["regions"] and got["flops"] == want["flops"]
    nbytes = cuda_bem.k4_bytes(c.shape[0], len(ws), 8)
    t = max(want["flops"] / 34e12, nbytes / 3.35e12)
    assert got["bound_ms"] == pytest.approx(1e3 * t, rel=1e-15)
    json.dumps(got)


@pytest.mark.parametrize("block", [1 << 24, 48 * 48])
def test_cuda_bem_k4_counts_host_branches_and_blocks_agree(monkeypatch, block):
    """The counts are the same whether the branches come from the host
    (``fd_active``) or are weighted on the device, and whatever the block
    of frequencies evaluated at once."""
    from raft_tpu_torch.hydro import wavetable

    monkeypatch.setattr(cuda_bem, "K4_COUNT_BLOCK", block)
    c, _diag, _mask, lid, area = _hull()
    depth = 30.0
    ws = np.array([0.3, 0.4, 1.2, 1.5, 2.5, 0.35])
    k = torch.as_tensor(ws * ws / 9.81)
    fd_np = wavetable.fd_fit_grid(ws, depth, 9.81)
    fd = {key: torch.as_tensor(v) for key, v in fd_np.items()}
    want = _old_k4_work(c, area, lid, k, fd, depth, 8, "float64")
    for host in (None, [bool(a > 0.5) for a in fd_np["active"]]):
        got = cuda_bem.k4_counts(c, area, lid, k, fd, depth, host)
        assert int(got["flops"]) == want["flops"]
        assert {key: int(v) for key, v in got["regions"].items()} == want["regions"]
