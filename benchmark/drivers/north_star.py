"""The north-star sweep: ``sweep_north_star`` over the design's plan-radius x
draft grid on the BEM coefficients of its nominal hull, staged on the card
in set-up (``stage_north_star_bem(mode="jax")``: K3, K4 and the LU).

Each call sweeps every lane of the grid in a seeded order (``lanes=``), so
each chunk holds other lanes.  The reference works the coefficients and
every lane out again in float64: a lane's answer does not depend on its
chunk, so every call of the window is compared against the one reference."""
from __future__ import annotations

import numpy as np

from benchmark.harness.driver import (Check, Driver as Base, edge_detail, exit_fault, iter_edge,
                                     iter_far, reference_precision, step_gap)
from benchmark.harness.spec import ROOT


class Driver(Base):
    def setup(self):
        from raft_tpu_torch.parallel.sweep import stage_north_star_bem

        cfg, p = self.cfg, self.p
        self.dt = self.dtype(p["dtype"])
        self.bem = stage_north_star_bem(
            nw=cfg["nw"], nw_bem=cfg["bem"]["nw_bem"], mode="jax", cache=False,
            dtype=self.dtype(cfg["bem"]["dtype"]), device=self.device)
        for i in range(p["warmup_calls"]):
            self.call(self.next_inputs(i))
        self.outputs.clear()

    def next_inputs(self, i):
        return self.rng.permutation(self.p["n_designs"])

    def call(self, lanes) -> dict:
        from raft_tpu_torch.parallel.sweep import sweep_north_star

        p = self.p
        res = sweep_north_star(n_designs=p["n_designs"], nw=self.cfg["nw"], chunk=p["chunk"],
                               n_iter=p["n_iter"], dtype=self.dt, device=self.device,
                               bem=self.bem, lanes=lanes)
        std, it, conv = (res[k].cpu().numpy() for k in ("std", "n_iter", "converged"))
        self.outputs.append((lanes, std, it, conv))
        return {"units": len(lanes) * self.cfg["nw"], "ok": bool(np.isfinite(std).all())}

    def release(self):
        self.bem = None

    def counters(self) -> dict:
        p = self.p
        return {"iters": np.concatenate([o[2] for o in self.outputs]),
                "k1": {"lanes_per_launch": p["chunk"], "nw": self.cfg["nw"],
                       "dtype": p["dtype"]}}

    def reference(self, sample, control=False):
        std, it, conv, hist, err = north_star_reference(self.torch, self.cfg, self.p,
                                                        self.device, control)
        return [(lanes, std[lanes], it[lanes], conv[lanes], hist[:, lanes], err[:, lanes])
                for lanes, *_ in (self.outputs[i] for i in sample)]

    def compare(self, got, ref):
        lim = self.cell.params["limits"]
        pairs = list(zip(got, ref))
        miss = sum(int((g[3] != r[3]).sum()) for g, r in pairs)
        edges = [iter_edge(g[2], r[2], r[5]) for g, r in pairs]
        self.detail = edge_detail(edges, [exit_fault(r[2], r[3], r[5]) for r in ref])
        return [Check("std_gap", max(step_gap(g[1], g[2], r[4]) for g, r in pairs),
                      lim["std_gap"]),
                Check("iter_far", float(sum(iter_far(g[2], r[2]) for g, r in pairs)),
                      lim["iter_far"]),
                Check("iter_edge", max(e[1] for e in edges), lim["iter_edge"]),
                Check("converged_miss", float(miss), lim["converged_miss"])]


def reference_inputs(cfg, dtype, device):
    from benchmark.reference import pipeline as R

    design = R.load_design(ROOT / cfg["design"])
    return R.design_inputs(design, cfg["nw"], cfg["w_min"], cfg["w_max"], cfg["Hs"], cfg["Tp"],
                           dtype, device)


def reference_bem(torch, cfg, inp, dtype, device, control):
    """The nominal hull's panel coefficients on the sweep's grid, staged in
    ``dtype`` on the spectral-amplitude basis, solved by the reference in
    float64 (or the control's precision)."""
    from benchmark.reference import pipeline as R

    b = cfg["bem"]
    with reference_precision(torch, b["dtype"], control) as bem_dt:
        host, _ = R.bem_coefficients(inp.design, b["nw_bem"], cfg["w_min"], cfg["w_max"],
                                     cfg["nw"], b["dz_max"], b["da_max"], bem_dt, device)
    return R.stage_bem(host, inp.wave, dtype, device)


def north_star_reference(torch, cfg, p, device, control=False, block: int = 250):
    """Every grid lane's std dev, iterations, convergence, and each step's
    std dev and convergence test."""
    from benchmark.reference import pipeline as R

    with reference_precision(torch, p["dtype"], control) as dt:
        inp = reference_inputs(cfg, dt, device)
        bem = reference_bem(torch, cfg, inp, dt, device, control)
        grid = torch.as_tensor(grid_lanes(p["n_designs"], p["grid_range"]), device=device).to(dt)
        warp = R.plan_draft(inp.members)
        std, it, conv, hist, err = [], [], [], [], []
        with torch.no_grad():
            for lo in range(0, grid.shape[0], block):
                out = R.forward(inp, warp(inp.members, grid[lo:lo + block]), bem=bem,
                                n_iter=p["n_iter"], history=True)
                std.append(R.response_std(out.Xi, inp.wave.w).double().cpu().numpy())
                hist.append(R.std_history(out, inp.wave.w).double().cpu().numpy())
                err.append(R.error_history(out).double().cpu().numpy())
                it.append(out.n_iter.cpu().numpy())
                conv.append(out.converged.cpu().numpy())
    return (np.concatenate(std), np.concatenate(it), np.concatenate(conv),
            np.concatenate(hist, axis=1), np.concatenate(err, axis=1))


def grid_lanes(n: int, span) -> np.ndarray:
    """(n, 2) [plan-radius scale, draft scale] on the near-square grid over
    ``span``, plan varying slowest, as the north star lays it out."""
    n_d = int(np.sqrt(n))
    while n % n_d:
        n_d -= 1
    n_p = n // n_d

    def axis(m):
        return np.linspace(span[0], span[1], m) if m > 1 else np.array([1.0])

    dd, pp = np.meshgrid(axis(n_d), axis(n_p))
    return np.stack([pp.ravel(), dd.ravel()], axis=1)
