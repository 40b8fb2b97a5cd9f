"""A wide variant sweep: ``sweep`` of one staged design over seeded
``scale_diameters`` variants, the scan driver at a fixed number of steps,
the std dev reduced on the card (``return_xi=False``).

Each call draws fresh scales; the reference solves a seeded sample of the
window's calls again in float64."""
from __future__ import annotations

import numpy as np

from benchmark.harness.driver import (Check, Driver as Base, edge_detail, exit_fault, iter_edge,
                                     iter_far, reference_precision, step_gap)
from benchmark.harness.spec import ROOT


class Driver(Base):
    def setup(self):
        from raft_tpu_torch.model import stage_design_base

        cfg, p = self.cfg, self.p
        self.dt = self.dtype(p["dtype"])
        _d, *self.staged = stage_design_base(
            str(ROOT / cfg["design"]), nw=cfg["nw"], Hs=cfg["Hs"], Tp=cfg["Tp"],
            w_min=cfg["w_min"], w_max=cfg["w_max"], dtype=self.dt, device=self.device)
        for i in range(p["warmup_calls"]):
            self.call(self.next_inputs(i))
        self.outputs.clear()

    def next_inputs(self, i):
        lo, hi = self.p["scale_range"]
        return self.rng.uniform(lo, hi, self.p["n_variants"])

    def call(self, thetas) -> dict:
        from raft_tpu_torch.parallel.sweep import sweep

        res = sweep(*self.staged, thetas, n_iter=self.p["n_iter"], return_xi=False,
                    dtype=self.dt, device=self.device)
        std, it = res["std dev"], res["iterations"]
        self.outputs.append((thetas, std, it))
        return {"units": len(thetas) * self.cfg["nw"], "ok": bool(np.isfinite(std).all())}

    def release(self):
        self.staged = None

    def counters(self) -> dict:
        return {"iters": np.concatenate([o[2] for o in self.outputs]),
                "k1": {"lanes_per_launch": self.p["n_variants"], "nw": self.cfg["nw"],
                       "dtype": self.p["dtype"]}}

    def reference(self, sample, control=False):
        from benchmark.drivers.north_star import reference_inputs
        from benchmark.reference import pipeline as R

        torch, p, out = self.torch, self.p, []
        with reference_precision(torch, p["dtype"], control) as dt, torch.no_grad():
            inp = reference_inputs(self.cfg, dt, self.device)
            for i in sample:
                thetas = self.outputs[i][0]
                std, it, conv, hist, err = [], [], [], [], []
                for lo in range(0, len(thetas), p["check_block"]):
                    th = torch.as_tensor(thetas[lo:lo + p["check_block"]], device=self.device)
                    res = R.forward(inp, R.scale_diameters(inp.members, th.to(dt)),
                                    n_iter=p["n_iter"], history=True)
                    std.append(R.response_std(res.Xi, inp.wave.w).double().cpu().numpy())
                    hist.append(R.std_history(res, inp.wave.w).double().cpu().numpy())
                    err.append(R.error_history(res).double().cpu().numpy())
                    it.append(res.n_iter.cpu().numpy())
                    conv.append(res.converged.cpu().numpy())
                out.append((thetas, np.concatenate(std), np.concatenate(it),
                            np.concatenate(hist, axis=1), np.concatenate(err, axis=1),
                            np.concatenate(conv)))
        return out

    def compare(self, got, ref):
        lim = self.cell.params["limits"]
        pairs = list(zip(got, ref))
        edges = [iter_edge(g[2], r[2], r[4]) for g, r in pairs]
        self.detail = edge_detail(edges, [exit_fault(r[2], r[5], r[4]) for r in ref])
        return [Check("std_gap", max(step_gap(g[1], g[2], r[3]) for g, r in pairs),
                      lim["std_gap"]),
                Check("iter_far", float(sum(iter_far(g[2], r[2]) for g, r in pairs)),
                      lim["iter_far"]),
                Check("iter_edge", max(e[1] for e in edges), lim["iter_edge"])]
