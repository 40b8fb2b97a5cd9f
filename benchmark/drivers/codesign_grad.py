"""The co-design gradient: d sigma_nacelle / d (plan radius, draft) of
seeded variants through ``grad_nacelle_accel_std`` (the scan driver, K1
forward and on the adjoint system), on the nominal hull's BEM
coefficients staged on the card in set-up.

One step is a fresh draw of ``n_variants`` lanes, solved in chunks of
``chunk`` lanes; the reference differentiates the plain float64 pipeline
again on a seeded sample of the window's steps."""
from __future__ import annotations

import numpy as np

from benchmark.harness.driver import Check, Driver as Base, reference_precision, scale_gap
from benchmark.harness.spec import ROOT


class Driver(Base):
    def setup(self):
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.model import stage_design_base
        from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
        from raft_tpu_torch.parallel.sweep import stage_north_star_bem

        cfg, p = self.cfg, self.p
        self.dt = self.dtype(p["dtype"])
        _d, members, rna, env, wave, C = stage_design_base(
            str(ROOT / cfg["design"]), nw=cfg["nw"], Hs=cfg["Hs"], Tp=cfg["Tp"],
            w_min=cfg["w_min"], w_max=cfg["w_max"], dtype=self.dt, device=self.device)
        A, B, F = stage_north_star_bem(nw=cfg["nw"], nw_bem=cfg["bem"]["nw_bem"], mode="jax",
                                       cache=False, dtype=self.dtype(cfg["bem"]["dtype"]),
                                       device=self.device)
        bem = (A.to(self.dt), B.to(self.dt), Cx(F.re.to(self.dt), F.im.to(self.dt)))
        draft, plan = make_stretch_draft(members), make_scale_plan(members)

        def apply_fn(m, th):
            return plan(draft(m, th[..., 1]), th[..., 0])

        self.args = (members, rna, env, wave, C)
        self.kw = dict(apply_fn=apply_fn, bem=bem, n_iter=p["n_iter"], dtype=self.dt,
                       device=self.device)
        for i in range(p["warmup_calls"]):
            self.call(self.next_inputs(i))
        self.outputs.clear()

    def next_inputs(self, i):
        lo, hi = self.p["scale_range"]
        th = self.rng.uniform(lo, hi, (self.p["n_variants"], 2))
        return th, self.torch.as_tensor(th, device=self.device).to(self.dt)

    def call(self, inputs) -> dict:
        from raft_tpu_torch.parallel.optimize import grad_nacelle_accel_std

        th_host, th = inputs
        c = self.p["chunk"]
        g = self.torch.cat([grad_nacelle_accel_std(*self.args, th[lo:lo + c], **self.kw)
                            for lo in range(0, th.shape[0], c)]).cpu().numpy()
        self.outputs.append((th_host, g))
        return {"units": 1, "ok": bool(np.isfinite(g).all())}

    def release(self):
        self.args = self.kw = None

    def counters(self) -> dict:
        return {"k1": {"lanes_per_launch": self.p["chunk"], "nw": self.cfg["nw"],
                       "dtype": self.p["dtype"]}}

    def reference(self, sample, control=False):
        from benchmark.drivers.north_star import reference_bem, reference_inputs
        from benchmark.reference import pipeline as R

        torch, p, out = self.torch, self.p, []
        with reference_precision(torch, p["dtype"], control) as dt:
            inp = reference_inputs(self.cfg, dt, self.device)
            bem = reference_bem(torch, self.cfg, inp, dt, self.device, control)
            warp = R.plan_draft(inp.members)
            for i in sample:
                th_host = self.outputs[i][0]
                grads = []
                for lo in range(0, len(th_host), p["check_block"]):
                    th = torch.as_tensor(th_host[lo:lo + p["check_block"]], device=self.device)
                    th = th.to(dt).requires_grad_(True)
                    res = R.forward(inp, warp(inp.members, th), bem=bem, n_iter=p["n_iter"])
                    sig = R.nacelle_accel_std(res.Xi, inp.wave.w, inp.rna.hHub)
                    (g,) = torch.autograd.grad(sig.sum(), th)
                    grads.append(g.double().cpu().numpy())
                out.append((th_host, np.concatenate(grads)))
        return out

    def compare(self, got, ref):
        gap = max(scale_gap(g[1], r[1]) for g, r in zip(got, ref))
        return [Check("grad_gap", gap, self.cell.params["limits"]["grad_gap"])]
