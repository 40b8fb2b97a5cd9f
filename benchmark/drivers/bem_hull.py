"""The hull panel solve: each call meshes a seeded variant of the design's
hull (``mesh_design``) and solves its panels on the card
(``solve_bem_any(mode="jax")``: K3, K4, the LU and its refinement).

A variant scales the platform's plan (x, y of every member end) and its
draft (z of the ends below the waterline).  The reference meshes a seeded
sample of the window's variants again and solves them with the plain
assembly in float64."""
from __future__ import annotations

import copy
import time

import numpy as np

from benchmark.harness.driver import Check, Driver as Base, array_gap, reference_precision
from benchmark.harness.spec import ROOT


def hull_variant(design: dict, plan: float, draft: float) -> dict:
    """``design`` with its platform's member ends scaled: x and y by
    ``plan``, z below the waterline by ``draft``."""
    out = copy.deepcopy(design)
    for m in out["platform"]["members"]:
        for key in ("rA", "rB"):
            x, y, z = (float(v) for v in m[key])
            m[key] = [x * plan, y * plan, z * draft if z < 0 else z]
    return out


class Driver(Base):
    def setup(self):
        import yaml

        with open(ROOT / self.cfg["design"]) as f:
            self.design = yaml.safe_load(f)
        b = self.cfg["bem"]
        self.w_bem = np.linspace(self.cfg["w_min"], self.cfg["w_max"], b["nw_bem"])
        self.dt = self.dtype(b["dtype"])
        self.mesh_s = []
        for i in range(self.p["warmup_calls"]):
            self.call(self.next_inputs(i))
        self.outputs.clear()
        self.mesh_s.clear()

    def next_inputs(self, i):
        lo, hi = self.p["scale_range"]
        plan, draft = self.rng.uniform(lo, hi, 2)
        return (plan, draft), hull_variant(self.design, plan, draft)

    def call(self, inputs) -> dict:
        from raft_tpu_torch.hydro.mesh import mesh_design
        from raft_tpu_torch.hydro.torch_bem import solve_bem_any

        b, cfg = self.cfg["bem"], self.cfg
        params, variant = inputs
        t0 = time.perf_counter()
        panels = mesh_design(variant, dz_max=b["dz_max"], da_max=b["da_max"])
        self.mesh_s.append(time.perf_counter() - t0)
        A, B, F = solve_bem_any(panels, self.w_bem, rho=cfg["rho"], g=cfg["g"],
                                beta=np.deg2rad(b["heading_deg"]), depth=cfg["depth"],
                                mode="jax", cache=False, dtype=self.dt, device=self.device)
        self.outputs.append((params, panels, A, B, F))
        ok = all(np.isfinite(a).all() for a in (A, B, F))
        return {"units": 1, "ok": bool(ok)}

    def counters(self) -> dict:
        from benchmark.work import bem as work

        b, cfg = self.cfg["bem"], self.cfg
        per_call = [work.hull_work(panels, self.w_bem, cfg["depth"], cfg["g"],
                                   self.torch.float64 if b["dtype"] == "float64"
                                   else self.torch.float32, self.device)
                    for _, panels, *_ in self.outputs]
        return {"mesh_s": list(self.mesh_s), "bem_work": per_call}

    def sample(self):
        """A seeded sample of the window's hulls, with the one of the most
        panels in it."""
        n = len(self.outputs)
        most = int(np.argmax([len(o[1]) for o in self.outputs]))
        rest = [i for i in range(n) if i != most]
        k = min(self.p["check_calls"] - 1, len(rest))
        return sorted([most] + [int(i) for i in self.check_rng().choice(rest, k, replace=False)])

    def reference(self, sample, control=False):
        from benchmark.reference import mesh as ref_mesh
        from benchmark.reference import panel as ref_panel

        cfg, b, out = self.cfg, self.cfg["bem"], []
        with reference_precision(self.torch, b["dtype"], control) as dt:
            for i in sample:
                params = self.outputs[i][0]
                pan = ref_mesh.mesh_design(hull_variant(self.design, *params),
                                           dz_max=b["dz_max"], da_max=b["da_max"])
                A, B, F, _ = ref_panel.solve_bem(
                    pan, self.w_bem, rho=cfg["rho"], g=cfg["g"],
                    beta=np.deg2rad(b["heading_deg"]), depth=cfg["depth"], dtype=dt,
                    device=self.device)
                out.append((params, pan, A, B, F))
        return out

    def compare(self, got, ref):
        lim = self.cell.params["limits"]
        pairs = list(zip(got, ref))
        return [Check(key, max(array_gap(g[k], r[k]) for g, r in pairs), lim[key])
                for key, k in (("mesh_gap", 1), ("A_gap", 2), ("B_gap", 3), ("F_gap", 4))]
