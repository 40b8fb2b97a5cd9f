"""The BEM gradient against central differences of its objective, with the
objective's branches taken afresh and held.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 -m raft_tpu_torch.tools.bem_grad_fd

The objective is sigma_nacelle of VolturnUS-S (48 w, 200 m, scan at 25
iterations, float64) through ``torch_bem.make_bem_fn`` (850 panels, the
1,024 class), a function of the radial scale theta.  It is piecewise
smooth: each pair's subdivision level, each wave-integral region (near
quadrature, table, far field, deep tail) and each Bessel approximation is
picked by a comparison, and the objective steps where one flips.  Autograd
differentiates with every such branch held; :class:`FrozenBranches` holds
them for a finite difference too.  At theta 1.0, 1.01 and 1.02 the tool
prints autograd's derivative beside central differences at h = 1e-3 ..
1e-6 with the branches taken afresh and, at 1e-4 .. 1e-6, held at theta.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class FrozenBranches:
    """Holds a run's branches for the runs after it: every comparison and
    every cast to an integer or bool dtype that the first run (inside the
    ``with``) makes is recorded in order, and inside :meth:`replay` the
    same operators return the recorded results.  An objective evaluated at
    theta +- h under ``replay()`` takes theta's branches (subdivision
    levels, wave-integral regions, Bessel branches, the scan's convergence
    flags): the piecewise function whose branches autograd holds, so its
    central difference is the derivative autograd computes.  The replay
    raises unless it takes exactly the recorded branches."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        aten = torch.ops.aten
        ops = {aten.lt, aten.le, aten.gt, aten.ge, aten.eq, aten.ne}
        int_types = (torch.bool, torch.int32, torch.int64)
        store = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                packet = func.overloadpacket
                if not (packet in ops or (packet is aten._to_copy
                                          and kwargs.get("dtype") in int_types)):
                    return func(*args, **kwargs)
                if store.replaying:
                    out = store.held[store.cursor]
                    store.cursor += 1
                    return out
                out = func(*args, **kwargs)
                store.held.append(out.clone())
                return out

        self._mode_cls = Mode
        self._mode = None
        self.held, self.cursor, self.replaying = [], 0, False

    @property
    def n_held(self) -> int:
        return len(self.held)

    def __enter__(self):
        self._mode = self._mode_cls()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    @contextlib.contextmanager
    def replay(self):
        self.cursor, self.replaying = 0, True
        try:
            with self._mode_cls():
                yield
            if self.cursor != len(self.held):
                raise RuntimeError(f"the replay took {self.cursor} of {len(self.held)} branches")
        finally:
            self.replaying = False


def main() -> int:
    from raft_tpu_torch.hydro import mesh, torch_bem
    from raft_tpu_torch.parallel.optimize import _make_loss, _value_and_grad, nacelle_accel_std
    from raft_tpu_torch.parallel.sweep import _volturnus, scale_diameters

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool runs on the card")
        return 2
    dev, dt = torch.device("cuda"), torch.float64
    print("device", torch.cuda.get_device_name(0), flush=True)
    design, members, rna, env, wave, C = _volturnus(48, dt, dev)
    bem_fn = torch_bem.make_bem_fn(mesh.mesh_design(design, dz_max=3.0, da_max=2.0),
                                   np.linspace(0.05, 2.95, 48), rho=float(env.rho),
                                   g=float(env.g), depth=200.0, dtype=dt, device=dev)
    loss = _make_loss(members, rna, env, wave, C, nacelle_accel_std, scale_diameters, None, 25,
                      False, bem_fn=bem_fn, dtype=dt, device=dev)
    for theta in (1.0, 1.01, 1.02):
        th = torch.tensor(theta, dtype=dt, device=dev)
        t0 = time.perf_counter()
        val, g = _value_and_grad(loss, th)
        g = float(g)
        print(f"theta {theta}: sigma_nacelle {float(val):.15e}, autograd {g:.12e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        with torch.no_grad():
            for h in (1e-3, 1e-4, 1e-5, 1e-6):
                fd = (float(loss(th + h)) - float(loss(th - h))) / (2 * h)
                print(f"  branches afresh, h {h:g}: {fd:.12e}, rel {abs(fd - g) / abs(fd):.3e}",
                      flush=True)
            with FrozenBranches() as frozen:
                loss(th)
            for h in (1e-4, 1e-5, 1e-6):
                vals = []
                for s in (1.0, -1.0):
                    with frozen.replay():
                        vals.append(float(loss(th + s * h)))
                fd = (vals[0] - vals[1]) / (2 * h)
                print(f"  branches held ({frozen.n_held}), h {h:g}: {fd:.12e}, rel "
                      f"{abs(fd - g) / abs(fd):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
