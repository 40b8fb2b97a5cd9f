"""Registered public entry points for the runtime audit (the port's copy
of ``raft_tpu.lint.registry``, on the port's functions).

Each entry is the *device core* of one public API, the function the
orchestrator runs on tensors already staged on the device, built on a
small OC3-spar model (few frequencies, ``_N_ITER`` fixed-point
iterations).  The orchestrators stage host data and return numpy by
contract; those copies are planned, outside the core, and the audit
(:mod:`raft_tpu_torch.lint.audit`) holds what happens inside it: the ops
dispatched, float64 ops at float32, host syncs, library builds and
staging misses on a repeated call, and on the card the kernel launches and
the peak memory.

``build(device, dtype)`` returns ``(fn, args, args2)``: two argument
tuples of the same structure, shapes and dtypes, with different values,
staged on ``device`` in ``dtype``.  The audit calls ``fn(*args)`` to warm
and measures ``fn(*args2)``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable

#: (name, device, dtype) -> staged base; the lock makes the get-or-stage
#: single-flight, so concurrent audit runners stage each base once
_base_cache: dict = {}
_base_lock = threading.Lock()

_N_ITER = 3     # fixed-point iterations: the audit checks structure, not
#                 convergence, so the cheapest deterministic loop suffices


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str
    public_api: str                      # the API this entry guards
    build: Callable                      # (device, dtype) -> (fn, args, args2)
    #: the API serves concurrent callers (the daemon): its host path falls
    #: under the GL3xx contracts (seeds :data:`CONCURRENT_FUNCTIONS`)
    concurrent: bool = False
    #: the API runs on every rank of a world: its host path falls under the
    #: GL4xx contracts (seeds :data:`MULTIHOST_FUNCTIONS`)
    multihost: bool = False
    #: ``stage(args, mesh)``: this rank's block of ``args`` through the
    #: staging the API itself runs with ``mesh=`` (``None``: the API does
    #: not shard).  The audit's sharded check runs it on a ``cpu_world(2)``
    stage: Callable | None = None

    @property
    def sharded(self) -> bool:
        return self.stage is not None


def _designs_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "raft_tpu", "designs")


def _cached(key, make):
    with _base_lock:
        hit = _base_cache.get(key)
        if hit is None:
            hit = _base_cache[key] = make()
        return hit


def _small_base(device, dtype, nw: int = 6):
    """OC3-spar staged by :func:`raft_tpu_torch.model.stage_design_base` on
    a small grid: ``(design, members, rna, env, wave, C_moor)``."""
    from raft_tpu_torch.model import stage_design_base

    return _cached(("base", nw, str(device), str(dtype)), lambda: stage_design_base(
        os.path.join(_designs_dir(), "OC3spar.yaml"), nw=nw, Hs=6.0, Tp=10.0, w_min=0.3,
        w_max=2.1, dtype=dtype, device=device))


def _entry_north_star_sweep(device, dtype):
    """Core of :func:`raft_tpu_torch.parallel.sweep.sweep`: the variants of
    one design (diameter scales) as lanes of one batched scan solve."""
    import torch

    from raft_tpu_torch.parallel.sweep import (
        _apply_lanes, forward_response, response_std, scale_diameters)

    _, members, rna, env, wave, C_moor = _small_base(device, dtype)

    def fn(thetas):
        with torch.no_grad():
            m = _apply_lanes(scale_diameters, members, thetas)
            out = forward_response(m, rna, env, wave, C_moor, n_iter=_N_ITER, dtype=dtype,
                                   device=device)
            return response_std(out.Xi.abs2(), wave.w), out.n_iter

    def th(step):
        return (1.0 + step * torch.arange(2, dtype=dtype)).to(device)

    return fn, (th(0.02),), (th(0.03),)


def _entry_dlc_solve(device, dtype):
    """Core of :func:`raft_tpu_torch.parallel.sweep.sweep_sea_states`: every
    sea state of a DLC table a lane (``_make_dlc_case_fn``)."""
    import numpy as np
    import torch

    from raft_tpu_torch.parallel.sweep import _make_dlc_case_fn, make_wave_states

    design, members, rna, env, wave, C_moor = _small_base(device, dtype)
    depth = float(design["mooring"]["water_depth"])
    w = wave.w.detach().cpu().numpy().astype(np.float64)
    run = _make_dlc_case_fn(members, rna, env, C_moor, None, _N_ITER, dtype=dtype,
                            device=device)

    def fn(waves):
        with torch.no_grad():
            return run(waves, None, None)

    def waves(rows):
        return make_wave_states(w, rows, depth, dtype=dtype, device=device)

    return fn, (waves([[6.0, 10.0], [8.0, 12.0]]),), (waves([[5.0, 9.0], [9.0, 13.0]]),)


def _entry_freq_sharded(device, dtype):
    """:func:`raft_tpu_torch.parallel.sweep.forward_response_freq_sharded`
    on a mesh of one rank (``make_mesh``; a world of one joined when there
    is none), with its default ``while`` driver: the SUM and MAX
    all-reduces every iteration, and the exit test's one host sync an
    iteration by design."""
    import dataclasses as dc

    from raft_tpu_torch.parallel.sweep import forward_response_freq_sharded, make_mesh

    _, members, rna, env, wave, C_moor = _small_base(device, dtype)
    mesh = make_mesh(1, axis="freq", device=device)

    def fn(wv):
        out = forward_response_freq_sharded(members, rna, env, wv, C_moor, mesh=mesh,
                                            n_iter=_N_ITER, dtype=dtype, device=device)
        return out.Xi.abs2(), out.n_iter

    return fn, (wave,), (dc.replace(wave, zeta=wave.zeta * 1.1),)


def _entry_val_grad(device, dtype):
    """Core of :func:`raft_tpu_torch.parallel.optimize.optimize_design`'s
    step: the value and gradient of the nacelle-acceleration objective
    through the reverse-differentiable scan driver (K1 forward and in its
    adjoint mode on the card)."""
    import torch

    from raft_tpu_torch.parallel.optimize import _make_loss, _value_and_grad, nacelle_accel_std
    from raft_tpu_torch.parallel.sweep import scale_diameters

    _, members, rna, env, wave, C_moor = _small_base(device, dtype)
    loss = _make_loss(members, rna, env, wave, C_moor, nacelle_accel_std, scale_diameters,
                      None, _N_ITER, False, dtype=dtype, device=device)

    def fn(theta):
        return _value_and_grad(loss, theta)

    return (fn, (torch.tensor(1.0, dtype=dtype).to(device),),
            (torch.tensor(1.05, dtype=dtype).to(device),))


def _entry_eigen(device, dtype):
    """:func:`raft_tpu_torch.solve.eigen.solve_eigen`: the generalized
    symmetric eigensolve (Cholesky and Jacobi sweeps)."""
    import torch

    from raft_tpu_torch.solve.eigen import solve_eigen
    from raft_tpu_torch.statics import assemble_statics

    _, members, rna, env, _, C_moor = _small_base(device, dtype)
    stat = assemble_statics(members, rna, env)
    M = stat.M_struc
    C = stat.C_struc + stat.C_hydro + C_moor
    eye = torch.eye(6, dtype=dtype, device=device)
    M2 = M + 0.01 * eye * M[0, 0]
    C2 = C + 0.01 * eye * torch.abs(C[2, 2])

    def fn(Mx, Cx_):
        out = solve_eigen(Mx, Cx_)
        return out.fns, out.modes

    return fn, (M, C), (M2, C2)


def fused_rao_args(seed: int, device, dtype, nw: int = 8):
    """The inputs of the ``fused_rao_solve`` entry: ``(Z0, w, B_drag, F)``
    from ``seed``, a well-conditioned impedance as the JAX entry makes it."""
    import numpy as np

    from raft_tpu_torch.core.cplx import Cx
    from raft_tpu_torch.core.device import to_device

    rng = np.random.default_rng(seed)

    def t(a):
        return to_device(a, dtype, device)

    Z0 = Cx(t(rng.normal(size=(nw, 6, 6)) + 8.0 * np.eye(6)),
            t(0.3 * rng.normal(size=(nw, 6, 6))))
    w = t(rng.uniform(0.2, 2.5, nw))
    Bd = t(rng.normal(size=(6, 6)))
    F = Cx(t(rng.normal(size=(nw, 6))), t(rng.normal(size=(nw, 6))))
    return Z0, w, Bd, F


def _entry_fused_rao_solve(device, dtype):
    """:func:`raft_tpu_torch.core.cuda6.solve_rao`: K1 on CUDA tensors, its
    plain version on CPU tensors."""
    from raft_tpu_torch.core import cuda6

    def fn(Z0, w, Bd, F):
        x = cuda6.solve_rao(Z0, w, Bd, F)
        return x.re, x.im

    return fn, fused_rao_args(0, device, dtype), fused_rao_args(1, device, dtype)


def _two_design_batch(device, dtype):
    """Two different designs (OC3 spar and a station-split variant with
    more segments and nodes) staged into one bucket, lane-leading."""
    import copy

    import numpy as np

    def make():
        from raft_tpu_torch.model import load_design, stage_designs

        path = os.path.join(_designs_dir(), "OC3spar.yaml")
        variant = copy.deepcopy(load_design(path))
        m0 = variant["platform"]["members"][0]
        s0, s1 = float(m0["stations"][0]), float(m0["stations"][-1])
        m0["stations"] = [s0, 0.5 * (s0 + s1), s1]
        m0["d"] = [float(np.atleast_1d(m0["d"])[0])] * 3
        m0["t"] = [float(np.atleast_1d(m0["t"])[0])] * 3
        staged = stage_designs([path, variant], nw=6, Hs=6.0, Tp=10.0, w_min=0.3, w_max=2.1,
                               dtype=dtype, device=device)
        if len(staged) != 1:
            raise AssertionError(f"audit fixture designs landed in {len(staged)} buckets "
                                 f"({list(staged)}); they must share one")
        (batch,) = staged.values()
        return batch

    return _cached(("sweep_designs", str(device), str(dtype)), make)


def _bucket_args(batch, dtype, device):
    import torch

    C = (batch.C_moor if batch.C_moor is not None
         else torch.zeros((len(batch.fnames), 6, 6), dtype=dtype, device=device))
    return (batch.members, batch.rna, batch.env, batch.wave, C, batch.bem)


def _entry_sweep_designs(device, dtype):
    """Core of :func:`raft_tpu_torch.parallel.sweep.sweep_designs`: one
    bucket's two different designs as lanes of one batched solve; the
    second call takes the same designs in swapped lane order."""
    import torch

    from raft_tpu_torch.parallel.sweep import _lane_slice, forward_response

    args = _bucket_args(_two_design_batch(device, dtype), dtype, device)

    def fn(members, rna, env, wave, C, bem):
        with torch.no_grad():
            out = forward_response(members, rna, env, wave, C, bem=bem, n_iter=_N_ITER,
                                   dtype=dtype, device=device)
            return out.Xi.abs2(), out.n_iter

    return fn, args, _lane_slice(args, torch.tensor([1, 0], device=device))


def _entry_serve_solve(device, dtype):
    """Core of :func:`raft_tpu_torch.serve.solver.solve_batch`: the bucket
    body of ``sweep_designs(health=True, return_xi=False)`` on a batch
    padded to a fixed capacity by tiling its real lanes; the two calls are
    two occupancies of the same capacity."""
    import torch

    from raft_tpu_torch.parallel.sweep import (
        _lane_finite, _lane_slice, forward_response, response_std)

    base = _bucket_args(_two_design_batch(device, dtype), dtype, device)

    def fn(members, rna, env, wave, C, bem):
        with torch.no_grad():
            out = forward_response(members, rna, env, wave, C, bem=bem, n_iter=_N_ITER,
                                   dtype=dtype, device=device)
            abs2 = out.Xi.abs2()
            return (response_std(abs2, wave.w), out.n_iter, out.converged,
                    _lane_finite(abs2))

    def pad(order):
        return _lane_slice(base, torch.tensor(order, device=device))

    return fn, pad((0, 0, 0, 0)), pad((1, 0, 1, 0))


def _sphere(scale: float):
    """A 32-panel sphere (4 x 8) of radius ``scale`` centred 3 m down."""
    import numpy as np

    th = np.linspace(0, np.pi, 5)
    pans = []
    for i in range(4):
        for j in range(8):
            p0, p1 = th[i], th[i + 1]
            a0, a1 = 2 * np.pi * j / 8, 2 * np.pi * (j + 1) / 8

            def pt(pp, aa):
                return [scale * np.sin(pp) * np.cos(aa), scale * np.sin(pp) * np.sin(aa),
                        -3.0 + scale * np.cos(pp)]

            pans.append([pt(p0, a0), pt(p1, a0), pt(p1, a1), pt(p0, a1)])
    return np.asarray(pans)


def _bem_entry(assembly: str, device, dtype):
    """:func:`raft_tpu_torch.hydro.torch_bem.solve_panels` on a small
    deep-water sphere at two frequencies, with the assembly route pinned;
    the two calls are two radii padded to one panel class."""
    import numpy as np

    from raft_tpu_torch.hydro import torch_bem, wavetable

    w = np.array([0.9, 1.4])
    tab = _cached(("tables", str(device), str(dtype)), lambda: torch_bem.stage_tables(
        wavetable.load_tables(), dtype, device))

    def args_for(scale):
        padded, pm, lm = torch_bem.pad_mesh(_sphere(scale), None)
        st = torch_bem.stage_inputs(padded, pm, lm, w, np.array([0.0]),
                                    wavetable.fd_fit_grid(w, -1.0, 9.81),
                                    finite_depth=False, dtype=dtype, device=device)
        return (st,)

    def fn(staged):
        A, B, F, resid = torch_bem.solve_panels(
            **staged, tab=tab, rho=1025.0, g=9.81, depth=0.0, finite_depth=False,
            assembly=assembly, dtype=dtype, device=device)
        return A, B, F.re, F.im, resid

    return fn, args_for(1.0), args_for(1.07)


def _entry_torch_bem(device, dtype):
    """The panel solve with the plain assembly (the route ``make_bem_fn``
    differentiates)."""
    return _bem_entry("plain", device, dtype)


def _entry_torch_bem_kernels(device, dtype):
    """The same panel solve through K3 and K4 on CUDA tensors (their plain
    versions on CPU tensors, as every wrapper does)."""
    return _bem_entry("kernels", device, dtype)


def _stage_variants(args, mesh):
    """:func:`~raft_tpu_torch.parallel.sweep.sweep`'s block of the variants."""
    from raft_tpu_torch.parallel.sweep import _stage_variants_global

    return (_stage_variants_global(args[0], mesh),)


def _stage_cases(args, mesh):
    """:func:`~raft_tpu_torch.parallel.sweep.sweep_sea_states`' block of the
    cases (no per-case excitation: the entry solves without BEM)."""
    from raft_tpu_torch.parallel.sweep import _stage_cases_global

    return (_stage_cases_global(args[0], None, None, False, mesh)[0],)


def _stage_bucket(args, mesh):
    """:func:`~raft_tpu_torch.parallel.sweep.sweep_designs`' block of a
    bucket's lanes (the serving solver's batches are such buckets)."""
    from raft_tpu_torch.parallel.sweep import _stage_bucket_global

    return _stage_bucket_global(args, mesh)


ENTRY_POINTS: tuple[EntryPoint, ...] = (
    EntryPoint("north_star_sweep", "raft_tpu_torch.parallel.sweep.sweep",
               _entry_north_star_sweep, concurrent=True, multihost=True, stage=_stage_variants),
    EntryPoint("dlc_solve", "raft_tpu_torch.parallel.sweep.sweep_sea_states",
               _entry_dlc_solve, concurrent=True, multihost=True, stage=_stage_cases),
    EntryPoint("freq_sharded_forward",
               "raft_tpu_torch.parallel.sweep.forward_response_freq_sharded",
               _entry_freq_sharded),
    EntryPoint("val_grad", "raft_tpu_torch.parallel.optimize.optimize_design",
               _entry_val_grad),
    EntryPoint("eigen", "raft_tpu_torch.solve.eigen.solve_eigen", _entry_eigen),
    EntryPoint("fused_rao_solve", "raft_tpu_torch.core.cuda6.solve_rao",
               _entry_fused_rao_solve),
    EntryPoint("sweep_designs", "raft_tpu_torch.parallel.sweep.sweep_designs",
               _entry_sweep_designs, concurrent=True, multihost=True, stage=_stage_bucket),
    EntryPoint("serve_solve", "raft_tpu_torch.serve.solver.solve_batch",
               _entry_serve_solve, concurrent=True, multihost=True, stage=_stage_bucket),
    EntryPoint("torch_bem", "raft_tpu_torch.hydro.torch_bem.solve_panels",
               _entry_torch_bem),
    EntryPoint("torch_bem_kernels", "raft_tpu_torch.hydro.torch_bem.solve_panels",
               _entry_torch_bem_kernels),
)

#: the daemon-facing functions whose whole host call path falls under the
#: GL3xx contracts: every ``concurrent=True`` entry's API, and the kernel
#: library registry, which a daemon's warm-up and solver loop reach together
CONCURRENT_FUNCTIONS: tuple[str, ...] = tuple(
    e.public_api for e in ENTRY_POINTS if e.concurrent
) + (
    "raft_tpu_torch.cache.aot.library",
    "raft_tpu_torch.cache.aot.prepare",
)

#: the functions that run on every rank of a world, whose host call path
#: falls under the GL4xx contracts: every ``multihost=True`` entry's API and
#: the multi-device staging and frequency-sharded solves
MULTIHOST_FUNCTIONS: tuple[str, ...] = tuple(
    e.public_api for e in ENTRY_POINTS if e.multihost
) + (
    "raft_tpu_torch.parallel.multihost.stage_global",
    "raft_tpu_torch.parallel.sweep.forward_response_freq_sharded",
    "raft_tpu_torch.parallel.sweep.forward_response_dp_sp",
)


def get_entries(names=None) -> tuple[EntryPoint, ...]:
    if names is None:
        return ENTRY_POINTS
    by_name = {e.name: e for e in ENTRY_POINTS}
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(f"unknown audit entries {missing}; have {sorted(by_name)}")
    return tuple(by_name[n] for n in names)
