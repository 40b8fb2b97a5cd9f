#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``raft_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure makes the script exit non-zero, and then it prints no
result line):

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles kernels K1/K2 (``csrc/solve6.cu``), K3
   (``csrc/bem_rankine.cu``), K4 (``csrc/bem_wave.cu``; each with
   float64, float32 and bfloat16 entries) and K5 (``csrc/drag.cu``) of
   ``raft_tpu_torch`` with one nvcc each, all at once, prints ptxas'
   registers and spills (kept beside each library, so a run that only loads
   a built library prints them too), and builds (or loads) the BEM
   wave-integral tables under the cache root
   (``raft_tpu_torch/_build/cache/wavetable/`` by default);
3. K1 against its plain PyTorch version on the card, numpy-seeded inputs at
   the sweep's call shape (250 designs x 200 frequencies) and at 1,000 x 200,
   in float64 and float32: random systems, a permutation matrix with w = 0
   (forces pivoting, solved exactly), one singular lane (zero-denominator
   guard) and a pivot-tie batch (equal |.|^2 in the pivot column; float64
   bit for bit); the adjoint mode against the forward mode on materialized
   transposes (bit for bit); with kernel, plain-version and
   ``torch.linalg.solve`` times beside the bound; then, as phase "K5 vs
   plain", K5 (one fixed-point step's drag linearization) against its plain
   version at the main paths' shapes (2,048 OC3spar variants x 200
   frequencies and 250 VolturnUS-S variants x 200 in float32, the daemon's
   8 sea-state lanes x 100 in float64, 8 lanes sharing one design's
   kinematics in float64): scale-relative difference within ``TOL`` (the
   moments sum 3 x nw terms in another order, and erf and exp round
   differently), two launches bit for bit, one launch a call, with kernel,
   plain-version and eager ``linearized_drag`` times beside the bound and
   the wrapper's host time a call;
4. K2 against its plain version at ``bench.py::pallas6_microbench``'s shape
   (16,384 diagonally dominant systems) in float64 and float32, with the
   same permutation, singular, pivot-tie and adjoint-mode cases; then the
   microbench itself, K2's path, with its launches counted;
5. the adjoints of K1 and K2 (``solve_rao_ad``, ``solve_cx_ad``) against
   autograd through the plain elimination on the card, float64, at the
   sweep's call shape;
6. the gradient guard: K1, K2, K3 and K4 called on the card with an input
   that requires grad raise and name the scan driver, launching nothing,
   as does ``forward_response(method="while")`` under autograd; the
   default driver (scan) differentiates 4 north-star lanes through K1 and
   its adjoint;
7. K3 (Rankine assembly) against its plain version on the VolturnUS-S hull
   (1,024-panel class) and the OC4semi hull with its waterplane lid
   (2,048 class), float64 and float32, with the pairs per subdivision level:
   two calls give the same bits, the kernel's near pass takes as many pairs
   as ``pair_levels`` puts on a level of 36 or more points, and one call
   under the profiler runs K3's kernel alone (no copy, cast or sync);
8. K4 (wave part) against its plain version on the same meshes, on a deep
   (1.5 rad/s) and a finite-depth (0.4 rad/s, 200 m) frequency chunk, and on
   every chunk of the north star's 48-frequency staging grid (one line per
   chunk: frequencies, deep or finite depth, the image evaluations per
   region of the wave integrals, kernel time against the bound); then K3
   and K4 at a panel count off the 64-panel classes (850, the hull
   unpadded);
9. ``run_raft`` on OC3spar, OC4semi and VolturnUS-S on the card in float64
   against the same run on the CPU (plain path);
10. the strip-theory north-star sweep at full size (1,000 VolturnUS-S
   variants x 200 frequencies, float32) with its K1 launches counted, then
   a 16-lane subset in float64 through the kernel and through the plain
   solve on the card;
11. ``Model(BEM="jax")`` on VolturnUS-S and OC4semi at full width in float64
   through run_raft's steps with K3/K4, again with their plain versions on
   the card (OC4semi through every step, its natural frequencies and std
   dev held; VolturnUS-S through the panel solve); and the VolturnUS-S
   panel solve in float32 against float64;
12. the BEM-staged north star with the panel solve on the card, whose K1,
   K3 and K4 launches are counted: the nominal hull's panel solve at 48
   frequencies in float64, interpolated to 200 and staged, then the
   1,000 x 200 sweep in float32; then a 16-lane float64 subset through K1
   and through the plain solve;
13. native BEM staging, the north star as ``bench.py`` stages it: the host
   C++ solver (``raft_tpu_torch/native/bem.cpp``, built with g++, its wave
   table built or loaded, both timed) solves the 850-panel hull at 48
   frequencies and 200 m depth cold (no result cache), with the host's
   core count printed; the card's staging (K3/K4) is held against it at
   ``PARITY_RTOL``; then the 1,000 x 200 float32 sweep runs on the
   native-staged coefficients, every lane converged;
14. the co-design gradient, whose K1 forward and adjoint launches are
   counted: ``grad_nacelle_accel_std`` of the 1,000 VolturnUS-S plan-radius
   x draft variants x 200 frequencies (float32, the card-staged BEM, scan
   loop at 25 iterations, chunks of 250), with the forward-only time beside
   it; then a 4-lane float64 subset through the kernels and through the
   plain solve, and against central differences;
15. ``optimize_design`` (6 Adam steps) on VolturnUS-S with the staged BEM,
   and the OC3spar mooring-knob gradient on the card against the CPU;
16. the BEM gradient, K1's forward and adjoint launches counted and K3/K4
   none: d sigma_nacelle / d theta (radial scale) through
   ``torch_bem.make_bem_fn`` (VolturnUS-S, 850 panels, 48 w, 200 m, the
   panel solve's plain assembly differentiated), scan at 25 iterations,
   at theta 1.01: float64 with the wall time and peak memory, against the
   same loss with the plain solve in K1's place on the panel solve's A, B,
   F at theta (value, and gradient in theta and in A, B, F) and
   against a central difference with theta's branches held
   (``tools/bem_grad_fd.py``); then float32 through the entry point,
   ``optimize_design(bem_fn=...)`` from theta 1.01, 1 Adam step at full
   width, its first value and gradient held against float64;
17. the DLC table: ``Model(BEM="jax")`` on VolturnUS-S at the north star's
   200 w with a 7-heading grid (K3 once, K4 per chunk counted), then
   ``sweep_sea_states`` over 64 cases (8 Hs/Tp rows x 8 headings), float64,
   all 64 against the plain solve in K1's place, 4 against the same call
   on the CPU and against the 64-case rows; then a 7-direction spread sea
   through ``directional_response`` on a grid that covers it;
18. the variant sweep, K1's launches counted: ``sweep`` of OC3spar's
   ``scale_diameters`` variants, 2,048 scales x 200 w, float32, scan at 25,
   wall-clock, solves/s and a profile; 64 lanes in float64 through K1 and
   through the plain solve;
19. the mixed designs, K1's launches counted: ``sweep_designs`` of 1,000
   dicts (250 of each shipped platform, member diameters scaled in [0.95,
   1.05]) at 200 w in two 500-lane buckets of 256 w, float32, staging and
   solve timed apart and the solve profiled; one lane of each family in
   float64 against its solo run, K1 against the plain solve per bucket with
   the padded bins exactly zero; the 250 VolturnUS-S dicts with the
   nominal hull's (native-staged) BEM coefficients;
20. the operations around the solve, K1's launches counted: the
   BEM-staged north star (1,000 x 200, float32, chunks of 250) through
   ``run_pipelined`` (copy, compute and fetch streams) at depth 2 and 1 in
   turns, twice each, bit for bit against each other and the old chunk
   loop, with each wall-clock and ``pipeline`` block, then with
   ``health=True`` under ``RAFT_TPU_STRICT``; the 64-case DLC table in
   chunks of 16 with ``health=True`` against the unchunked call (1e-12,
   float64) and the 1,000 mixed designs in chunks of 250 at depth 2 against
   theirs (1e-5 relative, float32) with ``RAFT_TPU_OBS`` armed: the JSONL
   log, Chrome trace and Prometheus text published, read back and their
   span names and counts checked; ``RAFT_TPU_FAULT_INJECT=nan_chunk:1``:
   lanes 16-31 quarantined and salvaged at ``n_iter_x4`` through K1 (1e-10
   from the clean run); a child process killed after chunk 1 (exit 77)
   with ``RAFT_TPU_CKPT`` armed, resumed here bit for bit; a corrupt chunk
   detected and recomputed; one ``torch.profiler`` capture of a pipelined
   pass (the ``pipeline/dispatch`` ranges, K1 on the compute stream, the
   copies on streams of their own);
21. the serving daemon (``raft_tpu_torch.serve``), K1's launches counted:
   an in-process ``SolverServer`` at the daemon's defaults (100 w padded to
   128, 25 scan iterations, 8 lanes a batch, a 25 ms deadline, float64)
   warmed on OC3spar, OC4semi and VolturnUS-S (two buckets), with each
   design's lane staging timed cold and warm; through a real
   ``SolveClient`` the mixed stream (3 designs x 8 sea states as ``solve``
   requests, a ``dlc`` of VolturnUS-S x 8, a ``sweep`` of the 3), every row
   bit for bit its ``solve_solo`` row with identical iterations; a lane at
   positions 0 and 1 of mixed batches bit for bit its solo row; a Tp = 0
   lane quarantined without moving its batch-mate's bits; each bucket's
   rows against ``sweep_designs`` on the same designs (1e-12
   scale-relative, identical iterations); one padded batch through K1 and
   through the plain solve (1e-10); no kernel build after the warm-up;
   then ``bench.py::serving_block``'s load (48 requests at 400 requests/s,
   a warm pass, the measured open loop, a sequential baseline) with p50,
   p99, solves/s, their ratio and the occupancy per bucket (reported, not
   gated); then a daemon child (``python -m raft_tpu_torch.serve daemon
   --warm oc3,oc4,volturnus``, at the daemon's defaults) serving the
   smoke's stream, its rows bit for bit the solo rows, SIGTERM with exit 0
   and its socket unlinked, its ready time, kernel builds and K1 launches
   printed (other daemon processes serving the same rows bit for bit
   without a build, a restarted one among them, are phase "fleet"'s
   replicas);
22. the fleet (``raft_tpu_torch.serve.fleet_smoke``): two replicas at the
   daemon's defaults started at once, ``kill_replica:1``
   mid-stream (every request answered once, the rows bit for bit the
   in-process solo rows and the "serve" child's, a resubmit, the killed
   replica restarted and re-admitted after a passing probe); one replica
   with ``queue_max = 1``, ``stall_replica:1`` and a burst of 7 (typed
   ``Overloaded`` sheds with ``retry_after_ms``, the stalled request
   recovered, every shed request served when submitted again); each
   replica's ready time and the live replicas' K1 launches printed (the
   killed replica's launches die with it);
23. the array farm, K1, K3 and K4 launches counted: ``Model(VolturnUS-S,
   nTurbines=16, BEM="jax")`` on a 4 x 4 grid at 1,500 m, 59 w, float64,
   every step timed; turbines against single-turbine runs, K1 and K3/K4
   against their plain versions, ``airgap`` at 4 deck points;
24. the multi-device slice, K1's launches on the sharded paths counted:
   ``make_mesh()`` joins this process to a world of one under NCCL; the
   north star's 1,000 variants x 200 w (float32, scan at 40) through
   ``sweep(mesh=)`` bit for bit ``sweep()`` with the same K1 launches;
   ``forward_response_freq_sharded`` on VolturnUS-S at 200 w, float64,
   with the native-staged BEM against the unsharded solve (1e-12,
   identical iterations) and against itself with the plain solve in K1's
   place (1e-10); ``forward_response_dp_sp`` on a (1, 1) mesh;
   ``sweep_sea_states(mesh=)`` on the 64-case DLC table;
   ``sweep_designs(mesh=)`` on the mixed designs;
   ``ArrayModel.solveDynamics(mesh=)`` on 4 turbines; one sharded scan
   chunk under CUDA's sync debug mode "error"; the sharded and unsharded
   north star and freq-sharded solve timed in turns (the cost of NCCL's
   all-reduces at world one); ``dist.destroy_process_group()`` at the end;
25. the port's lint (``raft_tpu_torch.lint``): the static pass over
   ``raft_tpu_torch/`` and this script against the committed baseline (no
   new violation); the race scenarios in a child process (8 threads, a
   1 us switch interval, every check exact); the runtime audit of every
   registered entry at
   float32 on the card against the ``"cuda"`` budgets of
   ``lint/budgets.json``: no float64 op, no rebuild, host syncs equal to
   the CPU budget's and to the warnings of CUDA's sync debug mode "warn";
   ``fused_rao_solve`` (K1) held to the plain solve at 1e-5 and
   ``torch_bem_kernels`` (K3, K4) to ``torch_bem`` (the plain assembly) at
   ``INTERP_PARITY_RTOL``, each kernel's launches counted (the audit's
   launches, warming and measured calls, join the kernels line); each
   entry's ops, host syncs, launches and peak bytes printed; then the
   backward probe (``audit.backward_probe``): ``val_grad`` with a hook
   inside its backward, which autograd runs on its device thread, and the
   ops, host syncs and sync-debug warnings the audit sees from there;
26. bf16 assembly (``RAFT_TPU_BEM_PRECISION=bf16``): the bf16 entries of K3
   (VolturnUS-S, 1,024 class; OC4semi with its lid, 2,048) and K4 (every
   chunk of the 48-w staging) against their plain versions on the same
   bf16 inputs, elementwise within one bf16 step of the plain output plus
   ``TOL_BEM["float32"]`` max|plain| (two K3 calls the same bits), each
   timed against its f32 entry in turns with its bound; then the card's
   staging of the nominal hull with the bf16 assembly (its K3/K4 bf16
   launches counted) in turns with the f32 staging: A and B within 0.1 of
   it, F's gap and the gaps to native printed, the refinement residual
   below 1e-4;
27. BEM inputs: a WEIS-array design (``io/weis.py``) through the Model on
   the card against the CPU; a Capytaine dataset written from the card's
   panel solve of VolturnUS-S read back through ``Model(BEM=
   load_capytaine_nc(...))`` against ``Model(BEM=(A, B, F))``; a Nemoh mesh
   of that hull through ``nemoh_to_pnl``;
28. the CLI (``raft_tpu_torch.cli``): ``volturn --bem --json`` with
   ``RAFT_TPU_BEM=jax`` at full width (850 panels, 59 w), with the f32
   precision (the Model's BEM in float64) and with ``RAFT_TPU_BEM_PRECISION=
   bf16`` (float32, bf16 assembly), in process with K1/K3/K4 launches
   counted, the f32 run also in a subprocess on the default device, held
   against each other, the bf16-to-f32 gap printed; ``sweep``, ``dlc`` (with and
   without ``--bem``) and ``optimize`` at small counts, five subprocesses
   at once with ``--plot`` into a temporary directory (where matplotlib is
   not installed, ``--plot`` must exit non-zero naming it);
29. the cache slice: ``python -m raft_tpu_torch.cache smoke`` in a
   subprocess (two children on one fresh cache root holding only the wave
   tables phase 2 built: the second with
   staging disk hits and no miss, neither building a library, the second
   launching no K3/K4, the same bits, the ledger's K1 count the children's
   K1 launches); then, armed in process, 5 K1 launches at 250 x 200 float32
   timed by the ledger (best time within 0.5-2x of phase 3's, roofline
   fraction phase 3's bound over it) and one scan chunk of the strip sweep
   under CUDA's sync debug mode "error";
30. the smokes: the hetero smoke (``raft_tpu_torch.build.smoke``, the
   mixed stream of OC3spar, VolturnUS-S and OC4semi at 200 w through
   ``sweep_designs`` in two children on one root: solo parity 1e-5, the
   second child bit for bit the first, no build in either), the BEM smoke
   (``raft_tpu_torch.hydro.bem_smoke``: novel two-column meshes with
   ``g++`` poisoned, children on K3/K4 and on the plain assembly, each
   within ``PARITY_RTOL`` of the native oracle, the kernels within
   ``INTERP_PARITY_RTOL`` of the plain legs) and the obs smoke
   (``python -m raft_tpu_torch.obs --nw 200``: the JSONL log, the Chrome
   trace, the per-bucket histograms, the Prometheus file, overhead within
   2x), all three at once through ``evidence.run_step``, every check of
   their JSON held and their children's K1, K3 and K4 launches counted;
   beside them ``utils.torch_trace`` around one ``sweep_designs`` call,
   whose trace must hold K1's kernels and the phase's range;
31. panel-solve copies: one solve and the refined solve's backward under
   the profiler, no host-device copy and no synchronisation inside; one
   ``bem_fn`` step after a first under CUDA's sync debug mode, with every
   host-to-device copy counted;
32. the sweeps and one gradient chunk again under ``torch.profiler``: device
   busy time, idle share and the operations that take the device time; the
   same gradient chunk with the adjoint's transposed copies, profiled in the
   same call, must run at least 75 copy and negation kernels more (3
   copies x 25 adjoint launches; a second pair of profiles, counted by
   kernel).

Every BEM solve here passes ``cache=False`` (the CLI phase's runs each get
a result cache of their own in a temporary directory), so each phase runs
its solver and no result is read from an earlier run's cache.

``--phases a,b`` runs only the named phases (for debugging; the names are
those printed after ``==``).  The last lines are the kernels JSON record,
the nvidia-smi line and ``{"ok": true, "device": {...}}``.  A kernel's
``ms`` in the record is its mean device time between two events with the
host's time to enqueue the call left out (:meth:`Smoke.time_ms`);
``plain_ms`` and ``library_ms`` are timed the same way.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DESIGNS = ROOT / "raft_tpu" / "designs"

# device clock cycles of the spin queued before each timed call (about 1 ms)
SPIN_CYCLES = 2_000_000
TOL = {"float64": 1e-12, "float32": 1e-5}
# adjoint cotangents and co-design gradients, kernels against autograd
# through the plain elimination (float64): the JAX package's bound between
# its adjoint rule and its differentiated elimination (tests/test_pallas6.py)
TOL_GRAD = 1e-9
# central differences of the scan objective, h = 1e-4 (tests/test_optimize.py)
FD_H, FD_RTOL = 1e-4, 2e-3
# the BEM gradient: float64 against central differences of the float64 loss
# (h = 1e-5, as tests/test_jax_bem.py) with theta's branches held
# (tools/bem_grad_fd.py), and float32 against float64, at a radial scale off the
# unwarped hull, where some pairs sit exactly on a subdivision-level tie
BEM_THETA, BEM_FD_H, BEM_FD_RTOL, BEM_TOL_32 = 1.01, 1e-5, 1e-5, 1e-3
# the BEM gradient's float64 value and gradient through K1 against the same
# loss with the plain solve differentiated by autograd, same card and inputs
BEM_TOL_PLAIN = 1e-10
# K3 / K4 against their plain versions, scale-relative per output: f64 to
# roundoff; f32 at the JAX package's assembly-route bound INTERP_PARITY_RTOL
TOL_BEM = {"float64": {"rankine": 1e-12, "wave": 1e-10},
           "float32": {"rankine": 1e-4, "wave": 1e-4}}
# the lint audit's BEM entries, K3/K4 against the plain assembly in float32
# after the whole solve: the JAX package's assembly-route bound
# (raft_tpu/core/pallas_bem.py::INTERP_PARITY_RTOL)
INTERP_PARITY_RTOL = 1e-4
# the bf16 entries of K3/K4 against their plain versions on the same bf16
# inputs, elementwise: both compute in float32 (TOL_BEM["float32"] apart)
# and round once to bf16, so where their float32 results straddle a
# rounding boundary the two land one bf16 step apart, and a step is up to
# 2^-7 of the value (2^-8 is half a step, the rounding error of one side)
BF16_STEP = 2.0 ** -7
# the bf16 staging's A and B against the f32 staging: the JAX package's bound
# for its bf16 mode against its f32 (tests/test_bem_tiles.py)
BF16_PARITY = 0.1
# The kernels' work counts and the card's peaks live beside the kernels
# (core/cuda6.py::work, core/cuda_bem.py::k3_work and k4_work, the peaks
# in obs/ledger.py), so this script's bounds and the performance ledger
# count the same work.

#: ``python -c`` payload: the CLI's ``main`` on its arguments, then one JSON
#: line of what the process built, launched and found in its caches
CLI_PROBE = """
import json, sys
from raft_tpu_torch import cli
cli.main(sys.argv[1:])
from raft_tpu_torch.cache import aot, stats
from raft_tpu_torch.core import cuda6, cuda_bem
from raft_tpu_torch.hydro import native_bem
print(json.dumps({"compiles": aot.compile_count(),
                  "launches": {**cuda6.LAUNCHES, **cuda_bem.LAUNCHES},
                  "bem_results": dict(native_bem.CACHE_STATS),
                  "warm_start": stats.report()}))
"""


def k1_bound_ms(n_designs: int, nw: int, itemsize: int, dtype_name: str):
    """Least time of one K1 call on the card: each input read once, each
    output written once, against the operations at the type's peak."""
    from raft_tpu_torch.core import cuda6
    from raft_tpu_torch.obs import ledger

    w = cuda6.work(n_designs, nw, itemsize)
    t, by = ledger.bound_s(w["flops"], w["bytes_accessed"], "NVIDIA H100", dtype_name)
    return 1e3 * t, by


def k2_bound_ms(n: int, itemsize: int, dtype_name: str):
    """Least time of one K2 call: 96 values per system (A and b read, x
    written) against K1's operations less the 72 of the drag assembly."""
    from raft_tpu_torch.core import cuda6
    from raft_tpu_torch.obs import ledger

    w = cuda6.work(n, 1, itemsize, fused=False)
    t, by = ledger.bound_s(w["flops"], w["bytes_accessed"], "NVIDIA H100", dtype_name)
    return 1e3 * t, by


def k3_work(*args) -> dict:
    """:func:`raft_tpu_torch.core.cuda_bem.k3_work`."""
    from raft_tpu_torch.core import cuda_bem

    return cuda_bem.k3_work(*args)


def k4_work(*args) -> dict:
    """:func:`raft_tpu_torch.core.cuda_bem.k4_work`."""
    from raft_tpu_torch.core import cuda_bem

    return cuda_bem.k4_work(*args)


def write_capytaine_nc(path, w, A, B, F):
    """A Capytaine-layout classic NetCDF dataset: A, B (6, 6, nw) and the
    excitation F (6, nw) as the diffraction force, a zero Froude-Krylov
    force, one heading."""
    import warnings

    from scipy.io import netcdf_file

    dofs = ["Surge", "Sway", "Heave", "Roll", "Pitch", "Yaw"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f = netcdf_file(str(path), "w")
        f.createDimension("omega", len(w))
        for dim, size in (("radiating_dof", 6), ("influenced_dof", 6), ("wave_direction", 1),
                          ("complex", 2), ("string5", 5)):
            f.createDimension(dim, size)
        f.createVariable("omega", "d", ("omega",))[:] = w
        for name in ("radiating_dof", "influenced_dof"):
            v = f.createVariable(name, "c", (name, "string5"))
            for i, d in enumerate(dofs):
                v[i] = np.frombuffer(d.ljust(5)[:5].encode(), dtype="S1")
        for name, arr in (("added_mass", A), ("radiation_damping", B)):
            f.createVariable(name, "d", ("omega", "radiating_dof", "influenced_dof"))[:] = \
                np.asarray(arr).transpose(2, 0, 1)
        for name, arr in (("diffraction_force", F), ("Froude_Krylov_force", np.zeros_like(F))):
            v = f.createVariable(name, "d", ("complex", "omega", "wave_direction",
                                             "influenced_dof"))
            v[0] = np.asarray(arr).real.T[:, None, :]
            v[1] = np.asarray(arr).imag.T[:, None, :]
        f.close()


def write_nemoh_mesh(path, panels):
    """A Nemoh mesh file of (n, 4, 3) panels: one node per vertex."""
    verts = np.asarray(panels).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("2 0\n")
        for i, v in enumerate(verts, 1):
            f.write(f"{i} {v[0]:.9f} {v[1]:.9f} {v[2]:.9f}\n")
        f.write("0 0.0 0.0 0.0\n")
        for p in range(len(panels)):
            f.write(" ".join(str(4 * p + k + 1) for k in range(4)) + "\n")
        f.write("0 0 0 0\n")


def tie_systems(n: int, rng) -> np.ndarray:
    """(n, 6, 6) complex systems whose pivot search ties: at column 0 rows 0
    and 1 (the pivot row itself in the tie), at column 2 rows 3 and 5 (row
    2's entry is smaller).  In each pair one entry is the other with re and
    im swapped, so |.|^2 rounds to the same value when each product and sum
    rounds on its own, as in the plain version and the kernel.  Every row
    of the eliminated U keeps at most one entry right of its diagonal, so
    the back substitution's sums are exact in any order: the kernel must
    equal the plain version bit for bit, and a tie broken to the other
    row changes the bits of nearly every lane."""
    def cx():
        return rng.normal(size=n) + 1j * rng.normal(size=n)

    def swap(z):
        return z.imag + 1j * z.real

    A = np.zeros((n, 6, 6), complex)
    p, P = cx(), 2.0 * cx()
    A[:, 0, 0], A[:, 0, 1] = p, cx()
    A[:, 1, 0], A[:, 1, 1] = swap(p), cx()
    A[:, 2, 2], A[:, 2, 3] = 0.3 * P, cx()
    A[:, 3, 2], A[:, 3, 4] = P, cx()
    A[:, 4, 3] = 4.0 * (np.abs(A[:, 2, 3]) + 1.0) * np.exp(1j * rng.uniform(0.0, 2 * np.pi, n))
    A[:, 5, 2], A[:, 5, 5] = swap(P), cx()
    return A


def print_ptxas(name: str, log: str):
    """Registers and spills per kernel entry from a build's ptxas output,
    each entry labelled by its template arguments: the type, and for
    solve6 fused or plain and forward or adjoint."""
    import re

    kind = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"_kernelI(d|f|13__nv_bfloat16)(?:Lb([01])E)?(?:Lb([01])E)?", line)
            kind = "" if m is None else {"d": "f64", "f": "f32"}.get(m[1], "bf16")
            if m is not None and m[2] is not None:
                kind += (" fused" if m[2] == "1" else " plain") + (" adjoint" if m[3] == "1" else "")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name} {kind}: {line.split(':', 1)[-1].strip()}")


@contextlib.contextmanager
def plain_solve():
    """The fixed-point driver's K1 entries (``solve_rao``, ``solve_rao_ad``)
    swapped for the plain elimination (autograd differentiates it) while
    the block runs: the main path's inputs and shapes, no K1."""
    from raft_tpu_torch.core import linalg6
    from raft_tpu_torch.solve import dynamics

    orig = dynamics.solve_rao, dynamics.solve_rao_ad
    dynamics.solve_rao = dynamics.solve_rao_ad = linalg6.solve_cx_fused
    try:
        yield
    finally:
        dynamics.solve_rao, dynamics.solve_rao_ad = orig


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


class Smoke:
    # the north star's full width: the co-design phases run at these sizes
    n_designs, nw, chunk = 1000, 200, 250
    # the design-batch phases: variants of the variant sweep, designs of each
    # family in the mixed-design sweep, turbines on a side of the farm's grid
    n_variants, per_family, farm_side = 2048, 250, 4

    def __init__(self):
        import torch

        self.torch = torch
        self.failures: list[str] = []
        self.record: dict = {}
        self.records: dict = {}
        self.record_bem: dict = {}
        self.main_launches: dict = {}
        self.record_grad: dict = {}
        self.staged = None
        self.staged_std = None
        self.cli_cold = None                 # phase "CLI"'s f32 subprocess, cold
        self.cli_cold_root = None
        self.record_native: dict = {}
        self.native_coeffs = None
        self.native_staged = None
        self.record_batches: dict = {}
        self.record_bf16: dict = {}
        self.record_cli: dict = {}
        self.record_cache: dict = {}
        self.record_cache_ledger: dict = {}
        self.dlc_grid = None
        self.mixed_staged = None
        self._cases: dict = {}
        self.serve_child_rows = None
        self.dev = torch.device("cuda")
        self._flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=self.dev)

    # -------------------------------------------------------------- helpers

    def check(self, ok: bool, what: str):
        print(("  ok   " if ok else "  FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def time_ms(self, fn, reps: int = 20) -> float:
        """Mean device time of fn(), each call after an L2 flush (64 MB) and
        a device spin of SPIN_CYCLES queued ahead of the start event, so the
        host's time to enqueue fn() (its wrapper's checks, small setup ops)
        is not inside the interval and a short kernel is timed alone."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self._flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    # ---------------------------------------------------------------- phases

    def phase_build(self):
        from raft_tpu_torch.core import cuda6, cuda_bem, cuda_drag, nvcc
        from raft_tpu_torch.hydro import wavetable

        t0 = time.perf_counter()
        nvcc.compile_all([cuda6.SPEC, cuda_bem.RANKINE, cuda_bem.WAVE, cuda_drag.SPEC])
        cuda6.build()
        cuda_bem.build()
        cuda_drag.build()
        print(f"  K1/K2, K3, K4, K5 built in {time.perf_counter() - t0:.2f} s (one nvcc each, in "
              f"parallel)")
        for spec in (cuda6.SPEC, cuda_bem.RANKINE, cuda_bem.WAVE, cuda_drag.SPEC):
            log = nvcc.build_log(spec)
            if log is None:
                print(f"  ptxas {spec.name}: no log beside {spec.path().name}")
            else:
                print_ptxas(spec.name, log)
        t0 = time.perf_counter()
        tab = wavetable.load_tables()
        print(f"  wave tables {tab['I0'].shape} ready in {time.perf_counter() - t0:.2f} s "
              f"(built, or loaded from the cache root's wavetable/)")

    def _k1_inputs(self, case: str, B: int, nw: int, dtype, rng):
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        w = np.linspace(0.05, 2.95, nw)
        if case == "random":
            Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
            Zi = rng.normal(size=(B, nw, 6, 6))
            Bd = 0.1 * rng.normal(size=(B, 6, 6))
        elif case == "permutation":
            P = np.zeros((6, 6))
            P[np.arange(6), (np.arange(6) + 1) % 6] = 1.0
            Zr = np.broadcast_to(P, (B, nw, 6, 6)).copy()
            Zi = np.zeros((B, nw, 6, 6))
            Bd = rng.normal(size=(B, 6, 6))
            w = np.zeros(nw)
        elif case == "pivot-tie":
            Z = tie_systems(B * nw, rng).reshape(B, nw, 6, 6)
            Zr, Zi = Z.real, Z.imag
            Bd = rng.normal(size=(B, 6, 6))
            w = np.zeros(nw)
        else:  # singular: lane (0, 0) is diag(1, 1, 0, 1, 1, 1) at w = 0
            Zr = rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6)
            Zi = rng.normal(size=(B, nw, 6, 6))
            Zr[0, 0] = np.diag([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
            Zi[0, 0] = 0.0
            Bd = 0.1 * rng.normal(size=(B, 6, 6))
            w[0] = 0.0
        Fr = rng.normal(size=(B, nw, 6))
        Fi = rng.normal(size=(B, nw, 6))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.dev).to(dtype)

        return Cx(t(Zr), t(Zi)), t(w), t(Bd), Cx(t(Fr), t(Fi))

    def phase_k1(self):
        from raft_tpu_torch.core import cuda6, linalg6
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        rng = np.random.default_rng(20261016)
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            for B in (1000, 250):
                nw = 200
                worst = 0.0
                worst_abs = 0.0
                for case in ("random", "permutation", "singular", "pivot-tie"):
                    Z0, w, Bd, F = self._k1_inputs(case, B, nw, dtype, rng)
                    xk = cuda6.solve_rao(Z0, w, Bd, F)
                    xp = linalg6.solve_cx_fused(Z0, w, Bd, F)
                    torch.cuda.synchronize()
                    diff = max(float((xk.re - xp.re).abs().max()),
                               float((xk.im - xp.im).abs().max()))
                    scale = max(float(xp.re.abs().max()), float(xp.im.abs().max()))
                    finite = bool(torch.isfinite(xk.re).all() and torch.isfinite(xk.im).all())
                    rel = diff / scale
                    worst, worst_abs = max(worst, rel), max(worst_abs, diff)
                    self.check(finite and rel <= TOL[name],
                               f"K1 {name} {B}x{nw} {case}: scale-relative diff "
                               f"{rel:.3e} (limit {TOL[name]:.0e})")
                    if case == "permutation":
                        # P x = F exactly: x_{(i+1) % 6} = F_i
                        want_r = torch.roll(F.re, 1, dims=-1)
                        self.check(bool((xk.re == want_r).all()),
                                   f"K1 {name} {B}x{nw} permutation solved exactly")
                    if case == "singular":
                        self.check(float(xk.re[0, 0, 2]) == 0.0 and float(xk.im[0, 0, 2]) == 0.0,
                                   f"K1 {name} {B}x{nw} singular lane takes the "
                                   f"zero-denominator guard")
                    if case == "pivot-tie":
                        same = bool(torch.equal(xk.re, xp.re) and torch.equal(xk.im, xp.im))
                        if name == "float64":
                            self.check(same, f"K1 float64 {B}x{nw} pivot-tie batch: kernel == "
                                       f"plain bit for bit (the lowest row wins the tie)")
                        else:
                            print(f"  K1 float32 {B}x{nw} pivot-tie batch bit for bit: {same}")
                    # the adjoint mode reads Z0^H and -B_drag^T in place: the
                    # same bits as the forward mode on materialized transposes
                    lam = cuda6.solve_rao_adjoint(Z0, w, Bd, F)
                    ZH = Cx(Z0.re.transpose(-1, -2).contiguous(),
                            (-Z0.im.transpose(-1, -2)).contiguous())
                    lam_m = cuda6.solve_rao(ZH, w, (-Bd.transpose(-1, -2)).contiguous(), F)
                    torch.cuda.synchronize()
                    self.check(bool(torch.equal(lam.re, lam_m.re) and torch.equal(lam.im, lam_m.im)),
                               f"K1 {name} {B}x{nw} {case}: adjoint mode == forward mode on the "
                               f"materialized Z0^H, -B_drag^T (bit for bit)")
                Z0, w, Bd, F = self._k1_inputs("random", B, nw, dtype, rng)
                Zc = torch.complex(Z0.re, Z0.im + w[:, None, None] * Bd[:, None])
                Fc = torch.complex(F.re, F.im)[..., None]
                ms = self.time_ms(lambda: cuda6.solve_rao(Z0, w, Bd, F))
                plain_ms = self.time_ms(lambda: linalg6.solve_cx_fused(Z0, w, Bd, F), reps=5)
                lib_ms = self.time_ms(lambda: torch.linalg.solve(Zc, Fc), reps=5)
                bound, by = k1_bound_ms(B, nw, torch.finfo(dtype).bits // 8, name)
                print(f"  K1 {name} {B}x{nw}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"torch.linalg.solve {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
                      f"max scale-rel diff {worst:.3e}, max abs diff {worst_abs:.3e}")
                if name == "float32" and B == 250:   # the sweep's call shape
                    self.record = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

    def _k5_inputs(self, kind: str, design: str, L: int, nw: int, dtype, rng):
        """One solve's drag inputs as ``solve_dynamics`` gets them:
        ``(plan, Xi, (members, kin, wave, env))`` for ``L`` seeded diameter
        variants (``variants``), ``L`` sea states of one design (``sea``:
        the kinematics carry the lanes, the nodes do not) or ``L`` lanes of
        one design's kinematics (``shared``: lane stride 0)."""
        import dataclasses

        from raft_tpu_torch.core import cuda_drag
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.hydro import strip
        from raft_tpu_torch.model import stage_design_base
        from raft_tpu_torch.parallel.sweep import _apply_lanes, make_wave_states, scale_diameters

        torch = self.torch
        _, m, _, env, wave, _ = stage_design_base(str(DESIGNS / f"{design}.yaml"), nw=nw, Hs=8.0,
                                                  Tp=12.0, w_min=0.05, w_max=2.95,
                                                  with_mooring=False, dtype=dtype,
                                                  device=self.dev)
        if kind == "variants":
            th = torch.as_tensor(rng.uniform(0.9, 1.1, L), dtype=dtype, device=self.dev)
            m = _apply_lanes(scale_diameters, m, th)
        elif kind == "sea":
            rows = np.stack([rng.uniform(2.0, 10.0, L), rng.uniform(6.0, 16.0, L),
                             rng.uniform(-0.5, 0.5, L)], axis=1)
            waves = make_wave_states(wave.w.cpu().numpy(), rows, float(env.depth), dtype=dtype,
                                     device=self.dev)
            wave = dataclasses.replace(waves, w=waves.w[0], k=waves.k[0])
            env = dataclasses.replace(env, beta=waves.beta)
        kin = strip.node_kinematics(m, wave, env)
        shape = (L, nw, 6)
        Xi = Cx(torch.as_tensor(0.3 * rng.normal(size=shape), dtype=dtype, device=self.dev),
                torch.as_tensor(0.3 * rng.normal(size=shape), dtype=dtype, device=self.dev))
        p = cuda_drag.plan(strip.drag_coeffs(m, env), kin.u, wave.w, (L,))
        return p, Xi, (m, kin, wave, env)

    def phase_k5(self):
        from raft_tpu_torch.core import cuda_drag
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.hydro import strip
        from raft_tpu_torch.obs import ledger

        torch = self.torch
        rng = np.random.default_rng(20261019)
        cases = (("OC3spar", "variants", 2048, 200, torch.float32),
                 ("VolturnUS-S", "variants", 250, 200, torch.float32),
                 ("VolturnUS-S", "sea", 8, 100, torch.float64),
                 ("OC4semi", "shared", 8, 100, torch.float64))
        for design, kind, L, nw, dtype in cases:
            name = str(dtype).split(".")[-1]
            label = f"K5 {name} {design} {kind} {L} x {nw}"
            p, Xi, (m, kin, wave, env) = self._k5_inputs(kind, design, L, nw, dtype, rng)
            n0 = cuda_drag.LAUNCHES["step"]
            B, F = cuda_drag.drag_step(p, Xi)
            B2, F2 = cuda_drag.drag_step(p, Xi)
            Bp, Fp = cuda_drag.drag_step_plain(p, Xi)
            Be, Fe = strip.linearized_drag(m, kin, Xi, wave, env)
            torch.cuda.synchronize()
            launched = cuda_drag.LAUNCHES["step"] - n0

            def rel(got, want):
                return (float(max((g - w).abs().max() for g, w in zip(got, want)))
                        / float(max(w.abs().max() for w in want)))

            out, plain, eager = (B, F.re, F.im), (Bp, Fp.re, Fp.im), (Be, Fe.re, Fe.im)
            d, d_eager = rel(out, plain), rel(out, eager)
            worst_abs = float(max((g - w).abs().max() for g, w in zip(out, plain)))
            finite = all(bool(torch.isfinite(t).all()) for t in out)
            same = all(torch.equal(a, b) for a, b in zip(out, (B2, F2.re, F2.im)))
            n_sub = round(float(p.coef[..., 0].sum()) / p.coef.shape[0])
            self.check(finite and d <= TOL[name] and launched == 2,
                       f"{label} ({n_sub} of {p.coef.shape[1]} nodes submerged): scale-relative "
                       f"diff to the plain version {d:.3e} (limit {TOL[name]:.0e}), one launch "
                       f"a call; against the eager linearized_drag {d_eager:.3e}")
            self.check(same, f"{label}: two launches give the same bits")
            ms = self.time_ms(lambda: cuda_drag.drag_step(p, Xi))
            plain_ms = self.time_ms(lambda: cuda_drag.drag_step_plain(p, Xi), reps=5)
            eager_ms = self.time_ms(lambda: strip.linearized_drag(m, kin, Xi, wave, env), reps=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                cuda_drag.drag_step(p, Xi)
            host_us = 1e6 * (time.perf_counter() - t0) / 100
            torch.cuda.synchronize()
            w = cuda_drag.work(L, n_sub, nw, torch.finfo(dtype).bits // 8, p.coef.shape[1],
                               kin_lanes=p.u.re.shape[0], coef_lanes=p.coef.shape[0])
            t_b, by = ledger.bound_s(w["flops"], w["bytes_accessed"], "NVIDIA H100", name)
            print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, eager "
                  f"linearized_drag {eager_ms:.4f} ms, bound {1e3 * t_b:.4f} ms ({by}, "
                  f"{w['bytes_accessed'] / 1e6:.1f} MB); wrapper {host_us:.1f} us of host a "
                  f"call; max abs diff {worst_abs:.3e}")
            if design == "OC3spar":                 # the wide sweep's call shape
                self.records["drag"] = {"max_abs_err": worst_abs, "ms": ms,
                                        "plain_ms": plain_ms, "bound_ms": 1e3 * t_b,
                                        "bound_by": by, "library_ms": None}
            del p, Xi, m, kin, B, F, B2, F2, Bp, Fp, Be, Fe

    def _k2_inputs(self, case: str, n: int, dtype, rng):
        """``bench.py::pallas6_microbench``'s systems (diagonally dominant:
        A.re = N(0, 1) + 8 I, A.im = 0.3 N(0, 1)), a permutation batch, or
        the microbench's systems with one singular lane."""
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        if case == "permutation":
            P = np.zeros((6, 6))
            P[np.arange(6), (np.arange(6) + 1) % 6] = 1.0
            Ar = np.broadcast_to(P, (n, 6, 6)).copy()
            Ai = np.zeros((n, 6, 6))
        elif case == "pivot-tie":
            A = tie_systems(n, rng)
            Ar, Ai = A.real, A.imag
        else:
            Ar = rng.normal(size=(n, 6, 6)) + 8.0 * np.eye(6)
            Ai = 0.3 * rng.normal(size=(n, 6, 6))
            if case == "singular":          # lane 0: diag(1, 1, 0, 1, 1, 1)
                Ar[0] = np.diag([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
                Ai[0] = 0.0

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.dev).to(dtype)

        return Cx(t(Ar), t(Ai)), Cx(t(rng.normal(size=(n, 6))), t(rng.normal(size=(n, 6))))

    def phase_k2(self):
        from raft_tpu_torch.core import cuda6, linalg6
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        rng = np.random.default_rng(20261017)
        n = 16384
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            worst, worst_abs = 0.0, 0.0
            for case in ("random", "permutation", "singular", "pivot-tie"):
                A, b = self._k2_inputs(case, n, dtype, rng)
                xk = cuda6.solve_cx(A, b)
                xp = linalg6.solve_cx(A, b)
                torch.cuda.synchronize()
                diff = max(float((xk.re - xp.re).abs().max()), float((xk.im - xp.im).abs().max()))
                scale = max(float(xp.re.abs().max()), float(xp.im.abs().max()))
                finite = bool(torch.isfinite(xk.re).all() and torch.isfinite(xk.im).all())
                worst, worst_abs = max(worst, diff / scale), max(worst_abs, diff)
                self.check(finite and diff / scale <= TOL[name],
                           f"K2 {name} {n} {case}: scale-relative diff {diff / scale:.3e} "
                           f"(limit {TOL[name]:.0e})")
                if case == "permutation":
                    self.check(bool((xk.re == torch.roll(b.re, 1, dims=-1)).all()),
                               f"K2 {name} {n} permutation solved exactly")
                if case == "singular":
                    self.check(float(xk.re[0, 2]) == 0.0 and float(xk.im[0, 2]) == 0.0,
                               f"K2 {name} singular lane takes the zero-denominator guard")
                if case == "pivot-tie":
                    same = bool(torch.equal(xk.re, xp.re) and torch.equal(xk.im, xp.im))
                    if name == "float64":
                        self.check(same, f"K2 float64 {n} pivot-tie batch: kernel == plain bit "
                                   f"for bit (the lowest row wins the tie)")
                    else:
                        print(f"  K2 float32 {n} pivot-tie batch bit for bit: {same}")
                lam = cuda6.solve_cx_adjoint(A, b)
                AH = Cx(A.re.transpose(-1, -2).contiguous(), (-A.im.transpose(-1, -2)).contiguous())
                lam_m = cuda6.solve_cx(AH, b)
                torch.cuda.synchronize()
                self.check(bool(torch.equal(lam.re, lam_m.re) and torch.equal(lam.im, lam_m.im)),
                           f"K2 {name} {n} {case}: adjoint mode == forward mode on the "
                           f"materialized A^H (bit for bit)")
            A, b = self._k2_inputs("random", n, dtype, rng)
            Ac = torch.complex(A.re, A.im)
            bc = torch.complex(b.re, b.im)[..., None]
            ms = self.time_ms(lambda: cuda6.solve_cx(A, b))
            plain_ms = self.time_ms(lambda: linalg6.solve_cx(A, b), reps=5)
            lib_ms = self.time_ms(lambda: torch.linalg.solve(Ac, bc), reps=5)
            bound, by = k2_bound_ms(n, torch.finfo(dtype).bits // 8, name)
            print(f"  K2 {name} {n} systems: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.linalg.solve ({Ac.dtype}) {lib_ms:.4f} ms, bound {bound:.5f} ms "
                  f"({by}); max scale-rel diff {worst:.3e}, max abs diff {worst_abs:.3e}")
            if name == "float32":               # the microbench's shape
                self.records["plain"] = {"max_abs_err": worst_abs, "ms": ms,
                                         "plain_ms": plain_ms, "bound_ms": bound,
                                         "bound_by": by, "library_ms": lib_ms}

    def phase_k2_microbench(self):
        """K2's path: ``bench.py::pallas6_microbench`` on the port -- the
        16,384 solves in float32 through ``cuda6.solve_cx`` against the plain
        elimination, best of 5 on the host clock."""
        from raft_tpu_torch.core import cuda6, linalg6

        torch = self.torch
        A, b = self._k2_inputs("random", 16384, torch.float32, np.random.default_rng(0))
        best = {}
        self.zero_counts()
        for label, fn in (("kernel", cuda6.solve_cx), ("plain", linalg6.solve_cx)):
            x = fn(A, b)
            torch.cuda.synchronize()
            t_best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                x = fn(A, b)
                torch.cuda.synchronize()
                t_best = min(t_best, time.perf_counter() - t0)
            best[label] = (t_best, x)
        launches = self.counts()
        self.add_main(launches, ("plain",))
        xk, xp = best["kernel"][1], best["plain"][1]
        err = float((xk.re - xp.re).abs().max() + (xk.im - xp.im).abs().max())
        print(f"  microbench 16384 x 6x6 float32: kernel {1e3 * best['kernel'][0]:.4f} ms, "
              f"plain {1e3 * best['plain'][0]:.4f} ms (best of 5, host clock), speedup "
              f"{best['plain'][0] / best['kernel'][0]:.1f}x, max abs diff {err:.3e}; "
              f"launches {launches}")
        self.check(launches["plain"] == 6 and launches["fused"] == 0 and err <= 1e-4,
                   "microbench: K2 launched 6 times, agrees with the plain solve")

    def _adjoint_case(self, fn, arrays):
        """Cotangents of the asymmetric loss sum(xr^2 + 0.7 xi^2 + 0.3 xr xi)
        through ``fn``."""
        torch = self.torch
        ts = [a.clone().requires_grad_(True) for a in arrays]
        x = fn(*ts)
        loss = (x.re**2 + 0.7 * x.im**2 + 0.3 * x.re * x.im).sum()
        return torch.autograd.grad(loss, ts)

    def phase_adjoint(self):
        from raft_tpu_torch.core import cuda6, linalg6
        from raft_tpu_torch.core.cplx import Cx

        torch = self.torch
        rng = np.random.default_rng(20261018)
        Z0, w, Bd, F = self._k1_inputs("random", 250, 200, torch.float64, rng)
        arrays = (Z0.re, Z0.im, w, Bd, F.re, F.im)
        self.zero_counts()
        got = self._adjoint_case(lambda zr, zi, w, bd, fr, fi: cuda6.solve_rao_ad(
            Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
        n_rao = self.counts()
        ref = self._adjoint_case(lambda zr, zi, w, bd, fr, fi: linalg6.solve_cx_fused(
            Cx(zr, zi), w, bd, Cx(fr, fi)), arrays)
        errs = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
        print(f"  solve_rao_ad float64 250x200: cotangent scale-rel diffs (Z0.re, Z0.im, w, "
              f"B_drag, F.re, F.im) {', '.join(f'{e:.2e}' for e in errs)}; launches {n_rao}")
        self.check(max(errs) <= TOL_GRAD and n_rao["fused"] == 1 and n_rao["fused_adjoint"] == 1,
                   f"K1 adjoint == autograd through the plain elimination ({TOL_GRAD:.0e}), "
                   f"one forward and one adjoint launch")
        A = Cx(Z0.re.reshape(-1, 6, 6), (Z0.im + w[:, None, None] * Bd[:, None]).reshape(-1, 6, 6))
        b = Cx(F.re.reshape(-1, 6), F.im.reshape(-1, 6))
        arrays = (A.re, A.im, b.re, b.im)
        self.zero_counts()
        got = self._adjoint_case(lambda ar, ai, br, bi: cuda6.solve_cx_ad(Cx(ar, ai), Cx(br, bi)),
                                 arrays)
        n_cx = self.counts()
        ref = self._adjoint_case(lambda ar, ai, br, bi: linalg6.solve_cx(Cx(ar, ai), Cx(br, bi)),
                                 arrays)
        errs = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
        print(f"  solve_cx_ad float64 50000 systems: cotangent scale-rel diffs (A.re, A.im, b.re, "
              f"b.im) {', '.join(f'{e:.2e}' for e in errs)}; launches {n_cx}")
        self.check(max(errs) <= TOL_GRAD and n_cx["plain"] == 1 and n_cx["plain_adjoint"] == 1,
                   f"K2 adjoint == autograd through the plain elimination ({TOL_GRAD:.0e}), "
                   f"one forward and one adjoint launch")

    def _bem_case(self, name: str, lid: bool, dtype):
        """A shipped design's panel mesh (dz_max 3, da_max 2), padded, and
        its geometry on the card: the K3 arguments."""
        from raft_tpu_torch.hydro import mesh, torch_bem
        from raft_tpu_torch.model import load_design

        key = (name, lid, dtype)
        if key not in self._cases:
            torch = self.torch
            design = load_design(DESIGNS / f"{name}.yaml")
            hull = mesh.mesh_design(design, dz_max=3.0, da_max=2.0)
            lid_p = mesh.mesh_lid(design, da_max=2.0) if lid else None
            padded, pm, lm = torch_bem.pad_mesh(hull, lid_p)

            def t(a):
                return torch.as_tensor(a, device=self.dev).to(dtype)

            P, pmt, lmt = t(padded), t(pm), t(lm)
            c, nrm, area, diag = torch_bem.panel_geometry(P)
            ls = (lmt > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
            spot = torch_bem.self_potential(P, c, nrm)
            self._cases[key] = {
                "args": (P, c, nrm, area, diag, pmt, ls, spot), "n": len(padded),
                "quad": torch_bem.stage_quad(dtype, self.dev),
                "label": f"{name}{' + lid' if lid else ''} ({len(hull)} hull + "
                         f"{0 if lid_p is None else len(lid_p)} lid -> {len(padded)})",
                "depth": float(design["mooring"]["water_depth"])}
        return self._cases[key]

    def _errs(self, got, ref):
        """(largest scale-relative, largest absolute) difference over outputs."""
        rel = max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
                  for g, r in zip(got, ref))
        return rel, max(float((g - r).abs().max()) for g, r in zip(got, ref))

    def phase_k3(self):
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem

        torch = self.torch
        for name, lid in (("VolturnUS-S", False), ("OC4semi", True)):
            for dtype in (torch.float64, torch.float32):
                dn = str(dtype).split(".")[-1]
                case = self._bem_case(name, lid, dtype)
                args = case["args"]
                quad = case["quad"]
                near = torch.zeros(1, dtype=torch.int32, device=self.dev)
                got = cuda_bem.rankine_assembly(*args, quad=quad, near_count=near)
                again = cuda_bem.rankine_assembly(*args, quad=quad)
                ref = torch_bem.rankine_plain(*args, quad=quad)
                torch.cuda.synchronize()
                rel, ab = self._errs(got, ref)
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                lim = TOL_BEM[dn]["rankine"]
                self.check(finite and rel <= lim, f"K3 {dn} {case['label']}: scale-relative "
                           f"diff {rel:.3e} (limit {lim:.0e})")
                wk = k3_work(args[1], args[4], args[5], args[6], torch.finfo(dtype).bits // 8, dn)
                same = all(torch.equal(g, h) for g, h in zip(got, again))
                self.check(same and int(near.item()) == wk["near_pairs"],
                           f"K3 {dn} n={case['n']}: two calls give the same bits ({same}); "
                           f"the near pass took {int(near.item())} pairs, pair_levels has "
                           f"{wk['near_pairs']} with a level of 36 or more points")
                ms = self.time_ms(lambda: cuda_bem.rankine_assembly(*args, quad=quad))
                plain_ms = self.time_ms(lambda: torch_bem.rankine_plain(*args, quad=quad), reps=2)
                print(f"  K3 {dn} n={case['n']}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                      f"bound {wk['bound_ms']:.4f} ms ({wk['bound_by']}; {wk['mflop']:.1f} MFLOP); "
                      f"{wk['per_pair']:.2f} contributions per pair, {wk['near_share']:.3f} of "
                      f"them in near pairs; pairs per level (ns 1/3/6/12[/24]) direct "
                      f"{wk['hist']['direct']}, image {wk['hist']['image']}; max abs diff "
                      f"{ab:.3e}")
                if name == "VolturnUS-S" and dtype == torch.float64:   # the staging's call
                    self.records["rankine"] = {"max_abs_err": ab, "ms": ms, "plain_ms": plain_ms,
                                               "bound_ms": wk["bound_ms"],
                                               "bound_by": wk["bound_by"], "library_ms": None}
                    self._k3_alone(args, quad)

    def _k3_alone(self, args, quad):
        """One wrapper call under the profiler: its one device operation is
        K3's kernel (no copy, no cast), and it makes no copy and no stream
        synchronisation on the host side either."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from raft_tpu_torch.core import cuda_bem

        torch = self.torch
        cuda_bem.rankine_assembly(*args, quad=quad)        # outputs' memory is cached now
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cuda_bem.rankine_assembly(*args, quad=quad)
            torch.cuda.synchronize()
        events = prof.events()
        device = [e.name for e in events if e.device_type == DeviceType.CUDA]
        host = sorted({e.name for e in events if e.device_type != DeviceType.CUDA})
        bad = [h for h in host if any(part in h for part in (
            "Memcpy", "Memset", "StreamSynchronize", "EventSynchronize", "aten::copy_",
            "aten::_to_copy"))]
        print(f"  K3 one wrapper call under the profiler: device operations {device}; host "
              f"events {host}")
        self.check(len(device) == 1 and "rankine_kernel" in device[0] and not bad,
                   f"K3's wrapper runs its kernel alone: {len(device)} device operation(s), "
                   f"no copy, cast or stream synchronisation ({bad or 'none'})")

    def phase_k4(self):
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem, wavetable

        torch = self.torch
        tab = wavetable.load_tables()
        for name, lid in (("VolturnUS-S", False), ("OC4semi", True)):
            for dtype in (torch.float64, torch.float32):
                dn = str(dtype).split(".")[-1]
                case = self._bem_case(name, lid, dtype)
                P, c, nrm, area, diag, pm, ls, spot = case["args"]
                R_pot, R_dn = torch_bem.rankine_plain(*case["args"], quad=case["quad"])
                tabd = torch_bem.stage_tables(tab, dtype, self.dev)
                nf = torch_bem.freq_chunk(case["n"], 48)
                depth = case["depth"]
                for label, w0 in (("deep", 1.5), ("finite-depth", 0.4)):
                    ws = w0 + 0.02 * np.arange(nf)
                    fd_np = wavetable.fd_fit_grid(ws, depth, 9.81)
                    want_active = 1.0 if label == "finite-depth" else 0.0
                    if not (fd_np["active"] == want_active).all():
                        self.check(False, f"K4 {label} chunk {ws} has active {fd_np['active']}")
                        continue
                    fd = {k: torch.as_tensor(v, device=self.dev).to(dtype) for k, v in fd_np.items()}
                    k = torch.as_tensor(ws * ws / 9.81, device=self.dev).to(dtype)
                    wargs = (R_pot, R_dn, c, nrm, area, pm, ls, tabd, k, fd)
                    kw = {"finite_depth": True, "depth": depth}
                    got = cuda_bem.wave_assembly(*wargs, **kw)
                    ref = torch_bem.wave_plain(*wargs, **kw)
                    torch.cuda.synchronize()
                    rel, ab = self._errs(got, ref)
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    lim = TOL_BEM[dn]["wave"]
                    self.check(finite and rel <= lim, f"K4 {dn} {case['label']} {label} "
                               f"{nf} x w: scale-relative diff {rel:.3e} (limit {lim:.0e})")
                    ms = self.time_ms(lambda: cuda_bem.wave_assembly(*wargs, **kw))
                    plain_ms = self.time_ms(lambda: torch_bem.wave_plain(*wargs, **kw), reps=2)
                    wk = k4_work(c, area, ls, k, fd, depth, torch.finfo(dtype).bits // 8, dn)
                    print(f"  K4 {dn} n={case['n']} {label} ({nf} x w from {w0}): kernel "
                          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {wk['bound_ms']:.4f} ms "
                          f"({wk['bound_by']}; operations {wk['ops_ms']:.4f} ms, bytes "
                          f"{wk['bytes_ms']:.4f} ms); max abs diff {ab:.3e}")
        self._k4_main_path()
        self._unaligned(tab)

    def _unaligned(self, tab):
        """K3 and K4 at a panel count off the 64-panel classes (the
        VolturnUS-S hull unpadded, 850 panels): the kernels guard the edge
        of the pair grid, and solve_panels launches them at any count."""
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem, wavetable

        torch = self.torch
        case = self._bem_case("VolturnUS-S", False, torch.float64)
        n = int(case["args"][5].sum())
        args = tuple(a[:n] for a in case["args"])
        got = cuda_bem.rankine_assembly(*args, quad=case["quad"])
        ref = torch_bem.rankine_plain(*args, quad=case["quad"])
        rel_r, _ = self._errs(got, ref)
        ws = 0.4 + 0.02 * np.arange(2)
        fd = {k: torch.as_tensor(v, device=self.dev) for k, v in
              wavetable.fd_fit_grid(ws, case["depth"], 9.81).items()}
        k = torch.as_tensor(ws * ws / 9.81, device=self.dev)
        P, c, nrm, area, diag, pm, ls, spot = args
        wargs = (ref[0], ref[1], c, nrm, area, pm, ls,
                 torch_bem.stage_tables(tab, torch.float64, self.dev), k, fd)
        kw = {"finite_depth": True, "depth": case["depth"]}
        rel_w, _ = self._errs(cuda_bem.wave_assembly(*wargs, **kw),
                              torch_bem.wave_plain(*wargs, **kw))
        self.check(n % 64 != 0 and rel_r <= TOL_BEM["float64"]["rankine"]
                   and rel_w <= TOL_BEM["float64"]["wave"],
                   f"K3/K4 float64 at an unaligned count n={n}: scale-relative diff "
                   f"{rel_r:.3e} / {rel_w:.3e}")

    def _staging_chunks(self, dtype):
        """The north star's staging calls of K4 (VolturnUS-S, 1,024 class,
        48 w in 200 m): (inputs, keywords, w of the chunk) per chunk."""
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem, wavetable

        torch = self.torch
        case = self._bem_case("VolturnUS-S", False, dtype)
        P, c, nrm, area, diag, pm, ls, spot = case["args"]
        R_pot, R_dn = cuda_bem.rankine_assembly(*case["args"], quad=case["quad"])
        tabd = torch_bem.stage_tables(wavetable.load_tables(), dtype, self.dev)
        w = np.linspace(0.05, 2.95, 48)
        nf = torch_bem.freq_chunk(case["n"], len(w))
        fd_all = wavetable.fd_fit_grid(w, case["depth"], 9.81)
        kw = {"finite_depth": True, "depth": case["depth"]}
        chunks = []
        for lo in range(0, len(w), nf):
            sl = slice(lo, lo + nf)
            fd = {k: torch.as_tensor(v[sl], device=self.dev).to(dtype) for k, v in fd_all.items()}
            k = torch.as_tensor(w[sl] ** 2 / 9.81, device=self.dev).to(dtype)
            chunks.append(((R_pot, R_dn, c, nrm, area, pm, ls, tabd, k, fd), kw, w[sl]))
        return chunks

    def _k4_main_path(self):
        """K4 at the main path's calls: every chunk of the north star's
        staging (VolturnUS-S, 1,024 class, 48 w, 200 m, float64), one line
        per chunk with its pairs' regions."""
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem

        dtype = self.torch.float64
        depth = self._bem_case("VolturnUS-S", False, dtype)["depth"]
        ms, plain_ms, bound, t_ops, t_bytes, rel, ab, n_fd = [], [], [], 0.0, 0.0, 0.0, 0.0, 0
        for idx, (wargs, kw, wc) in enumerate(self._staging_chunks(dtype)):
            got = cuda_bem.wave_assembly(*wargs, **kw)
            ref = torch_bem.wave_plain(*wargs, **kw)
            r, a = self._errs(got, ref)
            rel, ab = max(rel, r), max(ab, a)
            ms.append(self.time_ms(lambda: cuda_bem.wave_assembly(*wargs, **kw), reps=5))
            plain_ms.append(self.time_ms(lambda: torch_bem.wave_plain(*wargs, **kw), reps=1))
            c, area, ls, k, fd = wargs[2], wargs[4], wargs[6], wargs[8], wargs[9]
            wk = k4_work(c, area, ls, k, fd, depth, 8, "float64")
            bound.append(wk["bound_ms"])
            t_ops, t_bytes = t_ops + wk["ops_ms"], t_bytes + wk["bytes_ms"]
            act = fd["active"].cpu().numpy()
            n_fd += int(act.sum())
            kind = "finite depth" if act.all() else ("deep" if not act.any() else "mixed")
            tot = sum(wk["regions"].values())
            shares = ", ".join(f"{key} {v / tot:.3f}" for key, v in wk["regions"].items())
            print(f"  K4 staging chunk {idx:2d}: w {wc[0]:.4f}-{wc[-1]:.4f} rad/s, {kind}; image "
                  f"evaluations {tot} ({shares}); kernel {ms[-1]:.4f} ms, bound "
                  f"{wk['bound_ms']:.4f} ms ({wk['bound_by']}), {ms[-1] / wk['bound_ms']:.1f}x; "
                  f"scale-rel diff {r:.2e}")
        lim = TOL_BEM["float64"]["wave"]
        self.check(rel <= lim, f"K4 float64 on all {len(ms)} staging chunks: scale-relative "
                   f"diff {rel:.3e} (limit {lim:.0e})")
        print(f"  K4 float64 staging grid ({len(ms)} chunks, {n_fd} of 48 w finite depth): "
              f"kernel {np.mean(ms):.4f} ms per chunk (min {min(ms):.4f}, max {max(ms):.4f}), "
              f"plain {np.mean(plain_ms):.2f} ms, bound {np.mean(bound):.4f} ms (operations "
              f"{t_ops / len(ms):.4f}, bytes {t_bytes / len(ms):.4f}); max abs diff {ab:.3e}")
        self.records["wave"] = {"max_abs_err": ab, "ms": float(np.mean(ms)),
                                "plain_ms": float(np.mean(plain_ms)),
                                "bound_ms": float(np.mean(bound)),
                                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                                "library_ms": None}

    def phase_run_raft(self):
        from raft_tpu_torch.model import run_raft

        torch = self.torch
        for d in ("OC3spar", "OC4semi", "VolturnUS-S"):
            path = DESIGNS / f"{d}.yaml"
            self.zero_counts()
            t0 = time.perf_counter()
            rg = run_raft(path, dtype=torch.float64, device="cuda")
            t_gpu = time.perf_counter() - t0
            grew = self.counts()["fused"]
            t0 = time.perf_counter()
            rc = run_raft(path, dtype=torch.float64, device="cpu")
            t_cpu = time.perf_counter() - t0
            fg, fc = rg["eigen"]["frequencies"], rc["eigen"]["frequencies"]
            sg, sc = rg["response"]["std dev"], rc["response"]["std dev"]
            d_f = float(np.max(np.abs(fg - fc) / np.abs(fc)))
            d_s = float(np.max(np.abs(sg - sc)) / np.max(np.abs(sc)))
            ig, ic = rg["response"]["iterations"], rc["response"]["iterations"]
            print(f"  run_raft {d}: card {t_gpu:.2f} s, cpu {t_cpu:.2f} s, "
                  f"iterations {ig}/{ic}, K1 launches {grew}, fn rel diff {d_f:.2e}, "
                  f"std scale-rel diff {d_s:.2e}")
            print(f"    std dev (card): {np.array2string(sg, precision=6)}")
            self.check(d_f <= 1e-9 and d_s <= 1e-9 and ig == ic and grew > 0
                       and rg["response"]["converged"],
                       f"run_raft {d} card == cpu (1e-9, identical iterations, kernel launched)")

    def phase_sweep(self):
        from raft_tpu_torch.parallel.sweep import sweep_north_star

        torch = self.torch
        n, nw, chunk = 1000, 200, 250
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        res = sweep_north_star(n_designs=n, nw=nw, chunk=chunk, n_iter=40,
                               dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.counts()["fused"]
        self.add_main(self.counts(), ("fused", "step"))
        self.record["launches"] = launches
        self.record["sweep_wall_ms"] = 1e3 * wall
        peak = torch.cuda.max_memory_allocated()
        std, it, conv = res["std"], res["n_iter"], res["converged"]
        n_conv = int(conv.sum())
        print(f"  sweep {n} x {nw} float32 (chunk {chunk}): wall {wall:.3f} s, "
              f"{n * nw / wall:.1f} solves/s, max iterations {int(it.max())}, "
              f"mean iterations {float(it.float().mean()):.2f}, K1 launches {launches}, "
              f"peak memory {peak / 2**20:.1f} MiB")
        self.check(n_conv == n and bool(torch.isfinite(std).all()) and launches > 0,
                   f"sweep: {n_conv}/{n} lanes converged, all finite, K1 launched")

        lanes = np.arange(0, n, n // 16)[:16]
        sub_k = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                 device="cuda", lanes=lanes)
        with plain_solve():
            sub_p = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                     device="cuda", lanes=lanes)
        same_it = bool((sub_k["n_iter"] == sub_p["n_iter"]).all())
        d = float((sub_k["std"] - sub_p["std"]).abs().max() / sub_p["std"].abs().max())
        d32 = float((std[lanes].double() - sub_k["std"]).abs().max() / sub_k["std"].abs().max())
        print(f"  16-lane float64 subset: kernel vs plain std scale-rel diff {d:.2e}, "
              f"iterations {sub_k['n_iter'].tolist()}; float32 sweep vs float64 {d32:.2e}")
        self.check(same_it and d <= 1e-10,
                   "16-lane subset: kernel == plain (identical iterations, std 1e-10)")

    def counts(self) -> dict:
        """Every kernel wrapper's launch count, by entry (K5's is ``step``)."""
        from raft_tpu_torch.core import cuda6, cuda_bem, cuda_drag

        return {**cuda6.LAUNCHES, **cuda_bem.LAUNCHES, **cuda_drag.LAUNCHES}

    def zero_counts(self):
        from raft_tpu_torch.core import cuda6, cuda_bem, cuda_drag

        for counts in (cuda6.LAUNCHES, cuda_bem.LAUNCHES, cuda_drag.LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))

    def _model(self, design, dtype, full: bool = True):
        """``Model(BEM="jax")`` through run_raft's steps on the card; returns
        the model and the calcBEM wall-clock (ending in a synchronise)."""
        from raft_tpu_torch.model import Model

        torch = self.torch
        m = Model(design, BEM="jax", dtype=dtype, device="cuda")
        m.setEnv(Hs=8.0, Tp=12.0, V=10.0, beta=0.0,
                 Fthrust=float(design.get("turbine", {}).get("Fthrust", 0.0)))
        t0 = time.perf_counter()
        m.calcBEM(cache=False)
        torch.cuda.synchronize()
        t_bem = time.perf_counter() - t0
        if full:
            m.calcSystemProps()
            m.solveEigen()
            m.calcMooringAndOffsets()
            m.solveDynamics()
            m.calcOutputs()
        return m, t_bem

    def phase_model_bem(self):
        from raft_tpu_torch.hydro import torch_bem
        from raft_tpu_torch.model import load_design

        torch = self.torch
        # OC4semi's plain route runs the whole Model too, so its natural
        # frequencies and std dev are held; VolturnUS-S's stops after the panels
        for name, plain_whole in (("VolturnUS-S", False), ("OC4semi", True)):
            design = load_design(DESIGNS / f"{name}.yaml")
            runs = {}
            for route in ("kernels", "plain"):
                self.zero_counts()
                orig = torch_bem.rankine_assembly, torch_bem.wave_assembly
                if route == "plain":                 # plain assembly, same card
                    torch_bem.rankine_assembly = torch_bem.rankine_plain
                    torch_bem.wave_assembly = torch_bem.wave_plain
                try:
                    t0 = time.perf_counter()
                    m, t_bem = self._model(design, torch.float64,
                                           full=route == "kernels" or plain_whole)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    torch_bem.rankine_assembly, torch_bem.wave_assembly = orig
                grew = {k: v for k, v in self.counts().items() if k in ("fused", "rankine", "wave")}
                runs[route] = (m, t_bem, wall, grew)
            (mk, tk, wk, gk), (mp, tp, wp, gp) = runs["kernels"], runs["plain"]
            d_abf = max(torch_bem.parity_err(a, b) for a, b in zip(mk.bem, mp.bem))
            fk = mk.results["eigen"]["frequencies"]
            sk = mk.results["response"]["std dev"]
            ik = mk.results["response"]["iterations"]
            diag = mk.bem_diagnostics
            if plain_whole:
                fp = mp.results["eigen"]["frequencies"]
                sp = mp.results["response"]["std dev"]
                ip = mp.results["response"]["iterations"]
                d_f = float(np.max(np.abs(fk - fp) / np.abs(fp)))
                d_s = torch_bem.parity_err(sk, sp)
                whole = (f"whole run {wk:.2f} s / {wp:.2f} s; fn rel diff {d_f:.2e}, std "
                         f"scale-rel diff {d_s:.2e}, iterations {ik}/{ip}")
                held = d_f <= 1e-9 and d_s <= 1e-9 and ik == ip
                what = "kernels == plain (A/B/F 1e-10, fn and std 1e-9, identical iterations)"
            else:
                whole = (f"whole run {wk:.2f} s (the plain route solves the panels only, "
                         f"{wp:.2f} s); iterations {ik}")
                held = True
                what = "the panel solve through K3/K4 == through their plain versions (A/B/F 1e-10)"
            print(f"  Model(BEM='jax') {name} float64: {diag['panels']} panels -> "
                  f"{diag['padded']}, {diag['nw']} w; calcBEM {tk:.2f} s with K3/K4, {tp:.2f} s "
                  f"plain; {whole}; launches {gk} (plain run {gp}); A/B/F scale-rel diff "
                  f"{d_abf:.2e}, max refinement residual {diag['max_residual']:.2e}")
            print(f"    natural frequencies [Hz]: {np.array2string(fk, precision=5)}; "
                  f"std dev: {np.array2string(sk, precision=5)}")
            self.check(d_abf <= 1e-10 and held and all(gk[k] > 0 for k in gk)
                       and gp["rankine"] == gp["wave"] == 0 and diag["max_residual"] < 1e-4
                       and mk.results["response"]["converged"] and np.isfinite(sk).all(),
                       f"Model(BEM='jax') {name}: {what}, K1/K3/K4 launched, residual < 1e-4, "
                       f"the run converged")
            if name == "VolturnUS-S":
                m32, t32 = self._model(design, torch.float32, full=False)
                d32 = max(torch_bem.parity_err(a, b) for a, b in zip(m32.bem, mk.bem))
                print(f"  VolturnUS-S panel solve float32 vs float64: A/B/F scale-rel diff "
                      f"{d32:.3e} (PARITY_RTOL {torch_bem.PARITY_RTOL}); calcBEM {t32:.2f} s; "
                      f"refinement residual {m32.bem_diagnostics['max_residual']:.2e}")
                self.check(d32 <= torch_bem.PARITY_RTOL,
                           f"VolturnUS-S float32 panel solve within PARITY_RTOL of float64")

    def phase_north_star_bem(self):
        from raft_tpu_torch.parallel.sweep import stage_north_star_bem, sweep_north_star

        torch = self.torch
        n, nw, chunk = 1000, 200, 250
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        staged, diag = stage_north_star_bem(nw=nw, nw_bem=48, mode="jax", cache=False,
                                            dtype=torch.float64, device="cuda",
                                            return_diagnostics=True)
        torch.cuda.synchronize()
        t_stage = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = sweep_north_star(n_designs=n, nw=nw, chunk=chunk, n_iter=40, dtype=torch.float32,
                               device="cuda", bem=staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in self.counts().items()
                    if k in ("fused", "rankine", "wave", "step")}
        self.add_main(launches, ("fused", "rankine", "wave", "step"))
        self.staged = staged
        self.staged_std = res["std"]
        peak = torch.cuda.max_memory_allocated()
        self.record_bem = {"stage_ms": 1e3 * t_stage, "sweep_wall_ms": 1e3 * wall}
        std, it, conv = res["std"], res["n_iter"], res["converged"]
        n_conv = int(conv.sum())
        print(f"  BEM staging: {diag['panels']} panels -> {diag['padded']}, {diag['nw']} w, "
              f"float64, {t_stage:.3f} s (panel solve {diag['seconds']:.3f} s), max refinement "
              f"residual {diag['max_residual']:.2e}")
        print(f"  BEM-staged sweep {n} x {nw} float32 (chunk {chunk}): wall {wall:.3f} s, "
              f"{n * nw / wall:.1f} solves/s, max iterations {int(it.max())}, mean iterations "
              f"{float(it.float().mean()):.2f}, launches {launches}, peak memory "
              f"{peak / 2**20:.1f} MiB")
        self.check(n_conv == n and bool(torch.isfinite(std).all())
                   and launches["fused"] > 0 and launches["rankine"] == 1
                   and launches["wave"] == 24,
                   f"BEM-staged sweep: {n_conv}/{n} lanes converged, all finite, K1 launched, "
                   f"K3 once, K4 once per chunk of 2 w")

        lanes = np.arange(0, n, n // 16)[:16]
        sub_k = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                 device="cuda", bem=staged, lanes=lanes)
        with plain_solve():
            sub_p = sweep_north_star(n_designs=n, nw=nw, chunk=16, dtype=torch.float64,
                                     device="cuda", bem=staged, lanes=lanes)
        same_it = bool((sub_k["n_iter"] == sub_p["n_iter"]).all())
        d = float((sub_k["std"] - sub_p["std"]).abs().max() / sub_p["std"].abs().max())
        d32 = float((std[lanes].double() - sub_k["std"]).abs().max() / sub_k["std"].abs().max())
        print(f"  16-lane float64 subset: kernel vs plain std scale-rel diff {d:.2e}, "
              f"iterations {sub_k['n_iter'].tolist()}; float32 sweep vs float64 {d32:.2e}")
        print(f"    lane 0 std dev: {np.array2string(sub_k['std'][0].cpu().numpy(), precision=5)}")
        self.check(same_it and d <= 1e-10,
                   "BEM 16-lane subset: kernel == plain (identical iterations, std 1e-10)")

    def phase_grad_guard(self):
        """On the card the kernel wrappers refuse gradient work (their
        outputs carry no autograd history) and name the scan driver; the
        scan driver, the default of ``forward_response``, still
        differentiates through K1 and its adjoint."""
        from raft_tpu_torch.core import cuda6, cuda_bem
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.hydro import torch_bem, wavetable
        from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
        from raft_tpu_torch.parallel.sweep import (_volturnus, forward_response, north_star_grid,
                                                   response_std)

        torch = self.torch
        f64 = torch.float64
        rng = np.random.default_rng(20261019)
        Z0, w, Bd, F = self._k1_inputs("random", 4, 200, f64, rng)

        def refuses(name, call):
            self.zero_counts()
            try:
                call()
                msg = None
            except RuntimeError as e:
                msg = str(e)
            launched = {k: v for k, v in self.counts().items() if v}
            self.check(msg is not None and 'method="scan"' in msg and "solve_rao_ad" in msg
                       and not launched,
                       f"{name} with an input that requires grad raises and names the scan "
                       f"driver (launches {launched})")

        def grad(t):
            return t.clone().requires_grad_(True)

        refuses("K1 solve_rao", lambda: cuda6.solve_rao(Cx(grad(Z0.re), Z0.im), w, Bd, F))
        A = Cx(Z0.re.reshape(-1, 6, 6), Z0.im.reshape(-1, 6, 6))
        b = Cx(F.re.reshape(-1, 6), F.im.reshape(-1, 6))
        refuses("K2 solve_cx", lambda: cuda6.solve_cx(A, Cx(grad(b.re), b.im)))
        case = self._bem_case("VolturnUS-S", False, f64)
        args = list(case["args"])
        refuses("K3 rankine_assembly", lambda: cuda_bem.rankine_assembly(
            args[0], grad(args[1]), *args[2:], quad=case["quad"]))
        R_pot, R_dn = cuda_bem.rankine_assembly(*args, quad=case["quad"])
        tabd = torch_bem.stage_tables(wavetable.load_tables(), f64, self.dev)
        k = torch.as_tensor([1.5**2 / 9.81, 1.6**2 / 9.81], dtype=f64, device=self.dev)
        refuses("K4 wave_assembly", lambda: cuda_bem.wave_assembly(
            grad(R_pot), R_dn, *args[1:4], args[5], args[6], tabd, k, None,
            finite_depth=False, depth=0.0))

        _design, members, rna, env, wave, C = _volturnus(self.nw, f64, self.dev)
        draft, plan = make_stretch_draft(members), make_scale_plan(members)
        th = torch.as_tensor(north_star_grid(self.n_designs)[:4], dtype=f64,
                             device=self.dev).requires_grad_(True)
        m = plan(draft(members, th[:, 1]), th[:, 0])
        refuses("forward_response(method='while') under autograd", lambda: forward_response(
            m, rna, env, wave, C, n_iter=40, method="while", device=self.dev))
        self.zero_counts()
        out = forward_response(m, rna, env, wave, C, n_iter=25, device=self.dev)
        g = torch.autograd.grad(response_std(out.Xi.abs2(), wave.w)[:, 4].sum(), th)[0]
        n = self.counts()
        print(f"  default-driver gradient of 4 lanes' pitch std: {g.cpu().numpy().tolist()}; "
              f"launches {n}")
        self.check(bool(torch.isfinite(g).all()) and bool((g != 0).any())
                   and n["fused"] == 25 and n["fused_adjoint"] == 25,
                   "forward_response's default (scan) differentiates on the card: K1 forward "
                   "and adjoint once per step")

    def phase_native_bem(self):
        """The north star's BEM staged as bench.py stages it: the host C++
        solver, cold (no result cache), at 48 w on the full 850-panel mesh
        at 200 m depth, interpolated to 200 w and staged on the card; held
        against the card's staging (K3/K4) at PARITY_RTOL; then the
        1,000 x 200 float32 sweep on the native-staged coefficients."""
        import os

        from raft_tpu_torch.hydro import native_bem, torch_bem
        from raft_tpu_torch.parallel.sweep import stage_north_star_bem, sweep_north_star

        torch = self.torch
        n, nw, chunk = self.n_designs, self.nw, self.chunk
        cores = os.cpu_count()
        t0 = time.perf_counter()
        native_bem.build()
        t_lib = time.perf_counter() - t0
        had_table = native_bem.table_path().exists()
        t0 = time.perf_counter()
        native_bem.wave_integral(1.0, -1.0)              # loads or builds the table
        t_tab = time.perf_counter() - t0
        print(f"  native solver: g++ build {t_lib:.2f} s; wave table "
              f"{'loaded' if had_table else 'built'} in {t_tab:.2f} s "
              f"({native_bem.table_path().name}); host os.cpu_count() = {cores}")

        self.zero_counts()
        t0 = time.perf_counter()
        staged, diag = stage_north_star_bem(nw=nw, nw_bem=48, mode="native", cache=False,
                                            dtype=torch.float64, device=self.dev,
                                            return_diagnostics=True)
        torch.cuda.synchronize()
        t_native = time.perf_counter() - t0
        launched = {k: v for k, v in self.counts().items() if v}
        print(f"  native staging: {diag['panels']} panels x {diag['nw']} w, depth 200 m, f64 on "
              f"the host, cold: {t_native:.3f} s (solve {diag['seconds']:.3f} s) on "
              f"{cores} cores; launches {launched}")
        self.check(diag["route"] == "native" and not diag["cached"] and diag["panels"] == 850
                   and diag["nw"] == 48 and not launched,
                   "native staging: 850 panels x 48 w on the host, cold, no kernel launched")

        self.zero_counts()
        t0 = time.perf_counter()
        _card, diag_c = stage_north_star_bem(nw=nw, nw_bem=48, mode="jax", cache=False,
                                             dtype=torch.float64, device=self.dev,
                                             return_diagnostics=True)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches = self.counts()
        errs = [torch_bem.parity_err(c, h)
                for c, h in zip(diag_c["coeffs"][1:], diag["coeffs"][1:])]
        print(f"  card staging (K3/K4, f64): {t_card:.3f} s, launches K3 {launches['rankine']}, "
              f"K4 {launches['wave']}; against native, scale-relative: A {errs[0]:.3e}, "
              f"B {errs[1]:.3e}, F {errs[2]:.3e} (PARITY_RTOL {torch_bem.PARITY_RTOL})")
        self.check(max(errs) <= torch_bem.PARITY_RTOL and launches["rankine"] == 1
                   and launches["wave"] == 24,
                   "card staging within PARITY_RTOL of the native staging (A, B, F), K3 once, "
                   "K4 once per chunk")

        self.zero_counts()
        t0 = time.perf_counter()
        res = sweep_north_star(n_designs=n, nw=nw, chunk=chunk, n_iter=40, dtype=torch.float32,
                               device=self.dev, bem=staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sweep_launches = {k: v for k, v in self.counts().items() if v}
        std, it, conv = res["std"], res["n_iter"], res["converged"]
        n_conv = int(conv.sum())
        line = (f"  native-staged sweep {n} x {nw} float32 (chunk {chunk}): wall {wall:.3f} s, "
                f"{n * nw / wall:.1f} solves/s, max iterations {int(it.max())}, launches "
                f"{sweep_launches}")
        if self.staged_std is not None:
            d = float((std - self.staged_std).abs().max() / self.staged_std.abs().max())
            line += f"; std against the card-staged sweep: scale-rel diff {d:.3e}"
        print(line)
        self.check(n_conv == n and bool(torch.isfinite(std).all())
                   and sweep_launches.get("fused", 0) > 0
                   and set(sweep_launches) == {"fused", "step"},
                   f"native-staged sweep: {n_conv}/{n} lanes converged, all finite, K1 and K5 "
                   f"launched")
        self.native_coeffs = diag["coeffs"]
        self.native_staged = staged
        self.record_native = {"stage_s": t_native, "solve_s": diag["seconds"], "cores": cores,
                              "card_stage_s": t_card, "sweep_wall_s": wall}

    def _staged_bem(self):
        """The nominal hull's staged BEM of the BEM-staged north star (solved
        here when that phase did not run)."""
        if self.staged is None:
            from raft_tpu_torch.parallel.sweep import stage_north_star_bem

            self.staged = stage_north_star_bem(nw=self.nw, nw_bem=48, mode="jax", cache=False,
                                               dtype=self.torch.float64,
                                               device=self.dev)
        return self.staged

    def _codesign_setup(self, dtype):
        """The north star's design, sea state, mooring stiffness and staged
        BEM in ``dtype``, and its plan-radius x draft warp as ``apply_fn``."""
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
        from raft_tpu_torch.parallel.sweep import _volturnus

        _design, members, rna, env, wave, C = _volturnus(self.nw, dtype, self.dev)
        A, B, F = self._staged_bem()
        bem = (A.to(dtype), B.to(dtype), Cx(F.re.to(dtype), F.im.to(dtype)))
        draft, plan = make_stretch_draft(members), make_scale_plan(members)

        def apply_fn(m, th):
            return plan(draft(m, th[..., 1]), th[..., 0])

        return members, rna, env, wave, C, bem, apply_fn

    def phase_codesign(self):
        """The slice's main path: d sigma_nacelle / d (plan radius, draft) of
        every north-star variant, through the scan loop (K1 forward and K1
        on the adjoint system in every step)."""
        from raft_tpu_torch.parallel.optimize import (_make_loss, grad_nacelle_accel_std,
                                                      nacelle_accel_std)
        from raft_tpu_torch.parallel.sweep import north_star_grid

        torch = self.torch
        n, chunk, n_iter = self.n_designs, self.chunk, 25
        grid = north_star_grid(n)
        members, rna, env, wave, C, bem, apply_fn = self._codesign_setup(torch.float32)
        thetas = torch.as_tensor(grid, dtype=torch.float32, device=self.dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        grads, chunk_s = [], []
        t_all = time.perf_counter()
        for lo in range(0, n, chunk):
            t0 = time.perf_counter()
            grads.append(grad_nacelle_accel_std(members, rna, env, wave, C, thetas[lo:lo + chunk],
                                                apply_fn=apply_fn, bem=bem, n_iter=n_iter,
                                                dtype=torch.float32, device=self.dev))
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all
        launches = self.counts()
        peak = torch.cuda.max_memory_allocated()
        self.add_main(launches, ("fused", "fused_adjoint", "step"))
        grad = torch.cat(grads)
        loss = _make_loss(members, rna, env, wave, C, nacelle_accel_std, apply_fn, bem, n_iter,
                          False, dtype=torch.float32, device=self.dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            sigma = loss(thetas[:chunk])
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        self.record_grad = {"chunk_ms": 1e3 * float(np.mean(chunk_s[1:] or chunk_s))}
        n_chunks = len(chunk_s)
        print(f"  co-design gradient {n} x {wave.w.shape[0]} float32 (chunk {chunk}, scan "
              f"{n_iter}): total {total:.3f} s, per chunk "
              f"{', '.join(f'{t:.3f}' for t in chunk_s)} s; forward only {fwd_s:.3f} s per chunk "
              f"(gradient / forward {np.mean(chunk_s[1:] or chunk_s) / fwd_s:.2f}); launches "
              f"{ {k: v for k, v in launches.items() if v} }; peak memory {peak / 2**30:.2f} GiB")
        print(f"    sigma_nacelle of the first chunk: {float(sigma.min()):.5f} .. "
              f"{float(sigma.max()):.5f}; d sigma / d (plan, draft) lane 0: "
              f"{grad[0].tolist()}, lane {n - 1}: {grad[-1].tolist()}")
        self.check(bool(torch.isfinite(grad).all()) and grad.shape == (n, 2)
                   and bool(torch.isfinite(sigma).all())
                   and launches["fused"] == n_iter * n_chunks
                   and launches["fused_adjoint"] == n_iter * n_chunks
                   and launches["plain"] == launches["plain_adjoint"] == 0,
                   f"co-design gradient: every lane finite, K1 {n_iter} forward and {n_iter} "
                   f"adjoint launches per chunk")

        lanes = np.linspace(0, n - 1, 4).astype(int).tolist()
        members, rna, env, wave, C, bem, apply_fn = self._codesign_setup(torch.float64)
        th = torch.as_tensor(grid[lanes], dtype=torch.float64, device=self.dev)
        args = (members, rna, env, wave, C, th)
        kw = dict(apply_fn=apply_fn, bem=bem, n_iter=n_iter, dtype=torch.float64, device=self.dev)
        gk = grad_nacelle_accel_std(*args, **kw)
        with plain_solve():
            gp = grad_nacelle_accel_std(*args, **kw)
        d_plain = float((gk - gp).abs().max() / gp.abs().max())
        loss = _make_loss(members, rna, env, wave, C, nacelle_accel_std, apply_fn, bem, n_iter,
                          False, dtype=torch.float64, device=self.dev)
        fd = torch.zeros_like(th)
        with torch.no_grad():
            for j in range(2):
                e = torch.zeros_like(th)
                e[:, j] = FD_H
                fd[:, j] = (loss(th + e) - loss(th - e)) / (2 * FD_H)
        d_fd = float(((gk - fd).abs().amax(dim=1) / fd.abs().amax(dim=1)).max())
        d32 = float((grad[lanes].double() - gk).abs().max() / gk.abs().max())
        print(f"  4-lane float64 subset (lanes {lanes}): kernels vs plain solve {d_plain:.2e}, vs "
              f"central differences (h {FD_H}) {d_fd:.2e} per-lane scale-relative; float32 "
              f"gradient vs float64 {d32:.2e}")
        print(f"    gradient {gk.tolist()}; differences {fd.tolist()}")
        self.check(d_plain <= TOL_GRAD and d_fd <= FD_RTOL,
                   f"4-lane float64 gradient: kernels == plain ({TOL_GRAD:.0e}), central "
                   f"differences ({FD_RTOL:.0e})")

    def _oc3(self, nw: int, dev):
        """OC3spar's members, RNA, sea state (JONSWAP Hs 8 m / Tp 12 s on
        ``linspace(0.05, 2.95, nw)``) and mooring system on ``dev``, float64."""
        import yaml

        torch = self.torch
        from raft_tpu_torch.build.members import build_member_set, build_rna
        from raft_tpu_torch.core.types import Env, WaveState
        from raft_tpu_torch.core.waves import jonswap, wave_number
        from raft_tpu_torch.mooring.system import parse_mooring

        dtype = torch.float64
        with open(DESIGNS / "OC3spar.yaml") as f:
            design = yaml.safe_load(f)
        depth = float(design["mooring"]["water_depth"])
        w = torch.as_tensor(np.linspace(0.05, 2.95, nw), dtype=dtype, device=dev)
        wave = WaveState(w=w, k=wave_number(w, depth), zeta=torch.sqrt(jonswap(w, 8.0, 12.0)))
        moor = parse_mooring(design["mooring"], dev, dtype,
                             yaw_stiffness=design["turbine"].get("yaw_stiffness", 0.0))
        return (build_member_set(design, dev, dtype), build_rna(design),
                Env(Hs=8.0, Tp=12.0, depth=depth), wave, moor)

    def phase_optimize(self):
        from raft_tpu_torch.mooring.system import scale_mooring
        from raft_tpu_torch.parallel.optimize import _make_loss, nacelle_accel_std, optimize_design
        from raft_tpu_torch.parallel.sweep import _volturnus

        torch = self.torch
        _design, members, rna, env, wave, C = _volturnus(self.nw, torch.float64, self.dev)
        self.zero_counts()
        t0 = time.perf_counter()
        res = optimize_design(members, rna, env, wave, C, theta0=1.0, steps=6,
                              learning_rate=0.02, bounds=(0.8, 1.25), bem=self._staged_bem(),
                              n_iter=25, device=self.dev)
        wall = time.perf_counter() - t0
        launches = self.counts()
        print(f"  optimize_design VolturnUS-S (scale_diameters, staged BEM, float64, 6 Adam "
              f"steps): {wall:.2f} s; objective {np.array2string(res.history, precision=6)}; "
              f"theta {np.array2string(res.thetas, precision=5)}; launches K1 "
              f"{launches['fused']} / adjoint {launches['fused_adjoint']}")
        self.check(bool(np.isfinite(res.history).all()) and res.history[-1] < res.history[0]
                   and 0.8 <= float(res.theta) <= 1.25 and launches["fused_adjoint"] == 7 * 25,
                   "optimize_design: the objective falls, theta stays in bounds, K1 adjoint "
                   "launched every step")

        grads = []
        for dev in (self.dev, torch.device("cpu")):
            members, rna, env, wave, moor = self._oc3(59, dev)
            loss = _make_loss(members, rna, env, wave, None, nacelle_accel_std,
                              lambda m, t: m, None, 25, False, moor=moor,
                              moor_apply_fn=scale_mooring, device=dev)
            th = torch.ones(3, dtype=torch.float64, device=dev, requires_grad=True)
            t0 = time.perf_counter()
            (g,) = torch.autograd.grad(loss(th), th)
            grads.append((g.cpu(), time.perf_counter() - t0))
        (gc, tc), (gh, th_s) = grads
        d = float((gc - gh).abs().max() / gh.abs().max())
        print(f"  OC3spar mooring knobs (L, R, EA) at ones(3), 59 w: d sigma_nacelle / d theta "
              f"card {gc.tolist()} in {tc:.2f} s, cpu {gh.tolist()} in {th_s:.2f} s; scale-rel "
              f"diff {d:.2e}")
        self.check(d <= TOL_GRAD and bool(torch.isfinite(gc).all()) and bool((gc != 0).all()),
                   f"mooring-knob gradient card == cpu ({TOL_GRAD:.0e}), every knob moves")

    def add_main(self, launches: dict, keys):
        """Add one main-path run's launches of ``keys`` to the kernels record
        (summed over every path)."""
        for k in keys:
            self.main_launches[k] = self.main_launches.get(k, 0) + launches[k]

    def phase_bem_gradient(self):
        """The BEM gradient at full width: d sigma_nacelle / d theta (radial
        scale) through ``make_bem_fn`` (VolturnUS-S, 850 panels, 1,024 class,
        48 w, 200 m), the panel solve's plain assembly differentiated, K1
        forward and adjoint in every scan step; float64 against the plain
        solve in K1's place and against central differences; float32
        through ``optimize_design`` with ``bem_fn`` against float64."""
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.hydro import torch_bem
        from raft_tpu_torch.hydro.mesh import mesh_design
        from raft_tpu_torch.parallel.optimize import (_make_loss, _value_and_grad,
                                                      nacelle_accel_std, optimize_design)
        from raft_tpu_torch.parallel.sweep import _volturnus, scale_diameters
        from raft_tpu_torch.tools.bem_grad_fd import FrozenBranches

        torch = self.torch
        nw, depth, n_iter = 48, 200.0, 25
        w = np.linspace(0.05, 2.95, nw)            # _north_star_wave(48, 200.0)'s grid
        f32, f64 = torch.float32, torch.float64

        def staged(dtype):
            design, members, rna, env, wave, C = _volturnus(nw, dtype, self.dev)
            panels = mesh_design(design, dz_max=3.0, da_max=2.0)
            t0 = time.perf_counter()
            bem_fn = torch_bem.make_bem_fn(panels, w, rho=float(env.rho), g=float(env.g),
                                           depth=depth, beta=0.0, dtype=dtype, device=self.dev)
            return (members, rna, env, wave, C), panels, bem_fn, time.perf_counter() - t0

        def launched(launches, n):
            return (launches["fused"] == launches["fused_adjoint"] == n
                    and launches["rankine"] == launches["wave"] == 0)

        # float64: the value and gradient through K1, then with the plain solve in
        # K1's place (autograd through it), then the central difference
        inputs, panels, bem_fn, t_stage = staged(f64)
        solved = {}

        def recording_bem_fn(th):
            solved["bem"] = bem_fn(th)
            return solved["bem"]

        loss64 = _make_loss(*inputs, nacelle_accel_std, scale_diameters, None, n_iter, False,
                            bem_fn=recording_bem_fn, dtype=f64, device=self.dev)
        th64 = torch.tensor(BEM_THETA, dtype=f64, device=self.dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        val, g = _value_and_grad(loss64, th64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = self.counts()
        v64, g64 = float(val), float(g)
        print(f"  BEM gradient float64: {len(panels)} panels -> "
              f"{torch_bem.pad_panel_count(len(panels))}, {nw} w, {depth:.0f} m, scan "
              f"{n_iter}: bem_fn staged in {t_stage:.2f} s; value and gradient {wall:.2f} s, "
              f"peak memory {peak / 2**30:.2f} GiB; sigma_nacelle {v64:.6e}, d sigma / d theta "
              f"{g64:.6e}; launches { {k: v for k, v in launches.items() if v} }")
        self.check(np.isfinite(v64) and np.isfinite(g64) and g64 != 0.0
                   and launched(launches, n_iter),
                   f"BEM gradient float64: finite, K1 {n_iter} forward + {n_iter} adjoint "
                   f"launches, K3/K4 none (the plain assembly)")
        # K1 against the plain solve in its place on the same inputs: the panel
        # solve's A, B, F at theta, held as leaves, through the rest of the loss
        # (value, and gradient in theta and in A, B, F); the panel solve and its
        # backward are the same on both sides, so they are not run again
        A, B, F = solved["bem"]
        leaves = [t.detach().clone().requires_grad_(True) for t in (A, B, F.re, F.im)]
        loss_frozen = _make_loss(*inputs, nacelle_accel_std, scale_diameters, None, n_iter,
                                 False, bem_fn=lambda _th: (leaves[0], leaves[1],
                                                            Cx(leaves[2], leaves[3])),
                                 dtype=f64, device=self.dev)

        def frozen_value_and_grads():
            th = th64.detach().requires_grad_(True)
            v = loss_frozen(th)
            return float(v), torch.autograd.grad(v.sum(), [th, *leaves])

        t0 = time.perf_counter()
        vk, gk = frozen_value_and_grads()
        with plain_solve():
            vp, gp = frozen_value_and_grads()
        t_plain = time.perf_counter() - t0
        dv = abs(vk - vp) / abs(vp)
        dgs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
               for a, b in zip(gk, gp)]
        print(f"  BEM gradient float64, K1 vs the plain solve (autograd through it) on the panel "
              f"solve's A, B, F at theta ({t_plain:.2f} s): value {vp:.12e} rel {dv:.3e} (the "
              f"whole loss's {v64:.12e}), gradient in theta, A, B, F.re, F.im rel "
              + ", ".join(f"{d:.3e}" for d in dgs) + f" (limit {BEM_TOL_PLAIN:.0e})")
        self.check(dv <= BEM_TOL_PLAIN and max(dgs) <= BEM_TOL_PLAIN
                   and abs(vk - v64) <= BEM_TOL_PLAIN * abs(v64),
                   f"BEM gradient float64: K1 forward and adjoint == the plain solve "
                   f"({BEM_TOL_PLAIN:.0e}, value and gradient)")
        with torch.no_grad():
            with FrozenBranches() as frozen:                  # record theta's branches
                loss64(th64)
            frozen_fd = []
            for s in (1.0, -1.0):
                with frozen.replay():
                    frozen_fd.append(float(loss64(th64 + s * BEM_FD_H)))
        fd_frozen = (frozen_fd[0] - frozen_fd[1]) / (2 * BEM_FD_H)
        d_fd = abs(g64 - fd_frozen) / abs(fd_frozen)
        print(f"  BEM gradient at theta {BEM_THETA}: float64 {g64:.9e} vs the central difference "
              f"(h {BEM_FD_H}) with theta's branches held {fd_frozen:.9e}, rel {d_fd:.3e} (limit "
              f"{BEM_FD_RTOL:.0e}; {frozen.n_held} comparisons and integer casts held)")
        self.check(d_fd <= BEM_FD_RTOL,
                   f"BEM gradient: float64 == central difference ({BEM_FD_RTOL:.0e})")

        # float32 through the entry point: optimize_design(bem_fn=...) from theta
        # BEM_THETA, 1 Adam step; its first value and gradient are the float32
        # ones at theta, held against float64 (the step's sign gives the gradient's)
        inputs, panels, bem_fn, _t = staged(f32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        res = optimize_design(*inputs, theta0=BEM_THETA, steps=1, learning_rate=0.02,
                              bounds=(0.8, 1.25), n_iter=n_iter, bem_fn=bem_fn, dtype=f32,
                              device=self.dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = self.counts()
        self.add_main(launches, ("fused", "fused_adjoint", "step"))
        v32 = float(res.history[0])
        g32 = float(np.sign(res.thetas[0] - res.thetas[1])) * float(res.grad_norm)
        dv32, d32 = abs(v32 - v64) / abs(v64), abs(g32 - g64) / abs(g64)
        print(f"  optimize_design(bem_fn) float32, {len(panels)} panels, 1 Adam step from theta "
              f"{BEM_THETA} (2 values and gradients): {wall:.2f} s, peak memory "
              f"{peak / 2**30:.2f} GiB; objective {np.array2string(res.history, precision=7)}; "
              f"theta {np.array2string(res.thetas, precision=6)}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        print(f"  BEM gradient at theta {BEM_THETA}: float32 value {v32:.7e} vs float64 rel "
              f"{dv32:.3e}, gradient {g32:.9e} vs float64 {g64:.9e} rel {d32:.3e} (limit "
              f"{BEM_TOL_32:.0e})")
        self.check(bool(np.isfinite(res.history).all()) and bool(np.isfinite(res.thetas).all())
                   and res.thetas[1] != res.thetas[0] and launched(launches, 2 * n_iter),
                   f"optimize_design(bem_fn) float32: finite history, K1 2 x {n_iter} forward + "
                   f"2 x {n_iter} adjoint launches, K3/K4 none (the plain assembly)")
        self.check(dv32 <= BEM_TOL_32 and d32 <= BEM_TOL_32,
                   f"BEM gradient: float32 == float64 ({BEM_TOL_32:.0e}, value and gradient)")

    def phase_dlc(self):
        """The DLC table: ``Model(VolturnUS-S, BEM="jax")`` on the north star's
        200 w with a 7-heading grid (K3 once, K4 per chunk), then
        ``sweep_sea_states`` over 64 cases (8 Hs/Tp rows x 8 headings), 4 of
        them held against the CPU; then a 7-direction spread sea through
        ``directional_response``."""
        from raft_tpu_torch.model import Model, load_design
        from raft_tpu_torch.parallel.sweep import (_volturnus, directional_response,
                                                   make_wave_states, spread_sea_state,
                                                   sweep_sea_states)

        torch = self.torch
        f64 = torch.float64
        nw, n_iter = self.nw, 25
        w = np.linspace(0.05, 2.95, nw)
        design = load_design(DESIGNS / "VolturnUS-S.yaml")
        m = Model(design, w=w, BEM="jax", dtype=f64, device=self.dev)
        _d, members, rna, env, _wave, C = _volturnus(nw, f64, self.dev)
        hs_tp = np.stack([np.linspace(2.0, 10.0, 8), np.linspace(7.0, 15.0, 8)], axis=1)
        cases = np.array([[hs, tp, b] for hs, tp in hs_tp for b in np.linspace(0, np.pi / 2, 8)])
        torch.cuda.synchronize()
        self.zero_counts()
        t0 = time.perf_counter()
        m.calcBEM(headings=np.linspace(0, np.pi / 2, 7), cache=False)
        torch.cuda.synchronize()
        t_bem = time.perf_counter() - t0
        grid = m._bem_headings
        self.dlc_grid = grid
        waves = make_wave_states(w, cases, env.depth, dtype=f64, device=self.dev)
        t0 = time.perf_counter()
        res = sweep_sea_states(members, rna, env, waves, C, bem=grid, n_iter=n_iter, dtype=f64,
                               device=self.dev)
        wall = time.perf_counter() - t0
        launches = self.counts()
        self.add_main(launches, ("fused", "rankine", "wave", "step"))
        it = res["iterations"]
        print(f"  DLC table: calcBEM 200 w x 7 headings float64 {t_bem:.2f} s (max refinement "
              f"residual {m.bem_diagnostics['max_residual']:.2e}); sweep_sea_states "
              f"{len(cases)} cases x {nw} w float64 {wall:.3f} s, iterations "
              f"{int(it.min())}-{int(it.max())}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        print(f"    sigma_nacelle per Hs/Tp row (max over headings): "
              f"{np.array2string(res['nacelle accel std dev'].reshape(8, 8).max(1), precision=5)}")
        with plain_solve():
            plain = sweep_sea_states(members, rna, env, waves, C, bem=grid, n_iter=n_iter,
                                     dtype=f64, device=self.dev)
        d_plain = max(float(np.abs(res[k] - plain[k]).max() / np.abs(plain[k]).max())
                      for k in ("std dev", "nacelle accel std dev", "Xi_abs2"))
        same_plain = bool((res["iterations"] == plain["iterations"]).all())
        print(f"    64 cases, K1 vs the plain solve on the card: scale-relative {d_plain:.3e}, "
              f"iterations {'identical' if same_plain else 'differ'}")
        self.check(d_plain <= 1e-10 and same_plain,
                   "DLC table: 64 cases through K1 == the plain solve (1e-10, identical "
                   "iterations)")
        n_chunks = -(-nw // 2)
        self.check(res["std dev"].shape == (64, 6) and res["Xi_abs2"].shape == (64, nw, 6)
                   and bool(np.isfinite(res["Xi_abs2"]).all()) and int(it.max()) < n_iter
                   and launches["rankine"] == 1 and launches["wave"] == n_chunks
                   and launches["fused"] == n_iter,
                   f"DLC table: 64 cases finite and converged; K3 once, K4 {n_chunks} times, K1 "
                   f"{n_iter}")

        idx = [0, 21, 42, 63]

        def subset(dev):
            _d, mem, rna_d, env_d, _w, C_d = _volturnus(nw, f64, dev)
            wv = make_wave_states(w, cases[idx], env_d.depth, dtype=f64, device=dev)
            t0 = time.perf_counter()
            out = sweep_sea_states(mem, rna_d, env_d, wv, C_d, bem=grid, n_iter=n_iter,
                                   dtype=f64, device=dev)
            return {**out, "seconds": time.perf_counter() - t0}

        card, cpu = subset(self.dev), subset(torch.device("cpu"))
        rel = max(float(np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max())
                  for k in ("std dev", "nacelle accel std dev", "Xi_abs2"))
        same_it = bool((card["iterations"] == cpu["iterations"]).all())
        rows = max(float(np.abs(card[k] - res[k][idx]).max() / np.abs(res[k][idx]).max())
                   for k in ("std dev", "Xi_abs2"))
        print(f"  DLC cases {idx} float64, card vs CPU: scale-relative {rel:.3e}, iterations "
              f"{card['iterations'].tolist()} / {cpu['iterations'].tolist()} (card "
              f"{card['seconds']:.2f} s, CPU {cpu['seconds']:.2f} s); against the 64-case "
              f"sweep's rows {rows:.3e}")
        self.check(rel <= 1e-10 and same_it and rows <= 1e-12,
                   "DLC cases card == CPU (1e-10, identical iterations), and == the 64-case "
                   "sweep's rows (1e-12)")

        # a 7-direction spread spans +-77 degrees about its mean, wider than the
        # table's [0, 90] degree grid: it takes a grid of its own
        m.calcBEM(headings=np.linspace(-np.pi / 2, np.pi / 2, 7), cache=False)
        spread = spread_sea_state(w, 8.0, 12.0, env.depth, beta0=0.0, n_dir=7, dtype=f64,
                                  device=self.dev)
        t0 = time.perf_counter()
        d = directional_response(members, rna, env, spread, C, bem=m._bem_headings,
                                 n_iter=n_iter, dtype=f64, device=self.dev)
        wall = time.perf_counter() - t0
        long = sweep_sea_states(members, rna, env,
                                make_wave_states(w, [[8.0, 12.0, 0.0]], env.depth, dtype=f64,
                                                 device=self.dev),
                                C, bem=m._bem_headings, n_iter=n_iter, dtype=f64,
                                device=self.dev)
        per_it = d["per direction"]["iterations"]
        print(f"  spread sea (Hs 8 m, Tp 12 s, 7 directions, s = 2) float64: {wall:.3f} s; std "
              f"dev {np.array2string(d['std dev'], precision=5)}; sigma_nacelle "
              f"{d['nacelle accel std dev']:.6f} against {float(long['nacelle accel std dev'][0]):.6f} "
              f"long-crested; iterations {per_it.tolist()}")
        self.check(bool(np.isfinite(d["std dev"]).all()) and int(per_it.max()) < n_iter,
                   "directional_response: finite, every direction converged")

    # --------------------------------------- design batches and turbine arrays

    def _rel(self, got, want) -> float:
        """Scale-relative difference (largest |difference| over the largest
        |entry| of the reference), numpy or tensors."""
        got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
        want = want.detach().cpu().numpy() if hasattr(want, "detach") else np.asarray(want)
        return float(np.abs(got - want).max() / np.abs(want).max())

    def phase_variant_sweep(self):
        """``sweep`` of OC3spar's ``scale_diameters`` variants at
        ``bench.py::oc3_strip_throughput``'s width: 2,048 scales in [0.9,
        1.1] x 200 w, Hs 8 m / Tp 12 s, float32, scan at 25 iterations,
        ``return_xi=False``; then 64 of them in float64 through K1 and
        through the plain solve, and the solve under the profiler."""
        from raft_tpu_torch.model import stage_design_base
        from raft_tpu_torch.parallel.sweep import sweep

        torch = self.torch
        n, nw, n_iter = self.n_variants, 200, 25
        kw = dict(nw=nw, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
        path = DESIGNS / "OC3spar.yaml"
        thetas = np.linspace(0.9, 1.1, n)
        t0 = time.perf_counter()
        _d, m, rna, env, wave, C = stage_design_base(path, dtype=torch.float32, device=self.dev,
                                                     **kw)
        torch.cuda.synchronize()
        t_stage = time.perf_counter() - t0

        def run():
            return sweep(m, rna, env, wave, C, thetas, n_iter=n_iter, return_xi=False,
                         dtype=torch.float32, device=self.dev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        res = run()                                   # numpy out: ends in a synchronise
        wall = time.perf_counter() - t0
        launches = self.counts()
        self.add_main(launches, ("fused", "step"))
        it, std = res["iterations"], res["std dev"]
        conv = int((it < n_iter).sum())
        print(f"  variant sweep OC3spar {n} x {nw} float32: staging {t_stage:.3f} s, sweep "
              f"{wall:.3f} s, {n * nw / wall:.1f} solves/s; iterations {int(it.min())}-"
              f"{int(it.max())}; K1 launches {launches['fused']}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        self.check(conv == n and bool(np.isfinite(std).all()) and launches["fused"] == n_iter,
                   f"variant sweep: {conv}/{n} lanes converged before the cap, all finite, K1 "
                   f"launched once a step")
        self.record_batches["variant_wall_ms"] = 1e3 * wall

        lanes = thetas[::n // 64]
        _d, m64, rna64, env64, wave64, C64 = stage_design_base(path, dtype=torch.float64,
                                                               device=self.dev, **kw)
        args = (m64, rna64, env64, wave64, C64, lanes)
        sub_k = sweep(*args, n_iter=n_iter, dtype=torch.float64, device=self.dev)
        with plain_solve():
            sub_p = sweep(*args, n_iter=n_iter, dtype=torch.float64, device=self.dev)
        d = max(self._rel(sub_k[k], sub_p[k]) for k in ("std dev", "Xi_abs2"))
        same = bool((sub_k["iterations"] == sub_p["iterations"]).all())
        d32 = self._rel(std[::n // 64], sub_k["std dev"])
        print(f"  64 lanes float64 ({len(lanes)} x {nw}): K1 vs the plain solve scale-rel "
              f"{d:.3e} (std dev and |Xi|^2), iterations {'identical' if same else 'differ'}; "
              f"float32 sweep vs float64 {d32:.3e}")
        self.check(d <= 1e-10 and same,
                   "variant sweep, 64 lanes float64: K1 == the plain solve (1e-10, identical "
                   "iterations)")
        self._profile(f"variant sweep {n} x {nw}", run, {"K1": ("solve6_kernel", ", true, ")},
                      (self.record_batches, ("variant_wall_ms",)))

    def _mixed_designs(self, per_family: int, rng):
        """``per_family`` dicts of each shipped design with its platform
        members' diameters scaled by one factor drawn in [0.95, 1.05]."""
        import copy

        from raft_tpu_torch.model import load_design

        out = []
        for name in ("OC3spar", "VolturnUS-S", "OC4semi", "OC4semi_2"):
            base = load_design(DESIGNS / f"{name}.yaml")
            for f in rng.uniform(0.95, 1.05, per_family):
                d = copy.deepcopy(base)
                for mem in d["platform"]["members"]:
                    mem["d"] = (np.asarray(mem["d"], dtype=float) * f).tolist()
                out.append(d)
        return out

    def phase_mixed_designs(self):
        """``sweep_designs`` of 1,000 designs, 250 of each shipped platform
        with its member diameters scaled in [0.95, 1.05], at 200 w (bucket
        256), Hs 8 m / Tp 12 s, scan at 25 iterations, float32: staging and
        solve timed apart, the solve profiled.  Then one lane of each family
        in float64 against its solo run (the OC3 lane in a bucket with
        VolturnUS-S lanes at another depth), K1 against the plain solve on
        those buckets with the padded bins exactly zero, and the 250
        VolturnUS-S dicts again with the nominal hull's BEM coefficients."""
        from raft_tpu_torch.hydro.bem_io import interp_to_grid
        from raft_tpu_torch.model import stage_design_base, stage_designs
        from raft_tpu_torch.parallel.sweep import (_sweep_designs_bucket, forward_response,
                                                   response_std, stage_north_star_bem,
                                                   sweep_designs)

        torch = self.torch
        nw, n_iter = 200, 25
        kw = dict(nw=nw, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
        rng = np.random.default_rng(20261017)
        per = self.per_family
        designs = self._mixed_designs(per, rng)
        n = len(designs)
        t0 = time.perf_counter()
        staged = stage_designs(designs, dtype=torch.float32, device=self.dev, **kw)
        torch.cuda.synchronize()
        t_stage = time.perf_counter() - t0
        self.mixed_staged = staged

        def run():
            return sweep_designs(staged=staged, n_iter=n_iter, return_xi=False,
                                 dtype=torch.float32, device=self.dev)

        self.zero_counts()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        launches = self.counts()
        self.add_main(launches, ("fused", "step"))
        bk, it, std = res["buckets"], res["iterations"], res["std dev"]
        conv = int((it < n_iter).sum())
        fam = it.reshape(4, -1)
        print(f"  mixed designs {n} x {nw} float32: staging {t_stage:.3f} s (host build, one copy "
              f"per bucket, batched mooring stiffness), solve {wall:.3f} s, {n * nw / wall:.1f} "
              f"solves/s; buckets {bk['signatures']}, promotions {bk['promotions']}; iterations "
              f"per family (min-max) {[(int(f.min()), int(f.max())) for f in fam]}; K1 launches "
              f"{launches['fused']}")
        self.check(bk["n_buckets"] == 2 and bk["promotions"] == 0
                   and sorted(s["designs"] for s in bk["signatures"]) == [2 * per, 2 * per]
                   and all(s["nw"] == 256 for s in bk["signatures"]),
                   f"mixed designs: 2 buckets of {2 * per} lanes at nw 256, no promotion")
        self.check(conv == n and bool(np.isfinite(std).all())
                   and launches["fused"] == 2 * n_iter,
                   f"mixed designs: {conv}/{n} lanes converged before the cap, all finite, K1 "
                   f"launched once a step per bucket")
        self.record_batches.update(mixed_stage_s=t_stage, mixed_wall_ms=1e3 * wall)
        self._profile(f"mixed designs solve, {n} x {nw} in 2 buckets", run,
                      {"K1": ("solve6_kernel", ", true, ")},
                      (self.record_batches, ("mixed_wall_ms",)))

        # one lane of each family (and 3 more of each) in float64
        sub = [designs[per * f + j] for f in range(4) for j in range(min(4, per))]
        k = len(sub) // 4
        staged64 = stage_designs(sub, dtype=torch.float64, device=self.dev, **kw)
        mixed = sweep_designs(staged=staged64, n_iter=n_iter, dtype=torch.float64,
                              device=self.dev)
        errs, same = [], True
        for f in range(4):
            _d, m, rna, env, wv, C = stage_design_base(sub[k * f], dtype=torch.float64,
                                                       device=self.dev, **kw)
            o = forward_response(m, rna, env, wv, C, n_iter=n_iter, dtype=torch.float64,
                                 device=self.dev)
            errs.append(self._rel(mixed["std dev"][k * f], response_std(o.Xi.abs2(), wv.w)))
            same = same and int(o.n_iter) == int(mixed["iterations"][k * f])
        depths = {tuple(b.sig): sorted(set(b.env.depth.tolist())) for b in staged64.values()}
        print(f"  float64, one lane per family against its solo run (exact shapes, {nw} w): "
              f"scale-rel {['%.3e' % e for e in errs]}, iterations "
              f"{'identical' if same else 'differ'}; depths per bucket {depths}")
        self.check(max(errs) <= 1e-10 and same,
                   "mixed designs float64: each family's lane == its solo run (1e-10, identical "
                   "iterations), the OC3 lane beside VolturnUS-S lanes at another depth")
        zero_pad, d_plain, same_plain = True, 0.0, True
        for b in staged64.values():
            got = _sweep_designs_bucket(b, n_iter, True, torch.float64, self.dev)
            with plain_solve():
                ref = _sweep_designs_bucket(b, n_iter, True, torch.float64, self.dev)
            zero_pad = zero_pad and bool((got["Xi_abs2"][:, b.nw:] == 0).all())
            d_plain = max(d_plain, self._rel(got["Xi_abs2"], ref["Xi_abs2"]),
                          self._rel(got["std dev"], ref["std dev"]))
            same_plain = same_plain and bool((got["iterations"] == ref["iterations"]).all())
        print(f"  K1 vs the plain solve on both float64 buckets ({2 * k} lanes x 256 w each, two "
              f"depths in one): scale-rel {d_plain:.3e}, iterations "
              f"{'identical' if same_plain else 'differ'}; padded bins exactly 0: {zero_pad}")
        self.check(d_plain <= 1e-10 and same_plain and zero_pad,
                   "mixed designs: K1 == the plain solve per bucket (1e-10, identical "
                   "iterations), the padded bins exactly zero")

        # the 250 VolturnUS-S dicts with the nominal hull's coefficients
        coeffs = self.native_coeffs
        if coeffs is None:
            coeffs = stage_north_star_bem(nw=nw, nw_bem=48, mode="jax", cache=False,
                                          dtype=torch.float64, device=self.dev,
                                          return_diagnostics=True)[1]["coeffs"]
        w_bem, A_c, B_c, F_c = coeffs
        w = np.linspace(0.05, 2.95, nw)
        bem = tuple(interp_to_grid(w_bem, x, w) for x in (A_c, B_c, F_c))
        vus = designs[per:2 * per]
        self.zero_counts()
        t0 = time.perf_counter()
        staged_b = stage_designs(vus, bems=[bem] * len(vus), dtype=torch.float32,
                                 device=self.dev, **kw)
        torch.cuda.synchronize()
        t_stage_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_b = sweep_designs(staged=staged_b, n_iter=n_iter, return_xi=False,
                              dtype=torch.float32, device=self.dev)
        wall_b = time.perf_counter() - t0
        launches = self.counts()
        self.add_main(launches, ("fused", "step"))
        it_b = res_b["iterations"]
        conv_b = int((it_b < n_iter).sum())
        print(f"  {len(vus)} VolturnUS-S designs with the nominal hull's BEM ({'native' if self.native_coeffs is not None else 'card'} "
              f"staging, 48 -> {nw} w) float32: staging {t_stage_b:.3f} s, solve {wall_b:.3f} s; "
              f"iterations {int(it_b.min())}-{int(it_b.max())}; K1 launches {launches['fused']}")
        self.check(conv_b == len(vus) and bool(np.isfinite(res_b["std dev"]).all())
                   and launches["fused"] == n_iter,
                   f"mixed designs with bems: {conv_b}/{len(vus)} converged, all finite, K1 "
                   f"launched")

    # ------------------------------------------------ operations around the solve

    def _dlc_inputs(self):
        """The DLC table of phase "DLC table": VolturnUS-S at 200 w in float64,
        its 7-heading grid (solved here when that phase did not run) and the
        64 cases (8 Hs/Tp rows x 8 headings)."""
        from raft_tpu_torch.model import Model, load_design
        from raft_tpu_torch.parallel.sweep import _volturnus

        torch = self.torch
        w = np.linspace(0.05, 2.95, self.nw)
        if self.dlc_grid is None:
            m = Model(load_design(DESIGNS / "VolturnUS-S.yaml"), w=w, BEM="jax",
                      dtype=torch.float64, device=self.dev)
            m.calcBEM(headings=np.linspace(0, np.pi / 2, 7), cache=False)
            self.dlc_grid = m._bem_headings
        _d, members, rna, env, _wave, C = _volturnus(self.nw, torch.float64, self.dev)
        hs_tp = np.stack([np.linspace(2.0, 10.0, 8), np.linspace(7.0, 15.0, 8)], axis=1)
        cases = np.array([[hs, tp, b] for hs, tp in hs_tp for b in np.linspace(0, np.pi / 2, 8)])
        return w, (members, rna, env, C), cases

    def _north_star_loop(self, bem, dtype):
        """The north star's host loop over chunks as it stood before the
        pipeline (one ``forward_response`` per chunk of 250, ``while`` at
        40): the reference the pipelined runs are held to."""
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
        from raft_tpu_torch.parallel.sweep import (_volturnus, forward_response, north_star_grid,
                                                   response_std)

        torch = self.torch
        _d, members, rna, env, wave, C = _volturnus(self.nw, dtype, self.dev)
        A, B, F = bem
        bem = (A.to(dtype), B.to(dtype), Cx(F.re.to(dtype), F.im.to(dtype)))
        draft, plan = make_stretch_draft(members), make_scale_plan(members)
        scales = torch.as_tensor(north_star_grid(self.n_designs), device=self.dev).to(dtype)
        stds, iters = [], []
        with torch.no_grad():
            for lo in range(0, self.n_designs, self.chunk):
                th = scales[lo:lo + self.chunk]
                out = forward_response(plan(draft(members, th[:, 1]), th[:, 0]), rna, env, wave, C,
                                       bem=bem, n_iter=40, method="while", dtype=dtype,
                                       device=self.dev)
                stds.append(response_std(out.Xi.abs2(), wave.w))
                iters.append(out.n_iter)
        return torch.cat(stds), torch.cat(iters)

    def phase_operations(self):
        """The batch operations around the solve, K1 in every chunk, rung and
        salvaged lane: the BEM-staged north star (1,000 x 200, float32, chunks
        of 250) through ``run_pipelined`` at depth 2 and 1 in turns, twice
        each, bit for bit against each other and the old chunk loop, then with
        ``health=True`` under ``RAFT_TPU_STRICT``; the 64-case DLC table
        (float64) in chunks of 16 with ``health=True`` against the unchunked
        call, and the 1,000 mixed designs (float32) in chunks of 250 at depth 2
        with ``health=True`` against theirs, with ``RAFT_TPU_OBS`` armed: the
        JSONL log, Chrome trace and Prometheus text published and read back,
        the span roll-up's names and counts checked; a NaN chunk of the DLC
        table quarantined and salvaged; a kill after chunk 1 in a child (exit
        77) and the resume from the chunk store, bit for bit; a corrupt chunk
        detected and recomputed; one ``torch.profiler`` capture of a
        pipelined DLC pass (the dispatch range, K1 on the compute stream, the
        copies on their own streams)."""
        import os
        import shutil
        import tempfile
        import warnings

        from raft_tpu_torch import obs
        from raft_tpu_torch.parallel.sweep import (_case_slice, _make_dlc_case_fn,
                                                   make_wave_states, sweep_designs,
                                                   sweep_north_star, sweep_sea_states)

        torch = self.torch
        f32, f64 = torch.float32, torch.float64
        staged_bem = self._staged_bem()

        # 1. the north star through the pipeline, depth 2 and 1 in turns
        kw = dict(n_designs=self.n_designs, nw=self.nw, chunk=self.chunk, n_iter=40, dtype=f32,
                  device=self.dev, bem=staged_bem)
        t0 = time.perf_counter()
        loop_std, loop_it = self._north_star_loop(staged_bem, f32)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        runs, t_loop, k1 = [], [], 0
        for depth in (2, 1, None, 2, 1, None):
            torch.cuda.synchronize()
            if depth is None:
                t0 = time.perf_counter()
                again = self._north_star_loop(staged_bem, f32)
                torch.cuda.synchronize()
                t_loop.append(time.perf_counter() - t0)
                self.check(torch.equal(again[0], loop_std) and torch.equal(again[1], loop_it),
                           "the old chunk loop repeats its bits")
                continue
            self.zero_counts()
            t0 = time.perf_counter()
            res = sweep_north_star(**kw, pipeline_depth=depth)
            runs.append((depth, time.perf_counter() - t0, res))
            k1 += self.counts()["fused"]
        self.add_main({"fused": k1}, ("fused",))
        same = all(torch.equal(r["std"], loop_std) and torch.equal(r["n_iter"], loop_it)
                   for _d, _t, r in runs)
        for depth, wall, r in runs:
            p = r["pipeline"]
            print(f"  north star {self.n_designs} x {self.nw} float32, depth {depth}: wall "
                  f"{wall:.3f} s, overlap_fraction {p['overlap_fraction']}, max_in_flight "
                  f"{p['max_in_flight']}, stage_s {p['stage_s']}, fetch_s {p['fetch_s']}, "
                  f"pipeline wall_s {p['wall_s']}")
        print(f"    the old chunk loop, in turns with them: {t_loop[0]:.3f}, {t_loop[1]:.3f} s "
              f"(its first, cold run {t_cold:.3f} s); K1 launches over the four runs {k1}; std "
              f"dev and iterations bit for bit across the four runs and against the loop: "
              f"{same}")
        self.check(same and all(r["pipeline"]["max_in_flight"] == d for d, _t, r in runs),
                   "north star through run_pipelined: depth 2 == depth 1 == the chunk loop, bit "
                   "for bit (std dev, iterations), twice each")
        os.environ["RAFT_TPU_STRICT"] = "1"
        try:
            self.zero_counts()
            t0 = time.perf_counter()
            res_h = sweep_north_star(**kw, pipeline_depth=2, health=True)
            wall_h = time.perf_counter() - t0
            self.add_main(self.counts(), ("fused", "step"))
        finally:
            os.environ.pop("RAFT_TPU_STRICT", None)
        rz = res_h["resilience"]
        print(f"  north star health=True, RAFT_TPU_STRICT=1: {wall_h:.3f} s, resilience {rz}")
        self.check(rz["n_quarantined"] == 0 and bool(res_h["converged"].all())
                   and torch.equal(res_h["std"], loop_std),
                   "north star health=True (strict): every lane converged finite, same bits")

        # 2. the references: the DLC table and the mixed designs unchunked
        w, (members, rna, env, C), cases = self._dlc_inputs()
        grid = self.dlc_grid
        waves = make_wave_states(w, cases, env.depth, dtype=f64, device=self.dev)
        dlc = dict(bem=grid, n_iter=25, health=True, dtype=f64, device=self.dev)
        t0 = time.perf_counter()
        whole = sweep_sea_states(members, rna, env, waves, C, **dlc)
        t_whole = time.perf_counter() - t0
        staged = self.mixed_staged
        if staged is None:
            from raft_tpu_torch.model import stage_designs

            designs = self._mixed_designs(self.per_family, np.random.default_rng(20261017))
            staged = stage_designs(designs, nw=self.nw, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95,
                                   dtype=f32, device=self.dev)
            self.mixed_staged = staged
        mix = dict(staged=staged, n_iter=25, return_xi=False, health=True, dtype=f32,
                   device=self.dev)
        t0 = time.perf_counter()
        mixed_whole = sweep_designs(**mix)
        t_mixed = time.perf_counter() - t0

        # 3. chunked with RAFT_TPU_OBS armed: the DLC table and the mixed designs
        sink = tempfile.mkdtemp(prefix="raft_torch_obs_")
        obs.reset()
        os.environ["RAFT_TPU_OBS"] = sink
        try:
            self.zero_counts()
            t0 = time.perf_counter()
            chunked = sweep_sea_states(members, rna, env, waves, C, chunk=16, **dlc)
            t_chunked = time.perf_counter() - t0
            t0 = time.perf_counter()
            mixed = sweep_designs(**mix, chunk=self.chunk, pipeline_depth=2)
            t_mixed_chunked = time.perf_counter() - t0
            launches = self.counts()
            self.add_main(launches, ("fused", "step"))
            paths = obs.publish("operations")
        finally:
            os.environ.pop("RAFT_TPU_OBS", None)
        d_dlc = max(self._rel(chunked[k], whole[k])
                    for k in ("std dev", "nacelle accel std dev", "Xi_abs2"))
        same_it = bool((chunked["iterations"] == whole["iterations"]).all())
        p = chunked["pipeline"]
        print(f"  DLC table 64 x {self.nw} float64 health=True: unchunked {t_whole:.3f} s, chunks "
              f"of 16 {t_chunked:.3f} s; scale-rel {d_dlc:.3e}, iterations "
              f"{'identical' if same_it else 'differ'}; pipeline {p}; health {chunked['health']}")
        self.check(d_dlc <= 1e-12 and same_it and chunked["health"]["n_quarantined"] == 0
                   and p["chunks"] == 4 and p["donated_buffers"] == 4
                   and p["invalidated_buffers"] == 4,
                   "DLC table in chunks of 16 == unchunked (1e-12, identical iterations), the "
                   "chunks' excitation donated and released")
        rel_m = float(np.max(np.abs(mixed["std dev"] - mixed_whole["std dev"])
                             / np.maximum(np.abs(mixed_whole["std dev"]), 1e-30)))
        same_m = bool((mixed["iterations"] == mixed_whole["iterations"]).all())
        print(f"  mixed designs {sum(b['designs'] for b in mixed['buckets']['signatures'])} x "
              f"{self.nw} float32 health=True: unchunked {t_mixed:.3f} s, chunks of "
              f"{self.chunk} at depth 2 {t_mixed_chunked:.3f} s; std dev relative {rel_m:.3e}, "
              f"iterations {'identical' if same_m else 'differ'}; K1 launches (DLC + designs) "
              f"{launches['fused']}")
        print(f"    buckets {json.dumps(mixed['buckets'])}")
        print(f"    pipeline {json.dumps(mixed['pipeline'])}")
        h = mixed["health"]
        print(f"    health {json.dumps({k: v for k, v in h.items() if k != 'per_bucket'})}")
        self.check(rel_m <= 1e-5 and same_m and h["n_quarantined"] == 0
                   and all(b["chunks"] == 2 for b in mixed["pipeline"].values()),
                   "mixed designs in chunks of 250 at depth 2 == unchunked (1e-5 relative, "
                   "identical iterations), every lane healthy")
        events, corrupt = obs.read_jsonl(paths["jsonl"])
        with open(paths["chrome_trace"]) as f:
            chrome = json.load(f)
        with open(paths["prom"]) as f:
            prom = [line for line in f.read().splitlines() if line]
        prom_ok = all(line.startswith("#") or len(line.rsplit(" ", 1)) == 2
                      and float(line.rsplit(" ", 1)[1]) >= 0 for line in prom)
        roll = obs.trace.rollup()
        counts = {k: roll.get(k, {}).get("count", 0) for k in (
            "pipeline/stage", "pipeline/dispatch", "pipeline/fetch", "sweep_designs/bucket",
            "sweep_designs/bucket/pipeline/stage", "sweep_designs/bucket/pipeline/dispatch",
            "sweep_designs/bucket/pipeline/fetch")}
        spans = [e for e in events if e.get("type") == "span"]
        x_events = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
        print(f"  obs sinks {sorted(os.path.basename(v) for v in paths.values())}: JSONL "
              f"{len(events)} events ({corrupt} corrupt, {len(spans)} spans), Chrome trace "
              f"{len(x_events)} events, Prometheus {len(prom)} lines; roll-up counts {counts}")
        self.check(corrupt == 0 and events[0]["type"] == "meta" and events[-1]["type"] == "metrics"
                   and len(spans) == len(x_events) > 0 and prom_ok
                   and "raft_tpu_pipeline_chunks_computed 8" in prom
                   and counts == {"pipeline/stage": 4, "pipeline/dispatch": 4,
                                  "pipeline/fetch": 4, "sweep_designs/bucket": 2,
                                  "sweep_designs/bucket/pipeline/stage": 4,
                                  "sweep_designs/bucket/pipeline/dispatch": 4,
                                  "sweep_designs/bucket/pipeline/fetch": 4},
                   "obs: JSONL, Chrome trace and Prometheus text read back; the spans "
                   "pipeline/stage, dispatch, fetch and sweep_designs/bucket counted once a chunk "
                   "(a bucket)")
        shutil.rmtree(sink, ignore_errors=True)

        # 4. a NaN chunk: quarantined, every lane salvaged at n_iter_x4 through K1
        os.environ["RAFT_TPU_FAULT_INJECT"] = "nan_chunk:1"
        try:
            self.zero_counts()
            t0 = time.perf_counter()
            nan = sweep_sea_states(members, rna, env, waves, C, chunk=16, **dlc)
            t_nan = time.perf_counter() - t0
            launches = self.counts()
            self.add_main(launches, ("fused", "step"))
        finally:
            os.environ.pop("RAFT_TPU_FAULT_INJECT", None)
        hn = nan["health"]
        salvage_k1 = launches["fused"] - 4 * 25
        d_nan = max(self._rel(nan[k], chunked[k])
                    for k in ("std dev", "nacelle accel std dev", "Xi_abs2"))
        print(f"  NaN in chunk 1: {t_nan:.3f} s; quarantined {hn['quarantined']}, salvaged "
              f"{hn['salvaged']}, rungs {hn['rungs_used']}, K1 launches of the salvage "
              f"{salvage_k1} ({salvage_k1 / max(hn['salvaged'], 1):.0f} a lane); against the "
              f"clean run {d_nan:.3e}")
        self.check(hn["quarantined"] == list(range(16, 32)) and hn["salvaged"] == 16
                   and hn["rungs_used"] == {"n_iter_x4": 16} and not hn["unsalvaged"]
                   and salvage_k1 >= 16 and d_nan <= 1e-10 and nan["converged"].all(),
                   "NaN chunk: lanes 16-31 quarantined, each salvaged at n_iter_x4 through K1, "
                   "== the clean run (1e-10)")

        # 5. kill after chunk 1 in a child, resume here; a corrupt chunk recomputed
        tmp = tempfile.mkdtemp(prefix="raft_torch_ckpt_")
        try:
            self._kill_and_resume(tmp, w, cases, chunked)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # 6. one profiler capture of a pipelined DLC pass; does the scan chunk sync?
        self._profile_pipeline(members, rna, env, waves, C, dlc)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = _make_dlc_case_fn(members, rna, env, C, None, 25, dtype=f64, device=self.dev)
            sub = _case_slice(waves, slice(0, 16))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with torch.no_grad():
                    run(sub, None, None)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        where: dict = {}
        for c in caught:
            if "synchronizing CUDA operation" in str(c.message):
                at = f"{os.path.relpath(c.filename, ROOT)}:{c.lineno}"
                where[at] = where.get(at, 0) + 1
        print(f"  the DLC chunk function (scan, 25 iterations) under CUDA's sync debug mode: "
              f"{sum(where.values())} synchronising calls, by the line that made them: {where}")

    def _kill_and_resume(self, tmp: str, w, cases, clean: dict):
        """Kill a chunked DLC pass after chunk 1 in a child process (exit 77),
        resume it here from the chunk store; then corrupt chunk 2 in a fresh
        store and see it detected and recomputed."""
        import os
        import warnings

        from raft_tpu_torch.parallel.sweep import _volturnus, make_wave_states, sweep_sea_states
        from raft_tpu_torch.resilience import faults

        torch = self.torch
        betas, F_all, A, B = self.dlc_grid
        np.savez(os.path.join(tmp, "grid.npz"), betas=betas, F_all=F_all, A=A, B=B, w=w,
                 cases=cases)
        # the parent runs on the grid as the child reads it back
        z = np.load(os.path.join(tmp, "grid.npz"))
        grid = (z["betas"], z["F_all"], z["A"], z["B"])
        child = (
            "import json, sys, numpy as np, torch\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from raft_tpu_torch.parallel.sweep import _volturnus, make_wave_states, "
            "sweep_sea_states\n"
            f"z = np.load({os.path.join(tmp, 'grid.npz')!r})\n"
            "grid = (z['betas'], z['F_all'], z['A'], z['B'])\n"
            f"dev = torch.device({self.dev.type!r})\n"
            "_d, m, rna, env, _w, C = _volturnus(len(z['w']), torch.float64, dev)\n"
            "waves = make_wave_states(z['w'], z['cases'], env.depth, dtype=torch.float64, "
            "device=dev)\n"
            "res = sweep_sea_states(m, rna, env, waves, C, bem=grid, n_iter=25, chunk=16, "
            "health=True, dtype=torch.float64, device=dev)\n"
            "print(json.dumps(res['pipeline']))\n")
        store = os.path.join(tmp, "ckpt")
        env_child = {k: v for k, v in os.environ.items() if k != "RAFT_TPU_FAULT_INJECT"}
        env_child.update(RAFT_TPU_CKPT=store, RAFT_TPU_FAULT_INJECT="kill_after_chunk:1")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                           timeout=300, env=env_child)
        t_child = time.perf_counter() - t0
        stored = sorted(f for _d, _s, fs in os.walk(store) for f in fs if f.startswith("chunk_"))
        print(f"  child killed after chunk 1: exit {r.returncode} in {t_child:.2f} s (interpreter, "
              f"import torch, the first CUDA work, the solve); chunks stored {stored}")
        if r.returncode != faults.KILL_EXIT:
            print(r.stderr[-3000:])
        self.check(r.returncode == faults.KILL_EXIT and stored == ["chunk_0.npz", "chunk_1.npz"],
                   "kill_after_chunk:1 in a child: exit 77 after storing chunks 0 and 1")
        _d, m, rna, env, _w, C = _volturnus(len(w), torch.float64, self.dev)
        waves = make_wave_states(w, cases, env.depth, dtype=torch.float64, device=self.dev)
        dlc = dict(bem=grid, n_iter=25, chunk=16, health=True, dtype=torch.float64,
                   device=self.dev)
        keys = ("std dev", "nacelle accel std dev", "Xi_abs2", "iterations")

        def run(store_dir, fault=None):
            os.environ["RAFT_TPU_CKPT"] = store_dir
            if fault:
                os.environ["RAFT_TPU_FAULT_INJECT"] = fault
            try:
                with warnings.catch_warnings():       # the store's note on a corrupt chunk
                    warnings.simplefilter("ignore")
                    return sweep_sea_states(m, rna, env, waves, C, **dlc)
            finally:
                os.environ.pop("RAFT_TPU_CKPT", None)
                os.environ.pop("RAFT_TPU_FAULT_INJECT", None)

        resumed = run(store)
        p = resumed["pipeline"]
        bits = all(np.array_equal(resumed[k], clean[k]) for k in keys)
        print(f"  resumed here: chunks_resumed {p['chunks_resumed']}, chunks_computed "
              f"{p['chunks_computed']}, bit for bit with the uninterrupted run: {bits}")
        self.check(p["chunks_resumed"] == 2 and p["chunks_computed"] == 2 and bits,
                   "resume: 2 chunks from the store, 2 computed, bit-identical results")
        store2 = os.path.join(tmp, "ckpt2")
        first = run(store2, fault="corrupt_ckpt:2")
        again = run(store2)
        p2 = again["pipeline"]
        bits2 = all(np.array_equal(again[k], clean[k]) and np.array_equal(first[k], clean[k])
                    for k in keys)
        print(f"  corrupt_ckpt:2, then a run on that store: ckpt_corrupt {p2['ckpt_corrupt']}, "
              f"chunks_resumed {p2['chunks_resumed']}, chunks_computed {p2['chunks_computed']}, "
              f"bit for bit: {bits2}")
        self.check(p2["ckpt_corrupt"] == 1 and p2["chunks_resumed"] == 3
                   and p2["chunks_computed"] == 1 and bits2,
                   "corrupt chunk 2 detected by its hash and recomputed, results bit-identical")

    def _profile_pipeline(self, members, rna, env, waves, C, dlc):
        """One ``torch.profiler`` capture of the chunked DLC pass: the
        ``pipeline/dispatch`` ranges, K1 on the compute stream, the staging's
        host-to-device copies and the fetch's device-to-host copies each on
        a stream of their own."""
        import os
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        from raft_tpu_torch.parallel.sweep import sweep_sea_states

        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sweep_sea_states(members, rna, env, waves, C, chunk=16, **dlc)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        evs = [e for e in trace.get("traceEvents", []) if isinstance(e, dict)]
        ranges = [e for e in evs if e.get("name") == "pipeline/dispatch"
                  and e.get("cat") == "user_annotation"]
        gpu_ranges = [e for e in evs if e.get("name") == "pipeline/dispatch"
                      and e.get("cat") == "gpu_user_annotation"]

        def streams(pred):
            return sorted({e.get("args", {}).get("stream") for e in evs if pred(e)} - {None})

        def copies(kind):
            return [e.get("args", {}).get("stream") for e in evs
                    if e.get("cat") == "gpu_memcpy" and kind in e.get("name", "")]

        k1 = streams(lambda e: e.get("cat") == "kernel" and "solve6_kernel" in e.get("name", ""))
        h2d, d2h = copies("HtoD"), copies("DtoH")
        side_h2d = [s for s in h2d if s not in k1]
        side_d2h = [s for s in d2h if s not in k1]
        print(f"  profiled chunked DLC pass: 'pipeline/dispatch' ranges {len(ranges)} on the host, "
              f"{len(gpu_ranges)} on the device; K1 on streams {k1}; host-to-device copies "
              f"{len(h2d)} ({len(side_h2d)} off K1's stream, on {sorted(set(side_h2d))}), "
              f"device-to-host {len(d2h)} ({len(side_d2h)} off it, on {sorted(set(side_d2h))})")
        self.check(len(ranges) == 4 and len(k1) == 1 and len(side_h2d) >= 4
                   and len(side_d2h) >= 4 and not set(side_h2d) & set(side_d2h),
                   "profile: 4 dispatch ranges, K1 on one (compute) stream, the staging copies "
                   "and the fetches each on a stream of their own")

    def _serve_rows_equal(self, got: dict, want: dict) -> bool:
        """A served row against its reference row: bit for bit, identical
        iterations."""
        return got["std_dev"] == want["std_dev"] and got["iterations"] == want["iterations"]

    def phase_serve(self):
        """The serving daemon at its defaults, in process through a real
        socket client, then as a daemon child (see the module docstring,
        phase 21)."""
        import os
        import shutil
        import tempfile

        from raft_tpu_torch.core import cuda6
        from raft_tpu_torch.parallel.sweep import sweep_designs
        from raft_tpu_torch.serve import loadgen, protocol, smoke
        from raft_tpu_torch.serve.batcher import Lane
        from raft_tpu_torch.serve.client import SolveClient
        from raft_tpu_torch.serve.config import ServeConfig
        from raft_tpu_torch.serve.server import SolverServer
        from raft_tpu_torch.serve.solver import SolverCore, compiles, solve_batch, solve_solo

        torch = self.torch
        designs = ("oc3", "oc4", "volturnus")
        paths = {a: protocol.resolve_design(a)[0] for a in designs}
        tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
        server = None
        try:
            cuda6.build()                    # K1's library built or loaded before arming
            builds0 = compiles()
            # the daemon's defaults: 100 w (128 padded), 25 iterations, 8 lanes,
            # 25 ms, float64, the card
            cfg = ServeConfig(socket_path=os.path.join(tmp, "serve.sock"))
            probe = SolverCore(cfg)
            for a in designs:
                times = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    probe.stage_lane(paths[a], 8.0, 12.0)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                print(f"  stage_lane {a}: cold {times[0]:.4f} s, warm (memo hit) "
                      f"{times[1] * 1e3:.4f} ms")
            del probe
            server = SolverServer(cfg)
            server.start()
            t0 = time.perf_counter()
            warm = server.warmup(designs)
            torch.cuda.synchronize()
            print(f"  warmup {warm} in {time.perf_counter() - t0:.3f} s")
            self.check(len(warm) == 2 and compiles() == builds0,
                       "serve: warmup arms two buckets, no kernel build")
            seas = [(6.0 + 0.5 * i, 9.0 + 0.5 * i) for i in range(8)]
            sched = {"n_hs": 2, "n_tp": 1}
            self.zero_counts()
            with SolveClient(cfg.socket_path, connect_timeout=30.0) as cl:
                t0 = time.perf_counter()
                futs = [(a, Hs, Tp, cl.submit({"op": "solve", "design": a, "Hs": Hs, "Tp": Tp}))
                        for Hs, Tp in seas for a in designs]
                f_dlc = cl.submit({"op": "dlc", "design": "volturnus",
                                   "cases": [[Hs, Tp] for Hs, Tp in seas]})
                f_sw = cl.submit({"op": "sweep", "designs": list(designs), "Hs": 8.0, "Tp": 12.0})
                solves = [(a, Hs, Tp, f.result(600.0)) for a, Hs, Tp, f in futs]
                dlc, sw = f_dlc.result(600.0), f_sw.result(600.0)
                t_mixed = time.perf_counter() - t0
                # bench.py::serving_block's stream: a warm pass, the measured open
                # loop, a sequential baseline
                loadgen.run_open_loop(cl, 48, 400.0, **sched)
                server.core.reset_stats()
                server.reset_telemetry()
                open_out, _ = loadgen.run_open_loop(cl, 48, 400.0, **sched)
                occupancy = {k: v["mean_occupancy"]
                             for k, v in server.core.stats()["buckets"].items()}
                tel = server.telemetry()
                seq_out = loadgen.run_sequential(cl, 12, 400.0, **sched)
            torch.cuda.synchronize()
            launches = self.counts()
            self.add_main(launches, ("fused", "step"))
            print(f"  mixed stream: 24 solve + 1 dlc (8 lanes) + 1 sweep (3 lanes), cold "
                  f"staging included: {t_mixed:.3f} s; K1 launches in the served path "
                  f"{launches['fused']}")
            ratio = open_out["solves_per_s"] / seq_out["solves_per_s"]
            print(f"  load open loop (48 at 400/s): p50 {open_out['latency_p50_s']} s, p99 "
                  f"{open_out['latency_p99_s']} s, {open_out['solves_per_s']} solves/s; "
                  f"sequential (12): p50 {seq_out['latency_p50_s']} s, "
                  f"{seq_out['solves_per_s']} solves/s; ratio {ratio:.2f}; occupancy "
                  f"{occupancy}; server window p50 {tel['latency']['p50']} p99 "
                  f"{tel['latency']['p99']} (card: {nvidia_smi()})")
            self.check(launches["fused"] > 0 and compiles() == builds0,
                       "serve: the served path launched K1, no kernel build")
            ok = all(r["ok"] for *_x, r in solves) and dlc["ok"] and sw["ok"]
            self.check(ok, "serve: every request answered ok")
            core = server.core
            same = all(self._serve_rows_equal(r["results"][0],
                                              solve_solo(core, paths[a], Hs, Tp))
                       for a, Hs, Tp, r in solves)
            same &= all(self._serve_rows_equal(row, solve_solo(core, paths["volturnus"], Hs, Tp))
                        for row, (Hs, Tp) in zip(dlc["results"], seas))
            same &= all(self._serve_rows_equal(row, solve_solo(core, paths[a], 8.0, 12.0))
                        for row, a in zip(sw["results"], designs))
            self.check(ok and same, "serve: 35 served rows == solve_solo bit for bit, "
                                    "identical iterations")

            def lane(a, Hs, Tp):
                sig, staged = core.stage_lane(paths[a], Hs, Tp)
                return sig, Lane(request_id=None, seq=0, label=a, staged=staged)

            sig, l_a = lane("oc3", 7.0, 11.0)
            _s, l_v = lane("volturnus", 6.0, 10.0)
            _s, l_b = lane("oc3", 9.0, 13.0)
            solo = solve_solo(core, paths["oc3"], 7.0, 11.0)
            at0 = solve_batch(core, sig, [l_a, l_v, l_b])[0][0]
            at1 = solve_batch(core, sig, [l_v, l_a])[0][1]
            self.check(self._serve_rows_equal(at0, solo) and self._serve_rows_equal(at1, solo),
                       "serve: a lane at positions 0 and 1 of mixed batches == solo, bit for bit")
            _s, l_bad = lane("oc3", 6.0, 0.0)
            rows, info = solve_batch(core, sig, [l_a, l_bad])
            self.check(rows[1]["quarantined"] and not rows[1]["finite"]
                       and info["quarantined_real"] == [1]
                       and self._serve_rows_equal(rows[0], solo),
                       "serve: a Tp = 0 lane quarantined, its batch-mate's bits unmoved")
            ref = sweep_designs([paths[a] for a in designs], nw=cfg.nw, Hs=8.0, Tp=12.0,
                                n_iter=cfg.n_iter, return_xi=False, device=self.dev)
            errs, same_it = [], True
            for i, a in enumerate(designs):
                r = solve_solo(core, paths[a], 8.0, 12.0)
                want = np.asarray(ref["std dev"][i])
                errs.append(float(np.max(np.abs(np.asarray(r["std_dev"]) - want))
                                  / np.max(np.abs(want))))
                same_it &= r["iterations"] == int(ref["iterations"][i])
            print(f"  served rows against sweep_designs: rel {max(errs):.3e}")
            self.check(max(errs) <= 1e-12 and same_it,
                       "serve: each bucket's rows == sweep_designs (1e-12, identical iterations)")
            full = [l_a, l_v, l_b] + [lane("volturnus", 6.0 + k, 10.0 + k)[1] for k in range(1, 6)]
            rows_k1, _ = solve_batch(core, sig, full)
            with plain_solve():
                rows_plain, _ = solve_batch(core, sig, full)
            err = max(float(np.max(np.abs(np.subtract(a["std_dev"], b["std_dev"])))
                            / np.max(np.abs(b["std_dev"]))) for a, b in zip(rows_k1, rows_plain))
            print(f"  one padded batch (8 lanes x 128 w, float64) K1 against the plain solve: "
                  f"rel {err:.3e}")
            self.check(err <= 1e-10 and all(a["iterations"] == b["iterations"]
                                            for a, b in zip(rows_k1, rows_plain)),
                       "serve: a padded batch through K1 == the plain solve (1e-10, "
                       "identical iterations)")
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                solve_batch(core, sig, full)      # returns host rows: synchronised
                walls.append(1e3 * (time.perf_counter() - t0))
            print(f"  one padded batch (8 lanes): {np.mean(walls):.2f} ms mean, "
                  f"{min(walls):.2f} ms min of 5 (card: {nvidia_smi()})")
            self._profile("one padded serve batch (8 lanes x 128 w, float64, 25 iterations)",
                          lambda: solve_batch(core, sig, full), {"K1": ("solve6",)},
                          ({"wall_ms": float(np.mean(walls))}, ("wall_ms",)))
            server.stop()
            server = None

            # the daemon as a child process and its SIGTERM (other processes serving
            # these rows bit for bit without a build, a restarted one among them:
            # phase "fleet"'s replicas, held against these rows)
            sock = os.path.join(tmp, "child.sock")
            proc, ready = smoke.spawn_daemon(sock, os.path.join(tmp, "child.err"), None,
                                             full_width=True)
            rows1, full_c, info_c = smoke.drive_stream(sock)
            rc1 = smoke.stop_daemon(proc)
            fused = (full_c["solver"]["kernel_launches"]["fused"]
                     - ready["kernel_launches_at_ready"]["fused"])
            self.add_main({"fused": fused}, ("fused",))
            print(f"  daemon child: ready_s {ready['ready_s']} (spawn to ready "
                  f"{ready['spawn_to_ready_s']} s), compiles_at_ready "
                  f"{ready['compiles_at_ready']}, stream {info_c['wall_s']:.3f} s, "
                  f"K1 launches {fused}, exit {rc1}")
            solo_rows = smoke.solo_reference(None, full_width=True)
            self.check(rc1 == 0 and not os.path.exists(sock),
                       "serve: SIGTERM drains the child with exit 0, socket unlinked")
            self.check(rows1 == solo_rows, "serve: child rows == in-process solo rows")
            self.check(ready["compiles_at_ready"] == 0 and full_c["solver"]["compiles"] == 0,
                       "serve: no kernel build in the child (compiles 0)")
            self.serve_child_rows = rows1
        finally:
            if server is not None:
                server.stop()
            shutil.rmtree(tmp, ignore_errors=True)

    def phase_fleet(self):
        """The replica fleet behind the failover router (see the module
        docstring, phase 22)."""
        import shutil
        import tempfile

        from raft_tpu_torch.serve import fleet_smoke, smoke

        ref = smoke.solo_reference(None, fleet_smoke.STREAM, full_width=True)
        if self.serve_child_rows is not None:
            self.check(self.serve_child_rows == ref[:len(self.serve_child_rows)],
                       "fleet: reference rows == the serve phase's child rows, bit for bit")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
        try:
            t0 = time.perf_counter()
            checks, info = fleet_smoke.run(None, tmp, reference_rows=ref, full_width=True)
            self.add_main({"fused": info["k1_launches"]}, ("fused",))
            print(f"  fleet phases B and C in {time.perf_counter() - t0:.1f} s; ready_s "
                  f"{info['ready_s']}; failover requests {info['failover_requests']}, "
                  f"resubmitted responses {info['resubmitted_responses']}, killed "
                  f"{info['killed_replica']}, shed {info['shed_count']}; K1 launches of the "
                  f"live replicas after ready {info['k1_launches']} (card: {nvidia_smi()})")
            self.check(info["k1_launches"] > 0, "fleet: the replicas' served path launched K1")
            for name, ok in checks.items():
                self.check(ok, f"fleet: {name}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def phase_array_farm(self):
        """``Model(VolturnUS-S, nTurbines=16, BEM="jax")``: 16 turbines on a
        4 x 4 grid at 1,500 m, the default 59 w, float64, heading 30 deg,
        every step timed; K3 once and K4 per chunk, K1 per iteration for
        all turbines at once.  Turbine 0 against the single-turbine Model,
        the last against a one-turbine array at its position, K1 against
        the plain solve, K3/K4 against their plain versions, and the air
        gap of turbine 0's Model at 4 deck points."""
        from raft_tpu_torch.array import ArrayModel
        from raft_tpu_torch.hydro import torch_bem
        from raft_tpu_torch.model import Model, load_design

        torch = self.torch
        design = load_design(DESIGNS / "VolturnUS-S.yaml")
        side = self.farm_side
        pos = np.array([[1500.0 * i, 1500.0 * j] for i in range(side) for j in range(side)])
        env = dict(Hs=8.0, Tp=12.0, V=10.0, beta=float(np.deg2rad(30.0)),
                   Fthrust=float(design["turbine"]["Fthrust"]))
        f64 = torch.float64
        farm = Model(design, nTurbines=len(pos), positions=pos, BEM="jax", dtype=f64,
                     device=self.dev)
        farm.setEnv(**env)
        self.zero_counts()
        times = {}
        for step, call in (("calcBEM", lambda: farm.calcBEM(cache=False)),
                           ("calcSystemProps", farm.calcSystemProps),
                           ("solveEigen", farm.solveEigen),
                           ("calcMooringAndOffsets", farm.calcMooringAndOffsets),
                           ("solveDynamics", farm.solveDynamics),
                           ("calcOutputs", farm.calcOutputs)):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times[step] = time.perf_counter() - t0
        launches = self.counts()
        self.add_main(launches, ("fused", "rankine", "wave", "step"))
        resp = farm.results["response"]
        n_chunks = -(-len(farm.w) // 2)
        print(f"  farm of {len(pos)} VolturnUS-S, BEM='jax' ({farm.bem_diagnostics['panels']} panels -> "
              f"{farm.bem_diagnostics['padded']}), {len(farm.w)} w, float64, beta 30 deg: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
              + f"; iterations {resp['iterations'].tolist()}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        print(f"    std dev turbine 0: {np.array2string(resp['std dev'][0], precision=5)}; "
              f"natural frequencies [Hz] turbine 0: "
              f"{np.array2string(farm.results['eigen']['frequencies'][0], precision=5)}")
        self.check(bool(resp["converged"].all()) and bool(np.isfinite(resp["Xi per turbine"]).all())
                   and farm._moor_batchable() and launches["rankine"] == 1
                   and launches["wave"] == n_chunks and launches["fused"] == int(resp["iterations"].max()),
                   f"farm: {len(pos)} turbines converged and finite, the mooring batched, K3 once, K4 "
                   f"{n_chunks} times, K1 once an iteration")
        self.record_batches["farm_s"] = times

        bem = farm.bem
        single = Model(design, BEM=bem, dtype=f64, device=self.dev)
        single.setEnv(**env)
        single.calcSystemProps()
        single.solveEigen()
        t0 = time.perf_counter()
        single.calcMooringAndOffsets()
        torch.cuda.synchronize()
        t_moor1 = time.perf_counter() - t0
        single.solveDynamics()
        errs = [self._rel(resp["Xi per turbine"][0], single.results["response"]["Xi"]),
                self._rel(farm.results["eigen"]["frequencies"][0],
                          single.results["eigen"]["frequencies"]),
                self._rel(farm.results["means"]["platform offset"][0],
                          single.results["means"]["platform offset"])]
        same = int(resp["iterations"][0]) == single.results["response"]["iterations"]
        for t in (len(pos) - 1,):
            one = ArrayModel(design, positions=pos[t:t + 1], BEM=bem, dtype=f64, device=self.dev)
            one.setEnv(**env)
            one.calcSystemProps()
            one.calcMooringAndOffsets()
            one.solveDynamics()
            errs.append(self._rel(resp["Xi per turbine"][t],
                                  one.results["response"]["Xi per turbine"][0]))
            same = same and int(resp["iterations"][t]) == int(one.results["response"]["iterations"][0])
        print(f"  one turbine's calcMooringAndOffsets (the unbatched Newton): {t_moor1:.3f} s "
              f"against {times['calcMooringAndOffsets']:.3f} s for the farm's {len(pos)}")
        print(f"  farm against one turbine (0: the single Model's Xi, eigen, offset; "
              f"{len(pos) - 1}: a one-turbine array at its position): scale-rel "
              f"{['%.3e' % e for e in errs]}, iterations {'identical' if same else 'differ'}")
        self.check(max(errs) <= 1e-10 and same,
                   "farm turbines == their single-turbine runs (1e-10, identical iterations)")

        Xi_k = resp["Xi per turbine"]
        it_k = resp["iterations"].copy()
        with plain_solve():
            farm.solveDynamics()
        d_k1 = self._rel(Xi_k, farm.results["response"]["Xi per turbine"])
        same_k1 = bool((it_k == farm.results["response"]["iterations"]).all())
        plain = ArrayModel(design, positions=pos[:1], BEM="jax", dtype=f64, device=self.dev)
        plain.setEnv(**env)
        orig = torch_bem.rankine_assembly, torch_bem.wave_assembly
        torch_bem.rankine_assembly, torch_bem.wave_assembly = (torch_bem.rankine_plain,
                                                               torch_bem.wave_plain)
        try:
            plain.calcBEM(cache=False)
        finally:
            torch_bem.rankine_assembly, torch_bem.wave_assembly = orig
        d_bem = max(torch_bem.parity_err(a, b) for a, b in zip(bem, plain.bem))
        print(f"  farm: K1 vs the plain solve ({len(pos)} turbines x {len(farm.w)} w) scale-rel "
              f"{d_k1:.3e}, iterations {'identical' if same_k1 else 'differ'}; K3/K4 vs their "
              f"plain versions, A/B/F scale-rel {d_bem:.3e}")
        self.check(d_k1 <= 1e-10 and same_k1 and d_bem <= 1e-10,
                   "farm: K1 == the plain solve (1e-10, identical iterations), K3/K4 == plain "
                   "(A/B/F 1e-10)")

        pts = [[0.0, 0.0], [40.0, 0.0], [-20.0, 35.0], [-20.0, -35.0]]
        t0 = time.perf_counter()
        gap = single.airgap(pts, deck_z=15.0)
        t_gap = time.perf_counter() - t0
        print(f"  airgap of turbine 0's Model, deck 15 m, 4 points: sigma "
              f"{np.array2string(gap['sigma rel elevation'], precision=4)} m, 3-sigma margins "
              f"{np.array2string(gap['margin 3 sigma'], precision=4)} m ({t_gap * 1e3:.1f} ms)")
        self.check(bool(np.isfinite(gap["sigma rel elevation"]).all())
                   and bool((gap["sigma rel elevation"] > 0).all()),
                   "airgap: finite, positive relative-elevation sigma at 4 points")

    # ---------------------------------------------------- bf16 assembly

    def _bf16_held(self, got, ref, what: str):
        """Hold bf16 kernel outputs against their plain version's, elementwise:
        |kernel - plain| <= BF16_STEP |plain| + TOL_BEM["float32"] max|plain|.
        Returns (largest share of the bound used, elements past the half-step
        bound 2^-8 |plain| + ..., largest absolute difference)."""
        torch = self.torch
        worst, over_half, ab = 0.0, 0, 0.0
        tol = TOL_BEM["float32"]["wave" if "K4" in what else "rankine"]
        for g, r in zip(got, ref):
            g, r = g.float(), r.float()
            d = (g - r).abs()
            floor = tol * float(r.abs().max())
            worst = max(worst, float((d / (BF16_STEP * r.abs() + floor).clamp(min=1e-30)).max()))
            over_half += int((d > BF16_STEP / 2 * r.abs() + floor).sum())
            ab = max(ab, float(d.max()))
            if not bool(torch.isfinite(g).all()):
                worst = float("inf")
        return worst, over_half, ab

    def _turns(self, fa, fb, reps: int = 10):
        """Mean device times of fa and fb timed in turns: a, b, b, a."""
        ta = self.time_ms(fa, reps)
        tb = self.time_ms(fb, reps)
        tb = 0.5 * (tb + self.time_ms(fb, reps))
        ta = 0.5 * (ta + self.time_ms(fa, reps))
        return ta, tb

    def _walls_in_turns(self, fa, fb, reps: int = 2):
        """Walls of fa and fb (host clock, each ending in a synchronise) in
        turns a, b, b, a, ``reps`` times; returns (walls a, walls b)."""
        torch = self.torch
        wa, wb = [], []
        for _ in range(reps):
            for f, acc in ((fa, wa), (fb, wb), (fb, wb), (fa, wa)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                acc.append(time.perf_counter() - t0)
        return wa, wb

    def phase_multi_device(self):
        """The multi-device slice at world one: this process joins a world
        of one under NCCL (``make_mesh``), then each ``mesh=`` path runs
        against its unsharded counterpart on the card: the north star's
        1,000 variants x 200 w (float32, scan at 40) through ``sweep``;
        ``forward_response_freq_sharded`` on VolturnUS-S at 200 w, float64,
        with the native-staged BEM (K1 against the plain solve there too);
        ``forward_response_dp_sp`` on a (1, 1) mesh; ``sweep_sea_states`` on
        the 64-case DLC table; ``sweep_designs`` on the mixed designs;
        ``ArrayModel.solveDynamics`` on 4 turbines; one sharded scan chunk
        under CUDA's sync debug mode "error"; the sharded and unsharded
        north star and freq-sharded solve timed in turns."""
        import torch.distributed as dist

        from raft_tpu_torch.array import ArrayModel
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.model import load_design, stage_designs
        from raft_tpu_torch.parallel.geometry import make_scale_plan, make_stretch_draft
        from raft_tpu_torch.parallel.multihost import global_mesh, pmax, psum
        from raft_tpu_torch.parallel.sweep import (_apply_lanes, _volturnus, forward_response,
                                                   forward_response_dp_sp,
                                                   forward_response_freq_sharded, make_mesh,
                                                   make_wave_states, north_star_grid,
                                                   scale_diameters, stage_north_star_bem, sweep,
                                                   sweep_designs, sweep_sea_states)

        torch = self.torch
        f32, f64 = torch.float32, torch.float64
        nw = self.nw
        t0 = time.perf_counter()
        mesh = make_mesh()
        t_join = time.perf_counter() - t0
        try:
            self.check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
                       and mesh.device_type == "cuda" and mesh.mesh_dim_names == ("designs",),
                       f"make_mesh(): a world of one under NCCL on the card, joined in "
                       f"{t_join:.2f} s")

            def same(a, b):
                return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a
                           if isinstance(a[k], np.ndarray))

            # 1. the north star's variants through sweep(mesh=), the same bits and K1 launches
            _d, members, rna, env, wave, C = _volturnus(nw, f32, self.dev)
            draft, plan = make_stretch_draft(members), make_scale_plan(members)

            def apply_fn(m, th):
                return plan(draft(m, th[..., 1]), th[..., 0])

            thetas = north_star_grid(self.n_designs)
            kw = dict(apply_fn=apply_fn, n_iter=40, return_xi=False, dtype=f32, device=self.dev)

            def ns(mesh_=None):
                return sweep(members, rna, env, wave, C, thetas, mesh=mesh_, **kw)

            self.zero_counts()
            got = ns(mesh)
            k_sharded = self.counts()["fused"]
            self.add_main(self.counts(), ("fused", "step"))
            self.zero_counts()
            want = ns()
            k_plain = self.counts()["fused"]
            walls_u, walls_s = self._walls_in_turns(ns, lambda: ns(mesh))
            conv = bool(np.isfinite(got["std dev"]).all())
            print(f"  north star {self.n_designs} x {nw} float32 through sweep(mesh=make_mesh()), "
                  f"scan 40: K1 launches {k_sharded} (unsharded {k_plain}); walls in turns "
                  f"unsharded {[round(x, 4) for x in walls_u]} s, sharded "
                  f"{[round(x, 4) for x in walls_s]} s; {nvidia_smi()}")
            self.check(same(got, want) and k_sharded == k_plain == 40 and conv,
                       "sweep(mesh=make_mesh()) == sweep() bit for bit, the same K1 launches")

            # 2. the frequency-sharded solve, native-staged BEM, f64; K1 against plain there
            if self.native_staged is None:
                self.native_staged, diag = stage_north_star_bem(
                    nw=nw, nw_bem=48, mode="native", cache=False, dtype=f64, device=self.dev,
                    return_diagnostics=True)
                self.native_coeffs = diag["coeffs"]
            bem = self.native_staged
            _d, m64, rna64, env64, wave64, C64 = _volturnus(nw, f64, self.dev)

            def fs(mesh_=mesh):
                return forward_response_freq_sharded(m64, rna64, env64, wave64, C64, mesh_,
                                                     bem=bem, device=self.dev)

            def fu():
                return forward_response(m64, rna64, env64, wave64, C64, bem=bem, n_iter=40,
                                        method="while", device=self.dev)

            def rel(a, b):
                return float((a - b).abs().max() / b.abs().max())

            self.zero_counts()
            out_s = fs()
            k_fs = self.counts()["fused"]
            self.add_main(self.counts(), ("fused", "step"))
            out_u = fu()
            with plain_solve():
                out_p = fs()
            d_u = max(rel(out_s.Xi.re, out_u.Xi.re), rel(out_s.Xi.im, out_u.Xi.im))
            d_p = max(rel(out_s.Xi.re, out_p.Xi.re), rel(out_s.Xi.im, out_p.Xi.im))
            n_s, n_u, n_p = int(out_s.n_iter), int(out_u.n_iter), int(out_p.n_iter)
            walls_fu, walls_fs = self._walls_in_turns(fu, fs, reps=3)
            per_it = (min(walls_fs) - min(walls_fu)) / n_s
            print(f"  forward_response_freq_sharded VolturnUS-S {nw} w float64, native-staged "
                  f"BEM, while 40: {n_s} iterations (unsharded {n_u}, plain solve {n_p}), K1 "
                  f"launches {k_fs}; against unsharded {d_u:.3e}, K1 against the plain solve "
                  f"{d_p:.3e}; walls in turns unsharded {[round(x, 4) for x in walls_fu]} s, "
                  f"sharded {[round(x, 4) for x in walls_fs]} s: {1e3 * per_it:.3f} ms an "
                  f"iteration for the SUM and MAX all-reduce at world one")
            self.check(n_s == n_u == n_p == k_fs and bool(out_s.converged) and d_u <= 1e-12
                       and d_p <= 1e-10,
                       "freq-sharded == unsharded (1e-12, identical iterations); K1 == the plain "
                       "solve on the sharded path (1e-10, identical iterations)")
            # one iteration's collectives alone: the SUM of the (3, nodes) spectral
            # moments and the MAX of the lane error, 200 pairs, host clock
            moments = torch.rand(3, m64.node_r.shape[-2], dtype=f64, device=self.dev)
            err = torch.rand((), dtype=f64, device=self.dev)
            axis = (mesh, "designs")
            pair_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    psum(moments, axis)
                    pmax(err, axis)
                torch.cuda.synchronize()
                pair_ms.append(1e3 * (time.perf_counter() - t0) / 200)
            print(f"  one iteration's all-reduces at world one (SUM of 3 x "
                  f"{m64.node_r.shape[-2]} moments, MAX of the error; 200 pairs, host clock): "
                  f"{[round(x, 4) for x in pair_ms]} ms a pair")

            # 3. design x frequency on a (1, 1) mesh
            mesh2 = global_mesh(("designs", "freq"), (1, 1))
            th4 = np.array([0.95, 1.0, 1.05, 1.1])
            self.zero_counts()
            dp = forward_response_dp_sp(m64, rna64, env64, wave64, C64, th4, mesh2, bem=bem,
                                        device=self.dev)
            self.add_main(self.counts(), ("fused", "step"))
            with torch.no_grad():
                ref = forward_response(
                    _apply_lanes(scale_diameters, m64, torch.as_tensor(th4, device=self.dev)),
                    rna64, env64, wave64, C64, bem=bem, n_iter=40, method="while",
                    device=self.dev)
            d_dp = max(rel(dp.Xi.re, ref.Xi.re), rel(dp.Xi.im, ref.Xi.im))
            print(f"  forward_response_dp_sp (1, 1) mesh, 4 thetas x {nw} w float64: iterations "
                  f"{dp.n_iter.tolist()}, against unsharded {d_dp:.3e}")
            self.check(torch.equal(dp.n_iter, ref.n_iter) and d_dp <= 1e-12,
                       "dp x sp (1, 1) == unsharded (1e-12, identical iterations)")

            # 4. the DLC table's cases over the mesh
            w, (mem, rna_, env_, C_), cases = self._dlc_inputs()
            waves = make_wave_states(w, cases, env_.depth, dtype=f64, device=self.dev)
            self.zero_counts()
            dlc_s = sweep_sea_states(mem, rna_, env_, waves, C_, bem=self.dlc_grid, n_iter=25,
                                     mesh=mesh, dtype=f64, device=self.dev)
            self.add_main(self.counts(), ("fused", "step"))
            dlc_u = sweep_sea_states(mem, rna_, env_, waves, C_, bem=self.dlc_grid, n_iter=25,
                                     dtype=f64, device=self.dev)
            d_dlc = max(float(np.abs(dlc_s[k] - dlc_u[k]).max() / np.abs(dlc_u[k]).max())
                        for k in ("std dev", "nacelle accel std dev", "Xi_abs2"))
            print(f"  sweep_sea_states(mesh=) {len(cases)} cases x {nw} w float64: against "
                  f"unsharded {d_dlc:.3e}, bit for bit {same(dlc_s, dlc_u)}")
            self.check(np.array_equal(dlc_s["iterations"], dlc_u["iterations"])
                       and d_dlc <= 1e-12,
                       "sweep_sea_states(mesh=) == unsharded (1e-12, identical iterations)")

            # 5. the mixed designs over the mesh
            staged = self.mixed_staged
            if staged is None:
                staged = stage_designs(self._mixed_designs(self.per_family,
                                                           np.random.default_rng(20261017)),
                                       nw=nw, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95,
                                       dtype=f32, device=self.dev)
            self.zero_counts()
            mix_s = sweep_designs(staged=staged, n_iter=25, return_xi=False, mesh=mesh,
                                  dtype=f32, device=self.dev)
            self.add_main(self.counts(), ("fused", "step"))
            mix_u = sweep_designs(staged=staged, n_iter=25, return_xi=False, dtype=f32,
                                  device=self.dev)
            print(f"  sweep_designs(mesh=) {len(mix_s['designs'])} designs in "
                  f"{mix_s['buckets']['n_buckets']} buckets float32: bit for bit "
                  f"{same(mix_s, mix_u)}")
            self.check(same(mix_s, mix_u), "sweep_designs(mesh=) == unsharded bit for bit")

            # 6. four turbines over the mesh
            design = load_design(DESIGNS / "VolturnUS-S.yaml")
            farm = ArrayModel(design, nT=4, positions=[[0, 0], [1500, 0], [0, 1500],
                                                       [1500, 1500]], dtype=f64,
                              device=self.dev)
            farm.setEnv(Hs=8.0, Tp=12.0, V=10.0, Fthrust=float(design["turbine"]["Fthrust"]))
            farm.calcSystemProps()
            farm.solveDynamics()
            r_u = {k: np.copy(v) for k, v in farm.results["response"].items()
                   if isinstance(v, np.ndarray)}
            self.zero_counts()
            farm.solveDynamics(mesh=mesh)
            self.add_main(self.counts(), ("fused", "step"))
            r_s = farm.results["response"]
            print(f"  ArrayModel(4 VolturnUS-S).solveDynamics(mesh=) float64: iterations "
                  f"{r_s['iterations'].tolist()}, bit for bit {same(r_s, r_u)}")
            self.check(np.array_equal(r_s["iterations"], r_u["iterations"])
                       and float(np.abs(r_s["Xi per turbine"] - r_u["Xi per turbine"]).max())
                       <= 1e-12 * float(np.abs(r_u["Xi per turbine"]).max()),
                       "ArrayModel.solveDynamics(mesh=) == unsharded (1e-12, identical "
                       "iterations)")

            # 7. one sharded scan chunk (250 variants, the freq psum) under sync debug "error"
            th = torch.as_tensor(thetas[:250], dtype=f32, device=self.dev)
            bem32 = (bem[0].to(f32), bem[1].to(f32), Cx(bem[2].re.to(f32), bem[2].im.to(f32)))

            def chunk():
                with torch.no_grad():
                    return forward_response(_apply_lanes(apply_fn, members, th), rna, env,
                                            wave, C, bem=bem32, n_iter=25, method="scan",
                                            dtype=f32, device=self.dev, axis=(mesh, "designs"))

            chunk()
            torch.cuda.synchronize()
            raised = None
            n0 = self.counts()["fused"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                chunk()
            except RuntimeError as e:
                raised = str(e)[:300]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            n_k1 = self.counts()["fused"] - n0
            print(f"  one scan chunk (250 variants x {nw} w, 25 iterations, float32) with the "
                  f"psum and pmax over the mesh under sync debug \"error\": "
                  f"{raised or 'no synchronisation'}; K1 launches {n_k1}")
            self.check(raised is None and n_k1 == 25,
                       "the collectives add no synchronisation to a sharded scan chunk")
        finally:
            dist.destroy_process_group()

    def phase_lint(self):
        """The port's lint on the card: the static pass against the baseline,
        the race scenarios, and the runtime audit of every registered entry
        at float32 against the "cuda" budgets, with K1 and K3/K4 held to
        their plain versions on the audit's own inputs."""
        from raft_tpu_torch.core import linalg6
        from raft_tpu_torch.lint import audit
        from raft_tpu_torch.lint import baseline as bl
        from raft_tpu_torch.lint.cli import DEFAULT_TARGETS
        from raft_tpu_torch.lint.registry import fused_rao_args
        from raft_tpu_torch.lint.rules import lint_paths

        torch = self.torch
        # the races run in a child, beside the static pass and the audit:
        # their scenarios reset process-wide counters and set a 1 us switch
        # interval, which this process must not inherit
        races = self._cli_start([], {}, cwd=str(ROOT), module="raft_tpu_torch.lint.race")
        try:
            t0 = time.perf_counter()
            violations = lint_paths(list(DEFAULT_TARGETS), str(ROOT))
            fresh, absorbed = bl.filter_new(violations)
            t1 = time.perf_counter()
            self.zero_counts()
            reports = audit.run_audit(device="cuda")
            probe = audit.backward_probe(device="cuda")
            self.add_main(self.counts(), ("fused", "fused_adjoint", "rankine", "wave", "step"))
            t2 = time.perf_counter()
        finally:
            rc, rep, wall, err = self._cli_wait(races, timeout=300)
        for v in fresh:
            print("    " + v.format())
        self.check(not fresh, f"static pass over the port ({t1 - t0:.1f} s): {len(fresh)} new "
                              f"violations, {absorbed} triaged in the baseline")
        if rep is None:
            print(err)
            rep = {"ok": False, "elapsed_s": None, "failures": "no report"}
        checks = [ok for s in rep.values() if isinstance(s, dict)
                  for ok in s.get("checks", {}).values()]
        self.check(rc == 0 and rep["ok"],
                   f"race scenarios in a child (exit {rc}, {rep['elapsed_s']} s of scenarios, "
                   f"{wall:.1f} s of process): {sum(checks)} of {len(checks)} checks hold "
                   f"{rep.get('failures', '')}")
        cpu = audit.load_budgets()["platforms"]["cpu"]
        print(f"  the runtime audit, float32 on the card ({t2 - t1:.1f} s; "
              f"{nvidia_smi()}):")
        for r in reports:
            print(f"    {r.name}: ops {r.ops}, host syncs {r.host_syncs}, launches "
                  f"{r.launches or 'none'}, peak_bytes {r.peak_bytes}, f64 ops {r.f64_ops}, "
                  f"rebuilds {r.rebuilds}")
            for note in r.budget_notes:
                print(f"      {note}")
            self.check(r.ok and r.f64_ops == 0 and r.rebuilds == 0,
                       f"audit {r.name}: within its cuda budget, no float64 op, no rebuild")
            want = cpu.get(r.name, {}).get("host_syncs")
            self.check(r.host_syncs == want == r.sync_debug,
                       f"audit {r.name}: host syncs {r.host_syncs} == the CPU audit's {want} "
                       f"== sync-debug warnings {r.sync_debug} {r.sync_examples}")
        print(f"  backward probe (val_grad, float32): hook on the calling thread "
              f"{probe['hook_on_calling_thread']}; ops forward {probe['forward_ops']}, backward "
              f"{probe['backward_ops']}; inside the hook the mode saw {probe['hook_ops_seen']} "
              f"of {probe['hook_ops_run']} ops and {probe['hook_syncs_seen']} of "
              f"{probe['hook_syncs_run']} host syncs; host syncs {probe['host_syncs']}, "
              f"sync-debug warnings {probe['sync_debug_warnings']}")
        self.check(probe["forward_ops"] > 0 and probe["backward_ops"] > 0,
                   "lint: the backward probe's hook ran inside val_grad's backward")
        by = {r.name: r for r in reports}
        k1 = by["fused_rao_solve"]
        Z0, w, Bd, F = fused_rao_args(1, self.dev, torch.float32)
        plain = linalg6.solve_cx_fused(Z0, w, Bd, F)
        xr, xi = k1.outputs
        scale = float(torch.maximum(plain.re.abs().max(), plain.im.abs().max()))
        err = float(torch.maximum((xr - plain.re).abs().max(),
                                  (xi - plain.im).abs().max())) / scale
        self.check(k1.launches.get("k1_fused") == 1 and err <= TOL["float32"],
                   f"audit fused_rao_solve: K1 launched {k1.launches.get('k1_fused')} time(s), "
                   f"scale-relative {err:.3e} from the plain solve (tolerance {TOL['float32']})")
        kb, pb = by["torch_bem_kernels"], by["torch_bem"]
        errs = {}
        for name, a, b in zip(("A", "B", "F.re", "F.im"), kb.outputs[:4], pb.outputs[:4]):
            errs[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        launched = (kb.launches.get("bem_rankine", 0), kb.launches.get("bem_wave", 0))
        self.check(min(launched) >= 1 and not pb.launches
                   and max(errs.values()) <= INTERP_PARITY_RTOL,
                   f"audit torch_bem_kernels: K3 {launched[0]}, K4 {launched[1]} launches "
                   f"(the plain entry {pb.launches or 'none'}), scale-relative "
                   + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                   + f" from the plain assembly (tolerance {INTERP_PARITY_RTOL})")

    def phase_bf16(self):
        """The bf16 entries of K3 and K4 (``RAFT_TPU_BEM_PRECISION=bf16``)
        against their plain versions on the same bf16 inputs, elementwise
        within one bf16 step of the plain output plus TOL_BEM["float32"]:
        K3 on VolturnUS-S (1,024 class) and OC4semi with its lid (2,048),
        two calls the same bits; K4 on every chunk of the north star's
        48-w staging; each bf16 entry timed against its f32 entry in turns,
        with its bound (storage 2 bytes, float32 operations).  Then the
        card's staging of the nominal hull with the bf16 assembly (K3/K4
        bf16 launches counted: a main path) against the f32 staging
        (parity_err <= 0.1), against native (printed) and its refinement
        residual (< 1e-4)."""
        from raft_tpu_torch.core import cuda_bem
        from raft_tpu_torch.hydro import torch_bem
        from raft_tpu_torch.parallel.sweep import stage_north_star_bem

        torch = self.torch
        bf = torch.bfloat16
        for name, lid in (("VolturnUS-S", False), ("OC4semi", True)):
            case = self._bem_case(name, lid, torch.float32)
            args32, quad32 = case["args"], case["quad"]
            args = tuple(a if a.dtype == torch.bool else a.to(bf) for a in args32)
            quad = torch_bem.stage_quad(bf, self.dev)
            got = cuda_bem.rankine_assembly(*args, quad=quad)
            again = cuda_bem.rankine_assembly(*args, quad=quad)
            ref = torch_bem.rankine_plain(*args, quad=quad)
            torch.cuda.synchronize()
            worst, over_half, ab = self._bf16_held(got, ref, "K3")
            same = all(torch.equal(g, h) for g, h in zip(got, again))
            self.check(worst <= 1.0 and same and all(g.dtype == bf for g in got),
                       f"K3 bf16 {case['label']}: within one bf16 step + {TOL_BEM['float32']['rankine']:.0e}"
                       f" max|plain| (largest share of the bound {worst:.3f}; {over_half} "
                       f"elements past half a step); two calls the same bits ({same})")
            up = tuple(a if a.dtype == torch.bool else a.float() for a in args)
            wk = k3_work(up[1], up[4], up[5], up[6], 2, "float32")
            ms32, ms16 = self._turns(lambda: cuda_bem.rankine_assembly(*args32, quad=quad32),
                                     lambda: cuda_bem.rankine_assembly(*args, quad=quad))
            plain_ms = self.time_ms(lambda: torch_bem.rankine_plain(*args, quad=quad), reps=2)
            print(f"  K3 bf16 n={case['n']}: kernel {ms16:.4f} ms against f32 {ms32:.4f} ms in "
                  f"turns, plain {plain_ms:.2f} ms, bound {wk['bound_ms']:.4f} ms "
                  f"({wk['bound_by']}; 2-byte storage, float32 operations); max abs diff "
                  f"{ab:.3e}")
            if name == "VolturnUS-S":
                self.records["rankine_bf16"] = {
                    "max_abs_err": ab, "ms": ms16, "plain_ms": plain_ms,
                    "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"], "library_ms": None,
                    "f32_ms": ms32}

        # K4 on every chunk of the staging grid, bf16 inputs as solve_panels casts them
        ms16, ms32, plain_ms, bound, t_ops, t_bytes = [], [], [], [], 0.0, 0.0
        worst_all, over_all, ab_all = 0.0, 0, 0.0
        case = self._bem_case("VolturnUS-S", False, torch.float32)
        depth = case["depth"]
        rb = cuda_bem.rankine_assembly(*(a if a.dtype == torch.bool else a.to(bf)
                                         for a in case["args"]),
                                       quad=torch_bem.stage_quad(bf, self.dev))
        chunks = self._staging_chunks(torch.float32)
        tab16 = torch_bem._cast(chunks[0][0][7], bf)
        for idx, (wargs32, kw, wc) in enumerate(chunks):
            _R_pot, _R_dn, c, nrm, area, pm, ls, _tab, k, fd = wargs32
            wargs = (rb[0], rb[1], c.to(bf), nrm.to(bf), area.to(bf), pm.to(bf), ls, tab16,
                     k.to(bf), torch_bem._cast(fd, bf))
            got = cuda_bem.wave_assembly(*wargs, **kw)
            ref = torch_bem.wave_plain(*wargs, **kw)
            worst, over_half, ab = self._bf16_held(got, ref, "K4")
            worst_all, over_all, ab_all = max(worst_all, worst), over_all + over_half, max(ab_all, ab)
            a32, a16 = self._turns(lambda: cuda_bem.wave_assembly(*wargs32, **kw),
                                   lambda: cuda_bem.wave_assembly(*wargs, **kw), reps=3)
            ms32.append(a32)
            ms16.append(a16)
            plain_ms.append(self.time_ms(lambda: torch_bem.wave_plain(*wargs, **kw), reps=1))
            wk = k4_work(c, area, ls, k, fd, depth, 2, "float32")
            bound.append(wk["bound_ms"])
            t_ops, t_bytes = t_ops + wk["ops_ms"], t_bytes + wk["bytes_ms"]
            print(f"  K4 bf16 staging chunk {idx:2d}: w {wc[0]:.4f}-{wc[-1]:.4f}; kernel "
                  f"{a16:.4f} ms against f32 {a32:.4f} ms in turns, bound {wk['bound_ms']:.4f} ms; "
                  f"largest share of the bound {worst:.3f}, {over_half} past half a step")
        self.check(worst_all <= 1.0,
                   f"K4 bf16 on all {len(ms16)} staging chunks: within one bf16 step + "
                   f"{TOL_BEM['float32']['wave']:.0e} max|plain| (largest share {worst_all:.3f}; "
                   f"{over_all} elements past half a step)")
        print(f"  K4 bf16 staging grid: kernel {np.mean(ms16):.4f} ms per chunk against f32 "
              f"{np.mean(ms32):.4f} ms in turns, plain {np.mean(plain_ms):.2f} ms, bound "
              f"{np.mean(bound):.4f} ms (operations {t_ops / len(ms16):.4f}, bytes "
              f"{t_bytes / len(ms16):.4f}); max abs diff {ab_all:.3e}")
        self.records["wave_bf16"] = {
            "max_abs_err": ab_all, "ms": float(np.mean(ms16)),
            "plain_ms": float(np.mean(plain_ms)), "bound_ms": float(np.mean(bound)),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "f32_ms": float(np.mean(ms32))}

        # the card's staging of the nominal hull with the bf16 assembly (a main
        # path: its first run's launches counted), in turns with the f32 one
        stage, walls = {}, {"f32": [], "bf16": []}
        for turn, prec in enumerate(("f32", "bf16", "bf16", "f32")):
            self.zero_counts()
            t0 = time.perf_counter()
            _staged, diag = stage_north_star_bem(
                nw=self.nw, nw_bem=48, mode="jax", cache=False, dtype=torch.float32,
                device=self.dev, return_diagnostics=True, precision=prec)
            torch.cuda.synchronize()
            walls[prec].append(time.perf_counter() - t0)
            if prec not in stage:
                stage[prec] = diag
                diag["launches"] = {k: v for k, v in self.counts().items() if v}
            if turn == 1:
                self.add_main(self.counts(), ("rankine_bf16", "wave_bf16"))
        d16, d32 = stage["bf16"], stage["f32"]
        d16["wall"], d32["wall"] = np.mean(walls["bf16"]), np.mean(walls["f32"])
        errs = [torch_bem.parity_err(a, b) for a, b in zip(d16["coeffs"][1:], d32["coeffs"][1:])]
        native = self.native_coeffs
        if native is None:
            _s, dn = stage_north_star_bem(nw=self.nw, nw_bem=48, mode="native", cache=False,
                                          dtype=torch.float64, device=self.dev,
                                          return_diagnostics=True)
            native = self.native_coeffs = dn["coeffs"]
        errs_n = [torch_bem.parity_err(a, b) for a, b in zip(d16["coeffs"][1:], native[1:])]
        errs_n32 = [torch_bem.parity_err(a, b) for a, b in zip(d32["coeffs"][1:], native[1:])]
        print(f"  card staging float32, bf16 assembly: {d16['wall']:.3f} s, launches "
              f"{d16['launches']}, refinement residual {d16['max_residual']:.2e}; f32 assembly "
              f"{d32['wall']:.3f} s, launches {d32['launches']}, residual "
              f"{d32['max_residual']:.2e}")
        print(f"    bf16 against f32 parity_err A {errs[0]:.3e}, B {errs[1]:.3e}, F {errs[2]:.3e}; "
              f"against native: bf16 A {errs_n[0]:.3e}, B {errs_n[1]:.3e}, F {errs_n[2]:.3e}; "
              f"f32 A {errs_n32[0]:.3e}, B {errs_n32[1]:.3e}, F {errs_n32[2]:.3e}")
        self.record_bf16 = {"stage_s": d16["wall"], "stage_f32_s": d32["wall"],
                            "vs_f32": errs, "vs_native": errs_n, "f32_vs_native": errs_n32}
        # A and B at the JAX package's bound for its bf16 mode against its f32
        # (tests/test_bem_tiles.py holds A at 0.1).  F is printed: at this hull's
        # size its bf16 error comes from the geometry rounded to bf16 (coordinates
        # of 32-64 m in steps of 0.25 m), which the JAX package's mode rounds
        # alike; python3 -m raft_tpu_torch.tools.bf16_error splits it by source
        self.check(max(errs[:2]) <= BF16_PARITY and d16["max_residual"] < 1e-4
                   and d16["precision"] == "bf16" and d16["assembly_dtype"] == str(bf)
                   and d16["launches"].get("rankine_bf16") == 1
                   and d16["launches"].get("wave_bf16") == 24
                   and "rankine" not in d16["launches"] and "wave" not in d16["launches"],
                   f"card staging with the bf16 assembly: A and B within {BF16_PARITY} of the "
                   f"f32 staging (F {errs[2]:.3f}, printed), residual < 1e-4, K3 bf16 once and "
                   f"K4 bf16 once per chunk, no f32 launch")

    # ---------------------------------------------------------- BEM inputs

    def phase_bem_inputs(self):
        """The BEM inputs on the card: a WEIS-array design
        (``io/weis.py``) through the Model on the card against the CPU
        (1e-10); a Capytaine dataset written from the card's panel solve of
        VolturnUS-S and read back through ``Model(BEM=load_capytaine_nc)``
        against ``Model(BEM=(A, B, F))`` (1e-12); a Nemoh mesh of that hull
        through ``nemoh_to_pnl`` against ``write_pnl`` of the same panels."""
        import tempfile

        from raft_tpu_torch.hydro import bem_io, capy, mesh
        from raft_tpu_torch.io.weis import design_from_weis, member_from_arrays, \
            mooring_from_arrays
        from raft_tpu_torch.model import Model, load_design

        torch = self.torch
        spar = member_from_arrays(
            "spar", [0, 0, -120], [0, 0, 10], [9.4, 9.4, 6.5, 6.5], [0.027],
            stations=[-120, -12, -4, 10], potMod=False, Cd=0.8, Ca=1.0, rho_shell=8500,
            l_fill=[52.0, 0, 0], rho_fill=[1860.0, 0, 0])
        tower = member_from_arrays("tower", [0, 0, 10], [0, 0, 87.6], [6.5, 3.87],
                                   [0.027, 0.019], mtype=1, Cd=0.0, Ca=0.0)
        ang = np.deg2rad([0, 120, 240])
        moor = mooring_from_arrays(
            320.0, np.stack([853.87 * np.cos(ang), 853.87 * np.sin(ang), np.full(3, -320.0)], -1),
            np.stack([5.2 * np.cos(ang), 5.2 * np.sin(ang), np.full(3, -70.0)], -1), [902.2] * 3,
            diameter=0.09, mass_density=77.7066, stiffness=384.243e6)
        design = design_from_weis(
            [spar], tower, {"mRNA": 350000, "IxRNA": 3.5e7, "IrRNA": 2.6e7, "xCG_RNA": 0,
                            "hHub": 90.0, "Fthrust": 800e3, "yaw_stiffness": 9.834e7}, moor)

        def run(dev, **kw):
            m = Model(kw.pop("design", design), device=dev, **kw)
            m.setEnv(Hs=8.0, Tp=12.0, Fthrust=float(m.design["turbine"]["Fthrust"]))
            m.calcSystemProps()
            m.solveEigen()
            m.calcMooringAndOffsets()
            m.solveDynamics()
            m.calcOutputs()
            return m.results

        self.zero_counts()
        rg = run("cuda")
        grew = self.counts()["fused"]
        rc = run("cpu")
        d_f = self._rel(rg["eigen"]["frequencies"], rc["eigen"]["frequencies"])
        d_s = self._rel(rg["response"]["std dev"], rc["response"]["std dev"])
        same_it = rg["response"]["iterations"] == rc["response"]["iterations"]
        print(f"  WEIS-array spar design: card against cpu, fn {d_f:.2e}, std {d_s:.2e}, "
              f"iterations {rg['response']['iterations']}/{rc['response']['iterations']}, "
              f"K1 launches {grew}")
        self.check(d_f <= 1e-10 and d_s <= 1e-10 and same_it and grew > 0,
                   "design_from_weis: Model on the card == on the CPU (1e-10), K1 launched")

        volt = load_design(DESIGNS / "VolturnUS-S.yaml")
        m = Model(volt, BEM="jax", device="cuda")
        m.setEnv(Hs=8.0, Tp=12.0)
        A, B, F = m.calcBEM(cache=False)
        w = m.w.cpu().numpy()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "volturn.nc"
            write_capytaine_nc(path, w, A, B, F)
            A_c, B_c, F_c = capy.load_capytaine_nc(str(path))
            r_file = run("cuda", design=volt, BEM=(A_c, B_c, F_c))
            r_tuple = run("cuda", design=volt, BEM=(A, B, F))
            exact = all(np.array_equal(x, y) for x, y in ((A_c, A), (B_c, B), (F_c, F)))
            d_f = self._rel(r_file["eigen"]["frequencies"], r_tuple["eigen"]["frequencies"])
            d_s = self._rel(r_file["response"]["std dev"], r_tuple["response"]["std dev"])
            print(f"  Capytaine dataset from the card's solve ({len(w)} w): read back exactly "
                  f"{exact}; Model(BEM=load_capytaine_nc) against Model(BEM=(A, B, F)): fn "
                  f"{d_f:.2e}, std {d_s:.2e}")
            self.check(d_f <= 1e-12 and d_s <= 1e-12,
                       "Model(BEM=load_capytaine_nc(...)) == Model(BEM=(A, B, F)) (1e-12)")

            panels = mesh.mesh_design(volt, dz_max=3.0, da_max=2.0)
            nemoh = Path(tmp) / "hull.nemoh"
            write_nemoh_mesh(nemoh, panels)
            got = mesh.read_pnl(bem_io.nemoh_to_pnl(str(nemoh), str(Path(tmp) / "a.pnl")))
            mesh.write_pnl(str(Path(tmp) / "b.pnl"), panels)
            want = mesh.read_pnl(str(Path(tmp) / "b.pnl"))
            d = float(np.abs(got - want).max())
            print(f"  Nemoh mesh of {len(panels)} panels -> nemoh_to_pnl: max diff {d:.2e} "
                  f"against write_pnl of the same panels")
            self.check(got.shape == want.shape and d == 0.0,
                       "nemoh_to_pnl round trip == write_pnl of the same panels")

    # ------------------------------------------------------------------ CLI

    def _cli_start(self, args, env_extra, cwd=None, module="raft_tpu_torch.cli"):
        """Start ``python3 -m <module>`` (the CLI by default) on the default
        device in a subprocess: (process, start time)."""
        import os

        env = {**os.environ, "PYTHONPATH": str(ROOT), **env_extra}
        return (subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd,
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True), time.perf_counter())

    def _cli_wait(self, started, timeout=600):
        """Wait for a started process (killed past ``timeout`` s): (exit
        code, last stdout line parsed as JSON or None, wall s, stderr tail)."""
        proc, t0 = started
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        wall = time.perf_counter() - t0
        last = None
        lines = out.strip().splitlines()
        if lines:
            try:
                last = json.loads(lines[-1])
            except ValueError:
                last = None
        return proc.returncode, last, wall, err[-2000:]

    def _cli(self, args, env_extra, cwd=None):
        return self._cli_wait(self._cli_start(args, env_extra, cwd))

    def _cli_probe(self, root: str):
        """``volturn --bem --json`` (``RAFT_TPU_BEM=jax``, f32 precision) in
        a fresh process on the default device at cache root ``root``,
        through :data:`CLI_PROBE`: (exit code, the CLI's JSON, the process's
        builds, launches and cache counts, wall s, stderr tail)."""
        import os

        env = {**os.environ, "PYTHONPATH": str(ROOT), "RAFT_TPU_BEM": "jax",
               "RAFT_TPU_BEM_PRECISION": "f32", "RAFT_TPU_TORCH_CACHE_DIR": root}
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, "-c", CLI_PROBE, "volturn", "--bem", "--json"],
                                  env=env, capture_output=True, text=True, timeout=600)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", str(e.stdout or ""), str(e.stderr or "")
        wall = time.perf_counter() - t0
        res = diag = None
        try:
            lines = out.strip().splitlines()
            res, diag = json.loads(lines[-2]), json.loads(lines[-1])
        except (ValueError, IndexError):
            pass
        return rc, res, diag, wall, err[-2000:]

    def phase_cli(self):
        """The port's CLI on the card: ``analyze volturn --bem --json`` with
        ``RAFT_TPU_BEM=jax``, the slice's full-width path (850 panels, 1,024
        class, 59 w), once with the f32 precision (the Model solves its BEM
        in float64) and once with ``RAFT_TPU_BEM_PRECISION=bf16`` (float32,
        bf16 assembly): in process, launches counted (main paths); the f32
        run also in a subprocess on the default device at a fresh cache root
        holding the wave tables (kept for phase "cache"'s warm run), held
        against the in-process run; the bf16-to-f32 gap printed.  Each in-process run
        enables the cache (``main`` does) at a root of its own, and the
        phase disables it after.  Then ``sweep``, ``dlc`` and
        ``optimize`` at small counts and ``--plot`` into a temporary
        directory, each in a subprocess whose exit code must be 0."""
        import contextlib as _ctx
        import io
        import os
        import tempfile

        import shutil

        from raft_tpu_torch import cache, cli
        from raft_tpu_torch.hydro import wavetable

        torch = self.torch
        runs = {}
        tables = wavetable.cache_dir()
        wavetable.load_tables()                 # built once in phase "build"

        def fresh_root(name: str) -> str:
            """A result cache of its own for a subprocess, holding the wave
            tables already built, as a user's cache root does after its
            first BEM solve: the subprocess measures the CLI's start-up,
            not the tables' one-time build (21-24 s on a root without them:
            they follow the cache root, as the JAX package's do; phase
            "build" measures that build on the checkout's fresh root)."""
            root = Path(tmp) / name
            shutil.copytree(tables, root / "wavetable")
            return str(root)

        with tempfile.TemporaryDirectory() as tmp:
            for prec in ("f32", "bf16"):
                env = {"RAFT_TPU_BEM": "jax", "RAFT_TPU_BEM_PRECISION": prec,
                       "RAFT_TPU_TORCH_CACHE_DIR": str(Path(tmp) / f"cache-in-{prec}")}
                saved = {k: os.environ.get(k) for k in env}
                os.environ.update(env)
                try:
                    self.zero_counts()
                    out = io.StringIO()
                    t0 = time.perf_counter()
                    with _ctx.redirect_stdout(out):
                        res = cli.main(["volturn", "--bem", "--json"])
                    torch.cuda.synchronize()
                    t_in = time.perf_counter() - t0
                    launches = {k: v for k, v in self.counts().items() if v}
                    self.add_main(self.counts(), ("fused", "rankine", "wave", "rankine_bf16",
                                                  "wave_bf16", "step"))
                finally:
                    cache.disable()             # main enabled the cache at this run's root
                    for k, v in saved.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v
                want = ({"rankine_bf16", "wave_bf16", "fused", "step"} if prec == "bf16"
                        else {"rankine", "wave", "fused", "step"})
                if prec == "bf16":
                    # the f32 subprocess below measures the CLI's start-up; a
                    # second one at bf16 would repeat it
                    runs[prec] = (res, None, t_in, None, launches)
                    print(f"  cli volturn --bem --json, RAFT_TPU_BEM=jax, precision bf16: in "
                          f"process {t_in:.2f} s, launches {launches}")
                    self.check(set(launches) == want and res["response"]["converged"],
                               f"cli analyze volturn --bem (bf16): kernels {sorted(want)} "
                               f"launched, converged")
                    continue
                # a root that outlives the phase: phase "cache" runs the same
                # command again on it, warm
                self.cli_cold_root = tempfile.mkdtemp(prefix="raft_torch_cli_root_")
                shutil.copytree(tables, Path(self.cli_cold_root) / "wavetable")
                rc, last, diag, wall, err = self._cli_probe(self.cli_cold_root)
                self.cli_cold = (rc, last, diag, wall, err)
                runs[prec] = (res, last, t_in, wall, launches)
                ok = rc == 0 and last is not None
                d_p = d_s = float("inf")
                if ok:
                    d_p = self._rel(np.asarray(last["eigen"]["periods"]), res["eigen"]["periods"])
                    d_s = self._rel(np.asarray(last["response"]["std dev"]),
                                    res["response"]["std dev"])
                print(f"  cli volturn --bem --json, RAFT_TPU_BEM=jax, precision {prec}: in "
                      f"process {t_in:.2f} s, launches {launches}; subprocess rc {rc}, "
                      f"{wall:.2f} s; subprocess against in-process: periods {d_p:.2e}, "
                      f"std {d_s:.2e}")
                if not ok:
                    print(err)
                self.check(ok and d_p <= 1e-9 and d_s <= 1e-9 and set(launches) == want
                           and res["response"]["converged"],
                           f"cli analyze volturn --bem ({prec}): subprocess == in-process "
                           f"(1e-9), kernels {sorted(want)} launched, converged")
            r32, r16 = runs["f32"][0], runs["bf16"][0]
            g_p = self._rel(r16["eigen"]["periods"], r32["eigen"]["periods"])
            g_s = self._rel(r16["response"]["std dev"], r32["response"]["std dev"])
            print(f"  bf16 assembly against f32: eigen periods {g_p:.3e}, std dev {g_s:.3e} "
                  f"(scale-relative)")
            print(f"    periods f32  {np.array2string(r32['eigen']['periods'], precision=4)}")
            print(f"    periods bf16 {np.array2string(r16['eigen']['periods'], precision=4)}")
            self.record_cli = {p: {"in_process_s": runs[p][2], "subprocess_s": runs[p][3]}
                               for p in runs}
            self.record_cli["gap"] = {"periods": g_p, "std": g_s}

            # the other subcommands and --plot, all started at once
            cases = Path(tmp) / "cases.csv"
            cases.write_text("# Hs,Tp,beta_deg\n6,10,0\n8,12,0\n8,12,30\n4,8,30\n")
            small = ["--wmin", "0.05", "--wmax", "3.0", "--dw", "0.1"]
            plot_dir = Path(tmp) / "plots"
            plot_dir.mkdir()
            jobs = [(args, self._cli_start(args, {
                        "RAFT_TPU_BEM": "jax",
                        "RAFT_TPU_TORCH_CACHE_DIR": fresh_root(f"cache-{i}")}))
                    for i, args in enumerate((
                        ["sweep", "volturn", "-n", "16", *small],
                        ["dlc", "volturn", "--cases", str(cases), *small],
                        ["dlc", "volturn", "--cases", str(cases), "--bem", *small],
                        ["optimize", "volturn", "--steps", "2", *small]))]
            plot_job = self._cli_start(["oc3", "--plot", *small], {}, cwd=plot_dir)
            for args, job in jobs:
                rc, last, wall, err = self._cli_wait(job)
                vals = [] if last is None else [v for k, v in last.items()
                                                if k in ("std dev", "history")]
                finite = last is not None and all(np.isfinite(np.asarray(v, float)).all()
                                                  for v in vals)
                print(f"  cli {' '.join(args[:2])}{' --bem' if '--bem' in args else ''}: rc {rc}, "
                      f"{wall:.2f} s (five processes at once), keys "
                      f"{sorted(last) if last else None}")
                if rc != 0:
                    print(err)
                self.check(rc == 0 and finite, f"cli {args[0]} exits 0 with finite JSON output")

            rc, _last, wall, err = self._cli_wait(plot_job)
            pngs = sorted(p.name for p in plot_dir.glob("*.png"))
            print(f"  cli oc3 --plot: rc {rc}, {wall:.2f} s, wrote {pngs}")
            try:
                import matplotlib  # noqa: F401
            except ImportError:
                # the plots are drawn by matplotlib on the host; where it is
                # not installed --plot must fail naming it, after the analysis
                print("  matplotlib is not installed on this machine: --plot cannot draw here")
                self.check(rc != 0 and "matplotlib" in err and not pngs,
                           "cli --plot without matplotlib exits non-zero naming it")
            else:
                if rc != 0:
                    print(err)
                self.check(rc == 0 and pngs == ["raft_tpu_platform.png", "raft_tpu_raos.png"],
                           "cli --plot writes the platform and RAO figures")

    def phase_cache(self):
        """The cache slice.  (1) ``python -m raft_tpu_torch.cache smoke`` on
        the card in a subprocess (two children on one fresh root that holds
        only the wave tables already built: warm
        staging hits, no library built in either, no K3/K4 launch in the
        warm child, the same bits, the ledger's K1 count the children's K1
        launches).  (2) The full-width warm start: phase "CLI"'s
        ``volturn --bem --json`` subprocess (850 panels, 1,024 class, 59 w)
        run again on its root: the panel solve a result-cache hit, no
        K3/K4 launch, no library built in either, the same JSON bit for
        bit; both walls.  (3) In process with the cache enabled at a
        temporary root: 5 K1 launches at the north star's chunk shape (250
        x 200, float32), each after an L2 flush behind a device spin, timed
        by the ledger's events: its best time within 0.5-2x of phase "K1 vs
        plain"'s time; its roofline fraction that phase's bound over the
        best time (one work count and one peak table on both sides: an
        identity of the arithmetic, which the time check tests).  (4) The
        armed ledger's cost on the card's panel solve at the CLI's width
        (``Model.calcBEM`` without the result cache, unarmed and armed in
        turns) and one armed ``solve_panels`` under CUDA's sync debug mode
        "error", each of its K3/K4 launches timed.  (5) One scan chunk of
        the strip sweep (16 DLC cases, 25 iterations) armed under sync debug
        "error" (the ledger adds no sync); then the cache is disabled."""
        import os
        import shutil
        import tempfile

        from raft_tpu_torch import cache
        from raft_tpu_torch.core import cuda6, cuda_bem
        from raft_tpu_torch.hydro import torch_bem, wavetable
        from raft_tpu_torch.hydro.mesh import mesh_design
        from raft_tpu_torch.model import Model, load_design
        from raft_tpu_torch.obs import ledger
        from raft_tpu_torch.parallel.sweep import (_case_slice, _make_dlc_case_fn, _volturnus,
                                                   make_wave_states)

        torch = self.torch
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        env.pop("RAFT_TPU_TORCH_CACHE_DIR", None)
        # the smoke's root holds the wave tables phase "build" made, so its
        # cold child does not build them again (they follow the cache root)
        smoke_root = Path(tempfile.mkdtemp(prefix="raft_torch_cache_smoke_"))
        wavetable.load_tables()
        shutil.copytree(wavetable.cache_dir(), smoke_root / "wavetable")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.cache", "smoke",
                                   "--dir", str(smoke_root)],
                                  cwd=str(ROOT), env=env, capture_output=True, text=True,
                                  timeout=420)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        finally:
            shutil.rmtree(smoke_root, ignore_errors=True)
        wall = time.perf_counter() - t0
        res = None
        try:
            res = json.loads(out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            print(str(err)[-3000:])
        if res is not None:
            self.record_cache = {k: res.get(k) for k in (
                "cold_wall_s", "warm_wall_s", "parent_build_s", "cold_staging", "warm_staging",
                "warm_staging_by_category", "warm_kernels", "launches", "k1_ledger_count",
                "k1_launches")}
            print(f"  cache smoke (subprocess, {wall:.1f} s): rc {rc}; cold child "
                  f"{res['cold_wall_s']} s, warm child {res['warm_wall_s']} s; warm staging "
                  f"{res['warm_staging']}, by call site {res['warm_staging_by_category']}; "
                  f"warm kernels {res['warm_kernels']}")
            print(f"    launches {res['launches']}; ledger solve6_fused count "
                  f"{res['k1_ledger_count']} for {res['k1_launches']} K1 launches")
            print(f"    phases cold {res['cold_phases_s']}, warm {res['warm_phases_s']}")
            for e in res["ledger"]:
                print(f"    ledger {e}")
            for key in ("warm_staging_disk_hits", "warm_staging_no_miss", "warm_staging_saved_s",
                        "zero_compiles_both_children", "cold_bem_through_k3_k4",
                        "warm_no_k3_k4", "outputs_bit_identical",
                        "ledger_counts_k1_launches"):
                self.check(bool(res.get(key)), f"cache smoke: {key}")
        self.check(rc == 0 and res is not None and res.get("ok") is True,
                   "cache smoke: python -m raft_tpu_torch.cache smoke exits 0 with ok")

        # the full-width warm start: the CLI's panel solve, a second process
        root = self.cli_cold_root
        try:
            if self.cli_cold is None:
                root = tempfile.mkdtemp(prefix="raft_torch_cli_root_")
                wavetable.load_tables()
                shutil.copytree(wavetable.cache_dir(), Path(root) / "wavetable")
                self.cli_cold = self._cli_probe(root)
            cold, warm = self.cli_cold, self._cli_probe(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
            self.cli_cold_root = None
        for label, (rc, _res, diag, wall_s, err) in (("cold", cold), ("warm", warm)):
            lau = {k: v for k, v in (diag or {}).get("launches", {}).items() if v}
            print(f"  cli volturn --bem --json, {label} (fresh process, one root): rc {rc}, "
                  f"{wall_s:.2f} s; compiles {(diag or {}).get('compiles')}, launches {lau}, "
                  f"panel-solve results {(diag or {}).get('bem_results')}, warm start "
                  f"{(diag or {}).get('warm_start')}")
            if rc != 0 or diag is None:
                print(err)
        ok = all(r[0] == 0 and r[1] is not None and r[2] is not None for r in (cold, warm))
        self.check(ok and cold[2]["launches"]["rankine"] >= 1 and cold[2]["launches"]["wave"] >= 1
                   and cold[2]["bem_results"]["miss"] >= 1,
                   "cache, full width: the cold CLI process solves its panels through K3/K4")
        self.check(ok and warm[2]["launches"]["rankine"] == warm[2]["launches"]["wave"] == 0
                   and warm[2]["bem_results"]["hit"] >= 1 and warm[2]["bem_results"]["miss"] == 0,
                   "cache, full width: the warm CLI process hits its panel solve, no K3/K4 launch")
        self.check(ok and cold[2]["compiles"] == warm[2]["compiles"] == 0,
                   "cache, full width: no library built in either CLI process")
        self.check(ok and json.dumps(cold[1], sort_keys=True) == json.dumps(warm[1], sort_keys=True),
                   "cache, full width: the warm CLI's JSON equals the cold one's bit for bit")
        self.record_cli_warm = {"cold_s": cold[3], "warm_s": warm[3]}

        root = tempfile.mkdtemp(prefix="raft_torch_cache_phase_")
        try:
            cache.enable(root)
            ledger.reset()
            rng = np.random.default_rng(20261017)
            B, nw = 250, self.nw
            Z0, w, Bd, F = self._k1_inputs("random", B, nw, torch.float32, rng)
            cuda6.solve_rao(Z0, w, Bd, F)            # warm-up, its timing dropped
            torch.cuda.synchronize()
            ledger.reset()
            torch.cuda._sleep(SPIN_CYCLES)           # the host runs ahead of the events
            for _ in range(5):
                self._flush.zero_()
                cuda6.solve_rao(Z0, w, Bd, F)
            ledger.resolve(sync=True)
            (agg,) = [a for a in ledger.pending() if a["entry"] == "solve6_fused"]
            ledger.flush()
            summary = ledger.summary()
            print(f"  ledger after 5 K1 launches at {B}x{nw} float32: {json.dumps(summary)}")
            k1_ms = self.record.get("ms")
            if k1_ms is None:
                k1_ms = self.time_ms(lambda: cuda6.solve_rao(Z0, w, Bd, F))
            bound_ms = self.record.get("bound_ms") or k1_bound_ms(B, nw, 4, "float32")[0]
            best_ms = 1e3 * agg["best_s"]
            frac = ledger.fraction(agg)
            print(f"    best {best_ms:.5f} ms, mean {1e3 * agg['total_s'] / agg['count']:.5f} ms "
                  f"against phase K1's {k1_ms:.5f} ms (ratio {best_ms / k1_ms:.3f}); roofline "
                  f"fraction {frac:.6f} against bound/best {bound_ms / best_ms:.6f}")
            self.check(agg["count"] == 5 and 0.5 <= best_ms / k1_ms <= 2.0,
                       "cache: the ledger's K1 best time within 0.5-2x of phase K1's time")
            self.check(abs(frac - bound_ms / best_ms) <= 1e-9,
                       "cache: the ledger's roofline fraction == phase K1's bound / best (1e-9; "
                       "one work count and peak table on both sides, an identity)")
            self.record_cache_ledger = {"best_ms": best_ms, "k1_ms": k1_ms, "fraction": frac,
                                        "count": agg["count"]}

            # the armed ledger on the card's panel solve at the CLI's width
            design = load_design(DESIGNS / "VolturnUS-S.yaml")
            w_cli = np.arange(0.05, 3.0, 0.05)
            model = Model(design, w=w_cli, BEM="jax", device=self.dev)

            def calc(armed: bool) -> float:
                if armed:
                    cache.enable(root)
                else:
                    cache.disable()
                torch.cuda.synchronize()
                t = time.perf_counter()
                model.calcBEM(cache=False)
                torch.cuda.synchronize()
                return time.perf_counter() - t

            calc(True)                               # first use of this shape, dropped
            times = {True: [], False: []}
            for armed in (False, True, True, False):
                times[armed].append(calc(armed))
            cache.enable(root)
            ledger.flush()
            cost = float(np.mean(times[True]) - np.mean(times[False]))
            print(f"  Model.calcBEM (VolturnUS-S, 1,024 class, 59 w, no result cache) in turns: "
                  f"unarmed {[round(t, 4) for t in times[False]]} s, armed "
                  f"{[round(t, 4) for t in times[True]]} s; the armed ledger costs "
                  f"{cost * 1e3:.1f} ms a solve")
            self.record_cache_ledger["calcbem_s"] = {"unarmed": times[False],
                                                     "armed": times[True]}

            panels = mesh_design(design)
            padded, pm, lm = torch_bem.pad_mesh(panels, None)
            depth = float(design["mooring"]["water_depth"])
            staged = torch_bem.stage_inputs(padded, pm, lm, w_cli, [0.0],
                                            wavetable.fd_fit_grid(w_cli, depth, 9.81),
                                            finite_depth=True, dtype=torch.float64,
                                            device=self.dev)
            kw = dict(tab=torch_bem.stage_tables(wavetable.load_tables(), torch.float64,
                                                 self.dev),
                      depth=depth, finite_depth=True, dtype=torch.float64, device=self.dev)
            torch_bem.solve_panels(**staged, **kw)
            torch.cuda.synchronize()
            ledger.flush()
            n0 = dict(cuda_bem.LAUNCHES)
            raised = None
            torch.cuda.set_sync_debug_mode("error")
            try:
                torch_bem.solve_panels(**staged, **kw)
            except RuntimeError as e:
                raised = str(e)[:300]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            n_k3 = cuda_bem.LAUNCHES["rankine"] - n0["rankine"]
            n_k4 = cuda_bem.LAUNCHES["wave"] - n0["wave"]
            ledger.resolve(sync=True)
            timed = {e: sum(a["count"] for a in ledger.pending() if a["entry"] == e)
                     for e in ("bem_rankine", "bem_wave")}
            print(f"  one armed solve_panels (850 panels, 59 w, float64) under sync debug "
                  f"\"error\": {raised or 'no synchronisation'}; K3 {n_k3}, K4 {n_k4} launches, "
                  f"timed by the ledger {timed}")
            self.check(raised is None and n_k3 == timed["bem_rankine"] == 1
                       and n_k4 == timed["bem_wave"] >= 1,
                       "cache: the armed ledger adds no synchronisation to the panel solve and "
                       "times each of its K3/K4 launches")
            ledger.flush()

            # one scan chunk of the strip sweep, armed, under sync debug "error"
            f64 = torch.float64
            _d, members, rna, env_, _wave, C = _volturnus(nw, f64, self.dev)
            hs_tp = np.stack([np.linspace(2.0, 10.0, 8), np.linspace(7.0, 15.0, 8)], axis=1)
            cases = np.array([[hs, tp, b] for hs, tp in hs_tp
                              for b in np.linspace(0, np.pi / 2, 8)])
            waves = make_wave_states(np.linspace(0.05, 2.95, nw), cases, env_.depth, dtype=f64,
                                     device=self.dev)
            run = _make_dlc_case_fn(members, rna, env_, C, None, 25, dtype=f64, device=self.dev)
            sub = _case_slice(waves, slice(0, 16))
            with torch.no_grad():
                run(sub, None, None)
            torch.cuda.synchronize()
            ledger.flush()
            raised = None
            n0 = cuda6.LAUNCHES["fused"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.no_grad():
                    run(sub, None, None)
            except RuntimeError as e:
                raised = str(e)[:300]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            n_k1 = cuda6.LAUNCHES["fused"] - n0
            ledger.resolve(sync=True)
            timed = sum(a["count"] for a in ledger.pending() if a["entry"] == "solve6_fused")
            print(f"  one strip scan chunk (16 cases, 25 iterations, float64) armed under sync "
                  f"debug \"error\": {raised or 'no synchronisation'}; K1 launches {n_k1}, "
                  f"timed by the ledger {timed}")
            self.check(raised is None and n_k1 == 25 and timed == 25,
                       "cache: the armed ledger adds no synchronisation to a scan chunk "
                       "and times each of its K1 launches")
            ledger.flush()
        finally:
            cache.disable()
            ledger.reset()
            shutil.rmtree(root, ignore_errors=True)

    def phase_smokes(self):
        """The slice's three smokes on the card, at once, each through
        ``evidence.run_step`` on a thread of its own from the default cache
        root (which holds the wave tables phase "build" made; no kernel is
        built here): the hetero smoke (``python -m raft_tpu_torch.build.smoke
        --nw 200``), the BEM smoke (``python -m raft_tpu_torch.hydro.bem_smoke``,
        its own protocol: K3/K4 legs and plain legs) and the obs smoke
        (``python -m raft_tpu_torch.obs --nw 200``).  Every check of each
        smoke's JSON line must hold; each smoke's wall and its children's are
        printed, and the children's K1, K3 and K4 launches join the kernels
        line.  Meanwhile, in this process, ``utils.torch_trace`` wraps one
        ``sweep_designs`` call of the same stream under a ``phase``: the
        trace written must hold K1's kernel and the phase's range."""
        import os
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        from raft_tpu_torch.build.smoke import design_paths, stage_kw
        from raft_tpu_torch.evidence import last_json, run_step
        from raft_tpu_torch.parallel.sweep import sweep_designs
        from raft_tpu_torch.utils import phase, torch_trace

        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        env.pop("RAFT_TPU_TORCH_CACHE_DIR", None)
        py = sys.executable
        cmds = {"hetero": [py, "-m", "raft_tpu_torch.build.smoke", "--nw", "200"],
                "bem": [py, "-m", "raft_tpu_torch.hydro.bem_smoke"],
                "obs": [py, "-m", "raft_tpu_torch.obs", "--nw", "200"]}
        with ThreadPoolExecutor(len(cmds)) as pool:
            futs = {k: pool.submit(run_step, cmd, 420, f"{k} smoke", env)
                    for k, cmd in cmds.items()}
            # in process, beside them: one sweep_designs call under the profiler
            self.zero_counts()
            with tempfile.TemporaryDirectory(prefix="raft_torch_trace_") as d:
                with torch_trace(d) as path:
                    with phase("smokes_traced_sweep"):
                        sweep_designs(design_paths(), n_iter=8, return_xi=False,
                                      device=self.dev, **stage_kw(200))
                launched = self.counts()["fused"]
                self.add_main(self.counts(), ("fused", "step"))
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            steps = {k: f.result() for k, f in futs.items()}
        k1_events = [e for e in events if e.get("cat") == "kernel"
                     and "solve6_kernel" in e.get("name", "")]
        ranges = [e for e in events if e.get("name") == "smokes_traced_sweep"]
        print(f"  torch_trace of one sweep_designs call (3 designs x 200 w, float64): "
              f"{len(events)} events, {len(k1_events)} K1 kernels ({launched} launched), "
              f"{len(ranges)} phase range(s)")
        self.check(len(k1_events) == launched > 0 and len(ranges) >= 1,
                   "smokes: the torch_trace file holds each K1 kernel of the call and the "
                   "phase's range")
        res = {}
        for k, step in steps.items():
            res[k] = last_json(step["stdout_tail"]) or {}
            print(f"  {k} smoke: rc {step['rc']}, {step['elapsed_s']:.1f} s; children "
                  f"{res[k].get('child_wall_s')}")
            if not step["ok"] or not res[k].get("ok"):
                print("    " + "\n    ".join(step["tail"]))
        het, bem, obs = res["hetero"], res["bem"], res["obs"]
        for key in ("fewer_buckets_than_designs", "solo_parity_1e5",
                    "zero_builds_both_children", "results_identical", "k1_launches_equal"):
            self.check(het.get(key) is True, f"hetero smoke: {key}")
        print(f"    hetero: {het.get('n_designs')} designs in {het.get('n_buckets')} buckets "
              f"{het.get('signatures')}, solo {het.get('solo_max_rel')}, builds "
              f"{het.get('builds')}, K1 launches {het.get('k1_launches')}")
        bem_checks = bem.get("checks", {})
        for key in ("gxx_never_invoked", "parity_all_legs", "residual_small",
                    "warm_equals_cold_bits", "zero_builds_all_children", "routes",
                    "kernels_plain_agree", "k3_k4_on_kernel_legs_only"):
            self.check(bem_checks.get(key) is True, f"BEM smoke: {key}")
        print(f"    BEM: parity {bem.get('parity')}; kernels against plain "
              f"{bem.get('cross_route')}; launches {bem.get('launches')}; solves "
              f"{bem.get('solve_s')} s; builds {bem.get('builds')}; {bem.get('error', '')}")
        for key in ("jsonl_valid", "chrome_trace_valid", "per_bucket_histograms",
                    "prom_written", "overhead_bounded", "unarmed_published_nothing"):
            self.check(obs.get(key) is True, f"obs smoke: {key}")
        print(f"    obs: solves/s off {obs.get('solves_per_s_obs_off')}, on "
              f"{obs.get('solves_per_s_obs_on')}; histograms {obs.get('dispatch_histograms')}; "
              f"trace {obs.get('chrome_trace')}; K1 launches {obs.get('k1_launches')}")
        self.check(all(step["ok"] and res[k].get("ok") is True for k, step in steps.items()),
                   "smokes: all three exit 0 with ok")
        k1 = (sum((het.get("k1_launches") or {}).values())
              + sum((obs.get("k1_launches") or {}).values()))
        legs = (bem.get("launches") or {}).values()
        self.add_main({"fused": k1, "rankine": sum(v["rankine"] for v in legs),
                       "wave": sum(v["wave"] for v in legs)}, ("fused", "rankine", "wave"))

    def phase_solve_copies(self):
        """solve_panels copies nothing from the host and never waits for the
        device.  Under the profiler, every CUDA runtime call counted: one
        solve (VolturnUS-S, 1,024 class, a finite-depth and a deep chunk,
        K3/K4) and the refined solve's backward at a chunk's shapes, the
        library calls (LU, triangular solves) that both routes share; no
        host-device copy, no synchronisation, no ``cudaFree``.  Then one
        bem_fn step at full width (value and gradient, float32, the plain
        assembly) after a first, under CUDA's sync debug mode (every
        synchronisation PyTorch issues) with every host-to-device copy
        counted."""
        import warnings

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        from raft_tpu_torch.hydro import torch_bem, wavetable
        from raft_tpu_torch.hydro.mesh import mesh_design
        from raft_tpu_torch.model import load_design

        torch = self.torch
        f64 = torch.float64
        design = load_design(DESIGNS / "VolturnUS-S.yaml")
        panels = mesh_design(design, dz_max=3.0, da_max=2.0)
        padded, pm, lm = torch_bem.pad_mesh(panels, None)
        w, depth = np.array([0.3, 0.4, 1.5, 2.0]), 200.0
        fd = wavetable.fd_fit_grid(w, depth, 9.81)
        staged = torch_bem.stage_inputs(padded, pm, lm, w, [0.0], fd, finite_depth=True,
                                        dtype=f64, device=self.dev)
        kw = dict(tab=torch_bem.stage_tables(wavetable.load_tables(), f64, self.dev),
                  depth=depth, finite_depth=True, dtype=f64, device=self.dev)
        def profiled(label, fn):
            """fn() under the profiler: the host-device copies of the run and
            the CUDA runtime calls made between its entry and its exit."""
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(label):
                    fn()
                torch.cuda.synchronize()
            events = prof.events()
            span = next(e.time_range for e in events if e.name == label)
            runtime = {}
            for e in events:
                if (e.device_type != DeviceType.CUDA and e.name.startswith("cuda")
                        and span.start <= e.time_range.start and e.time_range.end <= span.end):
                    runtime[e.name] = runtime.get(e.name, 0) + 1
            copies = [e.name for e in events if e.device_type == DeviceType.CUDA
                      and ("HtoD" in e.name or "DtoH" in e.name)]
            waits = {k: v for k, v in runtime.items() if "Synchronize" in k or k == "cudaFree"}
            print(f"  {label} under the profiler: host-device copies {copies or 'none'}; runtime "
                  f"calls inside {runtime}")
            self.check(not copies and not waits,
                       f"{label}: no host-to-device or device-to-host copy, no synchronisation "
                       f"({waits or 'none'})")

        profiled("one solve (1,024 class, 4 w, K3/K4)",
                 lambda: torch_bem.solve_panels(**staged, **kw))
        # the refined solve's backward at a chunk's shapes (2 systems, 2n = 2,048)
        rng = np.random.default_rng(3)
        m = 2 * len(padded)
        M2 = torch.as_tensor(rng.normal(size=(2, m, m)) + m * np.eye(m), device=self.dev)
        M2.requires_grad_(True)
        B2 = torch.as_tensor(rng.normal(size=(2, m, 7)), device=self.dev)
        x = torch_bem.solve_refined(M2, B2)
        xbar = torch.ones_like(x)
        profiled("the refined solve's backward (2 x 2,048)",
                 lambda: torch.autograd.grad(x, M2, xbar, retain_graph=True))

        class HostCopies(TorchDispatchMode):
            """Every operator that takes a CPU tensor and gives a CUDA one."""
            def __init__(self):
                super().__init__()
                self.ops = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
                outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
                if any(t.device.type == "cpu" for t in ins) and any(t.is_cuda for t in outs):
                    self.ops.append(str(func))
                return out

        bem_fn = torch_bem.make_bem_fn(panels, w, depth=depth, dtype=torch.float32,
                                       device=self.dev)
        th = torch.tensor(1.0, device=self.dev, requires_grad=True)

        def step():
            A, B, F = bem_fn(th)
            val = A.sum() * 1e-6 + B.sum() * 1e-6 + (F.re**2 + F.im**2).sum() * 1e-10
            return torch.autograd.grad(val, th)[0]

        step()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught, HostCopies() as hc:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                grads = [step()]
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(c.message)[:80] for c in caught
                 if "called a synchronizing CUDA operation" in str(c.message)]
        print(f"  one bem_fn step (float32, value and gradient) after the first: host-to-device "
              f"copies {hc.ops or 'none'}; synchronisations {syncs or 'none'}; gradients "
              f"{[float(g) for g in grads]}")
        self.check(not hc.ops and not syncs and bool(torch.isfinite(torch.stack(grads)).all()),
                   "bem_fn step: no host-to-device copy, no synchronisation")

    def _count_device_ops(self, fn) -> dict:
        """Device operations (kernels, copies) of one run of ``fn`` under
        ``torch.profiler``, by kernel, counted as :meth:`_profile` counts
        them."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0)) > 0}

    def _profile(self, label: str, fn, kernels: dict, wall_key: tuple, split: str | None = None):
        """Where a run's time goes: a second, warm run under torch.profiler
        (its launches are not counted).  ``kernels`` maps a label to the
        substrings of a kernel's name; with ``split``, the name of a
        ``record_function`` range that ``fn`` opens after a synchronise, each
        kernel's time is also split into before and after that range.  Only
        device activity is traced unless ``split`` needs the host's ranges:
        the host's events are most of what the profiler has to process."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if split else [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        t_post = time.perf_counter()

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)

        def matches(name, parts):
            return all(part in name for part in parts)

        # device-side events only (kernels, copies): the CPU-side aten
        # entries carry their kernels' time too and would count it twice
        rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        n_dev = sum(r[1] for r in rows)
        rec, key = wall_key
        wall = sum(rec.get(k, 0.0) for k in key) or wall_ms
        boundary = None
        if split is not None:
            events = prof.events()
            boundary = min(e.time_range.start for e in events if e.name == split)
        shares = []
        for kname, parts in kernels.items():
            k_ms = sum(r[0] for r in rows if matches(r[2], parts)) / 1e3
            share = f"{kname} {k_ms:.3f} ms ({100 * k_ms / busy_ms:.2f}% of device time)"
            if boundary is not None:
                before = after = 0.0
                for e in events:
                    if e.device_type == DeviceType.CUDA and matches(e.name, parts):
                        dur = e.time_range.elapsed_us() / 1e3
                        if e.time_range.start >= boundary:
                            after += dur
                        else:
                            before += dur
                share += (f" [before '{split}' {before:.3f} ms = {100 * before / busy_ms:.2f}%, "
                          f"after {after:.3f} ms = {100 * after / busy_ms:.2f}%]")
            shares.append(share)
        print(f"  profiled {label}: wall {wall_ms:.1f} ms with the profiler on, "
              f"{wall:.1f} ms without; device busy {busy_ms:.2f} ms in {n_dev} device "
              f"operations; idle share {1 - busy_ms / wall:.3f} of the unprofiled wall; "
              + "; ".join(shares)
              + f" (the profiler's processing {time.perf_counter() - t_post:.1f} s)")
        for us, count, name in rows[:10]:
            print(f"    {us / 1e3:9.3f} ms  {count:6d}x  {name[:90]}")
        self.check(busy_ms > 0, f"profiler saw device time ({label})")
        return n_dev

    def phase_profile(self):
        from torch.profiler import record_function

        from raft_tpu_torch.core import cuda6
        from raft_tpu_torch.core.cplx import Cx
        from raft_tpu_torch.parallel.optimize import _make_loss, nacelle_accel_std
        from raft_tpu_torch.parallel.sweep import (north_star_grid, stage_north_star_bem,
                                                   sweep_north_star)

        torch = self.torch
        # solve6_kernel<T, FUSED, ADJOINT>: K1 is FUSED, forward and adjoint
        K1, K3, K4 = ("solve6_kernel", ", true, "), ("rankine_kernel",), ("wave_kernel",)
        K5 = ("drag_kernel",)

        def strip():
            sweep_north_star(n_designs=1000, nw=200, chunk=250, n_iter=40,
                             dtype=torch.float32, device="cuda")

        def bem():
            staged = stage_north_star_bem(nw=200, nw_bem=48, mode="jax", cache=False,
                                          dtype=torch.float64, device="cuda")
            sweep_north_star(n_designs=1000, nw=200, chunk=250, n_iter=40,
                             dtype=torch.float32, device="cuda", bem=staged)

        members, rna, env, wave, C, staged, apply_fn = self._codesign_setup(torch.float32)
        loss = _make_loss(members, rna, env, wave, C, nacelle_accel_std, apply_fn, staged, 25,
                          False, dtype=torch.float32, device=self.dev)
        th = torch.as_tensor(north_star_grid(self.n_designs)[:self.chunk], dtype=torch.float32, device=self.dev)

        def grad_chunk():
            t = th.clone().requires_grad_(True)
            val = loss(t)
            torch.cuda.synchronize()
            with record_function("codesign backward"):
                torch.autograd.grad(val.sum(), t)

        self._profile("strip sweep", strip, {"K1": K1, "K5": K5},
                      (self.record, ("sweep_wall_ms",)))
        self._profile("BEM staging + BEM-staged sweep", bem,
                      {"K1": K1, "K3": K3, "K4": K4, "K5": K5},
                      (self.record_bem, ("stage_ms", "sweep_wall_ms")))
        label = f"co-design gradient, one chunk of {self.chunk} x {self.nw}"
        n_dev = self._profile(label, grad_chunk, {"K1": K1}, (self.record_grad, ("chunk_ms",)),
                              split="codesign backward")

        # the same chunk with the adjoint solve on materialized Z0^T, -Z0.im^T
        # and -B_drag^T (what the kernel's adjoint mode reads in place): the
        # count moves by tens between calls, so both runs share this call
        layouts = []

        def with_copies(Z0, w, B_drag, G):
            if not layouts:
                layouts.append((tuple(Z0.re.shape), Z0.re.stride(), tuple(B_drag.shape),
                                B_drag.stride()))
            ZH = Cx(Z0.re.transpose(-1, -2).contiguous(), (-Z0.im.transpose(-1, -2)).contiguous())
            return cuda6.solve_rao(ZH, w, (-B_drag.transpose(-1, -2)).contiguous(), G)

        orig = cuda6.solve_rao_adjoint
        cuda6.solve_rao_adjoint = with_copies
        try:
            n_copies = self._profile(label + " with the adjoint's transposed copies", grad_chunk,
                                     {"K1": K1}, (self.record_grad, ("chunk_ms",)),
                                     split="codesign backward")
            by_copies = self._count_device_ops(grad_chunk)
        finally:
            cuda6.solve_rao_adjoint = orig
        by_dev = self._count_device_ops(grad_chunk)
        diff = {k: by_copies.get(k, 0) - by_dev.get(k, 0) for k in set(by_copies) | set(by_dev)}
        print(f"  the adjoint's inputs (shape, strides): {layouts[:1]}; device operations by "
              f"kernel, with the copies less without (a second pair of profiles, "
              f"{sum(by_copies.values())} against {sum(by_dev.values())}):")
        for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:8]:
            if v:
                print(f"    {v:+6d}  {k[:110]}")
        # the chunk's other operations come in two counts that differ by
        # about 70 between processes and between runs of one process
        # (18,167-18,173 and 18,240-18,241 in the same code), so the check
        # counts the kernels the transposed copies launch: a copy for each
        # of Z0^T, -Z0.im^T and -B_drag^T, and the two negations
        copies = sum(v for k, v in diff.items()
                     if "direct_copy_kernel" in k or "neg_kernel" in k)
        print(f"  gradient chunk: {n_dev} device operations against {n_copies} with the "
              f"transposed copies (the whole chunk, the profiles above)")
        self.check(copies >= 75,
                   f"gradient chunk: the transposed copies add {copies} copy and negation "
                   f"kernels to the chunk that K1's adjoint mode does without (at least 3 "
                   f"copies x 25 adjoint launches)")

    def run(self, only=None) -> int:
        torch = self.torch
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        print("card:", nvidia_smi(), flush=True)
        self.check(torch.backends.cuda.matmul.allow_tf32 is False,
                   "TF32 matmul is off (PyTorch's default; the port never turns it on)")
        phases = [("build", self.phase_build), ("K1 vs plain", self.phase_k1),
                  ("K5 vs plain", self.phase_k5),
                  ("K2 vs plain", self.phase_k2), ("K2 microbench", self.phase_k2_microbench),
                  ("adjoints", self.phase_adjoint),
                  ("gradient guard", self.phase_grad_guard),
                  ("K3 vs plain", self.phase_k3), ("K4 vs plain", self.phase_k4),
                  ("run_raft", self.phase_run_raft), ("sweep", self.phase_sweep),
                  ("Model(BEM='jax')", self.phase_model_bem),
                  ("BEM-staged north star", self.phase_north_star_bem),
                  ("native BEM staging", self.phase_native_bem),
                  ("co-design gradient", self.phase_codesign),
                  ("optimize_design", self.phase_optimize),
                  ("BEM gradient", self.phase_bem_gradient),
                  ("DLC table", self.phase_dlc),
                  ("variant sweep", self.phase_variant_sweep),
                  ("mixed designs", self.phase_mixed_designs),
                  ("operations", self.phase_operations),
                  ("serve", self.phase_serve),
                  ("fleet", self.phase_fleet),
                  ("array farm", self.phase_array_farm),
                  ("multi-device", self.phase_multi_device),
                  ("lint", self.phase_lint),
                  ("bf16 assembly", self.phase_bf16),
                  ("BEM inputs", self.phase_bem_inputs),
                  ("CLI", self.phase_cli),
                  ("cache", self.phase_cache),
                  ("smokes", self.phase_smokes),
                  ("panel-solve copies", self.phase_solve_copies),
                  ("profile", self.phase_profile)]
        if only is not None:
            unknown = set(only) - {name for name, _ in phases}
            if unknown:
                print(f"unknown phases {sorted(unknown)}", file=sys.stderr)
                return 2
            phases = [(name, fn) for name, fn in phases if name in only]
        t_run = time.perf_counter()
        for name, fn in phases:
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:                       # a phase that raises has failed
                traceback.print_exc()
                self.failures.append(f"phase {name} raised")
            print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
        if self.cli_cold_root is not None:         # phase "CLI" ran without phase "cache"
            import shutil

            shutil.rmtree(self.cli_cold_root, ignore_errors=True)
        print(f"all phases: {time.perf_counter() - t_run:.1f} s", flush=True)
        if self.failures:
            print("FAILED: " + "; ".join(self.failures), file=sys.stderr)
            return 1
        if only is not None:
            print("subset of phases run: no result line", file=sys.stderr)
            return 4
        fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels = [
            {"name": "solve6_fused", "route": "cuda", "source": "raft_tpu_torch/csrc/solve6.cu",
             "replaces": "raft_tpu/core/pallas6.py:213",
             "launches": self.main_launches["fused"] + self.main_launches["fused_adjoint"],
             "launches_forward": self.main_launches["fused"],
             "launches_adjoint": self.main_launches["fused_adjoint"],
             **{k: self.record[k] for k in fields}},
            {"name": "solve6_plain", "route": "cuda", "source": "raft_tpu_torch/csrc/solve6.cu",
             "replaces": "raft_tpu/core/pallas6.py:202",
             "launches": self.main_launches["plain"],
             **{k: self.records["plain"][k] for k in fields}},
            {"name": "bem_rankine", "route": "cuda",
             "source": "raft_tpu_torch/csrc/bem_rankine.cu",
             "replaces": "raft_tpu/core/pallas_bem.py:103",
             "launches": self.main_launches["rankine"],
             **{k: self.records["rankine"][k] for k in fields}},
            {"name": "bem_wave", "route": "cuda", "source": "raft_tpu_torch/csrc/bem_wave.cu",
             "replaces": "raft_tpu/core/pallas_bem.py:255",
             "launches": self.main_launches["wave"],
             **{k: self.records["wave"][k] for k in fields}},
            {"name": "bem_rankine_bf16", "route": "cuda",
             "source": "raft_tpu_torch/csrc/bem_rankine.cu",
             "replaces": "raft_tpu/core/pallas_bem.py:103",
             "launches": self.main_launches["rankine_bf16"],
             **{k: self.records["rankine_bf16"][k] for k in fields}},
            {"name": "bem_wave_bf16", "route": "cuda",
             "source": "raft_tpu_torch/csrc/bem_wave.cu",
             "replaces": "raft_tpu/core/pallas_bem.py:255",
             "launches": self.main_launches["wave_bf16"],
             **{k: self.records["wave_bf16"][k] for k in fields}},
            {"name": "drag_step", "route": "cuda", "source": "raft_tpu_torch/csrc/drag.cu",
             "replaces": "no TPU kernel: the jnp ops of raft_tpu/hydro/strip.py::linearized_drag",
             "launches": self.main_launches["step"],
             **{k: self.records["drag"][k] for k in fields}},
        ]
        print(json.dumps({"kernels": kernels}))
        print(nvidia_smi())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0


def main() -> int:
    if not (ROOT / "raft_tpu_torch").is_dir() or not DESIGNS.is_dir():
        print("chip_smoke.py must run from the root of a raft_tpu checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        only = [name.strip() for name in sys.argv[2].split(",")]
    elif len(sys.argv) != 1:
        print("usage: python3 chip_smoke.py [--phases name,name,...]", file=sys.stderr)
        return 2
    return Smoke().run(only)


if __name__ == "__main__":
    sys.exit(main())
