"""The port stands alone: ``raft_tpu_torch`` imports neither JAX nor Flax
nor any module of the JAX package ``raft_tpu``, and its entry points refuse
to fall back to the CPU when no card is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "raft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


def _forbidden(name: str) -> bool:
    # exact package names: the prefix "raft_tpu" also begins "raft_tpu_torch"
    return name.split(".")[0] in FORBIDDEN


def test_fresh_process_imports_nothing_of_jax():
    code = (
        "import sys, torch\n"
        "import raft_tpu_torch.model, raft_tpu_torch.convert\n"
        "from raft_tpu_torch.parallel.sweep import sweep_north_star\n"
        "out = sweep_north_star(n_designs=2, nw=8, chunk=2, n_iter=5, device='cpu')\n"
        "assert out['std'].shape == (2, 6) and bool(torch.isfinite(out['std']).all())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_bem_modules_import_nothing_of_jax():
    """The panel-BEM modules (with their own copies of the JAX package's
    mesher, wave tables, Bessel functions and interpolation) load in a
    fresh process without JAX or the JAX package."""
    code = (
        "import sys\n"
        "import raft_tpu_torch.hydro.torch_bem\n"
        "import raft_tpu_torch.core.cuda_bem, raft_tpu_torch.core.nvcc\n"
        "import raft_tpu_torch.hydro.mesh, raft_tpu_torch.hydro.wavetable\n"
        "import raft_tpu_torch.hydro.bem_io, raft_tpu_torch.core.bessel\n"
        "import raft_tpu_torch.solve.eigen, raft_tpu_torch.parallel.sweep\n"
        "import raft_tpu_torch.parallel.optimize, raft_tpu_torch.core.cuda6\n"
        "import raft_tpu_torch.solve.dynamics, raft_tpu_torch.mooring.system\n"
        "import raft_tpu_torch.hydro.native_bem\n"
        "import raft_tpu_torch as rt\n"
        "assert rt.optimize_design.__module__ == 'raft_tpu_torch.parallel.optimize'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"hydro/torch_bem.py", "hydro/mesh.py", "hydro/wavetable.py", "hydro/bem_io.py",
            "core/bessel.py", "core/cuda_bem.py", "core/nvcc.py", "parallel/optimize.py",
            "core/cuda6.py", "hydro/native_bem.py"} <= names


def test_multi_device_modules_import_nothing_of_jax():
    """The multi-device layer (``core.collectives``, ``parallel.multihost``,
    ``spmd``, ``spmd_smoke``) and the package's lazy names load in a fresh
    process without JAX or the JAX package."""
    code = (
        "import sys\n"
        "import raft_tpu_torch.core.collectives\n"
        "import raft_tpu_torch.parallel.multihost, raft_tpu_torch.parallel.spmd\n"
        "import raft_tpu_torch.parallel.spmd_smoke\n"
        "import raft_tpu_torch as rt, raft_tpu_torch.parallel as par\n"
        "assert rt.make_mesh is par.make_mesh\n"
        "assert rt.forward_response_freq_sharded.__module__ == 'raft_tpu_torch.parallel.sweep'\n"
        "assert par.init_multihost.__module__ == 'raft_tpu_torch.parallel.multihost'\n"
        "from raft_tpu_torch.parallel import multihost as mh\n"
        "assert mh.psum.__module__ == 'raft_tpu_torch.core.collectives'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout



def test_lint_modules_import_nothing_of_jax():
    """The port's lint (``raft_tpu_torch.lint``: rules, knobs, registry,
    audit, race, baseline, cli) loads in a fresh process without JAX or the
    JAX package, and its static pass runs there."""
    code = (
        "import sys\n"
        "import raft_tpu_torch.lint.rules, raft_tpu_torch.lint.knobs\n"
        "import raft_tpu_torch.lint.registry, raft_tpu_torch.lint.audit\n"
        "import raft_tpu_torch.lint.race, raft_tpu_torch.lint.baseline\n"
        "import raft_tpu_torch.lint.cli\n"
        "from raft_tpu_torch.lint import lint_paths, RULES\n"
        "assert 'GL106' in RULES\n"
        "lint_paths(['raft_tpu_torch/lint'], '.')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {f"lint/{m}.py" for m in ("__init__", "__main__", "rules", "knobs", "registry",
                                     "audit", "race", "baseline", "cli")} <= names

def test_no_forbidden_import_in_source():
    found = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert found == []
    assert _forbidden("raft_tpu.core") and not _forbidden("raft_tpu_torch.core")


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without CUDA, the default device (the card) raises instead of
    silently running on the CPU."""
    from raft_tpu_torch.core.device import resolve_device
    from raft_tpu_torch.model import Model, load_design, run_raft
    from raft_tpu_torch.parallel.sweep import forward_response, sweep_north_star

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    design = load_design(ROOT / "raft_tpu" / "designs" / "OC3spar.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(design)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_raft(ROOT / "raft_tpu" / "designs" / "OC3spar.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_north_star(n_designs=2, nw=8)
    from raft_tpu_torch.hydro.torch_bem import solve_bem_any
    from raft_tpu_torch.parallel.sweep import stage_north_star_bem

    with pytest.raises(RuntimeError, match="CUDA"):
        stage_north_star_bem(nw=8, nw_bem=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        # the host solve never starts: the staging's device is checked first
        stage_north_star_bem(nw=8, nw_bem=4, mode="native")
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_bem_any(np.zeros((1, 4, 3)), [1.0])
    m = Model(design, device="cpu")
    m.calcSystemProps()
    args = (m.members, m.rna, m.env, m.wave, m.C_moor0)
    with pytest.raises(RuntimeError, match="CUDA"):
        forward_response(*args)
    from raft_tpu_torch.parallel.optimize import grad_nacelle_accel_std, optimize_design
    from raft_tpu_torch.parallel.sweep import grad_response_std

    with pytest.raises(RuntimeError, match="CUDA"):
        grad_nacelle_accel_std(*args, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        optimize_design(*args, theta0=1.0, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        grad_response_std(*args, 1.0)
    from raft_tpu_torch.core import cuda6
    from raft_tpu_torch.core.cplx import Cx

    with pytest.raises(RuntimeError, match="CUDA"):
        # a kernel argument made on an entry point's default device
        cuda6.solve_cx(Cx(torch.eye(6, device=resolve_device()), torch.zeros(6, 6)),
                       Cx(torch.ones(6), torch.zeros(6)))
    # the variant and mixed-design sweeps, the design staging, the bucketed
    # member build and the arrays
    from raft_tpu_torch.array import ArrayModel, stack_fowts
    from raft_tpu_torch.build.buckets import build_bucketed_member_set
    from raft_tpu_torch.model import _staged_wave, stage_design_base, stage_designs
    from raft_tpu_torch.parallel.sweep import sweep, sweep_designs

    path = ROOT / "raft_tpu" / "designs" / "OC3spar.yaml"
    kw = dict(nw=8, Hs=8.0, Tp=12.0, w_min=0.05, w_max=2.95)
    for call in (lambda: sweep(*args, [1.0, 1.1]),
                 lambda: sweep_designs([path], **kw),
                 lambda: sweep_designs(staged=stage_designs([path], device="cpu", **kw)),
                 lambda: stage_designs([path], **kw),
                 lambda: stage_design_base(path, **kw),
                 lambda: _staged_wave(8, 0.05, 2.95, 320.0, 8.0, 12.0),
                 lambda: build_bucketed_member_set(design),
                 lambda: stack_fowts([design]),
                 lambda: ArrayModel(design, nT=2),
                 lambda: Model(design, nTurbines=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert isinstance(Model(design, nTurbines=2, device="cpu"), ArrayModel)
    assert resolve_device("cpu").type == "cpu"


def test_bem_gradient_and_sea_state_entries_refuse_cpu_fallback(monkeypatch):
    """The BEM gradient's and the sea-state batches' entry points, like the
    others, raise without CUDA unless the caller asks for the CPU."""
    from raft_tpu_torch.hydro.torch_bem import make_bem_fn, stage_inputs
    from raft_tpu_torch.model import Model, load_design
    from raft_tpu_torch.parallel.sweep import (directional_response, make_wave_states,
                                               mixed_sea_state, spread_sea_state,
                                               sweep_sea_states)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.linspace(0.3, 1.5, 4)
    panels = np.array([[[1.0, 0.0, -1.0], [1.0, 0.5, -1.0], [1.0, 0.5, -2.0], [1.0, 0.0, -2.0]]])
    for call in (lambda: make_bem_fn(panels, w),
                 lambda: stage_inputs(panels, [1.0], [0.0], w, [0.0], {}, finite_depth=False,
                                      dtype=torch.float64, device=None),
                 lambda: make_wave_states(w, [[6.0, 10.0]], 200.0),
                 lambda: spread_sea_state(w, 6.0, 10.0, 200.0),
                 lambda: mixed_sea_state(w, [[6.0, 10.0, 0.0]], 200.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    m = Model(load_design(ROOT / "raft_tpu" / "designs" / "OC3spar.yaml"), device="cpu")
    m.calcSystemProps()
    waves = make_wave_states(_np(m.w), [[6.0, 10.0], [8.0, 12.0]], m.depth, device="cpu")
    for fn in (sweep_sea_states, directional_response):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(m.members, m.rna, m.env, waves, m.C_moor0)


def _np(t):
    return t.detach().cpu().numpy()


def test_kernel_wrappers_refuse_other_devices():
    """A tensor on another device than CPU or CUDA finds no kernel in the
    solve wrappers (no silent fallback to the plain version)."""
    from raft_tpu_torch.core import cuda6
    from raft_tpu_torch.core.cplx import Cx

    meta = {"device": "meta", "dtype": torch.float64}
    with pytest.raises(ValueError, match="no kernel"):
        cuda6.solve_cx(Cx(torch.empty(2, 6, 6, **meta), torch.empty(2, 6, 6, **meta)),
                       Cx(torch.empty(2, 6, **meta), torch.empty(2, 6, **meta)))
    with pytest.raises(ValueError, match="no kernel"):
        cuda6.solve_rao(Cx(torch.empty(1, 3, 6, 6, **meta), torch.empty(1, 3, 6, 6, **meta)),
                        torch.empty(3, **meta), torch.empty(1, 6, 6, **meta),
                        Cx(torch.empty(1, 3, 6, **meta), torch.empty(1, 3, 6, **meta)))


def test_kernel_wrappers_refuse_grad_off_the_cpu():
    """Off the CPU, a wrapper called under grad mode with an input that
    requires grad raises (a kernel's outputs carry no autograd history)
    and names the scan driver; without grad mode the same call reaches the
    device dispatch."""
    from raft_tpu_torch.core import cuda6, cuda_bem
    from raft_tpu_torch.core.cplx import Cx
    from raft_tpu_torch.hydro import torch_bem, wavetable

    meta = {"device": "meta", "dtype": torch.float64}

    def e(*shape, grad=False):
        return torch.empty(*shape, **meta).requires_grad_(grad)

    n = 8
    quad = tuple(e(torch_bem.LEVEL_START[-1] + torch_bem.LEVEL_COUNT[-1]) for _ in range(3))
    tab = {"I0": e(wavetable.NX, wavetable.NS), "I1": e(wavetable.NX, wavetable.NS)}
    calls = {
        "solve_rao": lambda g: cuda6.solve_rao(Cx(e(1, 3, 6, 6, grad=g), e(1, 3, 6, 6)), e(3),
                                              e(1, 6, 6), Cx(e(1, 3, 6), e(1, 3, 6))),
        "solve_cx": lambda g: cuda6.solve_cx(Cx(e(2, 6, 6), e(2, 6, 6)),
                                            Cx(e(2, 6, grad=g), e(2, 6))),
        "rankine_assembly": lambda g: cuda_bem.rankine_assembly(
            e(n, 4, 3, grad=g), e(n, 3), e(n, 3), e(n), e(n), e(n),
            torch.empty(n, dtype=torch.bool, device="meta"), e(n), quad=quad),
        "wave_assembly": lambda g: cuda_bem.wave_assembly(
            e(n, n), e(n, n), e(n, 3), e(n, 3), e(n), e(n),
            torch.empty(n, dtype=torch.bool, device="meta"), tab, e(2, grad=g), None,
            finite_depth=False, depth=0.0),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='method="scan"') as info:
            call(True)
        assert "solve_rao_ad" in str(info.value), name
        with torch.no_grad():
            with pytest.raises(ValueError, match="no kernel"):
                call(True)
        with pytest.raises(ValueError, match="no kernel"):
            call(False)


def test_native_solver_and_caches_are_the_ports_own(tmp_path):
    """The port's native library is built from its own source into its own
    build directory; its wave table and result caches live there too, and
    a process with a fresh HOME writes nothing under it."""
    from raft_tpu_torch.cache import config
    from raft_tpu_torch.hydro import native_bem

    assert native_bem.SRC == PKG / "native" / "bem.cpp"
    assert native_bem.lib_path().parent == PKG / "_build"
    assert native_bem.table_path().parent == PKG / "_build"
    text = native_bem.SRC.read_text()
    assert "getenv" not in text and "system(" not in text and "bem_set_table_path" in text
    home = tmp_path / "home"
    home.mkdir()
    code = (
        "import os\n"
        "from raft_tpu_torch.hydro import native_bem\n"
        "from raft_tpu_torch.cache import config\n"
        f"os.environ.pop({config.CACHE_ENV!r}, None)\n"
        "print('ROOT', config.cache_root())\n"
        "native_bem.wave_integral(1.0, -1.0)\n"
        "print('TABLE', native_bem.table_path().exists())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), HOME=str(home))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"ROOT {PKG / '_build' / 'cache'}" in proc.stdout and "TABLE True" in proc.stdout
    assert list(home.iterdir()) == []


def test_chip_smoke_refuses_without_card():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bem_input_and_cli_modules_import_nothing_of_jax_nor_matplotlib():
    """The BEM inputs (Capytaine datasets, the WEIS adapter, the HAMS and
    Nemoh files) and the runRAFT facade load in a fresh process without JAX
    or the JAX package, and ``import raft_tpu_torch.cli`` leaves matplotlib
    unloaded (the plots import it when they draw)."""
    code = (
        "import sys\n"
        "import raft_tpu_torch.hydro.capy, raft_tpu_torch.io.weis, raft_tpu_torch.cli\n"
        "import raft_tpu_torch.hydro.bem_io, raft_tpu_torch.tools.bf16_error\n"
        "import raft_tpu_torch.model, raft_tpu_torch.array\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
        "print('MATPLOTLIB', sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout and "MATPLOTLIB []" in proc.stdout, proc.stdout
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"hydro/capy.py", "io/weis.py", "cli.py", "tools/bf16_error.py"} <= names


def test_cli_and_bem_inputs_refuse_cpu_fallback(monkeypatch):
    """Without CUDA the CLI's default device raises, as every entry point's."""
    from raft_tpu_torch import cli

    from raft_tpu_torch import cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        for argv in (["oc3"], ["sweep", "oc3", "-n", "2"], ["optimize", "oc3", "--steps", "1"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(argv + ["--wmin", "0.2", "--wmax", "1.2", "--dw", "0.2"])
    finally:
        cache.disable()                 # main enables the cache first


def test_operations_modules_import_nothing_of_jax():
    """The batch operations layer (the chunk pipeline, lane health, the
    escalation ladder, chunk checkpoints, fault injection, retry, the obs
    spans, metrics and sinks, and the resilience smoke) loads in a fresh
    process without JAX or the JAX package."""
    code = (
        "import sys\n"
        "import raft_tpu_torch.obs, raft_tpu_torch.obs.flight, raft_tpu_torch.obs.export\n"
        "import raft_tpu_torch.resilience, raft_tpu_torch.resilience.smoke\n"
        "import raft_tpu_torch.resilience.__main__, raft_tpu_torch.resilience.faults\n"
        "import raft_tpu_torch.parallel.pipeline, raft_tpu_torch.build.buckets\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"obs/__init__.py", "obs/metrics.py", "obs/trace.py", "obs/flight.py",
            "obs/export.py", "resilience/__init__.py", "resilience/__main__.py",
            "resilience/smoke.py", "resilience/faults.py", "resilience/health.py",
            "resilience/ladder.py", "resilience/retry.py", "resilience/checkpoint.py",
            "parallel/pipeline.py"} <= names


def test_serve_modules_import_nothing_of_jax():
    """The serving tier (protocol, batcher, config, solver core, server,
    client, loadgen, router, fleet supervisor, the smokes and the CLI,
    and every lazy export of the package) loads in a fresh process without
    JAX or the JAX package."""
    code = (
        "import sys, importlib\n"
        "import raft_tpu_torch.serve as serve\n"
        "for m in ('config', 'protocol', 'batcher', 'solver', 'server', 'client', 'loadgen',\n"
        "          'router', 'fleet', 'smoke', 'fleet_smoke', '__main__'):\n"
        "    importlib.import_module('raft_tpu_torch.serve.' + m)\n"
        "for name in serve.__all__:\n"
        "    getattr(serve, name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {f"serve/{m}.py" for m in (
        "__init__", "__main__", "config", "protocol", "batcher", "solver", "server", "client",
        "loadgen", "router", "fleet", "smoke", "fleet_smoke")} <= names


def test_daemon_refuses_without_cuda(tmp_path, monkeypatch):
    """Without CUDA the daemon, the fleet and the smokes refuse to start
    (exit 2, no socket bound) unless they get ``--device cpu``; in process,
    a server or solver core for the card raises."""
    sock = tmp_path / "d.sock"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    for argv in (["daemon", "--socket", str(sock), "--nw", "8"],
                 ["fleet", "--socket", str(sock), "--replicas", "1"],
                 ["smoke"], ["fleet-smoke"]):
        proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.serve", *argv], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2, (argv, proc.stdout[-1000:], proc.stderr[-1000:])
        assert "CUDA" in proc.stderr and '"ready"' not in proc.stdout
        assert not sock.exists()
    from raft_tpu_torch.serve.config import ServeConfig
    from raft_tpu_torch.serve.server import SolverServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverServer(ServeConfig(socket_path=str(sock)))
    srv = SolverServer(ServeConfig(socket_path=str(sock), device="cpu"))
    assert srv.core.device.type == "cpu" and not sock.exists()
