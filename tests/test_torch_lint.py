"""The port's static lint (``raft_tpu_torch.lint``): a trigger and a
near-miss fixture per ported rule, the CLI's exit codes, suppressions, the
baseline with its reasons, hot-path reachability, the knob registry and
its README table, the repository clean against its baseline, and the rules
the two packages share held to the same findings as ``raft_tpu.lint``."""
import importlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest

from raft_tpu_torch.lint import baseline as bl
from raft_tpu_torch.lint import knobs
from raft_tpu_torch.lint.cli import DEFAULT_TARGETS, main as cli_main
from raft_tpu_torch.lint.rules import (
    NOT_PORTED, RULES, collect_env_reads, hot_functions, lint_paths)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, src, name="mod.py", extra=None):
    for fname, fsrc in {name: src, **(extra or {})}.items():
        p = tmp_path / fname
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(fsrc))


def _lint(tmp_path, src, name="mod.py", extra=None):
    _write(tmp_path, src, name, extra)
    return lint_paths([str(tmp_path)], str(tmp_path))


def _rules(vs):
    return {v.rule for v in vs}


HOT = '__graftlint_hot__ = ("step",)\n'

# rule -> (trigger source, near-miss source)
FIXTURES = {
    "GL101": (
        """
        import numpy as np
        import torch
        """ + HOT + """
        def step(x):
            return np.sin(x)
        """,
        """
        import numpy as np
        import torch
        """ + HOT + """
        def step(x, n: int):
            return torch.sin(x) + np.sqrt(n)
        """,
    ),
    "GL102": (
        """
        import torch
        """ + HOT + """
        def step(x):
            return float(x.sum())
        """,
        """
        import torch
        """ + HOT + """
        def step(x):
            return x * float(x.shape[0])
        """,
    ),
    "GL103": (
        """
        import torch
        """ + HOT + """
        def step(x):
            if (x > 0).any():
                return x
            return -x
        """,
        """
        import torch
        """ + HOT + """
        def step(x, mask=None, method: str = "scan"):
            if x.ndim == 2 and mask is not None and method == "scan":
                return torch.where(x > 0, x, -x)
            return x
        """,
    ),
    "GL105": (
        """
        import torch
        """ + HOT + """
        def step(x, dtype):
            return x + torch.zeros(3, dtype=torch.float64, device=x.device)
        """,
        """
        import torch
        """ + HOT + """
        def step(x, dtype):
            if dtype == torch.float64:
                return x
            return x + torch.zeros(3, dtype=dtype, device=x.device)

        def host(n):
            return torch.zeros(n, dtype=torch.float64)
        """,
    ),
    "GL106": (
        """
        import torch
        """ + HOT + """
        def step(x):
            return x.sum().item()
        """,
        """
        import torch
        from raft_tpu_torch.core.device import to_device
        """ + HOT + """
        def step(x, dev):
            return x * to_device(0.5, x.dtype, dev) + torch.full_like(x, 2.0)

        def host(x):
            return x.sum().item()
        """,
    ),
    "GL107": (
        """
        def key_parts(names):
            out = []
            for k in {"b", "a"}:
                out.append(k)
            return tuple(set(out))
        """,
        """
        def key_parts(names):
            out = []
            for k in sorted({"b", "a"}):
                out.append(k)
            return tuple(sorted(set(out)))
        """,
    ),
    "GL201": (
        """
        import os

        def stage(x):
            return os.environ.get("RAFT_TPU_WIDGET", "1")
        """,
        """
        import os

        def stage(x):
            return os.environ.get("RAFT_TPU_STRICT", "1")
        """,
    ),
    "GL202": (
        """
        import json
        import os
        from raft_tpu.cache.config import subdir

        def publish(payload, key):
            path = os.path.join(subdir("aot"), key + ".json")
            with open(path, "w") as f:
                json.dump(payload, f)
        """,
        """
        import json
        import os
        import tempfile
        from raft_tpu.cache.config import subdir

        def publish(payload, key):
            path = os.path.join(subdir("aot"), key + ".json")
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        """,
    ),
    "GL203": (
        """
        import subprocess

        def build(cmd):
            return subprocess.run(cmd, capture_output=True)
        """,
        """
        import subprocess

        def build(cmd):
            return subprocess.run(cmd, capture_output=True, timeout=300.0)
        """,
    ),
    "GL204": (
        """
        from raft_tpu_torch.parallel import pipeline as _pipe

        def run(fn, chunks):
            return _pipe.run_pipelined(fn, chunks, stage=lambda k: (k, k),
                                       donate_argnums=(1,))
        """,
        """
        from raft_tpu_torch.parallel import pipeline as _pipe

        def run(fn, chunks):
            donate = _pipe.donation_enabled()
            return _pipe.run_pipelined(fn, chunks, stage=lambda k: (k, k),
                                       donate_argnums=(1,) if donate else ())
        """,
    ),
    "GL301": (
        """
        import threading

        _memo: dict = {}
        _lock = threading.Lock()

        def remember(k, v):
            _memo[k] = v
        """,
        """
        import threading

        _memo: dict = {}
        _lock = threading.Lock()

        def remember(k, v):
            with _lock:
                _memo[k] = v

        def shadowed(k, v):
            _memo = {}
            _memo[k] = v
            return _memo
        """,
    ),
    "GL302": (
        """
        _memo: dict = {}

        def get_or_compute(k):
            if k not in _memo:
                _memo[k] = k * 2
            return _memo[k]
        """,
        """
        import threading

        _memo: dict = {}
        _lock = threading.Lock()

        def get_or_compute(k):
            with _lock:
                if k not in _memo:
                    _memo[k] = k * 2
                return _memo[k]
        """,
    ),
    "GL303": (
        """
        import os

        __graftlint_concurrent__ = ("serve",)

        def serve(req):
            return req * _depth()

        def _depth():
            return int(os.environ.get("RAFT_TPU_PIPELINE_DEPTH", "2"))
        """,
        """
        import os

        __graftlint_concurrent__ = ("serve",)
        _DEPTH = int(os.environ.get("RAFT_TPU_PIPELINE_DEPTH", "2"))

        def serve(req):
            return req * _DEPTH
        """,
    ),
    "GL401": (
        """
        import torch.distributed as dist

        __graftlint_multihost__ = ("step",)

        def reduce_all(t):
            dist.all_reduce(t)
            return t

        def step(t):
            if dist.get_rank() == 0:
                return reduce_all(t)
            return t
        """,
        """
        import torch.distributed as dist

        __graftlint_multihost__ = ("step",)

        def reduce_all(t):
            dist.all_reduce(t)
            return t

        def step(t):
            if t.shape[0] > 1:
                return reduce_all(t)
            return t
        """,
    ),
    "GL402": (
        """
        import os
        from raft_tpu_torch.cache.config import cache_root

        __graftlint_multihost__ = ("publish",)

        def publish(payload):
            path = os.path.join(str(cache_root()), "out.json")
            with open(path, "w") as f:
                f.write(payload)
        """,
        """
        import os
        import torch.distributed as dist
        from raft_tpu_torch.cache.config import cache_root
        from raft_tpu_torch.obs.export import _atomic_write

        __graftlint_multihost__ = ("publish",)

        def publish(payload):
            path = os.path.join(str(cache_root()), f"out-{dist.get_rank()}.json")
            _atomic_write(path, payload)
        """,
    ),
    "GL404": (
        """
        from torch.distributed.device_mesh import init_device_mesh

        def make():
            return init_device_mesh("cpu", (2,), mesh_dim_names=("freq",))

        def group(mesh):
            return mesh.get_group("frq")
        """,
        """
        from torch.distributed.device_mesh import init_device_mesh

        def make():
            return init_device_mesh("cpu", (2,), mesh_dim_names=("freq",))

        def group(mesh):
            return mesh.get_group("freq"), (mesh, "freq")
        """,
    ),
}


def test_every_ported_rule_has_fixtures():
    assert set(FIXTURES) == set(RULES)
    assert set(NOT_PORTED) == {"GL104", "GL403"} and not set(NOT_PORTED) & set(RULES)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_triggers(tmp_path, rule):
    vs = _lint(tmp_path, FIXTURES[rule][0])
    assert rule in _rules(vs), [v.format() for v in vs]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_near_miss(tmp_path, rule):
    vs = _lint(tmp_path, FIXTURES[rule][1])
    assert rule not in _rules(vs), [v.format() for v in vs]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_cli_fails_on_each_trigger(tmp_path, rule, capsys):
    _write(tmp_path, FIXTURES[rule][0])
    rc = cli_main([str(tmp_path), "--root", str(tmp_path), "--no-baseline", "--json"])
    out = capsys.readouterr().out
    assert rc == 1 and rule in out
    assert json.loads(out.strip().splitlines()[-1])["ok"] is False


@pytest.mark.parametrize("src,rule", [
    ("def step(x, dev):\n    return torch.tensor(0.5, device=dev) * x\n", "GL106"),
    ("def step(x):\n    return x * torch.as_tensor(np.arange(3.0), device=x.device)\n",
     "GL106"),
    ("def step(x, table):\n    return torch.full((3,), np.asarray(table)[0], device=x.device)\n",
     "GL106"),
    ("def step(x):\n    torch.cuda.synchronize()\n    return x\n", "GL106"),
    ("def step(x, ev):\n    ev.synchronize()\n    return x\n", "GL106"),
    ("def step(x):\n    return x.cpu()\n", "GL106"),
    ("def step(x):\n    print(x)\n    return x\n", "GL106"),
    ("def step(x):\n    return np.asarray(x)\n", "GL106"),
    ("def step(x):\n    return x if x.sum() > 0 else -x\n", "GL103"),
    ("def step(x):\n    assert torch.isfinite(x).all()\n    return x\n", "GL103"),
    ("def step(x):\n    while x.max() > 1:\n        x = x / 2\n    return x\n", "GL103"),
    ("def step(x):\n    return int(torch.argmax(x))\n", "GL102"),
])
def test_hot_path_spellings(tmp_path, src, rule):
    vs = _lint(tmp_path, "import numpy as np\nimport torch\n" + HOT + src)
    assert rule in _rules(vs), [v.format() for v in vs]


def test_scalar_fill_and_device_move_are_not_copies(tmp_path):
    vs = _lint(tmp_path, "import torch\n" + HOT + textwrap.dedent("""
        def step(x, dev):
            a = torch.full((3,), float("nan"), device=dev)
            b = torch.as_tensor(x, device=dev)
            return a, b
        """))
    assert not vs, [v.format() for v in vs]


def test_cpu_only_branch_is_not_a_sync(tmp_path):
    vs = _lint(tmp_path, "import torch\n" + HOT + textwrap.dedent("""
        def step(x):
            if x.device.type == "cpu":
                bad = [i for i, v in enumerate(x) if int(v) != 0]
                if bad:
                    raise ValueError(bad)
            return x
        """))
    assert not vs, [v.format() for v in vs]


def test_loop_keys_and_indices_are_not_tensors(tmp_path):
    vs = _lint(tmp_path, "import dataclasses\nimport torch\n" + HOT + textwrap.dedent("""
        def step(fields_in, x):
            out = {}
            for name, val in fields_in.items():
                out[name] = val * 2 if name.startswith("seg_") else val
            for i, t in enumerate(x):
                out[i] = t if i > 0 else -t
            for f in dataclasses.fields(x):
                if f.name not in out:
                    out[f.name] = None
            return out
        """))
    assert not vs, [v.format() for v in vs]


def test_gl204_out_of_range_index(tmp_path):
    vs = _lint(tmp_path, """
        from raft_tpu_torch.parallel import pipeline as _pipe

        def run(fn, chunks):
            donate = _pipe.donation_enabled()
            def stage(k):
                return (k, k)
            return _pipe.run_pipelined(fn, chunks, stage=stage,
                                       donate_argnums=(2,) if donate else ())
        """)
    msgs = [v.msg for v in vs if v.rule == "GL204"]
    assert len(msgs) == 1 and "out of range for the 2-item" in msgs[0]


def test_gl201_knob_classes_in_hot_code(tmp_path):
    vs = _lint(tmp_path, "import os\n" + HOT + textwrap.dedent("""
        def step(x):
            a = os.environ.get("RAFT_TPU_BEM_PRECISION", "")
            b = os.environ.get("RAFT_TPU_STRICT", "")
            return x, a, b
        """))
    gl201 = [v for v in vs if v.rule == "GL201"]
    assert len(gl201) == 1 and "RAFT_TPU_STRICT" in gl201[0].msg


def test_gl404_collective_in_rank_branch(tmp_path):
    vs = _lint(tmp_path, """
        import os
        import torch.distributed as dist
        from raft_tpu_torch.core.collectives import psum

        def step(t, axis):
            if dist.get_rank() == 0:
                dist.all_reduce(t)
            return psum(t, axis) if os.getpid() else t
        """)
    assert sum(v.rule == "GL404" for v in vs) == 2, [v.format() for v in vs]


# --------------------------------------------------------- reachability

def test_autograd_function_is_a_seed(tmp_path):
    vs = _lint(tmp_path, """
        import numpy as np
        import torch

        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return helper(x)

            @staticmethod
            def backward(ctx, g):
                if ctx.needs_input_grad[0]:
                    return g.cpu()
                return None

        def helper(x):
            return np.cos(x)

        def host(x):
            return np.cos(x)
        """)
    got = {(v.rule, v.func) for v in vs}
    assert got == {("GL101", "helper"), ("GL106", "F.backward")}, got


def test_driver_step_body_and_checkpoint_are_seeds(tmp_path):
    vs = _lint(tmp_path, """
        import torch
        from torch.utils.checkpoint import checkpoint

        def solve(x, n_iter: int = 3):
            def advance(y):
                return y * 2.0, float(y.max())
            for _ in range(n_iter):
                x, e = checkpoint(advance, x, use_reentrant=False)
            return x

        def impedance(x):
            return x.item()
        """, name="solve/dynamics.py")
    got = {(v.rule, v.func) for v in vs}
    assert got == {("GL102", "solve.advance")}, got


def test_pipeline_chunk_function_and_factory_closure(tmp_path):
    vs = _lint(tmp_path, """
        from raft_tpu_torch.parallel.pipeline import run_pipelined

        def make(scale):
            def run(x):
                return x.tolist()
            return run

        def sweep(chunks, scale):
            run = make(scale)
            def fn(x):
                return run(x)
            return run_pipelined(fn, chunks)
        """)
    got = {(v.rule, v.func) for v in vs}
    assert got == {("GL106", "make.run")}, got


def test_hot_declaration_crosses_modules(tmp_path):
    vs = _lint(tmp_path, """
        from pkg.helpers import reduce
        __graftlint_hot__ = ("step",)

        def step(x):
            return reduce(x)
        """, name="pkg/main.py", extra={"pkg/__init__.py": "", "pkg/helpers.py": """
        def reduce(x):
            return x.sum().item()

        def unused(x):
            return x.sum().item()
        """})
    got = {(v.rule, v.path, v.func) for v in vs}
    assert got == {("GL106", os.path.join("pkg", "helpers.py"), "reduce")}, got


def test_host_code_is_not_hot(tmp_path):
    vs = _lint(tmp_path, """
        import numpy as np
        import torch

        def orchestrate(x):
            if x.sum() > 0:
                print(x)
            return np.asarray(x.cpu()), float(x.max())
        """)
    assert not vs, [v.format() for v in vs]


def test_repo_hot_set_has_the_seeds():
    hot = set(hot_functions(list(DEFAULT_TARGETS), REPO))
    for want in ("raft_tpu_torch/core/cuda6.py::_SolveRaoAD.forward",
                 "raft_tpu_torch/core/cuda6.py::_SolveRaoAD.backward",
                 "raft_tpu_torch/solve/dynamics.py::solve_dynamics",
                 "raft_tpu_torch/solve/dynamics.py::solve_dynamics.advance",
                 "raft_tpu_torch/parallel/sweep.py::_sweep_sea_states_chunked.fn",
                 "raft_tpu_torch/parallel/sweep.py::_make_dlc_case_fn.run",
                 "raft_tpu_torch/hydro/strip.py::linearized_drag",
                 "raft_tpu_torch/core/cuda6.py::_solve_rao"):
        assert want in hot
    assert "raft_tpu_torch/parallel/sweep.py::sweep_sea_states" not in hot


# --------------------------------------------------- suppression, baseline

def test_line_and_file_suppression(tmp_path):
    src = "import torch\n" + HOT + textwrap.dedent("""
        def step(x):
            return x.sum().item()  # graftlint: disable=GL106
        """)
    assert not _lint(tmp_path, src)
    src = "# graftlint: disable-file=GL102, GL106\nimport torch\n" + HOT + textwrap.dedent("""
        def step(x):
            return float(x.sum()), x.cpu()
        """)
    assert not _lint(tmp_path, src)
    src = "import torch\n" + HOT + textwrap.dedent("""
        def step(x):
            return float(x.sum())  # graftlint: disable=GL106
        """)
    assert _rules(_lint(tmp_path, src)) == {"GL102"}


def test_baseline_round_trip_keeps_reasons(tmp_path):
    vs = _lint(tmp_path, FIXTURES["GL301"][0])
    path = str(tmp_path / "baseline.json")
    bl.save(vs, path)
    data = json.loads(open(path).read())
    fp = vs[0].fingerprint()
    data["_reasons"] = {fp: "single-threaded by contract", "GL999:gone:0": "stale"}
    with open(path, "w") as f:
        json.dump(data, f)
    fresh, absorbed = bl.filter_new(vs, path)
    assert fresh == [] and absorbed == len(vs)
    bl.save(vs, path)
    assert bl.reasons(path) == {fp: "single-threaded by contract"}
    # a second instance of the same finding is new
    fresh, absorbed = bl.filter_new(vs + vs, path)
    assert len(fresh) == len(vs) and absorbed == len(vs)


def test_fingerprint_ignores_line_numbers(tmp_path):
    a = _lint(tmp_path, FIXTURES["GL301"][0])
    b = _lint(tmp_path, "\n\n\n" + textwrap.dedent(FIXTURES["GL301"][0]))
    assert [v.fingerprint() for v in a] == [v.fingerprint() for v in b]
    assert [v.line for v in a] != [v.line for v in b]


def test_repo_clean_against_baseline_with_reasons():
    vs = lint_paths(list(DEFAULT_TARGETS), REPO)
    fresh, absorbed = bl.filter_new(vs)
    assert fresh == [], "\n".join(v.format() for v in fresh)
    committed = bl.load()
    reasons = bl.reasons()
    assert set(reasons) == set(committed), "every triaged finding carries one reason"
    assert all(len(r) > 20 and "\n" not in r for r in reasons.values())
    assert absorbed == sum(committed.values()), "the baseline holds no stale entry"


def test_cli_subprocess_green_on_repo():
    proc = subprocess.run([sys.executable, "-m", "raft_tpu_torch.lint", "--json"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["static"]["new"] == 0
    assert summary["gl3xx"]["ok"] and summary["gl4xx"]["ok"]


def test_cli_fails_loud_on_mistyped_target(capsys):
    assert cli_main(["raft_tpu_torch/no_such_module.py", "--root", REPO]) == 2
    assert "does not exist" in capsys.readouterr().out


# ------------------------------------------------------------ the knobs

def test_every_env_read_is_registered_and_every_knob_read():
    reads = collect_env_reads(list(DEFAULT_TARGETS), REPO)
    assert set(reads) <= knobs.names(), sorted(set(reads) - knobs.names())
    assert knobs.names() <= set(reads), sorted(knobs.names() - set(reads))
    assert len(knobs.KNOBS) == len(knobs.names()) == 30


def test_key_knobs_have_live_salt_sites():
    keyed = [k for k in knobs.KNOBS if k.classification == knobs.KEY]
    assert {k.name for k in keyed} == {"RAFT_TPU_BEM", "RAFT_TPU_BEM_ASSEMBLY",
                                       "RAFT_TPU_BEM_PRECISION", "RAFT_TPU_BUCKETS"}
    for k in keyed:
        mod, fn = k.salted_via.rsplit(".", 1)
        src = inspect.getsource(getattr(importlib.import_module(mod), fn))
        assert k.salt_token in src, (k.name, k.salted_via)
    for k in knobs.KNOBS:
        assert k.classification in (knobs.KEY, knobs.HOST, knobs.FAULT)
        assert (k.salted_via is None) == (k.classification != knobs.KEY)


def test_readme_knob_table_in_step_with_registry():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        block = knobs.rendered_block(f.read())
    assert block == knobs.md_table()
    for k in knobs.KNOBS:
        assert f"`{k.name}`" in block


def test_rewrite_docs_round_trip(tmp_path):
    p = tmp_path / "README.md"
    p.write_text(f"head\n{knobs.BEGIN_MARK}\nold\n{knobs.END_MARK}\ntail\n")
    assert knobs.rewrite_docs(str(p)) is True
    assert knobs.rewrite_docs(str(p)) is False
    text = p.read_text()
    assert text.startswith("head\n") and text.endswith("tail\n")
    assert knobs.rendered_block(text) == knobs.md_table()


def test_registry_seed_names_resolve():
    from raft_tpu_torch.lint import registry

    for dotted in registry.CONCURRENT_FUNCTIONS + registry.MULTIHOST_FUNCTIONS:
        mod, fn = dotted.rsplit(".", 1)
        assert callable(getattr(importlib.import_module(mod), fn)), dotted
    for e in registry.ENTRY_POINTS:
        if e.multihost:
            assert e.sharded, e.name


def test_catalog_documents_every_rule():
    from raft_tpu_torch.lint import rules

    doc = rules.__doc__
    for r in list(RULES) + list(NOT_PORTED):
        assert r in doc, r
    assert "GL104 static-arg-hazard" in doc and "GL403 unsharded-large-operand" in doc


# ----------------------------------------------- parity with the JAX rules

SHARED = ("GL107", "GL202", "GL203", "GL301", "GL302")


def test_shared_rules_match_the_jax_package(tmp_path):
    """The rules that do not depend on the framework give the same
    (rule, file, line) set from both engines on the same snippet files."""
    from raft_tpu.lint.rules import lint_paths as jax_lint_paths

    for rule in SHARED:
        trigger, near = FIXTURES[rule]
        _write(tmp_path, trigger, name=f"{rule.lower()}_trigger.py")
        _write(tmp_path, near, name=f"{rule.lower()}_near.py")
    _write(tmp_path, """
        import os
        import subprocess
        from collections import Counter

        _hist = Counter()
        _seen: set = set()

        def scan(root, cmd):
            for name in os.listdir(root):
                _hist[name] += 1
            _seen.add(root)
            p = subprocess.Popen(cmd)
            return "".join({"x", "y"}), p, list(set(cmd))
        """, name="mixed.py")

    def key(vs):
        return sorted((v.rule, v.path, v.line) for v in vs if v.rule in SHARED)

    port = key(lint_paths([str(tmp_path)], str(tmp_path)))
    jax_side = key(jax_lint_paths([str(tmp_path)], str(tmp_path)))
    assert port == jax_side
    assert {r for r, _p, _l in port} == set(SHARED)
