"""The registry of every environment knob the port reads (the port's copy
of ``raft_tpu.lint.knobs``).

Each ``RAFT_TPU_*`` read in ``raft_tpu_torch`` is a contract with the
port's keys.  A knob that changes results must be folded into the key of
whatever stores those results, or a warm process is served a result
computed under the other setting.  A knob that only steers the host
(roots, schedules, timeouts, strictness) stays out of the keys.  The
registry writes that classification down once, and three consumers hold
the code to it:

* rule **GL201** (:mod:`raft_tpu_torch.lint.rules`): every knob read in
  linted code names a registered knob, and a read in hot-path code names a
  ``key`` knob;
* the **knob table** in README.md's port section is generated from this
  file (:func:`md_table`; ``python -m raft_tpu_torch.lint.knobs`` rewrites
  it between the AUTOGEN markers), and a test pins file == registry;
* a **salt-site test** asserts each ``key`` knob's ``salt_token`` appears in
  the source of its ``salted_via`` function.

Classifications:

``key``
    The knob changes results; its resolved value is folded into a key: the
    chunk store's (``resilience/checkpoint.py::store_key``, with
    ``runtime_salt``), the BEM result cache's
    (``hydro/native_bem.py::result_cache_key`` as ``hydro/torch_bem.py``
    salts it) or a kernel library's (``cache/aot.py``).  ``salted_via``
    names the function that folds it in, ``salt_token`` the fragment of
    its source that carries it.
``host``
    Host-side only: roots, schedules, timeouts and strictness.
``fault``
    Deterministic fault injection (:mod:`raft_tpu_torch.resilience.faults`).

Unlike the JAX package, ``RAFT_TPU_DONATE`` is ``host`` here: PyTorch has
no buffer donation, and the port's ``donate_argnums`` only drops the
executor's own references (``parallel/pipeline.py``), which changes no
result.  The evidence runner's ``RAFT_EVIDENCE_*`` variables are
registered too, as ``host`` knobs; the JAX runner's
``RAFT_EVIDENCE_BENCH_TIMEOUT`` has no counterpart, since the port's
runner has no bench step yet.
"""
from __future__ import annotations

import dataclasses
import os
import re

#: env names GL201 (and the drift test) count as knob reads: the port's
#: ``RAFT_TPU_*`` and the evidence runner's ``RAFT_EVIDENCE_*``
ENV_READ_RE = re.compile(r"^RAFT_(?:TPU|EVIDENCE)_[A-Z0-9_]+$")

KEY = "key"
HOST = "host"
FAULT = "fault"


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: str            # human-readable default, for the table
    layer: str              # the module that parses it
    classification: str     # KEY / HOST / FAULT
    description: str        # one line, for the table
    salted_via: str | None = None    # dotted function folding it into a key
    salt_token: str | None = None    # source fragment proving the salt


KNOBS: tuple[Knob, ...] = (
    # --------------------------------------------------- result-changing ----
    Knob("RAFT_TPU_BEM", "auto (jax on the card)", "hydro.torch_bem", KEY,
         "Panel-solver route: the host C++ solver, the on-device solve, or auto; "
         "each route keeps its results under its own result-cache namespace",
         salted_via="raft_tpu_torch.hydro.torch_bem.solve_bem_jax",
         salt_token='"torch-bem-jax"'),
    Knob("RAFT_TPU_BEM_PRECISION", "f32", "hydro.torch_bem", KEY,
         "Assembly precision of a float32 panel solve (f32, or bf16 assembly "
         "with an f32 factor and refinement)",
         salted_via="raft_tpu_torch.hydro.torch_bem.solve_bem_jax",
         salt_token="str(dtype), prec"),
    Knob("RAFT_TPU_BEM_ASSEMBLY", "auto (kernels on the card)", "hydro.torch_bem", KEY,
         "Assembly route of the on-device panel solve: xla (the plain versions), "
         "pallas (K3/K4), or auto",
         salted_via="raft_tpu_torch.hydro.torch_bem.solve_bem_jax",
         salt_token="resolved_assembly(assembly, dev)"),
    Knob("RAFT_TPU_BUCKETS", "built-in ladder", "build.buckets", KEY,
         "Size-class ladder of the shape-bucketed design batches; the bucket "
         "signature is part of the chunk store's key",
         salted_via="raft_tpu_torch.parallel.sweep._sweep_designs_bucket",
         salt_token='"sig", label'),
    # -------------------------------------------------------- host-only ----
    Knob("RAFT_TPU_TORCH_CACHE_DIR", "raft_tpu_torch/_build/cache", "cache.config", HOST,
         "The port's cache root; 'off' turns off the staging cache and the ledger"),
    Knob("RAFT_TPU_CKPT", "off", "resilience.checkpoint", HOST,
         "Durable chunk store ('1' = the cache root's ckpt/, or a directory)"),
    Knob("RAFT_TPU_OBS", "off", "obs.export", HOST,
         "Observability export sink ('1' = the cache root's obs/, or a directory)"),
    Knob("RAFT_TPU_OBS_FLUSH_MS", "1000 ms", "obs.export", HOST,
         "Debounce of the per-sweep auto-publish, read once per process"),
    Knob("RAFT_TPU_TORCH_ROOFLINE", "built-in per-device table", "obs.ledger", HOST,
         "Peak '<flops>:<bytes/s>' override of the kernel ledger's roofline fractions"),
    Knob("RAFT_TPU_PIPELINE_DEPTH", "2", "parallel.pipeline", HOST,
         "Dispatch-ahead window of the chunked executor (min 1)"),
    Knob("RAFT_TPU_DONATE", "on", "parallel.pipeline", HOST,
         "Whether the executor drops its references to donated chunk inputs "
         "(no buffer aliasing in PyTorch; results unchanged)"),
    Knob("RAFT_TPU_STRICT", "on", "resilience.health", HOST,
         "Fail loud after reporting a degraded sweep result"),
    Knob("RAFT_TPU_BUILD_TIMEOUT", "300 s", "resilience.retry", HOST,
         "Hard timeout of each nvcc or g++ build subprocess"),
    # ---------------------------------------------------- solver daemon ----
    # read once when the daemon arms (ServeConfig.from_env); the request
    # path never reads the environment
    Knob("RAFT_TPU_SERVE_BATCH_DEADLINE_MS", "25 ms", "serve.config", HOST,
         "Micro-batch close deadline of the solver daemon"),
    Knob("RAFT_TPU_SERVE_BATCH_MAX", "8", "serve.config", HOST,
         "Padded lane capacity of every daemon batch (served rows are batch-independent)"),
    Knob("RAFT_TPU_SERVE_SOCKET", "per-uid tmp path", "serve.config", HOST,
         "Default AF_UNIX socket path of the solver daemon"),
    # ---------------------------------------------------- serving fleet ----
    # read once when the fleet arms (FleetConfig.from_env)
    Knob("RAFT_TPU_FLEET_REPLICAS", "2", "serve.fleet", HOST,
         "Replica daemons of the supervised fleet"),
    Knob("RAFT_TPU_FLEET_PROBE_MS", "500 ms", "serve.fleet", HOST,
         "Heartbeat cadence of the router's health probes"),
    Knob("RAFT_TPU_FLEET_PROBE_TIMEOUT_MS", "2000 ms", "serve.fleet", HOST,
         "Deadline of each probe, admission and refresh connection"),
    Knob("RAFT_TPU_FLEET_QUEUE_MAX", "32", "serve.fleet", HOST,
         "Per-replica in-flight cap; admission sheds past queue_max x healthy replicas"),
    Knob("RAFT_TPU_FLEET_SHED_ERROR_RATE", "0.5", "serve.fleet", HOST,
         "Windowed error rate above which admission sheds"),
    Knob("RAFT_TPU_FLEET_RESTART_MAX", "3", "serve.fleet", HOST,
         "Restarts per replica allowed in one window"),
    Knob("RAFT_TPU_FLEET_RESTART_WINDOW_S", "30 s", "serve.fleet", HOST,
         "Sliding window of the restart bound"),
    Knob("RAFT_TPU_FLEET_SOCKET", "per-uid tmp path", "serve.fleet", HOST,
         "Front-end AF_UNIX socket path of the fleet router"),
    # ---------------------------------------------------- evidence runner ----
    # the JAX runner's variables, read by raft_tpu_torch/evidence.py
    Knob("RAFT_EVIDENCE_SKIP_TESTS", "unset", "evidence", HOST,
         "Skip the evidence runner's fast test tier"),
    Knob("RAFT_EVIDENCE_LINT_TIMEOUT", "600 s", "evidence", HOST,
         "Timeout of the evidence runner's lint step"),
    Knob("RAFT_EVIDENCE_SERVE_TIMEOUT", "600 s", "evidence", HOST,
         "Timeout of the evidence runner's serve smoke"),
    Knob("RAFT_EVIDENCE_FLEET_TIMEOUT", "600 s", "evidence", HOST,
         "Timeout of the evidence runner's fleet smoke"),
    Knob("RAFT_EVIDENCE_DRYRUN_TIMEOUT", "300 s", "evidence", HOST,
         "Timeout of the evidence runner's SPMD smoke (the JAX runner's multichip dry run)"),
    # -------------------------------------------------- fault injection ----
    Knob("RAFT_TPU_FAULT_INJECT", "unset", "resilience.faults", FAULT,
         "Deterministic host-side fault specs (nan_chunk:K, kill_after_chunk:K, ...)"),
)

_BY_NAME = {k.name: k for k in KNOBS}


def get(name: str) -> Knob | None:
    return _BY_NAME.get(name)


def names() -> frozenset:
    return frozenset(_BY_NAME)


# ------------------------------------------------------------------ docs --

#: markers bounding the generated table in README.md
BEGIN_MARK = "<!-- BEGIN AUTOGEN KNOB TABLE (python -m raft_tpu_torch.lint.knobs) -->"
END_MARK = "<!-- END AUTOGEN KNOB TABLE -->"

_LABEL = {KEY: "key", HOST: "host", FAULT: "fault"}


def md_table() -> str:
    """The knob reference as a Markdown table, key knobs first."""
    lines = ["| Knob | Default | Layer | Class | Effect |",
             "|---|---|---|---|---|"]
    for k in sorted(KNOBS, key=lambda k: (k.classification != KEY, k.name)):
        salt = f" (keyed in `{k.salted_via.rsplit('.', 1)[-1]}`)" if k.salted_via else ""
        lines.append(f"| `{k.name}` | {k.default} | `{k.layer}` | "
                     f"{_LABEL[k.classification]}{salt} | {k.description} |")
    return "\n".join(lines) + "\n"


def readme_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "README.md")


def rendered_block(text: str) -> str | None:
    """The generated block of ``text`` (between the markers, exclusive),
    or None when the markers are absent."""
    try:
        _head, rest = text.split(BEGIN_MARK, 1)
        block, _tail = rest.split(END_MARK, 1)
    except ValueError:
        return None
    return block.strip("\n") + "\n"


def rewrite_docs(path: str | None = None) -> bool:
    """Regenerate the table between the markers (default README.md);
    True when the file changed."""
    path = path or readme_path()
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if BEGIN_MARK not in text or END_MARK not in text:
        raise RuntimeError(f"AUTOGEN markers missing from {path}")
    head, rest = text.split(BEGIN_MARK, 1)
    _old, tail = rest.split(END_MARK, 1)
    new = head + BEGIN_MARK + "\n\n" + md_table() + "\n" + END_MARK + tail
    if new == text:
        return False
    with open(path, "w", encoding="utf-8") as f:
        f.write(new)
    return True


if __name__ == "__main__":
    changed = rewrite_docs()
    print(f"[knobs] README knob table {'updated' if changed else 'up to date'} "
          f"({len(KNOBS)} knobs)")
