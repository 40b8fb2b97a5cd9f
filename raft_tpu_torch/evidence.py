"""One command that mirrors the round's checks locally (port of
``raft_tpu.evidence``).

``python -m raft_tpu_torch.evidence [--device cpu] [--out PATH]`` runs,
in order, each step in a fresh subprocess under its own timeout:

1. the fast test tier (``pytest tests/ -m "not slow"``, with xdist's six
   workers where xdist is installed, as the round's test command runs);
   skipped under ``RAFT_EVIDENCE_SKIP_TESTS=1``;
2. the lint (``python -m raft_tpu_torch.lint --audit --json``: the static
   pass against the baseline and the runtime audit against
   ``lint/budgets.json``);
3. the serve smoke (``python -m raft_tpu_torch.serve smoke``);
4. the fleet smoke (``python -m raft_tpu_torch.serve fleet-smoke``);
5. the SPMD smoke (``python -m raft_tpu_torch.parallel.spmd_smoke``), in
   place of the JAX runner's ``__graft_entry__.dryrun_multichip(8)``: a
   world of ranks on the CPU (two) or on the cards (two, or one on a
   machine with one card);
6. the three smokes of the slice: ``python -m raft_tpu_torch.build.smoke``
   (the hetero smoke), ``python -m raft_tpu_torch.hydro.bem_smoke`` and
   ``python -m raft_tpu_torch.obs``.

For each step it records ``ok``, ``rc`` (124 for a step cut by its
timeout, which kills the step's whole process group), ``elapsed_s``, the
tail of its output and the tail of its standard output, and lifts the
step's last JSON line of standard output into ``json``.  The lint's
``audit`` block (the counterpart of the JAX runner's ``budgets``) and each
``glNxx`` block of its ``--json`` line are lifted one key deeper, beside
``json``.  ``all_green`` is true when every step that ran is ok.

It differs from the JAX runner in three ways.  ``--device cpu`` is passed
to every step that takes it (without it the steps run on the card, and the
runner exits 2 without CUDA).  It has no ``bench.py`` step, which measures
the JAX package: its JSON says ``"bench": {"absent": ...}`` until the
port's benchmark exists, and that entry does not count against
``all_green``.  And it writes ``raft_tpu_torch/_build/evidence.json``
(git-ignored) in place of the JAX package's seed file ``EVIDENCE.json``,
and prints the path.

:func:`run_step` is a plain function: the smokes run their children
through it, and ``chip_smoke.py`` runs the three smokes with it.

Knobs (env), the JAX runner's: ``RAFT_EVIDENCE_SKIP_TESTS=1``,
``RAFT_EVIDENCE_LINT_TIMEOUT`` (s, default 600),
``RAFT_EVIDENCE_SERVE_TIMEOUT`` (600), ``RAFT_EVIDENCE_FLEET_TIMEOUT``
(600), ``RAFT_EVIDENCE_DRYRUN_TIMEOUT`` (300, the SPMD smoke's).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
#: where the runner writes its JSON (``raft_tpu_torch/_build/`` is git-ignored)
DEFAULT_OUT = REPO / "raft_tpu_torch" / "_build" / "evidence.json"
#: seconds of each step without a knob of its own
TESTS_TIMEOUT = 1800.0
SMOKE_TIMEOUT = 900.0
BENCH_ABSENT = {"absent": "waits for the port's benchmark PR"}


def _text(x) -> str:
    if x is None:
        return ""
    return x.decode(errors="replace") if isinstance(x, bytes) else x


def run_step(cmd, timeout: float, label: str, env: dict | None = None) -> dict:
    """Run ``cmd`` in a fresh process (its own session, from the repository's
    root, with ``env`` or this process's environment) under ``timeout``
    seconds; past it the whole process group is killed and ``rc`` is 124.
    Returns ``{"ok", "rc", "elapsed_s", "tail", "stdout_tail"}``, the last
    12 lines of stdout and stderr together and the last 3 of stdout."""
    t0 = time.perf_counter()
    # bounded below by communicate(timeout=), and a timeout kills the whole
    # group (a smoke's own children too), which checked_subprocess cannot
    proc = subprocess.Popen(list(cmd), cwd=str(REPO), env=env,  # graftlint: disable=GL203
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        rc = 124
    dt = time.perf_counter() - t0
    stdout = _text(out)
    print(f"[evidence] {label}: rc={rc} in {dt:.1f}s", file=sys.stderr, flush=True)
    return {"ok": rc == 0, "rc": rc, "elapsed_s": round(dt, 3),
            "tail": (stdout + _text(err)).strip().splitlines()[-12:],
            # stderr must never bury the one-line JSON result
            "stdout_tail": stdout.strip().splitlines()[-3:]}


def last_json(lines) -> dict | None:
    """The last line of ``lines`` that parses as a JSON object, or None."""
    for line in reversed(lines or []):
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            return obj
    return None


def run_child(module: str, argv, timeout: float, label: str,
              env_extra: dict | None = None) -> dict:
    """A smoke's child: ``python -m module *argv`` through :func:`run_step`
    with ``env_extra`` over this environment (a None value removes the
    variable) and the repository on ``PYTHONPATH``.  Returns the child's
    JSON line with its ``wall_s``; raises ``RuntimeError`` with the child's
    output tail when it fails or prints no JSON."""
    env = {**os.environ, "PYTHONPATH": str(REPO) + (
        os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else "")}
    for k, v in (env_extra or {}).items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    r = run_step([sys.executable, "-m", module, *argv], timeout, label, env=env)
    res = last_json(r["stdout_tail"])
    if not r["ok"] or res is None:
        raise RuntimeError(f"{label} child failed (rc={r['rc']}):\n" + "\n".join(r["tail"]))
    return {**res, "wall_s": r["elapsed_s"]}


def _lift(step: dict) -> dict:
    """Put the step's last JSON line of stdout under ``json``."""
    js = last_json(step.get("stdout_tail"))
    if js is not None:
        step["json"] = js
    return step


def steps(device: str | None, n_cards: int = 0) -> list:
    """The runner's steps in order: ``(label, argv, timeout)``."""
    py = sys.executable
    dev = ["--device", device] if device else []
    out = []
    if not os.environ.get("RAFT_EVIDENCE_SKIP_TESTS"):
        xdist = (["-p", "xdist", "-n", "6", "--dist", "loadfile"]
                 if importlib.util.find_spec("xdist") else [])
        out.append(("tests_fast", [py, "-m", "pytest", "tests/", "-q", "-m", "not slow",
                                   "-p", "no:cacheprovider", *xdist], TESTS_TIMEOUT))
    out += [
        ("lint", [py, "-m", "raft_tpu_torch.lint", "--audit", "--json", *dev],
         float(os.environ.get("RAFT_EVIDENCE_LINT_TIMEOUT") or 600.0)),
        ("serve_smoke", [py, "-m", "raft_tpu_torch.serve", "smoke", *dev],
         float(os.environ.get("RAFT_EVIDENCE_SERVE_TIMEOUT") or 600.0)),
        ("fleet_smoke", [py, "-m", "raft_tpu_torch.serve", "fleet-smoke", *dev],
         float(os.environ.get("RAFT_EVIDENCE_FLEET_TIMEOUT") or 600.0)),
        ("spmd_smoke", [py, "-m", "raft_tpu_torch.parallel.spmd_smoke", *dev]
         + ([] if device == "cpu" or n_cards >= 2 else ["--world", "1"]),
         float(os.environ.get("RAFT_EVIDENCE_DRYRUN_TIMEOUT") or 300.0)),
        ("hetero_smoke", [py, "-m", "raft_tpu_torch.build.smoke", *dev], SMOKE_TIMEOUT),
        ("bem_smoke", [py, "-m", "raft_tpu_torch.hydro.bem_smoke", *dev], SMOKE_TIMEOUT),
        ("obs_smoke", [py, "-m", "raft_tpu_torch.obs", *dev], SMOKE_TIMEOUT),
    ]
    return out


def collect(device: str | None, n_cards: int = 0) -> dict:
    """Run every step (:func:`steps`) and return the evidence dict."""
    evidence: dict = {"host": os.uname().nodename, "python": sys.version.split()[0],
                      "device": device or "cuda"}
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}     # the tests' JAX side runs on the CPU
    for label, argv, timeout in steps(device, n_cards):
        print(f"[evidence] {label} ...", file=sys.stderr, flush=True)
        step = _lift(run_step(argv, timeout, label, env=env if label == "tests_fast" else None))
        if label == "lint":
            js = step.get("json") or {}
            if js.get("audit") is not None:
                step["audit"] = js["audit"]
            for k, v in js.items():
                if len(k) == 5 and k.startswith("gl") and k.endswith("xx"):
                    step[k] = v
        evidence[label] = step
    evidence["bench"] = dict(BENCH_ABSENT)
    evidence["all_green"] = all(v["ok"] for v in evidence.values()
                                if isinstance(v, dict) and "ok" in v)
    return evidence


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.evidence")
    ap.add_argument("--device", default=None, choices=("cpu",),
                    help="pass --device cpu to every step (default: the card)")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="the JSON file to write")
    args = ap.parse_args(argv)

    n_cards = 0
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("raft_tpu_torch.evidence: CUDA is not available: pass --device cpu",
                  file=sys.stderr)
            return 2
        n_cards = torch.cuda.device_count()
    evidence = collect(args.device, n_cards)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(evidence, f, indent=1)
    os.replace(tmp, args.out)
    print(f"[evidence] all_green={evidence['all_green']} -> {args.out}", flush=True)
    return 0 if evidence["all_green"] else 1


if __name__ == "__main__":
    sys.exit(main())
