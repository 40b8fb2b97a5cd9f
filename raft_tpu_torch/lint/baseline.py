"""The committed baseline of triaged findings (the port's copy of
``raft_tpu.lint.baseline``).

The baseline is a JSON map ``fingerprint -> count`` of the violations
triaged when the lint landed or later.  A run fails only on violations the
baseline does not cover, so every regression stops the gate.

Fingerprints (:meth:`raft_tpu_torch.lint.rules.Violation.fingerprint`) are
free of line numbers: rule + file + enclosing function + stripped source
text.  ``python -m raft_tpu_torch.lint --write-baseline`` regenerates the
file; review the diff like any other code change.

Every triaged fingerprint carries a one-line reason in ``_reasons``: why
the finding is safe as it stands.  A ``--write-baseline`` refresh keeps the
reasons of fingerprints that survive and drops the rest; a finding without
a reason fails the test that pins them.
"""
from __future__ import annotations

import json
import os
from collections import Counter

from raft_tpu_torch.lint.rules import Violation

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def _read(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load(path: str | None = None) -> Counter:
    data = _read(path or DEFAULT_BASELINE)
    return Counter({str(k): int(v) for k, v in data.get("violations", {}).items()})


def reasons(path: str | None = None) -> dict:
    """``{fingerprint: reason}`` of the committed triage."""
    return {str(k): str(v) for k, v in
            _read(path or DEFAULT_BASELINE).get("_reasons", {}).items()}


def save(violations: list[Violation], path: str | None = None) -> str:
    path = path or DEFAULT_BASELINE
    counts = Counter(v.fingerprint() for v in violations)
    try:
        kept = {k: v for k, v in reasons(path).items() if k in counts}
    except (OSError, json.JSONDecodeError, ValueError):
        kept = {}
    payload = {
        "_comment": "graftlint baseline of the port: fingerprint -> count of triaged "
                    "violations; regenerate with `python -m raft_tpu_torch.lint "
                    "--write-baseline`. _reasons carries the one-line reason of each.",
        "_reasons": {k: kept[k] for k in sorted(kept)},
        "violations": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path


def filter_new(violations: list[Violation],
               path: str | None = None) -> tuple[list[Violation], int]:
    """(violations the baseline does not cover, number it absorbed)."""
    budget = load(path)
    fresh: list[Violation] = []
    absorbed = 0
    for v in violations:
        fp = v.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            absorbed += 1
        else:
            fresh.append(v)
    return fresh, absorbed
