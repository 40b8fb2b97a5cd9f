"""``python -m raft_tpu_torch.lint``: the port's graftlint command line.

Modes (composable):

* default: the static pass over the port (``raft_tpu_torch/`` and
  ``chip_smoke.py``) against the committed baseline; exit 1 on a new
  violation;
* ``--audit``: also run the runtime audit over the registered entries on
  ``--device`` (the card by default: it raises without CUDA unless
  ``--device cpu`` is given) against the committed budgets of that
  platform; exit 1 on a breach;
* ``--write-baseline``: regenerate the baseline from the tree, exit 0;
* ``--write-budgets``: run the audit on ``--device`` and refresh that
  platform's section of ``lint/budgets.json``, exit 0;
* ``--json``: one machine-readable JSON line after the human output.

A target that does not exist fails loudly (exit 2).  Tests and their
fixtures are not linted: fixtures must contain violations.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_TARGETS = ("raft_tpu_torch", "chip_smoke.py")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _family_summary(prefix: str, rules, fresh, violations) -> dict:
    fam = {}
    for r in sorted(x for x in rules if x.startswith(prefix)):
        n_new = sum(1 for v in fresh if v.rule == r)
        n_total = sum(1 for v in violations if v.rule == r)
        fam[r] = {"new": n_new, "triaged": n_total - n_new}
    return {"rules": fam, "ok": all(c["new"] == 0 for c in fam.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.lint",
        description="graftlint for the port: static pass, runtime audit")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: raft_tpu_torch and chip_smoke.py)")
    ap.add_argument("--root", default=None, help="repo root for relative paths")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from the current tree")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every violation, ignoring the baseline")
    ap.add_argument("--audit", action="store_true",
                    help="also run the runtime audit of the registered entries")
    ap.add_argument("--audit-only", action="store_true", help="run only the runtime audit")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="the audit's device (default: the card)")
    ap.add_argument("--write-budgets", action="store_true",
                    help="run the audit and refresh the budgets of its platform")
    ap.add_argument("--json", action="store_true", help="emit a final JSON line")
    args = ap.parse_args(argv)

    root = args.root or repo_root()
    rc = 0
    summary: dict = {"tool": "graftlint", "package": "raft_tpu_torch"}

    if args.write_budgets:
        from raft_tpu_torch.lint.audit import write_budgets

        path, reports = write_budgets(device=args.device)
        for r in reports:
            print(r.summary())
        print(f"[graftlint] budgets written: {path} ({len(reports)} entries)")
        if args.json:
            print(json.dumps({**summary, "ok": True, "budgets_written": len(reports)}))
        return 0

    if not args.audit_only:
        from raft_tpu_torch.lint import baseline as bl
        from raft_tpu_torch.lint.rules import RULES, lint_paths

        targets = list(args.paths) if args.paths else list(DEFAULT_TARGETS)
        try:
            violations = lint_paths(targets, root)
        except (FileNotFoundError, ValueError) as e:
            print(f"[graftlint] error: {e}")
            return 2
        if args.write_baseline:
            path = bl.save(violations)
            print(f"[graftlint] baseline written: {path} "
                  f"({len(violations)} violations triaged)")
            summary["static"] = {"violations": len(violations), "baseline_written": True}
        else:
            fresh, absorbed = ((violations, 0) if args.no_baseline
                               else bl.filter_new(violations))
            for v in fresh:
                print(v.format())
            print(f"[graftlint] static: {len(fresh)} new violation(s), {absorbed} "
                  f"baselined, {len(violations)} total")
            summary["static"] = {"new": len(fresh), "baselined": absorbed,
                                 "total": len(violations)}
            for fam in ("GL3", "GL4"):
                block = _family_summary(fam, RULES, fresh, violations)
                summary[f"{fam.lower()}xx"] = block
                print(f"[graftlint] {fam.lower()}xx: " + "  ".join(
                    f"{r}={c['new']} new/{c['triaged']} triaged"
                    for r, c in block["rules"].items()))
            if fresh:
                rc = 1

    if (args.audit or args.audit_only) and not args.write_baseline:
        from raft_tpu_torch.lint.audit import run_audit

        reports = run_audit(device=args.device)
        for r in reports:
            print(r.summary())
        bad = [r for r in reports if not r.ok]
        summary["audit"] = {"entries": [r.to_dict() for r in reports], "failed": len(bad)}
        if bad:
            rc = 1

    summary["ok"] = rc == 0
    if args.json:
        print(json.dumps(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main())
