"""graftlint for the port: the static pass over PyTorch hot paths, the knob
registry, the runtime audit with budgets, and the race scenarios.

* the **static pass** (:mod:`raft_tpu_torch.lint.rules`): the JAX
  package's rule IDs on the port's contracts, hot-path reachability in
  place of jit reachability;
* the **knob registry** (:mod:`raft_tpu_torch.lint.knobs`): every
  ``RAFT_TPU_*`` read, classified ``key``, ``host`` or ``fault``, and the
  README's knob table;
* the **runtime audit** (:mod:`raft_tpu_torch.lint.audit`): the registered
  entry points (:mod:`raft_tpu_torch.lint.registry`) run at float32 under
  a ``TorchDispatchMode``, held to ``lint/budgets.json``;
* the **race scenarios** (:mod:`raft_tpu_torch.lint.race`).

CLI: ``python -m raft_tpu_torch.lint [--audit] [--device cpu|cuda]
[--write-baseline] [--write-budgets] [--json] [paths...]`` exits 0 when
clean and 1 on a new violation or a budget breach.  ``RULES``,
``NOT_PORTED``, ``Violation`` and ``lint_paths`` load with
:mod:`raft_tpu_torch.lint.rules` on first use.
"""
_RULES_NAMES = ("NOT_PORTED", "RULES", "Violation", "lint_paths")


def __getattr__(name):
    if name in _RULES_NAMES:
        from raft_tpu_torch.lint import rules

        return getattr(rules, name)
    raise AttributeError(f"module 'raft_tpu_torch.lint' has no attribute {name!r}")
