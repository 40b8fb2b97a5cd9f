"""The run's isolation from the JAX package: no module whose top-level name
(the part before the first dot, compared whole) is one of ``FORBIDDEN`` may
be loaded in the process that prints the result."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


def top_level(modules) -> set:
    return {m.partition(".")[0] for m in modules}


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = top_level(sys.modules if modules is None else modules)
    return sorted(names & set(forbidden))
