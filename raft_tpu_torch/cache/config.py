"""Warm-start enablement: one cache root and one switch (port of
``raft_tpu.cache.config``).

A process of the port pays its start-up again every time: the CLI, a
daemon, each fleet replica, the kill test's child.  ``enable()`` is the
single switch that lets the next process start warm.  It fixes the
directory the warm-start layers write under: the content-addressed staging
cache (:mod:`raft_tpu_torch.cache.staging`) and the per-kernel performance
ledger (:mod:`raft_tpu_torch.obs.ledger`), which it arms.  The JAX
package's switch also wires XLA's persistent compilation cache; eager
PyTorch compiles no program, and the port's kernel libraries are keyed and
kept by the registry (:mod:`raft_tpu_torch.cache.aot`) in
``raft_tpu_torch/_build/`` whether or not the switch is on.

Resolution order for the cache root:

1. the ``cache_dir=`` argument;
2. the ``RAFT_TPU_TORCH_CACHE_DIR`` environment variable: the spellings
   ``off`` / ``0`` / ``none`` / ``disabled`` / ``false`` / ``no``
   (case-insensitive) turn the warm-start layers off, keeping the run
   bit-identical to an uncached one; an EMPTY value means unset;
3. the default ``raft_tpu_torch/_build/cache`` (inside the checkout, so a
   process reads and writes nothing around it).

Layout under the root::

    <root>/staging/     content-addressed npz staging artifacts
    <root>/ledger/      per-kernel performance ledger (JSON per entry)
    <root>/torch-bem*/  panel-solver results (hydro/native_bem.py)
    <root>/wavetable/   the on-device BEM's wave-integral tables
    <root>/ckpt/        chunk stores (RAFT_TPU_CKPT=1)
    <root>/obs/         observability sinks (RAFT_TPU_OBS=1)

The last four predate the switch and keep their own ``cache=`` flags and
knobs: they follow the root wherever it resolves, and ``off`` leaves them
at the default root (their artifacts are exact, so a hit is bit-identical).
:func:`cache_root` is that rule.
"""
from __future__ import annotations

import hashlib
import os
import threading
from pathlib import Path

#: the knob naming the cache root
CACHE_ENV = "RAFT_TPU_TORCH_CACHE_DIR"
_OFF_SPELLINGS = ("off", "0", "none", "disabled", "false", "no")
_PKG = Path(__file__).resolve().parents[1]

# one lock guards the enablement state AND the code-salt memo: a daemon
# thread toggling the cache while another reads it can never observe a
# half-updated state, and the fingerprint is computed once
_state_lock = threading.Lock()
_state = {"enabled": False, "dir": None}
_code_salt: list = []


class CacheDisabledError(RuntimeError):
    """The cache root vanished between an ``is_enabled()`` check and the
    path derivation (a concurrent ``disable()``): callers on the warm path
    treat it as a miss."""


def code_fingerprint() -> str:
    """Content hash of the port's own sources: every ``.py``, ``.cu`` and
    ``.cpp`` under ``raft_tpu_torch/`` except ``_build/``.  Editing any of
    them moves every staging artifact, ledger entry and chunk store, so a
    developer iterating on the code is never served pre-edit arrays.
    Conservative on purpose (a docstring edit moves it too).  Computed once
    per process; the lock makes the walk single-flight."""
    with _state_lock:
        if not _code_salt:
            h = hashlib.sha256()
            for path in sorted(_PKG.rglob("*")):
                if path.suffix in (".py", ".cu", ".cpp") and "_build" not in path.parts:
                    h.update(path.relative_to(_PKG).as_posix().encode())
                    h.update(path.read_bytes())
            _code_salt.append(h.hexdigest()[:16])
        return _code_salt[0]


def default_dir() -> str:
    return str(_PKG / "_build" / "cache")


def resolve_dir(cache_dir: str | None = None) -> str | None:
    """The cache root this process would use, or None when off.  Pure
    resolution: creates nothing."""
    if cache_dir is None:
        env = os.environ.get(CACHE_ENV)
        cache_dir = env.strip() if env is not None and env.strip() else default_dir()
    if cache_dir.strip().lower() in _OFF_SPELLINGS:
        return None
    return os.path.abspath(os.path.expanduser(cache_dir))


def enable(cache_dir: str | None = None) -> str | None:
    """Turn the warm-start layers on: fix the root for the staging cache
    and the ledger, and arm the ledger.  Idempotent.  Returns the root, or
    None when the resolution says off, in which case nothing is armed and
    every cached entry point takes its plain path."""
    root = resolve_dir(cache_dir)
    if root is None:
        disable()
        return None
    with _state_lock:
        _state.update(enabled=True, dir=root)
    return root


def disable() -> None:
    """Turn the warm-start layers off for this process: no staging
    artifact or ledger entry is read or written, and the kernel wrappers
    record no event."""
    with _state_lock:
        _state.update(enabled=False, dir=None)


def is_enabled() -> bool:
    with _state_lock:
        return bool(_state["enabled"])


def cache_dir() -> str | None:
    with _state_lock:
        return _state["dir"]


def cache_root() -> Path:
    """The root of the layers that keep their own flags (the BEM result
    caches, the wave tables, the chunk store, the obs sinks): the enabled
    root, else what the knob resolves to, else the default when the knob
    says off."""
    return Path(cache_dir() or resolve_dir() or default_dir())


def subdir(name: str) -> str:
    """``<root>/<name>``, created on demand.  The caller checked
    ``is_enabled()``; a root disabled since by another thread raises
    :class:`CacheDisabledError`, which the warm layers treat as a miss."""
    with _state_lock:
        root = _state["dir"]
    if root is None:
        raise CacheDisabledError(f"cache disabled concurrently; no root for subdir {name!r}")
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    return d
