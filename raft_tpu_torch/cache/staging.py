"""Content-addressed on-disk cache for host-side array staging (port of
``raft_tpu.cache.staging``; numpy only).

Some host staging costs a process seconds and is a pure function of its
file and array inputs: the WAMIT parse and interpolation of
:func:`raft_tpu_torch.hydro.bem_io.load_wamit_coeffs`.  (The JAX package
also stages the per-case heading rows of ``sweep_sea_states``; in the
port a hit there costs more than the interpolation it skips, so they are
computed each time.)
:func:`cached_arrays` memoizes such a function as an npz artifact keyed by
a hash of everything it reads: file CONTENTS (not paths or mtimes, so a
rewritten file invalidates and an identical copy hits), array bytes, and
scalar and string parameters, salted with a format tag, the port's version
and :func:`raft_tpu_torch.cache.config.code_fingerprint`.

Any failure to read an artifact is a miss that falls through to the real
computation (and the fresh store replaces the bad file).  Writes are
atomic (a temporary file and ``os.replace``), so a killed process never
leaves a truncated artifact that a later run would trust.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

import numpy as np

from raft_tpu_torch.cache import config, stats

_FORMAT_SALT = "staging-v1"       # bump to invalidate every artifact


def _update(h, part) -> None:
    """Fold one key part into the hash: arrays by dtype, shape and bytes,
    files by content hash, scalars and strings canonically."""
    if isinstance(part, FileKey):
        h.update(b"file:")
        h.update(part.digest.encode())
    elif isinstance(part, np.ndarray) or hasattr(part, "__array__"):
        a = np.asarray(part)
        h.update(f"arr:{a.dtype.str}:{a.shape}:".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    elif isinstance(part, (list, tuple)):
        h.update(f"seq{len(part)}:".encode())
        for p in part:
            _update(h, p)
    elif isinstance(part, float):
        h.update(np.float64(part).tobytes())
    elif isinstance(part, (int, bool, np.integer)):
        h.update(f"int:{int(part)}:".encode())
    elif part is None:
        h.update(b"none:")
    else:
        h.update(f"str:{part}:".encode())


class FileKey:
    """Content identity of an input file: the sha256 of its bytes.
    Touching a file without changing it still hits; any edit, even one
    that keeps the size, invalidates."""

    def __init__(self, path: str):
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        self.path = path
        self.digest = h.hexdigest()


def staging_key(category: str, *parts) -> str:
    """Hex digest addressing one staged artifact; the port's version and
    source fingerprint are part of it."""
    import raft_tpu_torch

    h = hashlib.sha256()
    h.update(f"{_FORMAT_SALT}:{raft_tpu_torch.__version__}:"
             f"{config.code_fingerprint()}:{category}:".encode())
    for p in parts:
        _update(h, p)
    return h.hexdigest()[:32]


def _load(path: str):
    """``(arrays, cold_s)`` of an artifact; raises on anything unreadable."""
    with np.load(path, allow_pickle=False) as z:
        n = int(z["__n__"])
        return tuple(z[f"arr{i}"] for i in range(n)), float(z["__cold_s__"])


def _store(path: str, out: tuple, cold_s: float, meta: dict | None) -> None:
    payload = {f"arr{i}": np.asarray(a) for i, a in enumerate(out)}
    payload["__n__"] = np.int64(len(out))
    payload["__cold_s__"] = np.float64(cold_s)
    if meta:
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def cached_arrays(category: str, parts, compute, meta: dict | None = None):
    """Memoize ``compute() -> tuple of arrays`` on disk, content-addressed.

    ``parts``: everything the computation reads (arrays, scalars, strings,
    :class:`FileKey` markers for files).  Returns the tuple (complex dtypes
    round-trip).  With the cache off this is exactly ``compute()``.  A hit
    records the seconds it saved: the cold run stores its own compute time
    in the artifact, so ``saved = stored cold_s - load_s``."""
    if not config.is_enabled():
        return tuple(compute())
    from raft_tpu_torch.utils import profiling as prof

    try:
        path = os.path.join(config.subdir("staging"),
                            f"{category}-{staging_key(category, *parts)}.npz")
    except config.CacheDisabledError:
        return tuple(compute())
    if os.path.exists(path):
        t0 = time.perf_counter()
        try:
            with prof.phase("cache/staging_load", sync=False):
                out, cold_s = _load(path)
            stats.record("staging", "disk_hit", saved_s=cold_s - (time.perf_counter() - t0),
                         category=category)
            return out
        except Exception:
            # truncated, corrupt or foreign: recompute, and the store below
            # replaces it atomically
            stats.record("staging", "error", category=category)
    t0 = time.perf_counter()
    out = tuple(compute())
    cold_s = time.perf_counter() - t0
    stats.record("staging", "miss", category=category)
    try:
        with prof.phase("cache/staging_save", sync=False):
            _store(path, out, cold_s, meta)
    except OSError:
        stats.record("staging", "error", category=category)  # a failed store never fails the run
    return out
