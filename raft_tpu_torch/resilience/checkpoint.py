"""Durable per-chunk result store: a killed sweep resumes, not restarts
(port of ``raft_tpu.resilience.checkpoint``).

A chunked sweep over thousands of cases that is preempted at chunk 37 of
40 would otherwise throw away 36 chunks of finished results.  This store
makes partial progress durable: each fetched chunk result is written as
an atomic npz (tmp + ``os.replace``; a kill mid-write can never leave a
truncated artifact that a later run would trust), indexed by a
``manifest.json`` (also atomically replaced) that records a content hash
per chunk.

Keying: the JAX package names a store by the AOT key of the compiled
program.  The port compiles no program per call, so :func:`store_for`
names it by its own digest of everything that decides the results: the
tag, the chunk arguments' shapes and dtypes, a content hash of the
constants (the design, the staged coefficients), the caller's ``extra``
(knobs, a content hash of the input table), the chunk count, a
fingerprint of the port's own sources (kernels included;
:func:`raft_tpu_torch.cache.config.code_fingerprint`), the device
type, and what else decides the bits of the same program on the same
inputs (:func:`runtime_salt`): the torch and CUDA versions, the card's
name, the float32 matmul precision and the TF32 switch.  A store written
on the CPU is never served on the card: the two give different bits.  Any
change to the code, the inputs, the knobs, the framework or the device
lands in a different directory, so a resume is only ever
served results the current program would have computed (bit for bit:
npz round-trips array bytes exactly).

Corruption tolerance is absolute: a missing, unreadable, truncated or
hash-mismatched chunk artifact counts as a miss — logged, counted,
deleted, recomputed — never served.

Armed by ``RAFT_TPU_CKPT``: unset/``off`` disables (the default — the
fast path writes nothing); ``1``/``on`` roots the store under the port's
cache root's ``ckpt/`` (``RAFT_TPU_TORCH_CACHE_DIR``, else
``raft_tpu_torch/_build/cache``); any other value is the root directory
itself.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading

import numpy as np
import torch

from raft_tpu_torch.cache import config

_OFF = ("off", "0", "none", "disabled", "false", "no")


def root() -> str | None:
    """The checkpoint root this process would use, or None when disabled."""
    v = os.environ.get("RAFT_TPU_CKPT", "").strip()
    if not v or v.lower() in _OFF:
        return None
    if v.lower() in ("1", "on", "true", "yes"):
        return os.path.join(str(config.cache_root()), "ckpt")
    return os.path.abspath(os.path.expanduser(v))


def enabled() -> bool:
    return root() is not None


def _host(a) -> np.ndarray:
    """A leaf as a contiguous host array (tensors are copied off the card)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def _leaf_hash(leaves) -> str:
    h = hashlib.sha256()
    for a in leaves:
        a = _host(a)
        h.update(f"{a.dtype.str}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def content_hash(leaves) -> str:
    """Value hash of a list of arrays or tensors, for folding input VALUES
    into a store key (the argument signature alone hashes shapes and
    dtypes, which two tables of the same size share)."""
    return _leaf_hash(leaves)[:16]


def _tree(obj, out: list, values: bool) -> None:
    """Flatten ``obj`` into ``out``: tensors and arrays (as their values,
    or as dtype and shape), dataclass fields by name, sequences and dicts
    in order, anything else by ``repr``."""
    if hasattr(obj, "detach") or isinstance(obj, np.ndarray):
        if values:
            out.append(obj)
        else:
            out.append(f"{obj.dtype}{tuple(obj.shape)}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out.append(type(obj).__name__)
        for f in dataclasses.fields(obj):
            out.append(f.name)
            _tree(getattr(obj, f.name), out, values)
    elif isinstance(obj, (tuple, list)):
        out.append(len(obj))
        for x in obj:
            _tree(x, out, values)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            out.append(k)
            _tree(obj[k], out, values)
    elif not values:
        out.append(repr(obj))
    elif isinstance(obj, (int, float, bool, np.generic)):
        out.append(np.asarray(obj))
    else:
        out.append(np.frombuffer(repr(obj).encode(), dtype=np.uint8))


def runtime_salt(device) -> str:
    """What decides a program's bits besides its sources and inputs: the
    torch and CUDA versions, the device type and, on the card, its name,
    and the float32 matmul precision with the TF32 switch.  A machine
    without CUDA names no card."""
    dev_type = device.type if hasattr(device, "type") else str(device).split(":")[0]
    kind = ""
    if dev_type == "cuda":
        kind = (torch.cuda.get_device_name(torch.device(device)) if torch.cuda.is_available()
                else "no card")
    return json.dumps([torch.__version__, torch.version.cuda, dev_type, kind,
                       torch.get_float32_matmul_precision(),
                       bool(torch.backends.cuda.matmul.allow_tf32)])


def topology(mesh) -> list:
    """The layout a sharded program ran on, as the JAX package's AOT key
    folds it in (``raft_tpu/cache/aot.py::_topology``): the backend, the
    mesh's device type, dimension names and shape, and the world's size."""
    import torch.distributed as dist

    return [dist.get_backend(), mesh.device_type, list(mesh.mesh_dim_names or ()),
            [int(n) for n in mesh.shape], dist.get_world_size()]


def store_key(tag: str, args, *, consts=(), extra=(), n_chunks: int, device,
              mesh=None) -> str:
    """The digest :func:`store_for` names a store by (see the module
    docstring); with ``mesh`` its :func:`topology` too, so a resume on
    another layout never reuses a chunk."""
    sig: list = []
    _tree(args, sig, values=False)
    const_vals: list = []
    _tree(consts, const_vals, values=True)
    ex: list = []
    _tree(tuple(extra), ex, values=False)
    h = hashlib.sha256()
    for part in (tag, json.dumps(sig), content_hash(const_vals), json.dumps(ex),
                 str(int(n_chunks)), config.code_fingerprint(), runtime_salt(device)):
        h.update(part.encode())
        h.update(b"\0")
    if mesh is not None:
        h.update(json.dumps(topology(mesh)).encode())
    return h.hexdigest()


class ChunkStore:
    """Per-chunk result store for one (program, chunk-count) identity.

    Results are flat tuples of host arrays (what the pipeline's fetch
    step produces); a non-tuple result is stored and restored as the
    bare array.  Construct via :func:`store_for` (which resolves the
    root and derives the key) rather than directly.
    """

    def __init__(self, key: str, n_chunks: int, base: str):
        self.key = key
        self.n_chunks = int(n_chunks)
        self.dir = os.path.join(base, key)
        os.makedirs(self.dir, exist_ok=True)
        self._manifest_path = os.path.join(self.dir, "manifest.json")
        # per-store lock around every manifest read-modify-write (entry
        # update + atomic replace as one critical section): two threads
        # checkpointing chunks concurrently can never drop each other's
        # entries by racing the whole-file rewrite
        self._lock = threading.Lock()
        self.saved = 0
        self.resumed = 0
        self.corrupt = 0
        m = None
        try:
            with open(self._manifest_path) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            m = None
        if (not isinstance(m, dict) or m.get("key") != key
                or m.get("n_chunks") != self.n_chunks):
            # unreadable manifest, or a stale store from a different
            # program/chunking under a colliding path: start fresh
            m = {"key": key, "n_chunks": self.n_chunks, "chunks": {}}
        self._manifest = m

    # ------------------------------------------------------------- paths

    def _chunk_path(self, k: int) -> str:
        return os.path.join(self.dir, f"chunk_{int(k)}.npz")

    def _write_manifest(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._manifest, f)
            os.replace(tmp, self._manifest_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # --------------------------------------------------------------- api

    def save(self, k: int, result) -> None:
        """Persist chunk ``k``: atomic npz first, manifest second — a
        kill between the two leaves an orphan file the manifest ignores
        (recomputed next run), never a manifest entry without data."""
        scalar = not isinstance(result, tuple)
        leaves = [result] if scalar else list(result)
        path = self._chunk_path(k)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{f"arr_{i}": np.asarray(a)
                               for i, a in enumerate(leaves)})
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        from raft_tpu_torch.resilience import faults

        faults.maybe_corrupt_file("corrupt_ckpt", k, path)
        with self._lock:
            self._manifest["chunks"][str(int(k))] = {
                "sha": _leaf_hash(leaves), "n": len(leaves),
                "scalar": scalar,
            }
            self._write_manifest()
            self.saved += 1
        from raft_tpu_torch import obs as _obs

        _obs.metrics.counter("ckpt.saved").inc()

    def _drop(self, k: int, why: str) -> None:
        import warnings

        warnings.warn(
            f"checkpoint chunk {k} of {self.key} is unusable ({why}); "
            f"it will be recomputed", stacklevel=3)
        from raft_tpu_torch import obs as _obs

        _obs.metrics.counter("ckpt.corrupt").inc()
        with self._lock:
            self.corrupt += 1
            self._manifest["chunks"].pop(str(int(k)), None)
            try:
                os.unlink(self._chunk_path(k))
            except OSError:
                pass
            self._write_manifest()

    def load(self, k: int):
        """Chunk ``k``'s stored result, or None (missing or corrupt —
        a corrupt artifact is detected by content hash, logged, deleted,
        and counted; it is NEVER returned)."""
        with self._lock:
            entry = self._manifest["chunks"].get(str(int(k)))
        if entry is None:
            return None
        try:
            with np.load(self._chunk_path(k), allow_pickle=False) as z:
                leaves = [z[f"arr_{i}"] for i in range(int(entry["n"]))]
        except Exception:
            self._drop(k, "unreadable/truncated npz")
            return None
        if _leaf_hash(leaves) != entry["sha"]:
            self._drop(k, "content hash mismatch")
            return None
        with self._lock:
            self.resumed += 1
        from raft_tpu_torch import obs as _obs

        _obs.metrics.counter("ckpt.resumed").inc()
        return leaves[0] if entry.get("scalar") else tuple(leaves)

    def complete(self) -> bool:
        return len(self._manifest["chunks"]) >= self.n_chunks

    def to_dict(self) -> dict:
        return {
            "key": self.key,
            "dir": self.dir,
            "n_chunks": self.n_chunks,
            "saved": self.saved,
            "resumed": self.resumed,
            "corrupt": self.corrupt,
        }


def store_for(tag: str, args, *, consts=(), extra=(), n_chunks: int,
              device, mesh=None) -> ChunkStore | None:
    """A :class:`ChunkStore` for the chunked program identified by
    :func:`store_key`, or None when ``RAFT_TPU_CKPT`` is off (then nothing
    is hashed: the constants' content hash copies them off the card).
    ``args``: one chunk's arguments (only shapes and dtypes are read);
    ``consts``: the value-bearing constants the chunks close over;
    ``device``: where the chunks run; ``mesh``: the ``DeviceMesh`` a
    sharded program's chunks run on (its layout is in the key)."""
    base = root()
    if base is None:
        return None
    key = store_key(tag, args, consts=consts, extra=extra, n_chunks=n_chunks,
                    device=device, mesh=mesh)
    return ChunkStore(key[:24], n_chunks, base)
