"""Warm-start subsystem of the port (port of ``raft_tpu.cache``): one cache
root and switch, the content-addressed staging cache, the kernel-library
registry and the warm-start counters.

* :func:`enable` — the one switch (``RAFT_TPU_TORCH_CACHE_DIR``; ``off``
  keeps a run bit-identical to an uncached one).  It fixes the root of
  the staging cache and arms the per-kernel performance ledger
  (:mod:`raft_tpu_torch.obs.ledger`).  Called by the CLI and the serving
  daemon at start-up; library users opt in.
* :mod:`raft_tpu_torch.cache.staging` — content-addressed npz cache of
  host staging (the WAMIT parse and interpolation).
* :mod:`raft_tpu_torch.cache.aot` — the kernel-library registry: each
  nvcc and g++ library built once per key (source, flags, target,
  compiler, torch and CUDA versions, card), opened once per process,
  single-flight, its builds counted.
* :mod:`raft_tpu_torch.cache.stats` — hits, misses and saved seconds per
  layer; :func:`report` is the ``warm_start`` block.

``python -m raft_tpu_torch.cache smoke [--device cpu]`` proves that a
second process starts warm.
"""
from raft_tpu_torch.cache.aot import (  # noqa: F401
    compile_count,
    compile_counts,
    compile_events,
    evict_memory,
    reset_compile_events,
)
from raft_tpu_torch.cache.config import (  # noqa: F401
    cache_dir,
    cache_root,
    code_fingerprint,
    default_dir,
    disable,
    enable,
    is_enabled,
    resolve_dir,
)
from raft_tpu_torch.cache.staging import FileKey, cached_arrays, staging_key  # noqa: F401
from raft_tpu_torch.cache.stats import report  # noqa: F401
