# A frozen copy of raft_tpu_torch/io/schema.py for the benchmark's reference;
# it imports nothing of the program.
"""Typed, shape-checked, defaulted access to YAML design dictionaries.

The port's own copy of ``raft_tpu.io.schema`` (host numpy, no torch).
Behavioral equivalent of the reference's ``getFromDict`` accessor
(raft/raft.py:1164-1224): every field read from a design dict goes through
one function that coerces dtype, validates/broadcasts shape, and applies
defaults — so malformed design files fail loudly at load time, before any
device computation.
"""
from __future__ import annotations

import numpy as np


def get_from_dict(d: dict, key: str, shape=0, dtype=float, default=None):
    """Read ``d[key]`` with dtype coercion, shape validation and defaults.

    Parameters
    ----------
    shape : 0 for a scalar, -1 for "scalar or any-length 1D", an int n for a
        length-n 1D array (scalars broadcast), or a sequence like [n, 2] for
        a 2D array (rows of scalars broadcast along the last axis).
    default : value used when ``key`` is absent; ``None`` makes the field
        required.  Scalar defaults broadcast to the requested shape.
    """
    if key in d:
        val = d[key]
        if shape == 0:
            if np.isscalar(val):
                return dtype(val)
            raise ValueError(f"design field '{key}' must be a scalar")
        if shape == -1:
            if np.isscalar(val):
                return dtype(val)
            return np.array(val, dtype=dtype)
        # fixed shapes
        if np.isscalar(shape):
            if np.isscalar(val):
                return np.tile(dtype(val), int(shape))
            arr = np.array(val, dtype=dtype)
            if arr.shape != (int(shape),):
                raise ValueError(
                    f"design field '{key}' has length {arr.shape}, expected {int(shape)}"
                )
            return arr
        # 2D shape spec like [n, 2]
        n, m = int(shape[0]), int(shape[1])
        if np.isscalar(val):
            return np.tile(dtype(val), (n, m))
        arr = np.array(val, dtype=dtype)
        if arr.ndim == 1:
            if n == -1:
                return np.tile(arr, (1, 1)) if arr.shape[0] == m else _fail(key, arr, (n, m))
            if arr.shape[0] == m:
                return np.tile(arr, (n, 1))
            return _fail(key, arr, (n, m))
        if n != -1 and arr.shape != (n, m):
            return _fail(key, arr, (n, m))
        if n == -1 and arr.shape[1] != m:
            return _fail(key, arr, (n, m))
        return arr

    if default is None:
        raise ValueError(f"design field '{key}' is required but missing")
    if shape == 0 or shape == -1:
        return dtype(default) if np.isscalar(default) else np.array(default, dtype=dtype)
    if np.isscalar(shape):
        if np.isscalar(default):
            return np.tile(dtype(default), int(shape))
        arr = np.array(default, dtype=dtype)
        if arr.shape != (int(shape),):
            return _fail(key, arr, (int(shape),))
        return arr
    n, m = int(shape[0]), int(shape[1])
    if np.isscalar(default):
        return np.tile(dtype(default), (n, m))
    return np.array(default, dtype=dtype)


def _fail(key, arr, want):
    raise ValueError(f"design field '{key}' has shape {arr.shape}, expected {want}")
