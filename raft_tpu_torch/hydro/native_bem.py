"""The host C++ panel solver, ``BEM="native"`` (port of
``raft_tpu.hydro.native_bem``).

A ctypes wrapper around the port's own copy of the solver,
``raft_tpu_torch/native/bem.cpp``: a Hess & Smith constant-source panel
method with the deep-water and finite-depth Green functions, OpenMP over
panel pairs, one complex LU per frequency.  Given a hull panel mesh and a
frequency grid it returns added mass A(w), radiation damping B(w) and wave
excitation X(w) as host numpy, the layout ``Model(BEM=(A, B, F))`` and
:func:`raft_tpu_torch.parallel.sweep.stage_bem` take.  Nothing here touches
torch.

* **Build.** ``g++ -O3 -march=native -fopenmp -shared -fPIC`` at first use
  into ``raft_tpu_torch/_build/``, the library named by a hash of the
  source, the flags and the host's CPU (what ``-march=native`` compiles
  for), published atomically by :func:`raft_tpu_torch.core.nvcc.run_jobs`,
  as the JAX package builds its solver: a hard timeout on the compiler
  (``RAFT_TPU_BUILD_TIMEOUT``, default 300 s) and one bounded retry with
  backoff (:func:`raft_tpu_torch.resilience.retry.retry_call`).  A build
  that fails twice raises with the compiler's redacted stderr tail; it is
  never skipped.
* **Wave table.** The solver's I0/I1 table (1600 x 320, built once per
  host in about 10 s on 8 cores) is cached beside the library as
  ``native_wavetable-<hash>.bin``, published by the solver through a
  temporary file and ``rename``.
* **Result cache.** :func:`solve_bem` results are content-addressed npz
  files under :func:`cache_root` (``RAFT_TPU_TORCH_CACHE_DIR``, else
  ``raft_tpu_torch/_build/cache``), in namespaces of the port's own
  (``torch-bem``; the on-device route's is ``torch-bem-jax``) and keyed
  with :data:`PORT_TAG` and the library's hash, published atomically; a
  corrupt file is a miss and is deleted.  ``CACHE_STATS`` counts hits,
  misses and corrupt files.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import tempfile
from pathlib import Path

import numpy as np

from raft_tpu_torch.core import nvcc

SRC = Path(__file__).resolve().parents[1] / "native" / "bem.cpp"
BUILD_DIR = nvcc.BUILD_DIR
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
#: salt of every result-cache key of the port
PORT_TAG = "raft_tpu_torch"
CACHE_ENV = "RAFT_TPU_TORCH_CACHE_DIR"
#: result-cache outcomes in this process (a corrupt file counts as a miss too)
CACHE_STATS = {"hit": 0, "miss": 0, "corrupt": 0}

_lib = None


@functools.cache
def _host_tag() -> str:
    """The CPU that ``-march=native`` compiles for: its model and flags
    (Linux), else the machine type."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(sorted({line for line in f
                                   if line.startswith(("model name", "flags"))}))
    except OSError:
        return platform.machine()


def lib_key() -> str:
    """Hash of the source, the flags and the host: the library's name and
    the salt of its results."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_tag().encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / f"libraft_bem_native-{lib_key()}.so"


def table_path() -> Path:
    """The solver's wave-integral table file (one per library)."""
    return BUILD_DIR / f"native_wavetable-{lib_key()}.bin"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Two
    attempts, each under the build timeout, 2 s apart."""
    so = lib_path()
    if so.exists():
        return so
    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.resilience import retry

    timeout_s = retry.build_timeout_s()
    job = nvcc.Job("g++ build of native/bem.cpp", ("g++", *GXX_FLAGS, str(SRC), "-lm"), so)
    try:
        with trace.span("bem/build_lib"):
            retry.retry_call(lambda attempt: nvcc.run_jobs([job], timeout=timeout_s),
                             retries=2, backoff_s=2.0, retry_on=(retry.SubprocessFailed,),
                             describe="BEM solver build")
    except retry.RetryExhausted as e:
        last = e.last
        raise RuntimeError(
            f"BEM solver build failed after {e.attempts} attempt(s) ({last.kind}, timeout "
            f"{timeout_s:.0f} s per attempt):\n{last.detail}") from e
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = build()
        lib = ctypes.CDLL(str(so))
        nvcc.note(so, "loaded")
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.bem_solve_mh.restype = ctypes.c_int
        lib.bem_solve_mh.argtypes = [
            dptr, ctypes.c_int,                                 # panels, np
            dptr, ctypes.c_int,                                 # w, nw
            ctypes.c_double,                                    # depth
            ctypes.c_double, ctypes.c_double,                   # rho, g
            dptr, ctypes.c_int,                                 # betas, nb
            dptr, dptr, dptr, dptr,                             # A, B, Fre, Fim
            dptr, dptr,                                         # Fhre, Fhim (Haskind, may be NULL)
            ctypes.c_int, ctypes.c_int,                         # nthreads, nlid
        ]
        lib.bem_green_fd.restype = None
        lib.bem_green_fd.argtypes = [ctypes.c_double] * 5 + [dptr]
        lib.bem_dispersion.restype = ctypes.c_double
        lib.bem_dispersion.argtypes = [ctypes.c_double, ctypes.c_double]
        lib.bem_wave_integral.restype = None
        lib.bem_wave_integral.argtypes = [ctypes.c_double, ctypes.c_double, dptr, dptr]
        lib.bem_wave_integral_direct.restype = None
        lib.bem_wave_integral_direct.argtypes = lib.bem_wave_integral.argtypes
        lib.bem_set_table_path.restype = None
        lib.bem_set_table_path.argtypes = [ctypes.c_char_p]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib.bem_set_table_path(os.fsencode(table_path()))
        _lib = lib
    return _lib


# ------------------------------------------------------------ result cache

def cache_root() -> Path:
    """``RAFT_TPU_TORCH_CACHE_DIR``, else ``raft_tpu_torch/_build/cache``."""
    root = os.environ.get(CACHE_ENV)
    return Path(root) if root else BUILD_DIR / "cache"


def result_cache_key(namespace: str, panels, w, betas, scalars, salt=(),
                     extra_bytes: bytes = b"") -> Path:
    """Content-addressed artifact path for one solve's inputs, salted with
    :data:`PORT_TAG` and ``salt``."""
    h = hashlib.sha256()
    for part in (PORT_TAG, *salt):
        h.update(repr(part).encode())
    h.update(np.ascontiguousarray(panels).tobytes())
    h.update(np.ascontiguousarray(w).tobytes())
    h.update(np.ascontiguousarray(betas).tobytes())
    h.update(np.asarray(scalars, dtype=np.float64).tobytes())
    h.update(extra_bytes)
    return cache_root() / namespace / (h.hexdigest()[:24] + ".npz")


def result_cache_load(key: Path, needed) -> dict | None:
    """A cached result with every ``needed`` array, or None (a miss); a
    corrupt or incomplete file is counted, deleted and missed."""
    if not key.exists():
        CACHE_STATS["miss"] += 1
        return None
    try:
        with np.load(key) as z:
            missing = set(needed) - set(z.files)
            if missing:
                raise KeyError(sorted(missing))
            out = {k: z[k].copy() for k in needed}
    except Exception:                    # any unreadable artifact is a miss
        CACHE_STATS["corrupt"] += 1
        CACHE_STATS["miss"] += 1
        key.unlink(missing_ok=True)
        return None
    CACHE_STATS["hit"] += 1
    return out


def result_cache_store(key: Path, payload: dict) -> None:
    """Write to a temporary file beside ``key`` and ``os.replace`` it: a
    reader sees no file or the whole one."""
    key.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=key.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, key)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# ------------------------------------------------------------------ probes

def wave_integral(X: float, Y: float, direct: bool = False):
    """The dimensionless PV wave integrals (I0, I1) at (X, Y): from the
    table, or by the direct pole-subtracted quadrature."""
    lib = _load()
    i0, i1 = ctypes.c_double(), ctypes.c_double()
    fn = lib.bem_wave_integral_direct if direct else lib.bem_wave_integral
    fn(X, Y, ctypes.byref(i0), ctypes.byref(i1))
    return i0.value, i1.value


def green_fd(nu: float, depth: float, R: float, zP: float, zQ: float):
    """The finite-depth Green function and its R and z derivatives, complex
    scalars, the 1/r and free-surface-image parts included."""
    out = (ctypes.c_double * 6)()
    _load().bem_green_fd(nu, depth, R, zP, zQ, out)
    return complex(out[0], out[1]), complex(out[2], out[3]), complex(out[4], out[5])


def dispersion(nu: float, depth: float) -> float:
    """k0 with k0 tanh(k0 depth) = nu."""
    return float(_load().bem_dispersion(nu, depth))


# ------------------------------------------------------------------- solve

def solve_bem(panels: np.ndarray, w: np.ndarray, rho: float = 1025.0, g: float = 9.81,
              beta=0.0, depth: float = 0.0, nthreads: int = 0, cache: bool = True,
              haskind: bool = False, lid: np.ndarray | None = None):
    """Solve the panels on the host (finite depth when ``depth`` > 0).

    ``panels`` (np, 4, 3) hull mesh with outward normals; ``w`` (nw,) rad/s;
    ``beta`` one heading [rad] or a grid (the influence matrix is factored
    once per frequency, each heading is one more back substitution);
    ``nthreads`` 0 takes OpenMP's default; ``lid`` optional (nl, 4, 3)
    interior waterplane panels at z = 0, which remove the irregular
    frequencies.

    Returns (A[6, 6, nw], B[6, 6, nw], F) with F[6, nw] complex for a
    scalar heading or F[nb, 6, nw] for a grid; with ``haskind`` also Fh,
    the excitation by the Haskind relation, in F's layout."""
    panels = np.ascontiguousarray(panels, dtype=np.float64)
    n_lid = 0
    if lid is not None and len(lid) > 0:
        panels = np.ascontiguousarray(
            np.concatenate([panels, np.asarray(lid, dtype=np.float64)]), dtype=np.float64)
        n_lid = len(lid)
    w = np.ascontiguousarray(np.atleast_1d(w), dtype=np.float64)
    scalar_beta = np.ndim(beta) == 0
    betas = np.ascontiguousarray(np.atleast_1d(beta), dtype=np.float64)
    n_p, n_w, n_b = len(panels), len(w), len(betas)
    depth = float(depth) if depth and depth > 0 else -1.0
    needed = ("A", "B", "F", "Fh") if haskind else ("A", "B", "F")

    def result(d: dict) -> tuple:
        return tuple(d[k][0] if scalar_beta and k in ("F", "Fh") else d[k] for k in needed)

    key = None
    if cache:
        key = result_cache_key("torch-bem", panels, w, betas,
                               (rho, g, depth, float(haskind), float(n_lid)),
                               salt=(lib_key(),))
        hit = result_cache_load(key, needed)
        if hit is not None:
            return result(hit)
    lib = _load()
    A = np.zeros((n_w, 6, 6))
    B = np.zeros((n_w, 6, 6))
    Fre = np.zeros((n_w, n_b, 6))
    Fim = np.zeros((n_w, n_b, 6))
    Fhre = np.zeros((n_w, n_b, 6)) if haskind else None
    Fhim = np.zeros((n_w, n_b, 6)) if haskind else None

    def dptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if a is not None else None

    ret = lib.bem_solve_mh(dptr(panels), n_p, dptr(w), n_w, depth, rho, g, dptr(betas), n_b,
                           dptr(A), dptr(B), dptr(Fre), dptr(Fim), dptr(Fhre), dptr(Fhim),
                           nthreads, n_lid)
    if ret != 0:
        raise RuntimeError(f"bem_solve_mh failed with code {ret}")
    res = {"A": A.transpose(1, 2, 0), "B": B.transpose(1, 2, 0),
           "F": (Fre + 1j * Fim).transpose(1, 2, 0)}               # F (nb, 6, nw)
    if haskind:
        res["Fh"] = (Fhre + 1j * Fhim).transpose(1, 2, 0)
    if key is not None:
        result_cache_store(key, res)
    return result(res)
