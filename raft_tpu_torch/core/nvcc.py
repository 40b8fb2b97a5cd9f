"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source in ``raft_tpu_torch/csrc/`` has a plain C interface and
becomes one shared library in ``raft_tpu_torch/_build/``, named by a hash of
the source and the flags, so a changed source is rebuilt and an unchanged
one is loaded as it is.  :func:`compile_all` starts one ``nvcc`` per
missing library, all at once, and waits for them; :func:`load` builds one
library if needed and opens it.  Each build's compiler output (``-Xptxas
-v``: registers and spills per kernel) is kept beside its library as
``lib<name>-<hash>.log``, and :func:`build_log` reads it back whether the
library was built in this process or loaded.  :func:`run_jobs`, the step
that runs the compilers and publishes their outputs atomically, also
builds the host panel solver with ``g++``
(:mod:`raft_tpu_torch.hydro.native_bem`, which retries it through
:func:`raft_tpu_torch.resilience.retry.retry_call`).  A compiler that
fails or outlives its timeout (``RAFT_TPU_BUILD_TIMEOUT``) raises
:class:`~raft_tpu_torch.resilience.retry.SubprocessFailed` with a
redacted tail of its stderr; the ``hang_subprocess`` fault spec swaps a
compiler for a process that sleeps past the timeout.
:func:`build_counts` reports the libraries this process compiled and
opened (the ``obs`` block's ``kernel_builds``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the compiler's timeout when ``RAFT_TPU_BUILD_TIMEOUT`` is unset
DEFAULT_TIMEOUT_S = 900.0

_counts_lock = threading.Lock()
_build_counts: dict = {}         # library name -> {"compiled": n, "loaded": n}


def _library_name(so: Path) -> str:
    """``lib<name>-<hash>.so`` -> ``<name>``."""
    return so.stem.rsplit("-", 1)[0].removeprefix("lib")


def note(so: Path, event: str) -> None:
    """Count one ``"compiled"`` or ``"loaded"`` event of a library."""
    with _counts_lock:
        c = _build_counts.setdefault(_library_name(Path(so)), {"compiled": 0, "loaded": 0})
        c[event] += 1


def build_counts() -> dict:
    """Per library, the builds this process ran and the times it opened
    the library."""
    with _counts_lock:
        return {k: dict(v) for k, v in sorted(_build_counts.items())}


@dataclasses.dataclass(frozen=True)
class Spec:
    """One kernel library: ``name``, its source in ``csrc/`` and the flags
    added to :data:`NVCC_FLAGS`."""

    name: str
    source: str
    extra_flags: tuple = ()

    @property
    def flags(self) -> tuple:
        return NVCC_FLAGS + tuple(self.extra_flags)

    def path(self) -> Path:
        src = (CSRC / self.source).read_bytes()
        key = hashlib.sha256(src + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{key}.so"

    def log_path(self) -> Path:
        return self.path().with_suffix(".log")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


@dataclasses.dataclass(frozen=True)
class Job:
    """One compiler run: ``argv`` without its output, which goes to a
    temporary file beside ``so`` (``-o`` is appended) and is published as
    ``so`` with ``os.replace``; ``log``, when given, keeps the compiler's
    stderr."""

    what: str
    argv: tuple
    so: Path
    log: Path | None = None


def run_jobs(jobs, timeout: float | None = None) -> None:
    """Start every job at once and wait for them, each for at most
    ``timeout`` seconds (default ``RAFT_TPU_BUILD_TIMEOUT``, else
    :data:`DEFAULT_TIMEOUT_S`); publish each output atomically, so a
    killed or failed compiler never leaves a library under its key.
    Raises :class:`~raft_tpu_torch.resilience.retry.SubprocessFailed`
    (a ``RuntimeError``) naming every failed job, with the redacted tail
    of each one's stderr."""
    from raft_tpu_torch.resilience import faults, retry

    if timeout is None:
        timeout = retry.build_timeout_s(DEFAULT_TIMEOUT_S)
    started = []
    try:
        for job in jobs:
            job.so.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=job.so.suffix, dir=job.so.parent)
            os.close(fd)
            argv = [*job.argv, "-o", tmp]
            if faults.consume("hang_subprocess"):
                argv = [sys.executable, "-c", "import time; time.sleep(3600)"]
            proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            started.append((job, tmp, proc))
        failed, kind = [], "nonzero"
        for job, tmp, proc in started:
            try:
                _out, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                failed.append(f"{job.what}: no result after {timeout:.0f} s")
                kind = "timeout"
                continue
            if proc.returncode != 0:
                failed.append(f"{job.what} ({proc.returncode}):\n"
                              f"{retry.redacted_tail(err, 4000)}")
            else:
                if job.log is not None:
                    job.log.write_text(err)
                os.replace(tmp, job.so)
                note(job.so, "compiled")
        if failed:
            raise retry.SubprocessFailed("build failed", kind, detail="\n".join(failed))
    finally:
        for _job, tmp, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def compile_all(specs) -> None:
    """Compile every spec whose library is missing, one ``nvcc`` each, all
    started together; raises if any build fails."""
    missing = [spec for spec in specs if not spec.path().exists()]
    if missing:
        nvcc = _nvcc()
        run_jobs([Job(spec.source, (nvcc, *spec.flags, str(CSRC / spec.source)), spec.path(),
                      spec.log_path()) for spec in missing])


def build_log(spec: Spec) -> str | None:
    """The compiler output of ``spec``'s library build, or None when the
    library was built before its log was kept."""
    log = spec.log_path()
    return log.read_text() if log.exists() else None


def load(spec: Spec, signatures: dict) -> ctypes.CDLL:
    """Build ``spec`` if needed and open it; ``signatures`` maps each C
    entry point to its ``argtypes`` (every entry returns a cudaError_t)."""
    compile_all([spec])
    lib = ctypes.CDLL(str(spec.path()))
    note(spec.path(), "loaded")
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the int the C entry
    points take."""
    import torch

    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and a floating input requires grad.

    A kernel writes its outputs through ctypes, so they carry no autograd
    history: a backward pass would leave the kernel out without a word.
    The JAX package raises there too (its Pallas kernels have no VJP rule,
    and ``lax.while_loop`` refuses reverse mode)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors
                                    if t is not None and t.is_floating_point()):
        raise RuntimeError(
            f"{what}: the kernel has no backward and an input requires grad. Differentiate "
            "the fixed point with method=\"scan\" (its 6x6 solves go through "
            "cuda6.solve_rao_ad / solve_cx_ad, which launch the kernels inside an "
            "autograd.Function), or run the plain version on CPU tensors")
