"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source in ``raft_tpu_torch/csrc/`` has a plain C interface and
becomes one shared library in ``raft_tpu_torch/_build/``.  A :class:`Spec`
is a library of the kernel-library registry
(:mod:`raft_tpu_torch.cache.aot`): it names its file by a key of the
source, the flags, the target, the ``nvcc`` version, the torch and CUDA
versions and the card, so a change to any of them rebuilds and an
unchanged library is opened as it is.  The registry builds each library
once per key, opens it once per process and counts the builds
(:func:`build_counts` is a view of its counts).  :func:`compile_all`
starts one ``nvcc`` per missing library, all at once, and waits for them.
Each build's compiler output (``-Xptxas -v``: registers and spills per
kernel) is kept beside its library as ``lib<name>-<key>.log``, and
:func:`build_log` reads it back whether the library was built in this
process or loaded.
:func:`run_jobs`, the step that runs the compilers and publishes their
outputs atomically, also builds the host panel solver with ``g++``
(:mod:`raft_tpu_torch.hydro.native_bem`).  A compiler that fails or
outlives its timeout (``RAFT_TPU_BUILD_TIMEOUT``) raises
:class:`~raft_tpu_torch.resilience.retry.SubprocessFailed` with a
redacted tail of its stderr; the ``hang_subprocess`` fault spec swaps a
compiler for a process that sleeps past the timeout.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the compiler's timeout when ``RAFT_TPU_BUILD_TIMEOUT`` is unset
DEFAULT_TIMEOUT_S = 900.0

#: the target every kernel library is built for
TARGET = "sm_90a"


def build_counts() -> dict:
    """Per library, the builds this process ran and the times it opened
    the library (a view of :mod:`raft_tpu_torch.cache.aot`'s counts)."""
    from raft_tpu_torch.cache import aot

    built, opened = aot.compile_counts(), aot.open_counts()
    return {tag: {"compiled": built.get(tag, 0), "loaded": opened.get(tag, 0)}
            for tag in sorted(set(built) | set(opened))}


@functools.cache
def _tool_version(tool: str) -> str:
    """What ``tool --version`` prints, or ``"unknown"``: a key salt, so a
    new compiler rebuilds every library."""
    try:
        out = subprocess.run([tool, "--version"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"


@functools.cache
def _runtime_salts() -> tuple:
    """The torch and CUDA versions and the card's name."""
    import torch

    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no card"
    return (torch.__version__, str(torch.version.cuda), card)


@dataclasses.dataclass(frozen=True)
class Spec:
    """One kernel library: ``name``, its source in ``csrc/``, the flags
    added to :data:`NVCC_FLAGS`, and its C entry points ``signatures``
    (``(entry, argtypes, restype)``; ``restype`` None means a
    cudaError_t).  A library of the registry (:mod:`raft_tpu_torch.cache.
    aot`): ``tag``, ``key``, ``path``, ``job`` and ``open``."""

    name: str
    source: str
    extra_flags: tuple = ()
    signatures: tuple = ()
    retries = 1
    timeout_s = DEFAULT_TIMEOUT_S

    @property
    def tag(self) -> str:
        return self.name

    @property
    def flags(self) -> tuple:
        return NVCC_FLAGS + tuple(self.extra_flags)

    def key(self) -> str:
        h = hashlib.sha256((CSRC / self.source).read_bytes())
        for part in (" ".join(self.flags), TARGET, _tool_version(_nvcc()), *_runtime_salts()):
            h.update(b"\0" + str(part).encode())
        return h.hexdigest()[:16]

    def path(self, key: str | None = None) -> Path:
        return BUILD_DIR / f"lib{self.name}-{key or self.key()}.so"

    def log_path(self) -> Path:
        return self.path().with_suffix(".log")

    def job(self, path) -> "Job":
        path = Path(path)
        return Job(self.source, (_nvcc(), *self.flags, str(CSRC / self.source)), path,
                   path.with_suffix(".log"))

    def open(self, path) -> ctypes.CDLL:
        lib = ctypes.CDLL(str(path))
        for name, argtypes, restype in self.signatures:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int if restype is None else restype
        return lib


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
    started together (through the registry, which counts the builds);
    raises if any build fails."""
    from raft_tpu_torch.cache import aot

    aot.prepare(specs)


def build_log(spec: Spec) -> str | None:
    """The compiler output of ``spec``'s library build, or None when the
    library was built before its log was kept."""
    log = spec.log_path()
    return log.read_text() if log.exists() else None


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
