"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source in ``raft_tpu_torch/csrc/`` has a plain C interface and
becomes one shared library in ``raft_tpu_torch/_build/``, named by a hash of
the source and the flags, so a changed source is rebuilt and an unchanged
one is loaded as it is.  :func:`compile_all` starts one ``nvcc`` per
missing library, all at once, and waits for them; :func:`load` builds one
library if needed and opens it.  Each build's compiler output (``-Xptxas
-v``: registers and spills per kernel) is kept beside its library as
``lib<name>-<hash>.log``, and :func:`build_log` reads it back whether the
library was built in this process or loaded.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def compile_all(specs) -> None:
    """Compile every spec whose library is missing, one ``nvcc`` each, all
    started together; raises if any build fails."""
    jobs = []
    try:
        for spec in specs:
            so = spec.path()
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *spec.flags, "-o", tmp, str(CSRC / spec.source)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((spec, so, tmp, proc))
        failed = []
        for spec, so, tmp, proc in jobs:
            _out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                failed.append(f"{spec.source} ({proc.returncode}):\n{err[-4000:]}")
            else:
                spec.log_path().write_text(err)
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    finally:
        for _spec, _so, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


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
