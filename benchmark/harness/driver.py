"""The interface every driver (``drivers/<name>.py``) implements, and what
they share.

A driver owns one kind of entry of the program.  ``setup`` makes the
cell's inputs from the seed, stages them and warms up every shape the
window uses; ``call`` makes one timed call and returns when its result is
on the host; ``release`` frees the program's state once the window has
closed; ``check`` runs the plain reference on what the window produced and
returns the compared numbers; ``counters`` gives the per-layer readers what
the driver counted itself.  Inputs that a call needs are drawn by
``next_inputs`` before the call is due, so the generator's time is not the
program's."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np

DTYPES = ("float32", "float64")


@dataclass
class Check:
    """One compared number with its limit: ``value <= limit`` passes."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


class Driver:
    def __init__(self, cell, seed: int, device):
        import torch

        self.torch = torch
        self.cell = cell
        self.p = cell.params["traffic_params"]
        self.cfg = cell.config
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rng = np.random.default_rng([self.seed, 0])
        self.outputs = []          # what each call produced, on the host
        self.detail = {}           # what the last comparison saw besides its numbers

    def dtype(self, name: str):
        if name not in DTYPES:
            raise ValueError(f"dtype {name!r}: expected one of {DTYPES}")
        return getattr(self.torch, name)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def check_rng(self):
        """The generator of the reference's sample, apart from the traffic's."""
        return np.random.default_rng([self.seed, 1])

    # the interface
    def setup(self):
        raise NotImplementedError

    def next_inputs(self, i: int):
        raise NotImplementedError

    def call(self, inputs) -> dict:
        """One timed call; returns ``{"units": ..., "ok": ...}``."""
        raise NotImplementedError

    def release(self):
        pass

    def counters(self) -> dict:
        return {}

    def sample(self) -> list:
        """The window's calls the reference checks: ``check_calls`` of them
        drawn from the seed (every call where the cell names no count)."""
        n = len(self.outputs)
        k = self.p.get("check_calls")
        if k is None or k >= n:
            return list(range(n))
        return sorted(int(i) for i in self.check_rng().choice(n, k, replace=False))

    def answers(self, sample: list) -> list:
        """The program's answers of the sampled calls."""
        return [self.outputs[i] for i in sample]

    def reference(self, sample: list, control: bool = False) -> list:
        """The reference's answers of the sampled calls, in the layout of
        :meth:`answers`; ``control`` computes them one precision below the
        configuration's."""
        raise NotImplementedError

    def compare(self, got: list, ref: list) -> list:
        """The compared numbers, each a :class:`Check` with its limit."""
        raise NotImplementedError

    def check(self) -> list:
        sample = self.sample()
        return self.compare(self.answers(sample), self.reference(sample))

    def control(self) -> list:
        """The control's numbers: the reference one precision below, put in
        the program's place."""
        sample = self.sample()
        return self.compare(self.reference(sample, control=True), self.reference(sample))


def scale_gap(got, ref) -> float:
    """The largest gap of ``got`` from ``ref`` over rows, each measured
    against the largest magnitude of its own row of ``ref`` (the small
    components of a row are compared against its scale, not their own)."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return float("inf")
    scale = np.maximum(np.abs(ref).max(axis=-1), 1e-300)
    gap = np.abs(got - ref).max(axis=-1) / scale
    return float(np.nan_to_num(gap, nan=np.inf).max()) if gap.size else 0.0


def array_gap(got, ref) -> float:
    """max |got - ref| / max |ref| over a whole array."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        return float("inf")
    gap = np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-300)
    return float(np.nan_to_num(gap, nan=np.inf))


@contextlib.contextmanager
def reference_precision(torch, stated: str, control: bool):
    """The dtype the reference computes a stage in: float64, or for the
    control one precision below the ``stated`` one (float64 -> float32;
    float32 -> float32 with TF32 on, the matrix products of the program's
    float32 running with TF32 off)."""
    if not control:
        yield torch.float64
        return
    tf32 = stated == "float32"
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def step_gap(std, iters, std_hist) -> float:
    """The widest gap of each lane's std dev from the reference's after the
    same number of fixed-point steps as the lane took (``std_hist``
    (n_iter, lanes, 6)): a lane whose convergence test flips by one step
    between precisions is compared at its own step, not at the other's."""
    k = np.clip(np.asarray(iters).astype(int) - 1, 0, std_hist.shape[0] - 1)
    return scale_gap(std, std_hist[k, np.arange(len(k))])


def iter_far(iters, ref_iters) -> int:
    """Lanes whose step count is more than one from the reference's."""
    return int((np.abs(np.asarray(iters).astype(int) - np.asarray(ref_iters).astype(int)) > 1)
               .sum())


def edge_distance(ref_err, steps, lanes) -> np.ndarray:
    """How far the reference's convergence test lay from the tolerance, as a
    share of it, at step ``steps`` (1-based) of each of ``lanes``
    (``ref_err`` (n_iter, lanes))."""
    from benchmark.reference.dynamics import TOL

    r = np.asarray(ref_err)[np.asarray(steps, dtype=int) - 1, lanes]
    return np.abs(r / TOL - 1.0)


def iter_edge(iters, ref_iters, ref_err) -> tuple:
    """The lanes one step off the reference's count, and the widest
    distance of the reference's convergence test from the tolerance at the
    earlier of the two steps over them (0 where no lane is off).  A lane
    may stop a step before or after the reference only where that test lies
    within rounding of the tolerance; a stopping rule off by one step reads
    the distance of a test that was not on the edge."""
    it, rit = np.asarray(iters).astype(int), np.asarray(ref_iters).astype(int)
    off = np.nonzero(np.abs(it - rit) == 1)[0]
    if not off.size:
        return 0, 0.0
    return int(off.size), float(edge_distance(ref_err, np.minimum(it, rit)[off], off).max())


def edge_detail(edges, faults) -> dict:
    """The lanes one step off over a comparison's :func:`iter_edge` pairs,
    and the stopping-rule faults' readings (:func:`exit_fault`)."""
    return {"lanes_off": sum(e[0] for e in edges),
            **{f"fault_{k}": max(f[k] for f in faults) for k in ("late", "early")}}


def exit_fault(ref_iters, ref_converged, ref_err) -> dict:
    """What :func:`iter_edge` reads for a program whose every lane stops
    one step late (``late``) or early (``early``) against the reference
    itself: the largest distance from the tolerance of the test that ended
    each converged lane, and of the one before it.  Worked out from the
    reference alone, as a state left unchanged needs no run."""
    rit = np.asarray(ref_iters).astype(int)
    lanes = np.nonzero(np.asarray(ref_converged, dtype=bool))[0]
    early = lanes[rit[lanes] >= 2]
    return {"late": float(edge_distance(ref_err, rit[lanes], lanes).max()) if lanes.size else 0.0,
            "early": (float(edge_distance(ref_err, rit[early] - 1, early).max())
                      if early.size else 0.0)}
