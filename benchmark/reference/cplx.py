# A frozen copy of raft_tpu_torch/core/cplx.py for the benchmark's reference;
# it imports nothing of the program.
"""Complex arithmetic as explicit (re, im) pairs of real tensors.

The port keeps the JAX package's (re, im) representation instead of
``torch.complex*``: every quantity compares plane by plane with the
reference, and the solve kernel takes the two planes as separate real
buffers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Cx:
    """A complex tensor as a (re, im) pair of equally-shaped real tensors."""

    re: Tensor
    im: Tensor

    # ---- constructors ----
    @staticmethod
    def expi(theta: Tensor) -> "Cx":
        """e^{i theta} for real theta."""
        return Cx(torch.cos(theta), torch.sin(theta))

    # ---- views ----
    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def to_complex(self) -> np.ndarray:
        """Materialize as a numpy complex array on the host."""
        return self.re.detach().cpu().numpy() + 1j * self.im.detach().cpu().numpy()

    # ---- arithmetic ----
    def __add__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re + o.re, self.im + o.im)
        return Cx(self.re + o, self.im + torch.zeros_like(self.im))

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re - o.re, self.im - o.im)
        return Cx(self.re - o, self.im)

    def __neg__(self):
        return Cx(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re * o.re - self.im * o.im, self.re * o.im + self.im * o.re)
        return Cx(self.re * o, self.im * o)  # o real scalar/tensor

    __rmul__ = __mul__

    def mul_i(self) -> "Cx":
        """Multiply by i."""
        return Cx(-self.im, self.re)

    def abs2(self) -> Tensor:
        return self.re * self.re + self.im * self.im

    def abs(self) -> Tensor:
        return torch.sqrt(self.abs2())

    # ---- structural ops ----
    def sum(self, axis):
        return Cx(self.re.sum(dim=axis), self.im.sum(dim=axis))

    def swapaxes(self, a, b):
        return Cx(self.re.transpose(a, b), self.im.transpose(a, b))


def where(cond: Tensor, a: Cx, b: Cx) -> Cx:
    return Cx(torch.where(cond, a.re, b.re), torch.where(cond, a.im, b.im))


def stack(xs, axis=0) -> Cx:
    return Cx(torch.stack([x.re for x in xs], dim=axis),
              torch.stack([x.im for x in xs], dim=axis))


def einsum(eq: str, *ops) -> Cx:
    """einsum over a mix of Cx and real operands (expands re/im products)."""
    cxs = [isinstance(o, Cx) for o in ops]
    n_cx = sum(cxs)
    if n_cx == 0:
        r = torch.einsum(eq, *ops)
        return Cx(r, torch.zeros_like(r))
    if n_cx == 1:
        i = cxs.index(True)
        re_ops = [o.re if j == i else o for j, o in enumerate(ops)]
        im_ops = [o.im if j == i else o for j, o in enumerate(ops)]
        return Cx(torch.einsum(eq, *re_ops), torch.einsum(eq, *im_ops))
    if n_cx == 2:
        i = cxs.index(True)
        j = cxs.index(True, i + 1)

        def term(pi, pj):
            arrs = []
            for k, o in enumerate(ops):
                if k == i:
                    arrs.append(o.re if pi == 0 else o.im)
                elif k == j:
                    arrs.append(o.re if pj == 0 else o.im)
                else:
                    arrs.append(o)
            return torch.einsum(eq, *arrs)

        return Cx(term(0, 0) - term(1, 1), term(0, 1) + term(1, 0))
    raise NotImplementedError("einsum with >2 complex operands")
