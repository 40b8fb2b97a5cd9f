"""Device resolution shared by the port's entry points, and the copy of a
host value to the card that does not synchronise the host."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without CUDA only an explicit CPU device is
    accepted: nothing moves to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev


def require_on(dev: torch.device, dtype: torch.dtype, **tensors):
    """Raise unless every floating tensor lies on ``dev`` in ``dtype``."""
    for name, t in tensors.items():
        if t.device.type != dev.type or (dev.index is not None and t.device != dev):
            raise ValueError(f"{name} lies on {t.device}, expected {dev}")
        if t.is_floating_point() and t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")


def to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a tensor on ``device`` in ``dtype``, without synchronising
    the host.  A tensor is moved or cast with ``non_blocking=True`` (and
    returned as it is when it already lies there in ``dtype``, autograd
    history kept).  A Python number, sequence or numpy array is cast on the
    host (the same rounding as casting on the card) and, for the card,
    copied from pinned memory with ``non_blocking=True``: a blocking copy
    of a host value waits for every kernel queued on the stream before it,
    which would stall a pipelined chunk's launches behind the previous
    chunk's work."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, non_blocking=True)
    host = torch.as_tensor(x, dtype=dtype).contiguous()
    dev = torch.device(device)
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)
