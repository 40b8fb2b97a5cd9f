"""Device resolution shared by the port's entry points."""
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
