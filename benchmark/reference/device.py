"""The reference's device helpers: a host value cast on the host and copied
to the device, a tensor moved or cast."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)


def to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype).to(device)
