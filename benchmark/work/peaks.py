"""The card's published peaks (``peaks.json``), by the name the device
reports."""
from __future__ import annotations

import json
from pathlib import Path


def peak(kind: str, dtype: str) -> tuple:
    """(FLOP/s, bytes/s) of the device ``kind`` for arithmetic in ``dtype``;
    None for a device the table does not hold."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    for d in table["devices"]:
        if d["kind_contains"] in kind:
            return d["flops_per_s"][dtype], d["bytes_per_s"]
    return None


def bound_s(flops: float, nbytes: float, kind: str, dtype: str):
    """The least time of ``flops`` and ``nbytes`` on the device: the larger
    of the two over their peaks.  None for an unknown device."""
    pk = peak(kind, dtype)
    if pk is None:
        return None
    return max(flops / pk[0], nbytes / pk[1])
