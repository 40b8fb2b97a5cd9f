"""Milliseconds of device time per hull in the panel solve's factor and
solves: the kernels of the dense LU, its triangular solves and row swaps
(cuSOLVER and cuBLAS), named by the parts of their names below."""
from benchmark.harness import profile

#: a kernel counts when its name holds one of these
NAMES = ("getrf", "getrs", "laswp", "trsm", "trsv", "lu_", "ipiv", "pivot", "iamax")


def read(ctx, tag):
    p = ctx["profile"]
    ks = [e for e in p.device if e.kind == "kernel" and any(s in e.name.lower() for s in NAMES)]
    if not ks:
        return None
    return 1e3 * profile.device_s(ks) / ctx["n_calls"]
