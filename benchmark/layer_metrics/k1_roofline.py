"""K1's share of its roofline (``%``): the least time of its launches'
work on the card (operations over the peak for the dtype, or bytes over
the peak bandwidth, the larger) over the summed device time of its
kernels (``solve6_kernel``, forward and adjoint)."""
from benchmark.harness import profile
from benchmark.work import k1, peaks

KERNEL = "solve6_kernel"


def read(ctx, tag):
    info = ctx["counters"].get("k1")
    launches = profile.kernels(ctx["profile"], KERNEL)
    if not info or not launches:
        return None
    w = k1.work(info["lanes_per_launch"], info["nw"], 4 if info["dtype"] == "float32" else 8)
    bound = peaks.bound_s(w["flops"], w["bytes"], ctx["device_kind"], info["dtype"])
    if bound is None:
        return None
    return 100.0 * bound * len(launches) / profile.device_s(launches)
