"""K4's share of its roofline (``%``): the least time of the work its
launches had (each chunk of frequencies, counted from the panels each call
was given) over the summed device time of ``wave_kernel``."""
from benchmark.harness import profile
from benchmark.work import peaks

KERNEL = "wave_kernel"


def read(ctx, tag):
    work = ctx["counters"].get("bem_work")
    launches = profile.kernels(ctx["profile"], KERNEL)
    if not work or not launches or peaks.peak(ctx["device_kind"], work[0]["dtype"]) is None:
        return None
    bound = sum(peaks.bound_s(c["flops"], c["bytes"], ctx["device_kind"], w["dtype"])
                for w in work for c in w["k4"])
    return 100.0 * bound / profile.device_s(launches)
