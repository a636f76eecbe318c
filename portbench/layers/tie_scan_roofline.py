"""Share of its roofline that ``tie_scan_kernel`` reaches inside
``compute()``: the least time of its calls, counted from the epoch's scan
shape at the card's published peaks, over their device time, in %."""
from portbench.roofline import scan_call_bound_ms

KERNEL = "tie_scan_kernel"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("scan_shape"):
        return None
    times_us = trace.launches(KERNEL, span="compute")
    if not times_us:
        return None
    rows, n = ctx["scan_shape"]
    return 100.0 * len(times_us) * scan_call_bound_ms(rows, n) / (sum(times_us) * 1e-3)
