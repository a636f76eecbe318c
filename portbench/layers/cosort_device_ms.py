"""Device milliseconds, per epoch, of the sort kernels (the library's
radix and segmented sorts, by kernel name) launched inside ``compute()``."""


def read(ctx):
    trace, epochs = ctx.get("trace"), ctx.get("epochs") or 0
    if trace is None or not epochs:
        return None
    us = trace.device_us("compute", name_has=("sort",))
    return us / epochs * 1e-3 if us > 0 else None
