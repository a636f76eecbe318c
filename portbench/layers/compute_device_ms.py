"""Device milliseconds, per epoch, of every operation launched inside the
benchmark's span around ``compute()`` and the read of its values."""


def read(ctx):
    trace, epochs = ctx.get("trace"), ctx.get("epochs") or 0
    if trace is None or not epochs:
        return None
    us = trace.device_us("compute")
    return us / epochs * 1e-3 if us > 0 else None
