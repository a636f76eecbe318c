"""Mean host milliseconds of one ``MetricCollection.update`` call, taken
around the call with no synchronize: what the caller's thread pays."""


def read(ctx):
    times = ctx.get("update_host_s") or []
    return sum(times) / len(times) * 1e3 if times else None
