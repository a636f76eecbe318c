"""Host synchronizations per ``compute()`` call, counted exactly under
``torch.cuda.set_sync_debug_mode("warn")``: the port's value probes and
reads that stop the host inside the epoch's wait. The benchmark's own read
of the values comes after the count."""


def read(ctx):
    syncs, calls = (ctx.get("syncs") or {}).get("compute", (0, 0))
    return syncs / calls if calls else None
