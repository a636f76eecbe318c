"""Host synchronizations per ``update`` call, counted exactly under
``torch.cuda.set_sync_debug_mode("warn")``."""


def read(ctx):
    syncs, calls = (ctx.get("syncs") or {}).get("update", (0, 0))
    return syncs / calls if calls else None
