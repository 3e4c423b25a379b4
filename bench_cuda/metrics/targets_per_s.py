"""targets_per_s: targets whose results came back in the window, per second
of the window (from its first dispatch to the return that closed it)."""


def read(ctx):
    if ctx["loop"] != "batch" or not ctx["window_s"]:
        return None
    return (ctx["attempted"] - ctx["failed"]) / ctx["window_s"]
