"""idle_share.batch: the share of the profiled window in which no device
operation ran (1 - the union of device activity over the window)."""


def read(ctx):
    prof = ctx["profile"]
    if ctx["loop"] != "batch" or not prof or not prof.get("busy_s") or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
