"""idle_share.long: as idle_share.batch, for a one-target-at-a-time cell."""


def read(ctx):
    prof = ctx["profile"]
    if ctx["loop"] != "single" or not prof or not prof.get("busy_s") or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
