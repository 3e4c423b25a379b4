"""mfu.long: as mfu.batch, for the folds of a one-target-at-a-time cell."""


def read(ctx):
    if ctx["loop"] != "single" or not ctx["window_s"] or not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / ctx["peak_flops"]
