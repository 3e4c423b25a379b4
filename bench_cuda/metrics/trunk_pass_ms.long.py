"""trunk_pass_ms.long: the median device time of one trunk pass of a fold
(the program's ``trunk`` span)."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "single":
        return None
    return spans.median_device_ms(ctx, "trunk")
