"""features_span_ms.long: the median device time of a fold's features step,
the program's ``features`` span (the blocked DCA inverse at n 15456)."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "single":
        return None
    return spans.median_device_ms(ctx, "features")
