"""features_span_ms.batch: the median device time of a batch's features step
(one-hot, reweighting, DCA of each target), the program's ``features`` span."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "batch":
        return None
    return spans.median_device_ms(ctx, "features")
