"""host_gap_ms.long: the median, over folds, of the time a fold's stream held
no stage's work: across the host's waits and between stages, each put down
to the host span open at its middle (``obs.device_breakdown``)."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "single":
        return None
    return spans.gap_ms(ctx)
