"""host_waits_per_fold.long: the mean count of host waits on the device a fold
(the program's ``wait:*`` spans)."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "single":
        return None
    return spans.mean_waits(ctx)
