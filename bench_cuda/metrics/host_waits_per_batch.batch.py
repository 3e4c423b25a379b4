"""host_waits_per_batch.batch: the mean count of host waits on the device a
batch (the program's ``wait:*`` spans)."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "batch":
        return None
    return spans.mean_waits(ctx)
