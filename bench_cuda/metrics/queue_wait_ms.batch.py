"""queue_wait_ms.batch: the median time a batch waits for a worker, from its
hand-off to the executor until the worker holds its streams (the program's
``batch.queue`` span, host clock)."""

from bench_cuda import spans


def read(ctx):
    kept = spans.units(ctx) if ctx["loop"] == "batch" else None
    if not kept:
        return None
    values = [v for u in kept for v in spans.host_ms(u, "batch.queue")]
    return spans.statistics.median(values) if values else None
