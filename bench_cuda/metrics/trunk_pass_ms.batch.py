"""trunk_pass_ms.batch: the median device time of one trunk pass of a batch
(the program's ``trunk`` span), while another batch shares the card."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "batch":
        return None
    return spans.median_device_ms(ctx, "trunk")
