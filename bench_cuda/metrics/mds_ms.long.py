"""mds_ms.long: the median device time of one MDS (the program's ``mds``
span: the subspace iteration and its q x q ``eigh``, with the host's wait on
it)."""

from bench_cuda import spans


def read(ctx):
    if ctx["loop"] != "single":
        return None
    return spans.median_device_ms(ctx, "mds")
