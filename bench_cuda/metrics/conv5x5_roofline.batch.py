"""conv5x5_roofline.batch: the conv5x5_maxout launches in the profiled window
times each launch's bound (max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s) at the
cell's B and L_pad, the benchmark's frozen counts), over their summed device
time."""

from bench_cuda import yardstick

FRAGMENT = "conv5x5_maxout_kernel"


def read(ctx):
    prof = ctx["profile"]
    if ctx["loop"] != "batch" or not prof:
        return None
    hits = [(c, t) for name, c, t in prof["kernels"] if FRAGMENT in name]
    launches, seconds = sum(c for c, _ in hits), sum(t for _, t in hits)
    if not launches or seconds <= 0:
        return None
    flops, nbytes = yardstick.conv5x5_launch(ctx["batch_size"], ctx["l_pad"],
                                             ctx["cfg"]["cwidth"])
    bound = yardstick.bound_s(flops, nbytes, yardstick.PEAK_BF16_TENSOR)
    return 100.0 * launches * bound / seconds
