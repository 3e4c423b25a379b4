"""vgru_roofline.long: the vgru_final_cols launches in the profiled window
times each launch's bound (max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s) over
the bucket's depth x L_pad cells, the benchmark's frozen counts), over their
summed device time."""

from bench_cuda import yardstick

FRAGMENT = "vgru_kernel"


def read(ctx):
    prof = ctx["profile"]
    if ctx["loop"] != "single" or not prof:
        return None
    hits = [(c, t) for name, c, t in prof["kernels"] if FRAGMENT in name]
    launches, seconds = sum(c for c, _ in hits), sum(t for _, t in hits)
    if not launches or seconds <= 0:
        return None
    flops, nbytes = yardstick.vgru_launch(ctx["n_pad"], ctx["l_pad"], ctx["cfg"]["width"])
    bound = yardstick.bound_s(flops, nbytes, yardstick.PEAK_FP32_FLOPS)
    return 100.0 * launches * bound / seconds
