"""mfu.batch: the frozen FLOPs of every target completed in the window, at
its bucket shape, over the window's seconds, as a share of the engine's peak
(bf16 989 TFLOP/s on the tensor cores, fp32 67 TFLOP/s with TF32 off)."""


def read(ctx):
    if ctx["loop"] != "batch" or not ctx["window_s"] or not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / ctx["peak_flops"]
