"""The benchmark's yardstick: frozen FLOP and byte counts, the H100's peaks.

A copy of ``dmpfold2_tpu_torch/utils/flops.py`` as it stood when the
benchmark was written, kept here so that a later change to the program cannot
move the measure it is judged by. One difference: the MDS counts as the work
of a full symmetric eigendecomposition (9 L^3) whatever computes it, so the
bf16 engine's subspace iteration and the fp32 engine's ``eigh`` are credited
the same work. Kernel bounds follow the counts the port's kernel table was
measured against: each input read once, each output written once.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (the fp32 engine: TF32 off)
PEAK_BF16_TENSOR = 989e12  # bf16 on the tensor cores, dense
PEAK_HBM_BYTES = 3.35e12   # HBM3 bytes per second
PEAKS = {"fp32": PEAK_FP32_FLOPS, "bf16": PEAK_BF16_TENSOR}  # by the engine's precision

REFINE_FLOP_PER_PAIR = 24


def gru_flops(seq_len: int, batch_cols: int, layer_dims, bidirectional=False) -> float:
    """Dense FLOPs of a stacked GRU: per step the input and hidden projections
    to the three fused gates."""
    total = 0.0
    for cin, h in layer_dims:
        total += seq_len * batch_cols * 2.0 * (cin * 3 * h + h * 3 * h)
    return total * (2.0 if bidirectional else 1.0)


def trunk_pass_flops(l_pad: int, width: int = 512, cwidth: int = 128,
                     num_blocks: int = 16) -> float:
    """One trunk forward on an (L, L, 955) pair map."""
    ll = float(l_pad) * l_pad
    in_ch = 442 + width + 1
    f = 2.0 * ll * in_ch * (cwidth * 3)
    f += num_blocks * 2.0 * ll * 25 * cwidth * (cwidth * 4)
    f += num_blocks * 2.0 * ll * cwidth
    f += 2.0 * ll * cwidth * 2
    return f


def mds_flops(nres: int) -> float:
    """One MDS pass, counted as a full symmetric eigendecomposition."""
    return 9.0 * float(nres) ** 3


def fold_flops(nseqs: int, nres: int, nloops: int, minsteps: int, *,
               width: int = 512, cwidth: int = 128, num_blocks: int = 16) -> float:
    """Dense FLOPs of one fold at the padded shape (nseqs, nres)."""
    n, l = float(nseqs), float(nres)
    h = width // 2
    f = 2.0 * n * n * (l * 21)
    d = 21.0 * l
    f += 2.0 * n * d * d
    f += d ** 3 / 3.0 + 2.0 * d ** 3
    f += gru_flops(nseqs, nres, [(22, width), (width, width)])
    f += gru_flops(nres, 1, [(width, h), (width, h)], True)
    per_pass = (
        l * l * width
        + trunk_pass_flops(nres, width, cwidth, num_blocks)
        + mds_flops(nres)
        + gru_flops(nres, 1, [(width + 8, h), (width, h), (width, h)], True)
        + 2.0 * l * width * 3
    )
    f += (1 + nloops) * per_pass
    f += 2.0 * minsteps * 20.0 * l * l
    return f


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time a launch can take: max(operations / peak, bytes / HBM)."""
    return max(flops / peak, nbytes / PEAK_HBM_BYTES)


def conv5x5_launch(batch: int, l_pad: int, cwidth: int = 128) -> tuple[float, float]:
    """(FLOPs, bytes) of one ``conv5x5_maxout`` launch in stats mode at
    (B, L_pad): the 5x5 conv cwidth -> 4 cwidth over every pixel, the bf16
    input, weights and maxout output once, the fp32 bias and sums."""
    npix = batch * l_pad * l_pad
    c_out = 4 * cwidth
    w_numel = 25 * cwidth * c_out
    flops = 2.0 * npix * w_numel
    nbytes = 2 * (npix * cwidth + w_numel + npix * cwidth) + 4 * (c_out + batch * 2 * cwidth)
    return flops, nbytes


def vgru_launch(rows: int, cols: int, width: int = 512) -> tuple[float, float]:
    """(FLOPs, bytes) of one ``vgru_final_cols`` launch over ``cols`` columns
    each ``rows`` deep: the two layers' products over every valid cell, each
    input read and output written once (fp32)."""
    h = width
    cells = float(rows) * cols
    flops = 2 * 3 * h * 3 * h * cells
    nbytes = 4 * (rows * cols + cols + 22 * 3 * h + 3 * h * 3 * h + 4 * 3 * h + cols * h)
    return flops, nbytes


# the program's shape buckets when the benchmark was written: the padded
# (nseqs, nres) at which a fold's work is counted
SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 768, 1024, 1536, 2048, 3000)
RES_BUCKETS = (tuple(range(32, 129, 8)) + tuple(range(144, 257, 16))
               + tuple(range(288, 1025, 32)) + (1152, 1280, 1408, 1536))


def bucket(nseqs: int, nres: int) -> tuple[int, int]:
    """The padded shape of a target: each size rounded up to its bucket, or
    kept past the largest."""
    def up(v, table):
        return next((b for b in table if b >= v), v)
    return up(nseqs, SEQ_BUCKETS), up(nres, RES_BUCKETS)
