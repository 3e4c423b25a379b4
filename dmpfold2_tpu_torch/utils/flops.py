"""Analytic FLOP counts of a fold, and model FLOP utilization on an H100.

Counterpart of ``dmpfold2_tpu/utils/flops.py``, with the same closed-form
counts (2 M N K per matmul or conv; elementwise work, which is bound by
bytes, is left out). MDS is the full ``eigh`` every engine of this package
runs (9 L^3); the JAX package's subspace iteration has no counterpart here.

The peaks are an H100 SXM's (NVIDIA's data sheet, dense, at its 700 W power
limit). :func:`mfu` takes the peak as an argument, so every MFU printed names
the peak it was taken against.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (the fp32 engines: TF32 is off)
PEAK_BF16_TENSOR = 989e12  # bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12   # HBM3 bytes per second


def gru_flops(seq_len: int, batch_cols: int, layer_dims, bidirectional=False) -> float:
    """Dense FLOPs of a stacked GRU: per step, input and hidden projections
    to the 3 fused gates (2 (in 3h + h 3h) each)."""
    total = 0.0
    for cin, h in layer_dims:
        total += seq_len * batch_cols * 2.0 * (cin * 3 * h + h * 3 * h)
    return total * (2.0 if bidirectional else 1.0)


def trunk_pass_flops(l_pad: int, width: int = 512, cwidth: int = 128,
                     num_blocks: int = 16) -> float:
    """One trunk forward on an (L, L, 955) pair map."""
    ll = float(l_pad) * l_pad
    in_ch = 442 + width + 1
    f = 2.0 * ll * in_ch * (cwidth * 3)                      # input 1x1 maxout conv
    f += num_blocks * 2.0 * ll * 25 * cwidth * (cwidth * 4)  # 5x5 block convs
    f += num_blocks * 2.0 * ll * cwidth                      # sSE 1x1 conv
    f += 2.0 * ll * cwidth * 2                               # 1x1 head conv
    return f


def mds_flops(nres: int) -> float:
    """One MDS pass: a full symmetric eigendecomposition, 9 L^3."""
    return 9.0 * float(nres) ** 3


def fold_flops(nseqs: int, nres: int, nloops: int, minsteps: int, *,
               width: int = 512, cwidth: int = 128, num_blocks: int = 16) -> float:
    """Dense FLOPs of one fold at the padded shape (nseqs, nres): reweighting,
    the DCA covariance and its Cholesky inverse, the vertical and horizontal
    GRUs, (1 + nloops) passes of trunk, MDS and coordinate head, and
    2 x minsteps refinement steps."""
    n, l = float(nseqs), float(nres)
    h = width // 2
    f = 2.0 * n * n * (l * 21)                     # reweighting's identity matmul
    d = 21.0 * l                                   # DCA: the (21L)^2 covariance
    f += 2.0 * n * d * d
    f += d ** 3 / 3.0 + 2.0 * d ** 3               # Cholesky factor and inverse
    f += gru_flops(nseqs, nres, [(22, width), (width, width)])        # vgru
    f += gru_flops(nres, 1, [(width, h), (width, h)], True)           # hgru

    per_pass = (
        l * l * width                               # pair outer product
        + trunk_pass_flops(nres, width, cwidth, num_blocks)
        + mds_flops(nres)
        + gru_flops(nres, 1, [(width + 8, h), (width, h), (width, h)], True)
        + 2.0 * l * width * 3                       # coord_fc
    )
    f += (1 + nloops) * per_pass
    f += 2.0 * minsteps * 20.0 * l * l              # refinement force field
    return f


def mfu(flops: float, seconds: float, peak: float) -> float:
    """Share of ``peak`` FLOP/s sustained: ``flops`` in ``seconds``."""
    return flops / max(seconds, 1e-12) / peak
