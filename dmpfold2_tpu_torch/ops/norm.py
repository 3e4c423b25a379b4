"""Mask-aware instance norm.

Counterpart of ``dmpfold2_tpu/ops/norm.py:masked_instance_norm``: statistics
over the valid region only, biased variance, eps 1e-5, output re-masked so
padding stays exactly zero. With a full mask it is torch.nn.InstanceNorm2d
(affine). The map comes as row blocks over devices (``parallel/sharding.py``;
one block is the whole map). :func:`scale_shift_from_sums` is the same norm
from sums that a kernel's epilogue took (the bf16 engine).
"""

from __future__ import annotations

import torch

from ..parallel.sharding import reduce_sum


def scale_shift_from_sums(s: torch.Tensor, ss: torch.Tensor, nres: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """Per-target InstanceNorm affine from masked sums over [0, nres)^2.

    Counterpart of ``dmpfold2_tpu/kernels/conv_block.py:conv5x5_maxout_stats``
    (:466-476) and ``gemm_maxout_norm`` (:618-627): (B, C) fp32 sums and sums
    of squares, (B,) int32 ``nres`` -> (scale, shift), each (B, C), with
    ``normalized = x * scale + shift``. The variance is E[x^2] - E[x]^2,
    clamped at 0.
    """
    nr = nres.to(torch.float32)[:, None]
    count = torch.clamp(nr * nr, min=1.0)
    mean = s / count
    var = torch.clamp(ss / count - mean * mean, min=0.0)
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def shard_counts(masks: list) -> list:
    """The valid-pixel count of a map split by rows, (B, 1, 1, 1) on each
    shard's device, from the shards' (B, R_k, W, 1) masks: one reduction,
    shared by every norm over those masks."""
    counts = reduce_sum([m.float().sum(dim=(1, 2), keepdim=True) for m in masks])
    return [c.clamp(min=1.0) for c in counts]


def masked_instance_norm(xs: list, gammas: list, betas: list, masks: list, counts: list,
                         eps: float = 1e-5) -> list:
    """InstanceNorm of an NHWC map split by rows: ``xs[k]`` and ``masks[k]``
    ((B, R_k, W, 1) float validity mask) shard k's rows, ``gammas[k]``,
    ``betas[k]`` and ``counts[k]`` (:func:`shard_counts`) on its device.
    Two passes, each summed over the shards (``parallel.sharding.reduce_sum``):
    the mean from the summed sums, then the variance from the summed squared
    deviations. Returns each shard's normalized rows.

    Statistics and arithmetic are fp32 whatever ``x``'s dtype; the result is
    cast back to it (the JAX norm's policy, so bf16 training maps stay bf16).
    """
    in_dtype = xs[0].dtype
    xs = [x.float() for x in xs]
    masks = [m.float() for m in masks]  # a bf16 count of L^2 ones would round
    sums = reduce_sum([(x * m).sum(dim=(1, 2), keepdim=True) for x, m in zip(xs, masks)])
    means = [s / c for s, c in zip(sums, counts)]
    devs = reduce_sum([((x - mu).square() * m).sum(dim=(1, 2), keepdim=True)
                       for x, mu, m in zip(xs, means, masks)])
    return [(((x - mu) / torch.sqrt(d / c + eps) * g + b) * m).to(in_dtype)
            for x, mu, d, c, g, b, m in zip(xs, means, devs, counts, gammas, betas, masks)]
