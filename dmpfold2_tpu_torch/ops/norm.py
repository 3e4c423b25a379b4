"""Mask-aware instance norm.

Counterpart of ``dmpfold2_tpu/ops/norm.py:masked_instance_norm``: statistics
over the valid region only, biased variance, eps 1e-5, output re-masked so
padding stays exactly zero. With a full mask it is torch.nn.InstanceNorm2d
(affine). :func:`scale_shift_from_sums` is the same norm from sums that a
kernel's epilogue took (the bf16 engine).
"""

from __future__ import annotations

import torch


def masked_instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm on NHWC ``x`` with a (B, H, W, 1) float validity mask.

    Statistics and arithmetic are fp32 whatever ``x``'s dtype; the result is
    cast back to it (the JAX norm's policy, so bf16 training maps stay bf16).
    """
    in_dtype = x.dtype
    x, mask = x.float(), mask.float()  # a bf16 count of L^2 ones would round
    count = mask.sum(dim=(1, 2), keepdim=True).clamp(min=1.0)
    mean = (x * mask).sum(dim=(1, 2), keepdim=True) / count
    var = ((x - mean).square() * mask).sum(dim=(1, 2), keepdim=True) / count
    out = (x - mean) / torch.sqrt(var + eps) * gamma + beta
    return (out * mask).to(in_dtype)


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
