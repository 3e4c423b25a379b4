"""Mask-aware instance norm.

Counterpart of ``dmpfold2_tpu/ops/norm.py:masked_instance_norm``: statistics
over the valid region only, biased variance, eps 1e-5, output re-masked so
padding stays exactly zero. With a full mask it is torch.nn.InstanceNorm2d
(affine).
"""

from __future__ import annotations

import torch


def masked_instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm on NCHW ``x`` with a (B, 1, H, W) float validity mask."""
    g = gamma[None, :, None, None]
    b = beta[None, :, None, None]
    count = mask.sum(dim=(2, 3), keepdim=True).clamp(min=1.0)
    mean = (x * mask).sum(dim=(2, 3), keepdim=True) / count
    var = ((x - mean).square() * mask).sum(dim=(2, 3), keepdim=True) / count
    out = (x - mean) / torch.sqrt(var + eps) * g + b
    return out * mask
