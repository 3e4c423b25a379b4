"""The 2D residual trunk in fp32: Maxout conv blocks + squeeze-excitation.

Counterpart of the fp32 path of ``dmpfold2_tpu/models/trunk.py``: one input
Maxout2d (955 -> 128, 1x1, pool 3), 16 residual blocks (Maxout2d 5x5 pool 4
-> InstanceNorm -> SCSE -> residual add) and a final 1x1 conv to 2 channels
(distance map + confidence). The public functions take and return NHWC maps,
as the JAX package does; inside, maps are NCHW for ``F.conv2d``. Weights are
OIHW. All ops are mask-aware: padded positions are zero after every block.

The convolutions run in full fp32: the fp32 engine turns TF32 off
(``engine/fold.py``), since cuDNN convolutions default to TF32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..features.dca import NUM_DCA_CHANNELS
from ..ops.norm import masked_instance_norm

TRUNK_IN_CHANNELS = NUM_DCA_CHANNELS + 512 + 1  # 955
DEFAULT_WIDTH = 128
NUM_BLOCKS = 16


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def maxout_params(gen: torch.Generator, in_ch: int, out_ch: int, pool: int, ksize: int,
                  block: int = 0):
    """Maxout2d (reference network.py:12-23): conv to out_ch*pool channels with
    Xavier gain 1/sqrt(block), affine InstanceNorm."""
    gain = 1.0 / math.sqrt(max(block, 1))
    fan_in, fan_out = in_ch * ksize * ksize, out_ch * pool * ksize * ksize
    return {
        "w": _uniform(gen, (out_ch * pool, in_ch, ksize, ksize),
                      gain * math.sqrt(6.0 / (fan_in + fan_out))),
        "b": _uniform(gen, (out_ch * pool,), 1.0 / math.sqrt(fan_in)),
        "gamma": torch.ones(out_ch),
        "beta": torch.zeros(out_ch),
    }


def scse_params(gen: torch.Generator, width: int, reduction: int = 16):
    red = width // reduction
    return {
        # channel SE: two bias-free linears, (in, out) layout
        "cse_w1": _uniform(gen, (width, red), 1.0 / math.sqrt(width)),
        "cse_w2": _uniform(gen, (red, width), 1.0 / math.sqrt(red)),
        # spatial SE: 1x1 conv to one channel, OIHW
        "sse_w": _uniform(gen, (1, width, 1, 1), 1.0 / math.sqrt(width)),
        "sse_b": _uniform(gen, (1,), 1.0 / math.sqrt(width)),
    }


def trunk_params(gen: torch.Generator, in_channels: int = TRUNK_IN_CHANNELS,
                 width: int = DEFAULT_WIDTH, num_blocks: int = NUM_BLOCKS, ksize: int = 5):
    blocks = [{"maxout": maxout_params(gen, width, width, pool=4, ksize=ksize, block=i + 1),
               "scse": scse_params(gen, width)} for i in range(num_blocks)]
    return {
        "input": maxout_params(gen, in_channels, width, pool=3, ksize=1),
        "blocks": blocks,
        "out_w": _uniform(gen, (2, width, 1, 1), 1.0 / math.sqrt(width)),
        "out_b": _uniform(gen, (2,), 1.0 / math.sqrt(width)),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Same-padded conv, NCHW/OIHW (torch's zero padding of (k-1)//2)."""
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def maxout2d(params, x: torch.Tensor, pool: int, mask: torch.Tensor) -> torch.Tensor:
    """Conv to C*pool channels, max over each group of ``pool`` (channel c =
    g*pool + p; a tie takes the first), masked instance norm. NCHW."""
    out = _conv(x, params["w"], params["b"])
    b, c, h, w = out.shape
    out = out.view(b, c // pool, pool, h, w).amax(dim=2)
    return masked_instance_norm(out, params["gamma"], params["beta"], mask)


def scse(params, x: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Concurrent spatial & channel squeeze-excitation: cSE(x) + sSE(x). NCHW.

    ``pooled`` is the spatial mean of ``x``. In this network cSE always pools
    an affine InstanceNorm output, whose masked spatial mean is exactly the
    norm's beta, so callers pass beta and the cSE gate is a per-model
    constant.
    """
    y = torch.relu(pooled[None, :] @ params["cse_w1"]) @ params["cse_w2"]  # (1, C)
    cse_gate = torch.sigmoid(y)[:, :, None, None]
    sse_gate = torch.sigmoid(_conv(x, params["sse_w"], params["sse_b"]))
    return x * cse_gate + x * sse_gate


def resnet_block(params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Residual block (reference network.py:85-103), inference. NCHW."""
    mx = params["maxout"]
    t = maxout2d(mx, x, pool=4, mask=mask)
    t = scse(params["scse"], t, pooled=mx["beta"])
    return (t + x) * mask


def trunk_apply(params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, L, 955) NHWC -> (B, L, L, 2): distance-map + confidence channels.

    ``mask``: (B, L, L, 1) validity mask.
    """
    x = x.permute(0, 3, 1, 2)
    mask = mask.permute(0, 3, 1, 2)
    out = maxout2d(params["input"], x, pool=3, mask=mask)  # already masked by the norm
    for block in params["blocks"]:
        out = resnet_block(block, out, mask)
    out = _conv(out, params["out_w"], params["out_b"])
    return (out * mask).permute(0, 2, 3, 1)
