"""The 2D residual trunk in fp32: Maxout conv blocks + squeeze-excitation.

Counterpart of the fp32 path of ``dmpfold2_tpu/models/trunk.py``: one input
Maxout2d (955 -> 128, 1x1, pool 3), 16 residual blocks (Maxout2d 5x5 pool 4
-> InstanceNorm -> SCSE -> residual add) and a final 1x1 conv to 2 channels
(distance map + confidence). The public functions take and return NHWC maps,
as the JAX package does; inside, maps are NCHW for ``F.conv2d``. Weights are
OIHW. All ops are mask-aware: padded positions are zero after every block.

The convolutions run in full fp32: the fp32 engine turns TF32 off
(``engine/fold.py``), since cuDNN convolutions default to TF32.

The bf16 engine (:func:`trunk_apply_bf16`, weights from :func:`pack_bf16`)
keeps maps NHWC and runs the input layer and the 16 block convs through the
hand-written kernels of ``kernels/conv_block.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..features.dca import NUM_DCA_CHANNELS
from ..kernels import conv_block
from ..ops.norm import masked_instance_norm, scale_shift_from_sums

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


# ---------------------------------------------------------------- bf16 engine
#
# Counterpart of the bf16 path of dmpfold2_tpu/models/trunk.py with
# fused_conv="norm": the input layer through gemm_maxout, each block through
# conv5x5_maxout in stats mode and the block tail of _resnet_block_fused_norm,
# the head in fp32. Maps stay NHWC and contiguous (the implicit GEMM's K =
# (dy, dx, c_in) is contiguous in c_in); activations between layers are bf16.


@dataclass
class PackedTrunk:
    """Trunk weights packed once for the bf16 engine (:func:`pack_bf16`)."""

    input: dict         # w (k_pad, 3C) bf16, b (3C,), gamma, beta (C,)
    blocks: list        # per block: w (3200, 4C) bf16, b, gamma, beta, cse_gate, sse_w (C,), sse_b (1,)
    out_w: torch.Tensor  # (C, 2) fp32
    out_b: torch.Tensor  # (2,) fp32
    k_pad: int          # the input width the GEMM reads (955 -> 960)


def pack_bf16(params) -> PackedTrunk:
    """Pack fp32 trunk parameters (on their device) for :func:`trunk_apply_bf16`.

    The cSE gate is a per-model constant in this network (it pools an affine
    InstanceNorm output, whose masked mean is beta; see :func:`scse`), so it is
    computed here once: ``sigmoid(relu(beta @ W1) @ W2)`` in fp32.
    """
    inp = params["input"]
    k_pad = conv_block.gemm_k_pad(inp["w"].shape[1])
    w, b = conv_block.pack_gemm_weights(inp["w"], inp["b"], k_pad)
    out_w = params["out_w"]
    return PackedTrunk(input={"w": w, "b": b, "gamma": inp["gamma"], "beta": inp["beta"]},
                       blocks=[pack_block_bf16(block) for block in params["blocks"]],
                       out_w=out_w.reshape(out_w.shape[0], -1).T.contiguous(),
                       out_b=params["out_b"], k_pad=k_pad)


def pack_block_bf16(block) -> dict:
    """One residual block's parameters packed for :func:`resnet_block_fused_norm`."""
    mx, se = block["maxout"], block["scse"]
    w, b = conv_block.pack_conv5x5_weights(mx["w"], mx["b"])
    gate = torch.sigmoid(torch.relu(mx["beta"][None, :] @ se["cse_w1"]) @ se["cse_w2"])[0]
    return {"w": w, "b": b, "gamma": mx["gamma"], "beta": mx["beta"], "cse_gate": gate,
            "sse_w": se["sse_w"].reshape(-1), "sse_b": se["sse_b"]}


def resnet_block_fused_norm(p, x: torch.Tensor, mask: torch.Tensor, nres: torch.Tensor):
    """One residual block, bf16 in and out (JAX ``trunk._resnet_block_fused_norm``).

    The InstanceNorm's (scale, shift) come from the conv kernel's sums; sSE
    reads the raw maxout with scale folded into its weights (rounded to bf16,
    as JAX does) and shift into its bias; then gate, residual and mask.
    ``mask`` (B, L, L, 1) bf16.
    """
    z, s, ss = conv_block.conv5x5_maxout_stats(x, p["w"], p["b"], nres)
    scale, shift = scale_shift_from_sums(s, ss, nres, p["gamma"], p["beta"])
    w_eff = (scale * p["sse_w"][None, :]).to(torch.bfloat16)             # (B, C)
    s_bias = shift @ p["sse_w"] + p["sse_b"][0]                           # (B,)
    zf = z.float()
    s = torch.einsum("bhwc,bc->bhw", zf, w_eff.float()) + s_bias[:, None, None]
    gate = p["cse_gate"] + torch.sigmoid(s)[..., None]
    y = zf * scale[:, None, None, :] + shift[:, None, None, :]
    out = (y * gate + x.float()).to(torch.bfloat16)
    return out * mask


def trunk_apply_bf16(packed: PackedTrunk, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, L, k_pad) bf16 NHWC -> (B, L, L, 2) fp32.

    ``x``: the input channels, then zeros up to ``packed.k_pad``; ``mask``:
    (B, L, L, 1) float validity mask.
    """
    # per-target valid length (JAX trunk._mask_nres): every mask here is the
    # outer product of a right-padded row mask, so column 0 holds nres ones
    nres = mask[:, :, 0, 0].sum(dim=1).to(torch.int32)
    inp = packed.input
    out = conv_block.gemm_maxout_norm(x, inp["w"], inp["b"], inp["gamma"], inp["beta"], nres,
                                      mask)
    mask_bf = mask.to(torch.bfloat16)
    for block in packed.blocks:
        out = resnet_block_fused_norm(block, out, mask_bf, nres)
    out = out.float() @ packed.out_w + packed.out_b
    return out * mask
