"""The 2D residual trunk in fp32: Maxout conv blocks + squeeze-excitation.

Counterpart of the fp32 path of ``dmpfold2_tpu/models/trunk.py``: one input
Maxout2d (955 -> 128, 1x1, pool 3), 16 residual blocks (Maxout2d 5x5 pool 4
-> InstanceNorm -> SCSE -> residual add) and a final 1x1 conv to 2 channels
(distance map + confidence). Maps are NHWC, as in the JAX package; weights
are OIHW. All ops are mask-aware: padded positions are zero after every block.

:func:`trunk_apply` serves the fp32 fold and training (fp32 or bf16). Its fp32
convolutions run in full fp32: the fp32 engine turns TF32 off
(``engine/fold.py``), since cuDNN convolutions default to TF32.

The bf16 engine (:func:`trunk_apply_bf16`, weights from :func:`pack_bf16`)
runs the input layer and the 16 block convs through the hand-written kernels
of ``kernels/conv_block.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..features.dca import NUM_DCA_CHANNELS
from ..kernels import conv_block
from ..ops.dropout import dropout, fold_in
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
        "cse_w2": _uniform(gen, (red, width), 1.0 / math.sqrt(max(red, 1))),  # empty below 16
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

    The cSE gate is a per-model constant in this network (see :func:`scse`), so
    it is computed here once: ``sigmoid(relu(beta @ W1) @ W2)`` in fp32.
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


# ---------------------------------------------------------------- the trunk
#
# Counterpart of dmpfold2_tpu/models/trunk.py:trunk_apply (:300-417): the fp32
# fold, and training in fp32 or bf16 (differentiable, with dropout and the
# remat tiers). Maps stay NHWC and contiguous. With compute_dtype=bfloat16 the
# carries between blocks, the dropout, the convs and the scse/residual are
# bf16 (each block conv through conv_block.conv5x5_maxout_diff, the argmax
# kernel and its backward), the norm statistics fp32 and the head fp32; in
# fp32 every conv is F.conv2d (TF32 off, engine/fold.py:use_full_fp32).

BLOCK_DROPOUT = 0.2


def _maxout_last(y: torch.Tensor, pool: int) -> torch.Tensor:
    """(..., C * pool) -> (..., C), max over c = g * pool + p (a tie takes the first)."""
    return y.reshape(*y.shape[:-1], y.shape[-1] // pool, pool).amax(dim=-1)


def _input_layer(p, x: torch.Tensor, mask: torch.Tensor, dtype) -> torch.Tensor:
    """The 1x1 maxout input layer as a GEMM in ``dtype`` (bf16: output and
    bias in bf16, as the JAX bf16 conv emits), then the masked norm."""
    c_out = p["w"].shape[0]
    y = x.to(dtype) @ p["w"].reshape(c_out, -1).T.to(dtype) + p["b"].to(dtype)
    return masked_instance_norm(_maxout_last(y, 3), p["gamma"], p["beta"], mask)


def scse(se, t: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Concurrent spatial & channel squeeze-excitation, cSE(t) + sSE(t), NHWC
    in t's dtype.

    In this network cSE always pools an affine InstanceNorm output, whose
    masked spatial mean is exactly the norm's ``beta``, so the cSE gate is a
    per-model constant computed from it.
    """
    gate = torch.sigmoid(torch.relu(beta[None, :] @ se["cse_w1"]) @ se["cse_w2"])  # (1, C)
    w_sse = se["sse_w"].reshape(-1, 1).to(t.dtype)
    s = torch.sigmoid(t @ w_sse + se["sse_b"].to(t.dtype))                          # (B, L, L, 1)
    return t * gate.to(t.dtype) + t * s


def _block_conv(mx, x: torch.Tensor) -> torch.Tensor:
    """The block's 5x5 conv + bias + maxout(4): the argmax kernel's Function
    in bf16, F.conv2d in fp32."""
    if x.dtype == torch.bfloat16:
        return conv_block.conv5x5_maxout_diff(x, mx["w"], mx["b"])
    y = _conv(x.permute(0, 3, 1, 2), mx["w"], mx["b"]).permute(0, 2, 3, 1)
    return _maxout_last(y, 4)


def resnet_block(p, x: torch.Tensor, mask: torch.Tensor, *, seed: int | None = None,
                 remat_tail: bool = False, shard=None) -> torch.Tensor:
    """One residual block (reference network.py:85-103, JAX
    ``trunk.resnet_block``), NHWC in x's dtype.

    ``seed``: dropout 0.2 before the conv, elementwise then channelwise, its
    masks drawn from ``seed`` (so a replay under checkpointing draws the same
    ones; ``shard`` as ``ops.dropout.keep_mask`` takes it). ``remat_tail``:
    checkpoint only the norm + scse + residual tail, so
    the conv output (and, in bf16, the int8 index) is kept for the backward
    and only the tail is replayed.
    """
    mx = p["maxout"]
    out = x
    if seed is not None:
        out = dropout(out, BLOCK_DROPOUT, fold_in(seed, 0), shard=shard)
        out = dropout(out, BLOCK_DROPOUT, fold_in(seed, 1),
                      shape=(out.shape[0], 1, 1, out.shape[3]), shard=shard)
    y = _block_conv(mx, out)

    def tail(y_, x_):
        t = masked_instance_norm(y_, mx["gamma"], mx["beta"], mask)
        t = scse(p["scse"], t, mx["beta"])
        return (t + x_) * mask

    if remat_tail and torch.is_grad_enabled():
        return checkpoint(tail, y, x, use_reentrant=False)
    return tail(y, x)


def trunk_apply(params, x: torch.Tensor, mask: torch.Tensor, *,
                dropout_seed: int | None = None, remat=False,
                compute_dtype=torch.float32, dropout_shard=None) -> torch.Tensor:
    """(B, L, L, 955) NHWC -> (B, L, L, 2) fp32: distance-map + confidence
    channels, differentiable.

    ``mask``: (B, L, L, 1) float validity mask. ``dropout_seed`` (training):
    block i's dropout from ``fold_in(dropout_seed, i)``; None is no dropout.
    ``dropout_shard``: ``(offset, total)`` of this batch in a data-parallel
    global batch (``ops.dropout.keep_mask``).
    ``remat``: False; True checkpoints each whole block (one carry per block
    is kept); ``"save_conv"`` checkpoints each block's tail only (JAX
    ``trunk_apply``'s tiers, picked by ``train/step.py:resolve_remat``).
    """
    mask = mask.to(compute_dtype)
    out = _input_layer(params["input"], x, mask, compute_dtype)  # masked by the norm
    for i, block in enumerate(params["blocks"]):
        seed = None if dropout_seed is None else fold_in(dropout_seed, i)
        if remat is True and torch.is_grad_enabled():
            out = checkpoint(resnet_block, block, out, mask, seed=seed, shard=dropout_shard,
                             use_reentrant=False)
        else:
            out = resnet_block(block, out, mask, seed=seed, remat_tail=remat == "save_conv",
                               shard=dropout_shard)
    c_out = params["out_w"].shape[0]
    out = out.float() @ params["out_w"].reshape(c_out, -1).T + params["out_b"]
    return out * mask.float()
