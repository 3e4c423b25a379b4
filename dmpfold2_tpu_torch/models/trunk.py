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
runs the input layer, the 16 block convs and their tails through the
hand-written kernels of ``kernels/conv_block.py``.

Both take the map as a list of row blocks over a
``parallel.sharding.SeqShards`` (residue-axis sharding), each block on its
shard's device with that device's copy of the weights; the default is one
shard, the whole map. The input layer and the head are row-local; each
block exchanges 2 halo rows with its neighbours, runs its conv on the slab
(the kernels' slab forms in bf16), reduces the norm's statistics over the
shards and runs its tail row-local (the cSE gate is a per-model constant;
sSE, the residual and the mask are per pixel). One shard skips the exchange
and launches the square kernels. The bf16 engine's norm sums every shard's
kernel partials in the unsharded tile order, so its scale and shift, and
with them the block outputs, are the unsharded bits.
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
from ..ops.norm import masked_instance_norm, scale_shift_from_sums, shard_counts
from ..parallel.sharding import SeqShards, exchange_halo, gather_rows

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


# ---------------------------------------------------------------- bf16 engine
#
# Counterpart of the bf16 path of dmpfold2_tpu/models/trunk.py with
# fused_conv="norm": the input layer through gemm_maxout, each block through
# conv5x5_maxout in stats mode and block_tail (the tail of
# _resnet_block_fused_norm), the head in fp32. Maps stay NHWC and contiguous
# (the implicit GEMM's K = (dy, dx, c_in) is contiguous in c_in); activations
# between layers are bf16.


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


def _whole(seq, xs: list) -> SeqShards:
    """``seq``, or by default one shard: the whole map on its device."""
    return seq if seq is not None else SeqShards.split([xs[0].device], xs[0].shape[1])


def _norm_from_partials(partials: list, nres: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, devices) -> list:
    """(scale, shift) on each shard's device from every shard's kernel
    partials: joined in row order on the leader (``nres``'s device) and
    summed there, as the unsharded launch sums its own."""
    lead = nres.device
    joined = (partials[0] if len(partials) == 1
              else torch.cat([p.to(lead) for p in partials], dim=1))
    sums = joined.sum(dim=1)
    scale, shift = scale_shift_from_sums(sums[:, 0], sums[:, 1], nres, gamma, beta)
    return [(scale.to(d), shift.to(d)) for d in devices]


def input_layer_bf16(inputs: list, xs: list, masks: list, nres: list, seq: SeqShards) -> list:
    """The input layer over row shards, bf16 out (JAX ``gemm_maxout_norm``):
    ``inputs[k]`` (the packed ``w``, ``b``, ``gamma``, ``beta``), ``xs[k]``,
    ``masks[k]`` (float) and ``nres[k]`` on shard k's device. The GEMM
    kernel on each shard, the norm's (scale, shift) from every shard's
    partials, then each shard's rows normalized and masked."""
    parts = [conv_block.gemm_maxout_partials(x, p["w"], p["b"], n, r0)
             for p, x, n, r0 in zip(inputs, xs, nres, seq.bounds)]
    norms = _norm_from_partials([pt for _, pt in parts], nres[0], inputs[0]["gamma"],
                                inputs[0]["beta"], seq.devices)
    return [conv_block.normalize(z, sc, sh, m) for (z, _), (sc, sh), m in zip(parts, norms, masks)]


def resnet_block_fused_norm(blocks: list, xs: list, masks: list, nres: list,
                            seq: SeqShards) -> list:
    """One residual block over row shards, bf16 in and out (JAX
    ``trunk._resnet_block_fused_norm``): ``blocks[k]``, ``xs[k]``,
    ``masks[k]`` (bf16) and ``nres[k]`` on shard k's device.

    The halo exchange (several shards), the conv kernel's stats mode on each
    slab (or on the whole map), the InstanceNorm's (scale, shift) from every
    shard's partials, then the tail row-local (:func:`_fused_tail`).
    """
    sharded = seq.n > 1
    slabs = exchange_halo(xs, conv_block.HALO) if sharded else xs
    parts = [conv_block.conv5x5_maxout_partials(slab, b["w"], b["b"], n, r0, slab=sharded)
             for b, slab, n, r0 in zip(blocks, slabs, nres, seq.bounds)]
    norms = _norm_from_partials([pt for _, pt in parts], nres[0], blocks[0]["gamma"],
                                blocks[0]["beta"], seq.devices)
    return [_fused_tail(b, z, x, m, sc, sh)
            for b, (z, _), x, m, (sc, sh) in zip(blocks, parts, xs, masks, norms)]


def _fused_tail(p, z: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """The block tail from the conv's bf16 maxout ``z`` and the norm's
    (scale, shift): sSE, the cSE gate, residual and mask in one launch of
    ``conv_block.block_tail``. Per pixel, so a row slab gives the unsharded
    rows' bits."""
    return conv_block.block_tail(z, x, mask, scale, shift, p["sse_w"], p["sse_b"],
                                 p["cse_gate"])


def trunk_apply_bf16(packed: list, xs: list, masks: list, nres: torch.Tensor,
                     seq: SeqShards | None = None) -> torch.Tensor:
    """(B, L, L, k_pad) bf16 NHWC -> (B, L, L, 2) fp32, as row blocks over
    ``seq``: ``xs[k]`` (B, R_k, L, k_pad), the input channels then zeros up
    to ``packed[k].k_pad``, and ``masks[k]`` (B, R_k, L, 1) float validity
    mask on shard k's device, ``packed[k]`` its copy of the weights; ``nres``
    (B,) int32 on the leader. The output is gathered on the leader.

    Every shard launches the input GEMM (:func:`input_layer_bf16`) and each
    block's conv (:func:`resnet_block_fused_norm`, in its slab form when
    there are several shards); the norms come from every shard's partials
    and the tails run row-local.
    """
    seq = _whole(seq, xs)
    nres_s = [nres.to(d) for d in seq.devices]
    outs = input_layer_bf16([p.input for p in packed], xs, masks, nres_s, seq)
    masks_bf = [m.to(torch.bfloat16) for m in masks]
    for i in range(len(packed[0].blocks)):
        outs = resnet_block_fused_norm([p.blocks[i] for p in packed], outs, masks_bf, nres_s, seq)
    return gather_rows([(out.float() @ p.out_w + p.out_b) * m
                        for p, out, m in zip(packed, outs, masks)])


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


def _input_maxout(p, x: torch.Tensor, dtype) -> torch.Tensor:
    """The 1x1 maxout input layer as a GEMM in ``dtype`` (bf16: output and
    bias in bf16, as the JAX bf16 conv emits), before its norm."""
    c_out = p["w"].shape[0]
    y = x.to(dtype) @ p["w"].reshape(c_out, -1).T.to(dtype) + p["b"].to(dtype)
    return _maxout_last(y, 3)


def _input_layer(params: list, xs: list, masks: list, counts: list, dtype) -> list:
    """The input layer (:func:`_input_maxout`) on each shard, then the
    masked norm over all of them."""
    ys = [_input_maxout(p["input"], x, dtype) for p, x in zip(params, xs)]
    return masked_instance_norm(ys, [p["input"]["gamma"] for p in params],
                                [p["input"]["beta"] for p in params], masks, counts)


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


def _block_conv(mx, x: torch.Tensor, slab: bool = False) -> torch.Tensor:
    """The block's 5x5 conv + bias + maxout(4): the argmax kernel's Function
    in bf16, F.conv2d in fp32. ``slab``: x is a row slab with its halo rows,
    and the conv is "valid" in rows."""
    if x.dtype == torch.bfloat16:
        return conv_block.conv5x5_maxout_diff(x, mx["w"], mx["b"], slab)
    pad = mx["w"].shape[-1] // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), mx["w"], mx["b"], padding=(0 if slab else pad, pad))
    return _maxout_last(y.permute(0, 2, 3, 1), 4)


def resnet_block(blocks: list, xs: list, masks: list, counts: list, seq: SeqShards, *,
                 seed: int | None = None, remat_tail: bool = False, shard=None) -> list:
    """One residual block (reference network.py:85-103, JAX
    ``trunk.resnet_block``) over row shards, NHWC in x's dtype:
    ``blocks[k]`` the block's parameters on shard k's device.

    ``seed``: dropout 0.2 before the conv, elementwise then channelwise, its
    masks drawn from ``seed`` (so a replay under checkpointing draws the same
    ones) at the unsharded shape, each shard keeping its rows (``shard`` as
    ``ops.dropout.keep_mask`` takes it). Then the halo exchange (several
    shards), the conv on each slab, the norm reduced over the shards and the
    tail row-local. ``remat_tail``: checkpoint only the norm + scse +
    residual tail, so the conv output (and, in bf16, the int8 index) is kept
    for the backward and only the tail is replayed.
    """
    l_pad, sharded = seq.bounds[-1], seq.n > 1
    outs = xs
    if seed is not None:
        outs = [dropout(x, BLOCK_DROPOUT, fold_in(seed, 0), shard=shard, rows=(r0, l_pad))
                for x, r0 in zip(outs, seq.bounds)]
        outs = [dropout(x, BLOCK_DROPOUT, fold_in(seed, 1),
                        shape=(x.shape[0], 1, 1, x.shape[3]), shard=shard) for x in outs]
    slabs = exchange_halo(outs, conv_block.HALO) if sharded else outs
    ys = [_block_conv(b["maxout"], slab, slab=sharded) for b, slab in zip(blocks, slabs)]

    def tail(ys_, xs_):
        ts = masked_instance_norm(ys_, [b["maxout"]["gamma"] for b in blocks],
                                  [b["maxout"]["beta"] for b in blocks], masks, counts)
        return [(scse(b["scse"], t, b["maxout"]["beta"]) + x) * m
                for b, t, x, m in zip(blocks, ts, xs_, masks)]

    if remat_tail and torch.is_grad_enabled():
        return checkpoint(tail, ys, xs, use_reentrant=False)
    return tail(ys, xs)


def trunk_apply(params: list, xs: list, masks: list, seq: SeqShards | None = None, *,
                dropout_seed: int | None = None, remat=False,
                compute_dtype=torch.float32, dropout_shard=None) -> torch.Tensor:
    """(B, L, L, 955) NHWC -> (B, L, L, 2) fp32: distance-map + confidence
    channels, differentiable, as row blocks over ``seq`` (default one shard):
    ``xs[k]`` (B, R_k, L, 955) and ``masks[k]`` (B, R_k, L, 1) float validity
    mask on shard k's device, ``params[k]`` the trunk there. The output is
    gathered on the leader; gradients reach each shard's parameters and
    inputs across the copies.

    ``dropout_seed`` (training): block i's dropout from ``fold_in(dropout_seed,
    i)``; None is no dropout. ``dropout_shard``: ``(offset, total)`` of this
    batch in a data-parallel global batch (``ops.dropout.keep_mask``).
    ``remat``: False; True checkpoints each whole block (one carry per block
    is kept); ``"save_conv"`` checkpoints each block's tail only (JAX
    ``trunk_apply``'s tiers, picked by ``train/step.py:resolve_remat``). A
    checkpoint spans every shard, since the norm couples them.
    """
    seq = _whole(seq, xs)
    masks = [m.to(compute_dtype) for m in masks]
    counts = shard_counts(masks)
    outs = _input_layer(params, xs, masks, counts, compute_dtype)  # masked by the norm
    for i in range(len(params[0]["blocks"])):
        blocks = [p["blocks"][i] for p in params]
        kw = dict(seed=None if dropout_seed is None else fold_in(dropout_seed, i),
                  shard=dropout_shard)
        if remat is True and torch.is_grad_enabled():
            outs = checkpoint(resnet_block, blocks, outs, masks, counts, seq, **kw,
                              use_reentrant=False)
        else:
            outs = resnet_block(blocks, outs, masks, counts, seq,
                                remat_tail=remat == "save_conv", **kw)
    heads = []
    for p, out, m in zip(params, outs, masks):
        c_out = p["out_w"].shape[0]
        heads.append((out.float() @ p["out_w"].reshape(c_out, -1).T + p["out_b"]) * m.float())
    return gather_rows(heads)
