"""GRU layers in plain PyTorch, numerically the gates of torch.nn.GRU.

Counterpart of ``dmpfold2_tpu/models/gru.py``. Gate order r, z, n along the
stacked 3H axis; ``h' = (1-z)*n + z*h`` with ``n = tanh(x_n + r*(h W_hn +
b_hn))``. Weights keep the JAX layout: ``wi`` (in, 3H), ``wh`` (H, 3H).

Masking: sequences are right-padded. A forward scan freezes the state once
``t >= valid_len``; a reverse scan holds it at zero there, so the first valid
step sees a fresh zero state as an unpadded reverse scan would.

These are the plain versions. The fold reaches the hand-written kernels
through ``kernels/rgru.py`` (whose biGRU stack, as the JAX package's
``kernels/rgru.py:bigru_stack_pallas``, is :func:`bigru_stack` with both
directions of a layer in one kernel launch) and ``kernels/vgru.py``; those
run the functions here only for CPU tensors.
Training runs the functions here on every device, differentiated by autograd,
as the JAX training path runs its scans (the kernels have no backward).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.dropout import dropout, fold_in


def gru_layer_params(gen: torch.Generator, input_size: int, hidden_size: int):
    """One GRU layer-direction, torch's default U(-1/sqrt(H), 1/sqrt(H))."""
    k = 1.0 / math.sqrt(hidden_size)

    def u(shape):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * k

    return {
        "wi": u((input_size, 3 * hidden_size)),
        "wh": u((hidden_size, 3 * hidden_size)),
        "bi": u((3 * hidden_size,)),
        "bh": u((3 * hidden_size,)),
    }


def bigru_stack_params(gen: torch.Generator, num_layers: int, input_size: int,
                       hidden_size: int):
    layers = []
    for layer_idx in range(num_layers):
        in_size = input_size if layer_idx == 0 else 2 * hidden_size
        layers.append({"fwd": gru_layer_params(gen, in_size, hidden_size),
                       "bwd": gru_layer_params(gen, in_size, hidden_size)})
    return layers


def unigru_stack_params(gen: torch.Generator, num_layers: int, input_size: int,
                        hidden_size: int):
    return [gru_layer_params(gen, input_size if i == 0 else hidden_size, hidden_size)
            for i in range(num_layers)]


def gates(xp: torch.Tensor, hp: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """New state from the input projection ``xp`` and recurrent ``hp`` (…, 3H)."""
    hidden = h.shape[-1]
    r = torch.sigmoid(xp[..., :hidden] + hp[..., :hidden])
    z = torch.sigmoid(xp[..., hidden:2 * hidden] + hp[..., hidden:2 * hidden])
    n = torch.tanh(xp[..., 2 * hidden:] + r * hp[..., 2 * hidden:])
    return (1.0 - z) * n + z * h


def _valid_vector(valid_len, batch: int, device) -> torch.Tensor:
    """(B,) int tensor of per-column lengths from a scalar or a vector."""
    return torch.as_tensor(valid_len, dtype=torch.int32, device=device).expand(batch)


def gru_scan_projected(wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor,
                       valid_len, *, reverse: bool = False) -> torch.Tensor:
    """The recurrence of one layer-direction over ``xproj = x @ wi + bi``.

    (T, B, 3H) -> (T, B, H). ``valid_len``: scalar or (B,) true lengths.
    """
    seq_len, batch, _ = xproj.shape
    hidden = wh.shape[0]
    keep_all = _valid_vector(valid_len, batch, xproj.device)[:, None]
    h = xproj.new_zeros((batch, hidden))
    out = [h] * seq_len
    for t in (reversed(range(seq_len)) if reverse else range(seq_len)):
        h_new = gates(xproj[t], h @ wh + bh, h)
        keep = t < keep_all
        h = torch.where(keep, h_new, torch.zeros_like(h_new) if reverse else h)
        out[t] = h
    return torch.stack(out)


def bigru_stack(layers, x: torch.Tensor, valid_len, *, dropout_rate: float = 0.0,
                seed: int | None = None, shard=None) -> torch.Tensor:
    """Multi-layer biGRU (T, B, C) -> (T, B, 2H), the JAX ``gru.bigru_stack``,
    differentiable (training; the fold's stack is ``kernels/rgru.py``'s).

    With a ``seed``, dropout of ``dropout_rate`` follows every layer but the
    last (torch's semantics), its mask drawn from ``fold_in(seed, layer)``;
    ``shard`` as ``ops.dropout.keep_mask`` takes it, along B.
    """
    out = x
    for layer_idx, layer in enumerate(layers):
        passes = []
        for direction, reverse in (("fwd", False), ("bwd", True)):
            p = layer[direction]
            xproj = torch.matmul(out, p["wi"]) + p["bi"]
            passes.append(gru_scan_projected(p["wh"], p["bh"], xproj, valid_len,
                                             reverse=reverse))
        out = torch.cat(passes, dim=-1)
        if seed is not None and dropout_rate > 0.0 and layer_idx < len(layers) - 1:
            out = dropout(out, dropout_rate, fold_in(seed, layer_idx), shard=shard, batch_axis=1)
    return out


def unigru_stack_final(layers, x: torch.Tensor, valid_len, remat_chunk: int = 0) -> torch.Tensor:
    """Multi-layer unidirectional GRU returning the final state of the last
    layer: (T, B, C) -> (B, H). Each column freezes past its own length
    ``valid_len`` (scalar or (B,)).

    The vertical MSA reduction (reference network.py:224-225 takes
    ``vgru(x)[0][-1]``). Layer 0 projects one row per step, so no (T, B, 3H)
    tensor is made. ``remat_chunk`` (training, with autograd on): checkpoint
    the rows in chunks of that many, so the backward keeps one chunk's
    activations and the states at chunk boundaries, for one more forward of
    each chunk (the JAX ``remat_chunk``).
    """
    seq_len, batch, _ = x.shape
    hidden = layers[0]["wh"].shape[0]
    valid = _valid_vector(valid_len, batch, x.device)[:, None]
    hs = tuple(x.new_zeros((batch, hidden)) for _ in layers)

    def rows(start: int, xc: torch.Tensor, *hs):
        hs = list(hs)
        for dt in range(xc.shape[0]):
            keep = start + dt < valid
            layer_in = xc[dt]
            for i, p in enumerate(layers):
                h_new = gates(layer_in @ p["wi"] + p["bi"], hs[i] @ p["wh"] + p["bh"], hs[i])
                hs[i] = torch.where(keep, h_new, hs[i])
                layer_in = hs[i]
        return tuple(hs)

    if remat_chunk and seq_len > remat_chunk and torch.is_grad_enabled():
        for start in range(0, seq_len, remat_chunk):
            hs = checkpoint(rows, start, x[start:start + remat_chunk], *hs, use_reentrant=False)
        return hs[-1]
    return rows(0, x, *hs)[-1]
