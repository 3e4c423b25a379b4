"""Dropout with masks drawn from integer seeds.

Training draws its dropout masks (the trunk blocks, the residue GRUs) from a
``torch.Generator`` seeded inside the region that uses them, from an integer
fixed before the region. ``torch.utils.checkpoint`` restores only the global
RNG state, so a mask drawn from an advancing generator would differ when a
checkpointed region is replayed in the backward, and the gradients would be
silently wrong; a seed replays the same mask. :func:`fold_in` derives one
seed from another and an index, as ``jax.random.fold_in`` derives keys (the
bits differ from JAX's).
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64's mixer)."""
    z = (seed + (data + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def keep_mask(seed: int, shape, rate: float, device, shard=None,
              batch_axis: int = 0, rows=None) -> torch.Tensor:
    """Bool mask of ``shape``, each entry kept with probability 1 - ``rate``;
    with ``shard=(offset, total)`` the rows ``offset ..`` along ``batch_axis``
    of the mask of the global shape (``total`` rows), and with
    ``rows=(offset, total)`` likewise along axis 1 (a map's rows under
    residue-axis sharding): the slice of the unsharded draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cuts = [(axis, cut) for axis, cut in ((batch_axis, shard), (1, rows)) if cut is not None]
    full = list(shape)
    for axis, (_, total) in cuts:
        full[axis] = total
    keep = torch.rand(full, generator=gen, device=device) < 1.0 - rate
    for axis, (offset, _) in cuts:
        keep = keep.narrow(axis, offset, shape[axis])
    return keep


def dropout(x: torch.Tensor, rate: float, seed: int, shape=None, shard=None,
            batch_axis: int = 0, rows=None) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` in ``x``'s dtype; ``shape`` (default
    ``x.shape``) broadcasts the mask, e.g. (B, 1, 1, C) for channelwise;
    ``shard``, ``batch_axis`` and ``rows`` as :func:`keep_mask` takes them."""
    keep = keep_mask(seed, x.shape if shape is None else shape, rate, x.device, shard, batch_axis,
                     rows)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
