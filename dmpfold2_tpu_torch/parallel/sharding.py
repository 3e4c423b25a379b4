"""Residue-axis ("seq") sharding of the pair trunk: one target's (L, L)
maps split by rows over the devices of one mesh row.

Counterpart of ``dmpfold2_tpu/parallel/sharding.py``. JAX annotates its pair
tensors and leaves the partitioning to XLA; here the split, the halo
exchange and the reductions are explicit tensor functions, driven by one
process for the whole row. The mesh is an argument, never ambient state:
JAX's context manager exists because jit caches on the mesh, and PyTorch has
no such cache.

  * :func:`row_splits` cuts the padded length into row ranges that start on
    multiples of ``ROW_UNIT`` (16) rows, so that the conv kernel's 8-row
    tiles and the GEMM's 128-pixel tiles (at any width that is a multiple of
    8) fall where the unsharded launch puts them.
  * :class:`SeqShards` is a row's devices and that split.
  * :func:`scatter_rows` / :func:`gather_rows` move row blocks to and from
    the shards; :func:`exchange_halo` gives each shard its rows with the
    neighbours' edge rows around them (zero rows beyond the map, which is
    what a same-padded conv reads); :func:`reduce_sum` sums per-shard
    tensors on the first shard's device, in shard order, and hands the sum
    back to every shard.

Every cross-device move is a ``.to(device)`` of a tensor or of a slice of
one, so autograd carries gradients back across it (the halo's share of a
conv's input gradient returns to the neighbour's rows), and none of them
waits on the host. The features (the MSA one-hot, DCA) stay on the first
device: JAX also shards the MSA rows (``features/msa.py:48``), which saves
memory only at depths far beyond the bucket ladder's 3000 (the one-hot at
3000 x 2048 is 0.5 GB).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

ROW_UNIT = 16  # a shard's first row is a multiple of this


def row_splits(l_pad: int, n_seq: int) -> tuple[int, ...]:
    """Row bounds ``(0, r_1, ..., l_pad)`` of at most ``n_seq`` non-empty
    shards: each ``ceil(ceil(l_pad / 16) / n_seq) * 16`` rows, the last the
    rest (88 over 2: 48 + 40; over 3: 32 + 32 + 24). Fewer shards when
    ``l_pad`` leaves nothing for the last ones."""
    if l_pad < 1 or n_seq < 1:
        raise ValueError(f"row_splits: need l_pad >= 1 and n_seq >= 1 (got {l_pad}, {n_seq})")
    units = -(-l_pad // ROW_UNIT)
    per = -(-units // n_seq) * ROW_UNIT
    return tuple(range(0, l_pad, per)) + (l_pad,)


@dataclass(frozen=True)
class SeqShards:
    """One mesh row's devices and the row split of one padded length: shard
    ``k`` holds rows ``bounds[k] .. bounds[k + 1] - 1`` on ``devices[k]``.
    The first device is the leader, which runs everything that is not the
    pair trunk. A device may repeat (two shards on one card)."""

    devices: tuple
    bounds: tuple

    @classmethod
    def split(cls, devices, l_pad: int) -> "SeqShards":
        """The row ``devices`` over ``l_pad`` rows (:func:`row_splits`); a
        length too short for every device leaves the last ones out."""
        devices = tuple(torch.device(d) for d in devices)
        bounds = row_splits(l_pad, len(devices))
        return cls(devices[:len(bounds) - 1], bounds)

    @property
    def n(self) -> int:
        return len(self.devices)

    def rows(self, k: int) -> slice:
        return slice(self.bounds[k], self.bounds[k + 1])

    def replicate(self, make) -> list:
        """``make(device)`` once per distinct device, as a list per shard."""
        made: dict = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]


def scatter_rows(seq: SeqShards, x: torch.Tensor, axis: int = 1) -> list:
    """Each shard's rows of ``x`` along ``axis``, on its device."""
    return [x.narrow(axis, seq.bounds[k], seq.bounds[k + 1] - seq.bounds[k]).to(dev)
            for k, dev in enumerate(seq.devices)]


def gather_rows(parts: list, axis: int = 1) -> torch.Tensor:
    """The shards' row blocks joined in order on the first one's device (one
    block as it is)."""
    if len(parts) == 1:
        return parts[0]
    lead = parts[0].device
    return torch.cat([p.to(lead) for p in parts], dim=axis)


def exchange_halo(parts: list, halo: int, axis: int = 1) -> list:
    """Each shard's rows along ``axis`` with ``halo`` rows before and after
    them: the neighbours' edge rows (from as many shards as hold them), zero
    rows beyond the map. Shard k's result has ``rows_k + 2 halo`` rows, on
    its device."""
    sizes = [p.shape[axis] for p in parts]
    starts = [sum(sizes[:k]) for k in range(len(parts))]
    total = sum(sizes)
    out = []
    for k, part in enumerate(parts):
        lo, hi = starts[k] - halo, starts[k] + sizes[k] + halo
        pieces = []
        if lo < 0:
            pieces.append(_zero_rows(part, -lo, axis))
        for j, other in enumerate(parts):
            a, b = max(lo, starts[j]), min(hi, starts[j] + sizes[j])
            if a < b:
                pieces.append(other.narrow(axis, a - starts[j], b - a).to(part.device))
        if hi > total:
            pieces.append(_zero_rows(part, hi - total, axis))
        out.append(torch.cat(pieces, dim=axis))
    return out


def _zero_rows(like: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    shape = list(like.shape)
    shape[axis] = n
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def reduce_sum(parts: list) -> list:
    """The sum of per-shard tensors of one shape, added in shard order on the
    first shard's device, then copied back to each shard's device."""
    lead = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(lead)
    return [total.to(p.device) for p in parts]
