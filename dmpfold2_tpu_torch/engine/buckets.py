"""Shape buckets: pad (nseqs, nres) to a small set of shapes.

Counterpart of ``dmpfold2_tpu/engine/buckets.py``, with the same buckets: the
port pads to the same shapes as the JAX package, so padded results can be
compared with it position by position.
"""

from __future__ import annotations

import bisect

SEQ_BUCKETS = [16, 32, 64, 128, 256, 512, 768, 1024, 1536, 2048, 3000]
RES_BUCKETS = (
    list(range(32, 129, 8))         # 32..128 step 8
    + list(range(144, 257, 16))     # 144..256 step 16
    + list(range(288, 1025, 32))    # 288..1024 step 32
    + [1152, 1280, 1408, 1536]
)


def _round_up(value: int, buckets: list[int]) -> int:
    idx = bisect.bisect_left(buckets, value)
    if idx == len(buckets):
        return value  # beyond the largest bucket: use the exact size
    return buckets[idx]


def bucket_shape(nseqs: int, nres: int, enable: bool = True) -> tuple[int, int]:
    if not enable:
        return nseqs, nres
    return _round_up(nseqs, SEQ_BUCKETS), _round_up(nres, RES_BUCKETS)
