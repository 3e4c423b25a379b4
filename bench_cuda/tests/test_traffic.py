"""Each traffic mix: the same targets for a seed, other targets for another
seed, the same sizes for every seed, one bucket per batch mix."""

from __future__ import annotations

import numpy as np
import pytest

from bench_cuda import harness, yardstick

MIXES = ["pfam256-b8", "long3000x720"]
BIG_SEED = 2 ** 33 + 17


def _small(name):
    params = harness.traffic(name)
    if params["loop"] == "single":
        params.update(nseqs=[300, 300], nres=[72, 72], pool=4)  # the same code, a smaller array
    return params


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_targets(name):
    params = _small(name)
    a, b = params["module"].make(params, BIG_SEED), params["module"].make(params, BIG_SEED)
    assert len(a.alignments) == params["pool"]
    assert all(np.array_equal(x, y) for x, y in zip(a.alignments, b.alignments))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_targets_same_sizes(name):
    params = _small(name)
    a, b = params["module"].make(params, BIG_SEED), params["module"].make(params, BIG_SEED + 1)
    assert not all(np.array_equal(x, y) for x, y in zip(a.alignments, b.alignments))
    assert sorted(x.shape for x in a.alignments) == sorted(x.shape for x in b.alignments)


@pytest.mark.parametrize("name", MIXES)
def test_sizes_in_range_and_bucket(name):
    params = harness.traffic(name)
    shapes = params["module"].sizes(params, BIG_SEED)
    lo_s, hi_s = params["nseqs"]
    lo_r, hi_r = params["nres"]
    assert all(lo_s <= s <= hi_s and lo_r <= r <= hi_r for s, r in shapes)
    if params["loop"] == "batch":
        assert len({yardstick.bucket(*s) for s in shapes}) == 1


def test_batch_mix_across_buckets_is_refused():
    params = harness.traffic("pfam256-b8")
    params.update(nseqs=[100, 200])
    with pytest.raises(ValueError):
        params["module"].make(params, 1)
