"""The frozen counts: equal to the program's own at the time they were
frozen, and to the figures the port's kernel table was measured against."""

from __future__ import annotations

import pytest

from bench_cuda import yardstick
from dmpfold2_tpu_torch.engine.buckets import bucket_shape
from dmpfold2_tpu_torch.utils import flops


@pytest.mark.parametrize("shape", [(256, 88, 10, 100), (256, 256, 10, 100), (3000, 736, 30, 100)])
def test_fold_flops_frozen(shape):
    assert yardstick.fold_flops(*shape) == flops.fold_flops(*shape)


def test_kernel_bounds_match_the_kernel_table():
    f, b = yardstick.conv5x5_launch(8, 256)
    assert f == pytest.approx(1.72e12, rel=2e-3)
    assert yardstick.bound_s(f, b, yardstick.PEAK_BF16_TENSOR) * 1e3 == pytest.approx(1.737,
                                                                                      abs=5e-4)
    f, b = yardstick.vgru_launch(3000, 736)
    assert yardstick.bound_s(f, b, yardstick.PEAK_FP32_FLOPS) * 1e3 == pytest.approx(155.5,
                                                                                     abs=0.05)


def test_buckets_frozen():
    for nseqs in (1, 17, 129, 256, 257, 2999, 3000, 4000):
        for nres in (5, 33, 81, 88, 241, 256, 720, 1536, 2000):
            assert yardstick.bucket(nseqs, nres) == bucket_shape(nseqs, nres)
