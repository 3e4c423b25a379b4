"""The memory peak a run reports is the program's: the copies that the check
keeps of the timed path's stages are left out of it."""

from __future__ import annotations

import pytest
import torch

from bench_cuda import capture

MIB = 1 << 20


@pytest.mark.gpu
def test_kept_copies_are_left_out_of_the_peak():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    rec = capture.Recorder()
    state = torch.empty(64 * MIB, dtype=torch.uint8, device=dev)
    kept = [rec.keep(state) for _ in range(4)]           # 256 MiB of copies
    del state
    later = torch.empty(96 * MIB, dtype=torch.uint8, device=dev)  # the program's own peak
    del later
    program, total = rec.peaks(dev)
    assert program - base == 96 * MIB
    assert total - base == (256 + 96) * MIB
    assert all(k.is_cuda for k in kept)


def test_on_the_cpu_the_copies_are_plain():
    rec = capture.Recorder()
    t = torch.arange(6.0)
    c = rec.keep(t)
    assert torch.equal(c, t) and c.data_ptr() != t.data_ptr()
