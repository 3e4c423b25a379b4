"""The control, the reference one precision down in the program's place,
fails the cell's limits where the program passes them."""

from __future__ import annotations

import pytest

from bench_cuda import check, runner
from bench_cuda.tests import toy


@pytest.mark.parametrize("cell", ["bf16-pfam256-b8", "bf16-long3000x720"])
def test_fp8_control_fails_where_the_program_passes(cell):
    out = runner.run(toy.spec(cell, control=True))
    assert out.correct, out.checks
    ok, shown = check.verdict(out.control, {k: v["limit"] for k, v in out.checks.items()})
    assert not ok, shown
