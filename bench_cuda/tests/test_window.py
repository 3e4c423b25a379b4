"""The window loop at toy widths on the CPU, through to the last line."""

from __future__ import annotations

import json

import pytest

from bench_cuda import check, harness, runner
from bench_cuda.tests import toy

CELLS = ["bf16-pfam256-b8", "bf16-long3000x720"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(cell, trace):
    spec = toy.spec(cell, trace=trace)
    out = runner.run(spec)
    assert out.correct, out.checks
    assert out.units > 0 and out.attempted >= out.units and out.failed == 0
    man = harness.manifest(toy.ROOT)
    entries = harness.metrics_of(man, cell, "per_layer" if trace else "end_to_end")
    ctx = runner.context(spec, out)
    values = {m["name"]: harness.reader(m["name"])(ctx) for m in entries}
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = json.loads(json.dumps(harness.result_line(
        entries, values, correct=out.correct, attempted=out.attempted, failed=out.failed,
        device=device, checks=out.checks)))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["checks"]) == set(check.NUMBERS)
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    if not trace:
        # every end-to-end metric a CPU run can give (none of the device's)
        assert set(line["metrics"]) == {m["name"] for m in entries}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        # the syncs and spans are the card's: a CPU run reads the MFU alone
        assert {k for k in line["metrics"]} <= {m["name"] for m in entries}
        assert any(k.startswith("mfu") for k in line["metrics"])


def test_same_seed_same_first_answers():
    a = runner.run(toy.spec("bf16-pfam256-b8", seed=77, precision="fp32"))
    b = runner.run(toy.spec("bf16-pfam256-b8", seed=77, precision="fp32"))
    assert a.numbers == b.numbers


@pytest.mark.parametrize("cell", CELLS)
def test_fp32_engine_passes_the_check(cell):
    """The check's fp32 paths (cuDNN-style trunk layers, the eigh MDS held by
    its backward error) on the fp32 engine, under the cell's limits."""
    out = runner.run(toy.spec(cell, precision="fp32"))
    assert out.correct, out.checks
