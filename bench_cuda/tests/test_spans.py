"""The per-layer readers of the program's own spans (``bench_cuda/spans.py``
and its nine metrics) at toy widths on the CPU."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from bench_cuda import harness, runner, spans
from bench_cuda.tests import toy
from dmpfold2_tpu_torch.engine.fold import Folder
from dmpfold2_tpu_torch.models.gruresnet import init_params
from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target

NEW = {"queue_wait_ms.batch": "bf16-pfam256-b8", "features_span_ms.batch": "bf16-pfam256-b8",
       "trunk_pass_ms.batch": "bf16-pfam256-b8", "host_waits_per_batch.batch": "bf16-pfam256-b8",
       "features_span_ms.long": "bf16-long3000x720", "trunk_pass_ms.long": "bf16-long3000x720",
       "mds_ms.long": "bf16-long3000x720", "host_waits_per_fold.long": "bf16-long3000x720",
       "host_gap_ms.long": "bf16-long3000x720"}


@pytest.fixture(autouse=True)
def fresh():
    if not spans.TRACER.on:  # another module's test turned it off
        spans.TRACER.enable()
    spans.TRACER.clear()
    spans._memo.clear()
    yield
    spans._memo.clear()


@pytest.fixture(scope="module")
def params():
    return init_params(seed=0, width=32, cwidth=16, num_blocks=2)


def _alns(n, shape=(12, 30), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 22, shape).astype(np.uint8) for _ in range(n)]


def test_importing_the_helper_turns_the_programs_tracer_on():
    spans.TRACER.disable()
    importlib.reload(spans)
    assert spans.TRACER is not None and spans.TRACER.on


def test_units_leave_out_the_warm_up(params):
    folder = Folder(params, device="cpu")
    warm, *alns = _alns(3)
    folder.fold(warm, iterations=1, minsteps=1)
    for a in alns:
        folder.fold(a, iterations=2, minsteps=1)
    kept = spans.units({"loop": "single", "iterations": 2})
    assert len(kept) == 2 and len(spans.TRACER.units()) == 3
    assert all(sum(s["name"] == "trunk" for s in u["spans"]) == 3 for u in kept)
    assert spans.units({"loop": "batch", "iterations": 2}) is None  # no batch unit

    batcher = BatchFolder(params, device="cpu", batch_size=2)
    batcher.fold_many([Target(a) for a in _alns(2, seed=1)], iterations=1, minsteps=1)
    batcher.fold_many([Target(a) for a in _alns(4, seed=2)], iterations=2, minsteps=1)
    batcher.close()
    spans._memo.clear()
    kept = spans.units({"loop": "batch", "iterations": 2})
    assert [u["name"] for u in kept] == ["batch", "batch"]


def test_readers_return_none_without_a_tracer(monkeypatch):
    monkeypatch.setattr(spans, "TRACER", None)
    for name, cell in NEW.items():
        loop = "batch" if cell.endswith("b8") else "single"
        assert harness.reader(name)({"loop": loop, "iterations": 10}) is None, name


def test_device_readers_read_nothing_on_the_cpu_and_counts_do(params):
    """On the CPU a span has no device time: the device readers give None;
    the wait count and the queue wait read the host."""
    folder = Folder(params, device="cpu")
    for a in _alns(2):
        folder.fold(a, iterations=1, minsteps=1)
    ctx = {"loop": "single", "iterations": 1}
    for name in ("features_span_ms.long", "trunk_pass_ms.long", "mds_ms.long",
                 "host_gap_ms.long"):
        assert harness.reader(name)(ctx) is None, name
    # upload 2, reweight 1, sizes 2, eigh 2 (one a pass), fetch 2
    assert harness.reader("host_waits_per_fold.long")(ctx) == 9.0
    assert harness.reader("host_waits_per_batch.batch")(ctx) is None  # not the batch loop


def test_traced_toy_run_reads_the_host_metrics():
    spec = toy.spec("bf16-pfam256-b8", trace=True)
    out = runner.run(spec)
    assert out.correct, out.checks
    ctx = runner.context(spec, out)
    queue = harness.reader("queue_wait_ms.batch")(ctx)
    waits = harness.reader("host_waits_per_batch.batch")(ctx)
    # upload 2, reweight 2 (one a target), sizes 2, eigh 3 (one a pass), fetch 2
    assert queue is not None and queue >= 0.0 and waits == 11.0
    assert harness.reader("features_span_ms.batch")(ctx) is None


def test_manifest_holds_the_nine_readers():
    man = harness.manifest(toy.ROOT)
    entries = {m["name"]: m for m in man["per_layer"]}
    for name, cell in NEW.items():
        m = entries[name]
        assert m["workloads"] == [cell] and m["better"] == "lower"
        assert m["source"] in ("program_span", "program_counter")
        assert name in {e["name"] for e in harness.metrics_of(man, cell, "per_layer")}
        assert callable(harness.reader(name))
    assert list(entries)[-len(NEW):] == list(NEW)  # appended after the accepted ones
