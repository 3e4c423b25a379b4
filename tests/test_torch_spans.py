"""The port's span tracer (``utils/obs.py``: ``tracer``, ``span``, ``wait``,
``unit``, ``device_breakdown``, ``profile``) on toy CPU folds, and the
repaired ``Counters`` clock and batch log line.

On the CPU a span has host times only; the device path (CUDA events read
against the clock anchors) runs here with a stand-in event class.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dmpfold2_tpu_torch.engine.buckets import bucket_shape
from dmpfold2_tpu_torch.engine.fold import Folder
from dmpfold2_tpu_torch.models.gruresnet import init_params
from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target
from dmpfold2_tpu_torch.utils import obs

SHAPES = [(8, 20), (12, 25), (6, 20), (10, 40), (20, 22)]


@pytest.fixture(scope="module")
def params():
    return init_params(seed=0, width=32, cwidth=16, num_blocks=2)


@pytest.fixture(scope="module")
def alns():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 22, s).astype(np.uint8) for s in SHAPES]


@pytest.fixture(autouse=True)
def tracer():
    obs.tracer.disable()
    obs.tracer.clear()
    yield obs.tracer
    obs.tracer.disable()
    obs.tracer.clear()
    obs.tracer.capacity = obs.UNIT_CAPACITY


def _names(unit):
    out: dict = {}
    for s in unit["spans"]:
        out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def _expected(nloops, batch=1):
    want = {"fold": 1, "features": 1, "embed": 1, "pair_input": 1, "trunk": nloops + 1,
            "mds": nloops + 1, "coord": nloops + 1, "recycle": nloops, "refine": 2,
            "complete": 1, "wait:upload": 2, "wait:sizes": 2, "wait:reweight": batch,
            "wait:eigh": nloops + 1, "wait:fetch": 2}
    return {k: v for k, v in want.items() if v}


def _check_tree(spans, root_id):
    """Parents: each stage under the fold, each later pass under its recycle,
    each wait under the stage that waits."""
    by_id = {s["id"]: s for s in spans}
    recycles = {s["index"]: s["id"] for s in spans if s["name"] == "recycle"}
    parent_of = {"features": "fold", "embed": "fold", "pair_input": "fold", "refine": "fold",
                 "complete": "fold", "recycle": "fold", "wait:upload": "fold",
                 "wait:fetch": "fold", "wait:sizes": "embed", "wait:reweight": "features",
                 "wait:eigh": "mds"}
    for s in spans:
        if s["id"] == root_id:
            continue
        parent = by_id[s["parent"]]
        if s["name"] in ("trunk", "mds", "coord"):
            want = root_id if s["index"] == 0 else recycles[s["index"]]
            assert s["parent"] == want, s
        else:
            assert parent["name"] == parent_of[s["name"]], (s, parent)
        assert parent["t0"] <= s["t0"] <= s["t1"] <= parent["t1"]


@pytest.mark.parametrize("nloops", [0, 2])
def test_fold_emits_each_stage_once_per_pass(params, alns, tracer, nloops):
    tracer.enable()
    folder = Folder(params, device="cpu")
    folder.fold(alns[0], iterations=nloops, minsteps=2)
    folder.fold(alns[1], iterations=nloops, minsteps=2)
    units = tracer.units()
    assert [u["name"] for u in units] == ["fold", "fold"] and all(u["done"] for u in units)
    assert units[0]["trace"] != units[1]["trace"]
    for u in units:
        assert _names(u) == _expected(nloops)
        root = next(s for s in u["spans"] if s["parent"] is None)
        assert root["name"] == "fold"
        _check_tree(u["spans"], root["id"])
        assert [s["index"] for s in u["spans"] if s["name"] == "trunk"] == list(range(nloops + 1))
        waits = {k: v for k, v in u["counters"].items() if k.startswith("wait:")}
        assert waits == {k: v for k, v in _expected(nloops).items() if k.startswith("wait:")}
        assert u["counters"]["waits"] == sum(waits.values())
        assert all(s["d0"] is None for s in u["spans"])  # no device on the CPU


def test_batch_spans_carry_one_trace_id_per_batch(params, alns, tracer):
    tracer.enable()
    folder = BatchFolder(params, device="cpu", batch_size=2)
    folder.fold_many([Target(a) for a in alns], iterations=1, minsteps=2)
    folder.close()
    units = tracer.units()
    groups: dict = {}
    for a in alns:
        groups[bucket_shape(*a.shape)] = groups.get(bucket_shape(*a.shape), 0) + 1
    n_batches = sum(-(-n // 2) for n in groups.values())
    assert [u["name"] for u in units] == ["batch"] * n_batches
    assert len({u["trace"] for u in units}) == n_batches
    for u in units:
        names = _names(u)
        root = next(s for s in u["spans"] if s["parent"] is None)
        size = root["size"]
        assert names == {**_expected(1, batch=2), "batch": 1, "batch.queue": 1}
        by_id = {s["id"]: s for s in u["spans"]}
        queue = next(s for s in u["spans"] if s["name"] == "batch.queue")
        fold_span = next(s for s in u["spans"] if s["name"] == "fold")
        assert queue["parent"] == fold_span["parent"] == root["id"]
        assert fold_span["thread"] != root["thread"]  # the worker's
        assert queue["t1"] <= fold_span["t0"] and fold_span["t1"] <= root["t1"]
        _check_tree([s for s in u["spans"] if s["name"] not in ("batch", "batch.queue")],
                    fold_span["id"])
        assert all(by_id[s["parent"]]["thread"] == s["thread"] for s in u["spans"]
                   if s["name"] not in ("batch", "batch.queue", "fold"))
        assert size in (1, 2)


def test_outputs_are_bitwise_equal_with_tracing_on_and_off(params, alns, tracer):
    folder = Folder(params, device="cpu")
    batcher = BatchFolder(params, device="cpu", batch_size=2)
    targets = [Target(a) for a in alns]
    off = folder.fold(alns[3], iterations=2, minsteps=3), batcher.fold_many(targets, 1, 3)
    tracer.enable()
    on = folder.fold(alns[3], iterations=2, minsteps=3), batcher.fold_many(targets, 1, 3)
    batcher.close()
    assert tracer.units()
    for a, b in zip(off[0], on[0]):
        np.testing.assert_array_equal(a, b)
    for ra, rb in zip(off[1], on[1]):
        for a, b in zip(ra, rb):
            np.testing.assert_array_equal(a, b)


def test_off_stores_nothing_and_makes_no_cuda_event(params, alns, tracer, monkeypatch):
    made = []

    class CountingEvent:
        def __init__(self, *args, **kw):
            made.append(args)

    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    assert obs.span("trunk") is obs.wait("eigh") is obs.unit("fold") is obs._NOOP
    Folder(params, device="cpu").fold(alns[0], iterations=1, minsteps=2)
    batcher = BatchFolder(params, device="cpu", batch_size=2)
    batcher.fold_many([Target(a) for a in alns[:3]], iterations=1, minsteps=2)
    batcher.close()
    assert tracer.units() == [] and tracer.dropped == 0 and made == []


def test_span_lines_up_with_a_profiler_marker(tracer):
    """A span's host times, on the profiler's time base, hold the
    ``record_function`` marker opened inside it, to within 1 ms."""
    tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.unit("fold"):
            time.sleep(0.002)
            with obs.span("trunk", index=0):
                with record_function("marker"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    time.sleep(0.003)
            time.sleep(0.002)
    marker = next(e for e in prof.events() if e.name == "marker")
    sp = next(s for s in tracer.units()[0]["spans"] if s["name"] == "trunk")
    base = prof.profiler.kineto_results.trace_start_ns()  # the events' time base, wall ns
    start, end = ((tracer.wall_ns(sp[k]) - base) / 1e3 for k in ("t0", "t1"))
    assert abs(marker.time_range.start - start) < 1000.0
    assert abs(marker.time_range.end - end) < 1000.0
    assert start - 1000.0 <= marker.time_range.start <= marker.time_range.end <= end + 1000.0


def test_buffer_keeps_the_newest_units_and_counts_the_dropped(tracer):
    tracer.capacity = 3
    tracer.enable()
    for _ in range(5):
        with obs.unit("fold"), obs.span("features"):
            pass
    units = tracer.units()
    assert len(units) == 3 and tracer.dropped == 2
    traces = [u["trace"] for u in units]
    assert traces == sorted(traces) and traces[0] > min(traces) - 3
    with obs.unit("fold"):
        pass
    assert tracer.dropped == 3 and tracer.units()[-1]["trace"] == traces[-1] + 1


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: the time it is recorded, plus a
    device lag the test sets."""

    lag_ns = 0

    def __init__(self, **kw):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns() + _FakeEvent.lag_ns

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def test_device_events_convert_to_the_host_clock(tracer, monkeypatch):
    """CUDA events read against the anchors land on the host clock: with
    the device 2 ms behind the host, each span's device times trail its
    host times by 2 ms, and the wait's device time is a gap."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "lag_ns", 0)
    tracer.enable()
    _FakeEvent.lag_ns = 2_000_000
    with obs.unit("fold", torch.device("cuda", 0)):
        with obs.span("mds", index=0):
            time.sleep(0.004)
            with obs.wait("eigh"):
                time.sleep(0.003)
        with obs.span("coord", index=0):
            time.sleep(0.004)
    _FakeEvent.lag_ns = 0
    unit = tracer.units()[0]
    for s in unit["spans"]:
        for d, t in ((s["d0"], s["t0"]), (s["d1"], s["t1"])):
            assert abs(d - t - 2e6) < 0.5e6, s
    (part,) = obs.device_breakdown(unit)
    assert set(part["stages"]) == {"mds", "coord"}
    wait = next(s for s in unit["spans"] if s["name"] == "wait:eigh")
    # the stream idle across the wait
    assert abs(sum(part["gaps"].values()) - (wait["t1"] - wait["t0"])) < 0.5e6
    assert abs(part["covered"] - part["root"]) < 1e3


def test_device_breakdown_labels_gaps_by_the_innermost_host_span():
    """Stages get their own device time (each instant to the innermost span
    over it); the stream's idle time between stages and across a wait goes
    to the innermost host span open at its middle. The device reaches a
    stage's start when the host opens it, unless the stream is busy."""
    def sp(i, name, parent, t0, t1, d0, d1):
        return {"id": i, "name": name, "parent": parent, "thread": "main", "t0": t0, "t1": t1,
                "d0": d0, "d1": d1}

    unit = {"trace": 1, "name": "fold", "done": True, "counters": {}, "spans": [
        sp(1, "fold", None, 0, 100, 0, 120),
        sp(2, "features", 1, 0, 20, 0, 40),
        sp(3, "mds", 1, 50, 85, 50, 90),
        sp(4, "wait:eigh", 3, 58, 80, 60, 80),
        sp(5, "host_work", 1, 40, 49, None, None),
        sp(6, "coord", 1, 95, 110, 95, 120),
    ]}
    (part,) = obs.device_breakdown(unit)
    assert part["root"] == 120
    assert part["stages"] == {"features": 40, "mds": 20, "coord": 25}
    # 40-50: the host was in host_work at 45; 60-80: in the wait; 90-95: under fold alone
    assert part["gaps"] == {"host_work": 10, "wait:eigh": 20, "fold": 5}
    assert part["covered"] == part["root"]


def test_profile_writes_spans_into_the_profilers_trace(tmp_path, tracer):
    tracer.enable()
    path = tmp_path / "trace" / "fold.json"
    with obs.profile(str(path)):
        with obs.unit("fold"), obs.span("features"):
            torch.ones(8, 8).sum()
    trace = json.loads(path.read_text())
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "dmpfold2_span"]
    assert {e["name"] for e in spans} == {"fold", "features"}
    ops = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") != "dmpfold2_span"]
    assert ops
    lo = min(e["ts"] for e in spans)
    # the profiler's ops and the spans share one time base
    assert any(abs(e["ts"] - lo) < 1e6 for e in ops)


def test_trace_env_turns_the_tracer_on_and_exports_at_exit(tmp_path, tracer, monkeypatch):
    path = tmp_path / "spans.json"
    registered = []
    monkeypatch.setattr(obs.atexit, "register", lambda fn, *a: registered.append((fn, a)))
    monkeypatch.delenv(obs.TRACE_ENV, raising=False)
    assert obs.trace_from_env() is None and not tracer.on
    monkeypatch.setenv(obs.TRACE_ENV, str(path))
    assert obs.trace_from_env() == str(path) and tracer.on
    with obs.unit("fold"), obs.span("embed"):
        pass
    (fn, args), = registered
    fn(*args)
    events = json.loads(path.read_text())["traceEvents"]
    assert sorted(e["name"] for e in events if e["ph"] == "X") == ["embed", "fold"]


def test_counters_clock_starts_at_the_first_dispatch(params, alns):
    counters = obs.Counters()
    assert counters.started is None and counters.seconds == 0.0
    folder = BatchFolder(params, device="cpu", batch_size=2, counters=counters)
    time.sleep(0.3)  # set-up: not in the rate
    before = time.time()
    folder.fold_many([Target(a) for a in alns[:2]], iterations=0, minsteps=1)
    folder.close()
    assert counters.started >= before and counters.targets == 2
    assert counters.seconds < time.time() - before + 1e-3
    counters.reset()
    assert (counters.targets, counters.started) == (0, None)
    merged = obs.Counters.merge([counters, obs.Counters()])
    assert merged.started is None and merged.summary()["targets_per_s"] == 0.0


def test_verbose_batch_line_reports_queue_and_fold_apart(params, alns, tmp_path, monkeypatch):
    logfile = tmp_path / "targets.jsonl"
    monkeypatch.setenv("DMPFOLD2_TPU_LOG", str(logfile))
    folder = BatchFolder(params, device="cpu", batch_size=2, verbose=True, max_inflight=1)
    folder.fold_many([Target(a) for a in alns[:3]], iterations=0, minsteps=1)
    folder.close()
    lines = [json.loads(line) for line in logfile.read_text().splitlines()]
    assert len(lines) == 3
    for line in lines:
        assert line["queue_s"] >= 0.0 and line["fold_s"] > 0.0
        assert line["seconds"] == pytest.approx(line["fold_s"] / 2, abs=1e-4)
        # dispatch to retire holds the wait for a worker and the fold
        assert line["batch_seconds"] >= line["queue_s"] + line["fold_s"] - 2e-4
