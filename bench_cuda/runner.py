"""One run of one cell: set-up, the measured window, the traced extras, the
reference's check. Everything cell-specific comes in as data: the
configuration, the traffic parameters and the limits."""

from __future__ import annotations

import contextlib
import gc
import math
import random
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from . import capture, check, tracing, weights, yardstick


@dataclass
class Spec:
    cell: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = field(default_factory=time.perf_counter)
    control: bool = False     # also read the control's numbers (calibration only)


@dataclass
class Outcome:
    setup_s: float
    window_s: float
    units: int                # batches or folds completed in the window
    attempted: int            # targets whose results were due in the window
    failed: int               # of those, targets that came back without a result
    flops: float              # frozen FLOPs of the completed targets
    memory_peak_bytes: int    # the program's own, the check's copies left out
    memory_with_copies: int   # the card's peak with the check's copies
    correct: bool
    checks: dict
    syncs: int | None = None
    features_ms: list | None = None
    profile: dict | None = None
    numbers: dict | None = None
    control: dict | None = None
    setup_parts: dict | None = None


def _sample(seed: int, distinct: int, count: int) -> list:
    """``count`` indices among the first ``distinct`` units, drawn from the seed."""
    rng = random.Random(seed * 7919 + 13)
    return sorted(rng.sample(range(distinct), min(count, distinct)))


def _flops(alns, traffic) -> float:
    return sum(yardstick.fold_flops(*yardstick.bucket(*a.shape), traffic.iterations,
                                    traffic.minsteps) for a in alns)


def run(spec: Spec) -> Outcome:
    """Set up, measure, check: the :class:`Outcome` of one run."""
    from dmpfold2_tpu_torch.engine.fold import Folder
    from dmpfold2_tpu_torch.kernels import _build
    from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target

    dev = torch.device(spec.device)
    cfg, precision = spec.cfg, spec.cfg["precision"]
    parts: dict = {"imports": time.perf_counter() - spec.t_start}
    mark = [time.perf_counter()]

    def done(part: str) -> None:
        now = time.perf_counter()
        parts[part] = now - mark[0]
        mark[0] = now

    traffic = spec.traffic["module"].make(spec.traffic, spec.seed)
    done("traffic")
    params = weights.make(cfg, spec.seed, dev)
    done("weights")
    if dev.type == "cuda":
        _build.build()
    done("kernels")
    batch = traffic.loop == "batch"
    if batch:
        engine = BatchFolder(params, device=dev, batch_size=traffic.batch_size,
                             precision=precision, max_inflight=traffic.max_inflight,
                             dca_method=cfg["dca_method"])
    else:
        engine = Folder(params, device=dev, precision=precision, dca_method=cfg["dca_method"])
    del params
    done("engine")
    rng = random.Random(spec.seed * 104729 + 1)
    layer_passes = {0} | ({rng.randint(1, traffic.iterations)} if traffic.iterations else set())
    recorder = capture.Recorder(layer_passes)
    recorder.install()
    units_in_pool = max(1, len(traffic.alignments) // traffic.batch_size)
    sampled = _sample(spec.seed, min(units_in_pool, int(spec.traffic["check_within"])),
                      int(spec.traffic["check_units"]))
    results: dict = {}   # key -> (alignments, served results) of the sampled units
    try:
        # set-up: the cell's own shapes, once each on every stream in flight
        gen = traffic.batches()
        if batch:
            warm = [engine.fold_many_async([Target(a) for a in next(gen)],
                                           traffic.warmup_iterations, traffic.warmup_minsteps)
                    for _ in range(traffic.max_inflight)]
            for w in warm:
                w.wait()
        else:
            engine.fold(next(gen)[0], iterations=traffic.warmup_iterations,
                        minsteps=traffic.warmup_minsteps)
        done("warm-up")
        gen = traffic.batches()
        pool_batches = [next(gen) for _ in range(units_in_pool)]
        sampled_keys = {capture.batch_key(pool_batches[i][0]) for i in sampled}
        gen = traffic.batches()
        claimed: set = set()
        claim_lock = threading.Lock()  # the batch engine's workers claim from their threads

        def claim(key):
            with claim_lock:
                if key in sampled_keys and key not in claimed:
                    claimed.add(key)
                    return True
                return False

        recorder.claim = claim
        syncs = tracing.SyncCounter() if spec.trace else None
        spans = capture.FeatureSpans() if spec.trace else None
        if spans is not None:
            spans.install()
        profile = {} if spec.trace and dev.type == "cuda" else None
        t0 = time.perf_counter()
        setup_s = t0 - spec.t_start
        parts["rest"] = t0 - mark[0]
        stats = dict(units=0, attempted=0, failed=0, flops=0.0)
        if batch:
            pending: deque = deque()

            def submit():
                alns = next(gen)
                pending.append((alns, engine.fold_many_async([Target(a) for a in alns],
                                                             traffic.iterations,
                                                             traffic.minsteps)))

            def retire(count: bool):
                alns, handle = pending.popleft()
                served = handle.wait()
                key = capture.batch_key(alns[0])
                if key in sampled_keys and key not in results:
                    results[key] = (alns, served)
                if count:
                    stats["units"] += 1
                    stats["attempted"] += len(alns)
                    stats["failed"] += sum(r is None for r in served)
                    stats["flops"] += _flops(alns, traffic)

            for _ in range(1 + traffic.ahead):
                submit()
            with syncs.counting() if syncs else contextlib.nullcontext():
                while True:
                    retire(count=True)
                    t_end = time.perf_counter()
                    if t_end - t0 >= spec.seconds:
                        break
                    submit()
            if spans is not None:
                spans.uninstall()
            if profile is not None:
                # the batches in flight, then trace_units more, each return followed by a
                # dispatch, so the profiled window ends with the pipeline full
                with tracing.profiled(profile):
                    for _ in range(len(pending) + int(spec.traffic["trace_units"])):
                        retire(count=False)
                        submit()
            while pending:
                retire(count=False)
            engine.close()
        else:
            def fold_one(aln: np.ndarray):
                key = capture.batch_key(aln)
                if claim(key):
                    recorder.start(key)
                try:
                    coords, confs = engine.fold(aln, iterations=traffic.iterations,
                                                minsteps=traffic.minsteps)
                finally:
                    recorder.stop()
                if key in sampled_keys and key not in results:
                    results[key] = ([aln], [(coords, confs)])

            with syncs.counting() if syncs else contextlib.nullcontext():
                while True:
                    aln = next(gen)[0]
                    fold_one(aln)
                    stats["units"] += 1
                    stats["attempted"] += 1
                    stats["flops"] += _flops([aln], traffic)
                    t_end = time.perf_counter()
                    if t_end - t0 >= spec.seconds:
                        break
            if spans is not None:
                spans.uninstall()
            if profile is not None:
                with tracing.profiled(profile):
                    for _ in range(int(spec.traffic["trace_units"])):
                        fold_one(next(gen)[0])
        window_s = t_end - t0
        peak, with_copies = recorder.peaks(dev) if dev.type == "cuda" else (0, 0)
        features_ms = spans.ms() if spans is not None and dev.type == "cuda" else None
    finally:
        recorder.uninstall()
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge(spec, traffic, recorder.records, results, len(sampled))
    control = (judge(spec, traffic, recorder.records, results, len(sampled), control=True)
               if spec.control else None)
    correct, shown = check.verdict(numbers, spec.limits)
    return Outcome(setup_s=setup_s, window_s=window_s, units=stats["units"],
                   attempted=stats["attempted"], failed=stats["failed"], flops=stats["flops"],
                   memory_peak_bytes=int(peak), memory_with_copies=int(with_copies),
                   correct=correct and stats["failed"] == 0,
                   checks=shown, syncs=None if syncs is None else syncs.count,
                   features_ms=features_ms, profile=profile, numbers=numbers, control=control,
                   setup_parts=parts)


def judge(spec: Spec, traffic, records: list, results: dict, expected: int,
          control: bool = False) -> dict:
    """The check's numbers over every recorded unit (inf when one of the
    ``expected`` sampled units left no record or no served result)."""
    dev = torch.device(spec.device)
    judge_ = check.Judge(spec.cfg, weights.make(spec.cfg, spec.seed, dev), traffic.iterations,
                         traffic.minsteps, dev)
    readings = []
    with torch.inference_mode():
        for rec in records:
            if rec["key"] not in results:
                readings.append({k: math.inf for k in check.NUMBERS})
                continue
            alns, served = results[rec["key"]]
            if any(r is None for r in served):
                readings.append({k: math.inf for k in check.NUMBERS})
                continue
            try:
                readings.append(judge_.judge(rec, alns, served, control=control))
            except (IndexError, RuntimeError, ValueError) as exc:
                # a recorded state that does not fit its batch: not what was asked for
                print(f"bench_cuda: the check could not read a recorded fold: {exc}",
                      file=sys.stderr)
                readings.append({k: math.inf for k in check.NUMBERS})
    if len(readings) < expected:
        return {k: math.inf for k in check.NUMBERS}
    return check.worst(readings)



def context(spec: Spec, out: Outcome) -> dict:
    """What a metric's ``read(ctx)`` may read of a run."""
    t = spec.traffic
    l_pad = yardstick.bucket(t["nseqs"][1], t["nres"][1])[1]
    return {"cell": spec.cell, "loop": t["loop"], "precision": spec.cfg["precision"],
            "batch_size": int(t.get("batch_size", 1)), "l_pad": l_pad,
            "n_pad": yardstick.bucket(t["nseqs"][1], t["nres"][1])[0],
            "iterations": int(t["iterations"]), "minsteps": int(t["minsteps"]),
            "cfg": spec.cfg, "setup_s": out.setup_s, "window_s": out.window_s,
            "units": out.units, "attempted": out.attempted, "failed": out.failed,
            "flops": out.flops, "peak_flops": yardstick.PEAKS[spec.cfg["precision"]],
            "syncs": out.syncs, "features_ms": out.features_ms, "profile": out.profile}
