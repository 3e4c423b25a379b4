"""Hold the device times of the port's spans (``utils/obs.py``) against the
kernels that ``torch.profiler`` records, on one CUDA card.

    python3 scripts/span_check.py --out OUT/span_check [--cases long,batch]
    python3 scripts/span_check.py --out OUT/span_check --device cpu --toy   # no card

Cases (bf16, random weights at the published widths 512 / 128 / 16 blocks):
``long``, one seeded 3000 x 720 alignment (bucket 3000 x 736) through a held
``Folder``, ``-n 30 -m 100``; ``batch``, four batches of eight 256 x 250
alignments through ``BatchFolder(batch_size=8, max_inflight=2)``, ``-n 10
-m 100``. Each case, after a ``-n 1`` warm-up, runs one unit under
``obs.profile`` and reports:

  * alignment: each span's device start and end, on the profiler's time
    base, against the first and last device operation that the profiler
    ties to a launch the span's thread made inside the span, in us;
  * the profiler's device operations summed by the innermost span their
    launch fell in;
  * ``obs.device_breakdown`` of the profiled units: device time by stage,
    host gaps by label, and how much of each fold's device span they cover;
  * whether the profiler's own device and host times agree (the alignment
    holds the spans against the profiler's device times).

The sync counts and the idle share are the benchmark's (``bench_cuda``'s
traced run reports them beside the spans' wait counts and gaps).

Writes ``<out>.json`` and one merged Chrome trace per case
(``<out>_<case>.json``: kernels, host ops and spans); prints a summary.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dmpfold2_tpu_torch.engine.fold import Folder  # noqa: E402
from dmpfold2_tpu_torch.kernels import _build  # noqa: E402
from dmpfold2_tpu_torch.models.gruresnet import init_params  # noqa: E402
from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target  # noqa: E402
from dmpfold2_tpu_torch.utils import obs  # noqa: E402

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")
TOLERANCE_US = 50.0


def new_units(before: int) -> list:
    return [u for u in obs.tracer.units() if u["trace"] > before and u["done"]]


def last_trace() -> int:
    units = obs.tracer.units()
    return units[-1]["trace"] if units else 0


def _ts(host_ns: float, base: int) -> float:
    return (obs.tracer.wall_ns(host_ns) - base) / 1e3


def thread_ids(units: list, trace: dict, base: int) -> dict:
    """A span thread's native id -> the profiler's id for the thread (the
    profiler names a thread that ran no torch op under it by an id of its
    own): the thread whose copies to pageable memory, which block the call,
    lie inside the span thread's ``wait:*`` spans, matched greedily."""
    events = trace["traceEvents"]
    pageable = {e["args"]["correlation"] for e in events
                if e.get("cat") == "gpu_memcpy" and "Pageable" in e["name"]
                and "correlation" in e.get("args", {})}
    calls = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                   if e.get("cat") in LAUNCHES
                   and e.get("args", {}).get("correlation") in pageable)
    votes: Counter = Counter()
    for u in units:
        for s in u["spans"]:
            if s["name"].startswith("wait:") and s["t1"] is not None:
                h0, h1 = _ts(s["t0"], base), _ts(s["t1"], base)
                for t0, t1, tid in calls[bisect.bisect_left(calls, (h0,)):]:
                    if t0 > h1:
                        break
                    votes[s["tid"], tid] += t1 <= h1
    ids: dict = {}
    for (native, tid), n in votes.most_common():
        if n and native not in ids and tid not in ids.values():
            ids[native] = tid
    return ids


def profiler_clock(trace: dict) -> dict:
    """Whether the profiler's device times agree with its host times, which
    the spans share: no device operation starts before the call that
    launched it, and no device-to-host copy ends after its blocking call
    returned. Lags in us; ``consistent`` is false when either is broken by
    more than 1 us, and then the alignment reads the profiler's error."""
    events = trace["traceEvents"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in LAUNCHES and "correlation" in e.get("args", {})}
    starts, copies = [], []
    for e in events:
        call = calls.get(e.get("args", {}).get("correlation"))
        if e.get("cat") not in DEVICE_OPS or call is None:
            continue
        starts.append(e["ts"] - call["ts"])
        if "Device -> Pageable" in e["name"]:  # a copy the call waits for
            copies.append(e["ts"] + e.get("dur", 0.0) - (call["ts"] + call["dur"]))
    out = {"start_after_launch_us_min": min(starts, default=None),
           "ops_started_before_launch": sum(v < -1.0 for v in starts),
           "copy_end_after_return_us_max": max(copies, default=None)}
    out["consistent"] = (out["ops_started_before_launch"] == 0
                         and (out["copy_end_after_return_us_max"] or 0.0) <= 1.0)
    return out


def alignment(units: list, trace: dict) -> dict:
    """Each span's device times against the profiler's device operations
    launched inside it, and the operations summed by the innermost span
    (from host times alone). The first reads true only where
    :func:`profiler_clock` is consistent."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace["traceEvents"]
    ops = {e["args"]["correlation"]: e for e in events
           if e.get("cat") in DEVICE_OPS and "correlation" in e.get("args", {})}
    launches = sorted((e["tid"], e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in LAUNCHES and e.get("args", {}).get("correlation") in ops)
    by_tid: dict = defaultdict(list)
    for tid, ts, corr in launches:
        by_tid[tid].append((ts, corr))
    alias = thread_ids(units, trace, base)
    errors: dict = defaultdict(list)
    lags: dict = defaultdict(list)  # (device start - host open, device end - host close), us
    by_stage: dict = defaultdict(lambda: defaultdict(float))
    innermost: dict = {}  # correlation -> (depth, name) of the deepest span it was launched in
    for u in units:
        spans = [s for s in u["spans"] if s["t1"] is not None]
        depth = obs.tree_depths(spans)
        host = {s["id"]: (_ts(s["t0"], base), _ts(s["t1"], base)) for s in spans}
        for s in spans:
            h0, h1 = host[s["id"]]
            rows = by_tid.get(alias.get(s["tid"]), [])
            inside = [corr for _, corr in rows[bisect.bisect_left(rows, (h0, -1)):
                                             bisect.bisect_right(rows, (h1, float("inf")))]]
            if s["d0"] is not None:
                # the device reaches a span's start no earlier than the host opens it
                lags[s["name"]].append(((s["d0"] - s["t0"]) / 1e3, (s["d1"] - s["t1"]) / 1e3))
            if s["d0"] is not None and inside:
                first = min(ops[c]["ts"] for c in inside)
                last = max(ops[c]["ts"] + ops[c].get("dur", 0.0) for c in inside)
                errors[s["name"]].append((_ts(s["d0"], base) - first, _ts(s["d1"], base) - last))
            # the launches made inside this span and none deeper go to it
            for corr in inside:
                best = innermost.get(corr)
                if best is None or depth[s["id"]] > best[0]:
                    innermost[corr] = (depth[s["id"]], s["name"])
    for corr, (_, name) in innermost.items():
        op = ops[corr]
        by_stage[name][op["name"][:80]] += op.get("dur", 0.0) / 1e3
    summary = {}
    for name, pairs in sorted(errors.items()):
        starts = [abs(a) for a, _ in pairs]
        ends = [abs(b) for _, b in pairs]
        summary[name] = {"n": len(pairs), "start_us_median": statistics.median(starts),
                         "start_us_max": max(starts), "end_us_median": statistics.median(ends),
                         "end_us_max": max(ends),
                         "within_50us": sum(a <= TOLERANCE_US and b <= TOLERANCE_US
                                            for a, b in zip(starts, ends)) / len(pairs),
                         "first_op_minus_start_us_median": statistics.median(-a for a, _ in pairs)}
    for name, pairs in lags.items():
        summary.setdefault(name, {"n": len(pairs)}).update(
            open_lag_us_min=min(a for a, _ in pairs),
            open_lag_us_median=statistics.median(a for a, _ in pairs),
            close_lag_us_median=statistics.median(b for _, b in pairs))
    stages = {name: {"ms": round(sum(k.values()), 3),
                     "top": sorted(((n, round(t, 3)) for n, t in k.items()),
                                   key=lambda kv: -kv[1])[:6]}
              for name, k in by_stage.items()}
    return {"errors": summary, "ops_by_stage": stages}


def breakdown(units: list) -> dict:
    parts = [p for u in units for p in obs.device_breakdown(u)]
    stages: dict = defaultdict(float)
    gaps: dict = defaultdict(float)
    for p in parts:
        for k, v in p["stages"].items():
            stages[k] += v / 1e6 / len(parts)
        for k, v in p["gaps"].items():
            gaps[k] += v / 1e6 / len(parts)
    return {"folds": len(parts),
            "root_ms": statistics.fmean(p["root"] / 1e6 for p in parts) if parts else None,
            "covered_share": [round(p["covered"] / p["root"], 5) for p in parts],
            "stages_ms": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
            "gaps_ms": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
            "gap_ms_per_fold": [round(sum(p["gaps"].values()) / 1e6, 3) for p in parts]}


def run_case(case: str, params, device: str, toy: bool, out: str) -> dict:
    rng = np.random.default_rng(7)
    if case == "long":
        shape, iterations, minsteps = ((40, 50) if toy else (3000, 720)), 30, 100
        folder = Folder(params, device=device, precision="bf16")
        folder.fold(rng.integers(0, 22, shape).astype(np.uint8), iterations=1, minsteps=1)

        def unit():
            folder.fold(rng.integers(0, 22, shape).astype(np.uint8), iterations=iterations,
                        minsteps=minsteps)
    else:
        shape, iterations, minsteps, size = ((20, 30) if toy else (256, 250)), 10, 100, 8
        folder = BatchFolder(params, device=device, batch_size=size, precision="bf16",
                             max_inflight=2)

        def batches(n, its, steps):
            pending = [folder.fold_many_async(
                [Target(rng.integers(0, 22, shape).astype(np.uint8)) for _ in range(size)],
                its, steps) for _ in range(n)]
            for p in pending:
                p.wait()

        batches(2, 1, 1)

        def unit():
            batches(4, iterations, minsteps)
    mark = last_trace()
    trace_path = f"{out}_{case}.json"
    t0 = time.perf_counter()
    with obs.profile(trace_path):
        unit()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    units = new_units(mark)
    with open(trace_path) as fh:
        trace = json.load(fh)
    result = {"units": len(units), "profiled_s": wall, "breakdown": breakdown(units),
              "profiler_clock": profiler_clock(trace), **alignment(units, trace)}
    if case == "batch":
        result["queue_ms"] = [round((s["t1"] - s["t0"]) / 1e6, 3) for u in units
                              for s in u["spans"] if s["name"] == "batch.queue"]
        folder.close()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="path prefix of the outputs")
    ap.add_argument("--cases", default="long,batch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--toy", action="store_true", help="widths 32 / 16 / 2 and small shapes")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    widths = dict(width=32, cwidth=16, num_blocks=2) if args.toy else {}
    params = init_params(seed=0, **widths)
    if args.device == "cuda":
        _build.build()
    obs.tracer.enable()
    report = {"device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}
    for case in args.cases.split(","):
        report[case] = run_case(case, params, args.device, args.toy, args.out)
        r = report[case]
        print(f"{case}: gaps a fold {r['breakdown']['gap_ms_per_fold']} ms, covered "
              f"{r['breakdown']['covered_share']}; profiler clock {r['profiler_clock']}",
              flush=True)
        print(f"  device ops by the stage that launched them, ms: "
              f"{ {name: v['ms'] for name, v in r['ops_by_stage'].items()} }", flush=True)
        for name, e in r["errors"].items():
            if "start_us_median" in e:
                print(f"  {name}: n {e['n']} start |err| median {e['start_us_median']:.1f} max "
                      f"{e['start_us_max']:.1f} us, end median {e['end_us_median']:.1f} max "
                      f"{e['end_us_max']:.1f} us, within 50 us {e['within_50us']:.2f}; device "
                      f"start - host open min {e['open_lag_us_min']:.1f} median "
                      f"{e['open_lag_us_median']:.1f} us", flush=True)
    with open(args.out + ".json", "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k == "device"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
