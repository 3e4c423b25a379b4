"""Observability: structured per-target logs, throughput counters, profiling.

Counterpart of ``dmpfold2_tpu/utils/obs.py``:

  * ``log_target`` emits one JSON line per folded target (name, sizes,
    bucket, wall-clock, mean confidence) to stderr, or to the file named by
    ``DMPFOLD2_TPU_LOG`` (the variable both packages read, so one log
    configuration serves either);
  * ``Counters`` aggregates targets/s and residues/s across a streaming run;
    ``record`` takes a lock, since the serving dispatcher and finisher
    threads can both reach it; ``global_counters`` merges every process's
    counters in a process group;
  * ``profile`` wraps ``torch.profiler`` and writes a Chrome trace.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

_sink_broken = False


def _sink():
    path = os.environ.get("DMPFOLD2_TPU_LOG")
    if path:
        return open(path, "a")
    return sys.stderr


def log_target(name: str, nseqs: int, nres: int, bucket, seconds: float,
               mean_conf: float | None = None, **extra) -> None:
    record = {
        "event": "target_folded",
        "target": name,
        "nseqs": int(nseqs),
        "nres": int(nres),
        "bucket": list(bucket) if bucket is not None else None,
        "seconds": round(float(seconds), 4),
        "mean_conf": None if mean_conf is None else round(float(mean_conf), 4),
        "ts": time.time(),
    }
    record.update(extra)
    # logging never sinks the run: a bad DMPFOLD2_TPU_LOG path or a full disk
    # degrades to stderr (warned once), not to an exception in the fold loop
    global _sink_broken
    try:
        if _sink_broken:
            raise OSError("log sink previously failed")
        sink = _sink()
        print(json.dumps(record), file=sink, flush=True)
        if sink is not sys.stderr:
            sink.close()
    except OSError as exc:
        if not _sink_broken:
            print(f"dmpfold2_tpu_torch: log sink failed ({exc}); falling back to "
                  "stderr", file=sys.stderr)
            _sink_broken = True
        print(json.dumps(record), file=sys.stderr, flush=True)


@dataclass
class Counters:
    """Aggregate throughput counters for a streaming/folding run."""

    targets: int = 0
    residues: int = 0
    started: float = field(default_factory=time.time)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def record(self, nres: int) -> None:
        with self._lock:
            self.targets += 1
            self.residues += int(nres)

    @property
    def seconds(self) -> float:
        return time.time() - self.started

    def targets_per_s(self) -> float:
        return self.targets / max(self.seconds, 1e-9)

    @classmethod
    def merge(cls, counters) -> "Counters":
        """Aggregate several runs' counters (the earliest start wins)."""
        merged = cls()
        merged.started = min((c.started for c in counters), default=merged.started)
        for c in counters:
            merged.targets += c.targets
            merged.residues += c.residues
        return merged

    def summary(self) -> dict:
        return {
            "targets": self.targets,
            "residues": self.residues,
            "seconds": round(self.seconds, 3),
            "targets_per_s": round(self.targets_per_s(), 4),
        }


def global_counters(counters: Counters) -> Counters:
    """The whole process group's throughput: each process's (targets,
    residues, started) gathered and merged with :meth:`Counters.merge`.
    ``counters`` itself in a single process. A collective: every process
    calls it, from its main thread."""
    from ..parallel.mesh import replicate_result, world

    if world()[0] == 1:
        return counters
    rows = replicate_result([(counters.targets, counters.residues, counters.started)])
    merged = []
    for targets, residues, started in rows:
        c = Counters(targets=targets, residues=residues)
        c.started = started
        merged.append(c)
    return Counters.merge(merged)


@contextmanager
def profile(trace_path: str):
    """Profile the enclosed block (host, and the CUDA device when there is
    one) with ``torch.profiler`` and write a Chrome trace to ``trace_path``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        yield prof
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
