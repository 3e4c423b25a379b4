"""Observability: structured per-target logs, throughput counters, spans,
profiling.

Counterpart of ``dmpfold2_tpu/utils/obs.py``:

  * ``log_target`` emits one JSON line per folded target (name, sizes,
    bucket, wall-clock, mean confidence) to stderr, or to the file named by
    ``DMPFOLD2_TPU_LOG`` (the variable both packages read, so one log
    configuration serves either);
  * ``Counters`` aggregates targets/s and residues/s across a streaming run;
    its clock starts at the first dispatch (``start``), so set-up is not in
    the rate; ``record`` takes a lock, since the serving dispatcher and
    finisher threads can both reach it; ``global_counters`` merges every
    process's counters in a process group;
  * ``tracer`` (:class:`Tracer`) records the stages of each fold as spans,
    on the host and on the device, on one clock (below); off by default;
  * ``profile`` wraps ``torch.profiler`` and writes a Chrome trace, with the
    tracer's spans in it when the tracer is on.

Spans. A unit is one batch of the batch engine (``batch``) or one
``Folder.fold`` (``fold``); it has a trace id and a tree of spans. A span
holds its name, its host start and end (``time.perf_counter_ns``), its
parent and, when the unit runs on a CUDA device, a pair of CUDA events
recorded on the current stream at its start and end: the device time of the
work it enqueued. The events are read only when the spans are read
(:meth:`Tracer.units`), so the fold gains no synchronisation. ``wait``
spans (``wait:<site>``) mark each place where the host waits on the device
and count it in the unit's counters. Off, ``span`` and ``wait`` are one
attribute test each and return a shared no-op; nothing is stored and no
event is made. Spans never open a ``torch.profiler.record_function``, which
would put an annotation on the device's timeline.

The clock. Host times are ``time.perf_counter_ns``. At ``enable`` (and at
each ``anchor``) the tracer pairs that clock with the wall clock, which is
``torch.profiler``'s time base, and, on each CUDA device, with a CUDA event
recorded on an idle device; a device event then converts to the host clock
by its elapsed time from the nearest anchor. So spans, kernels and host ops
share one time line: ``profile`` writes them into one Chrome trace.

``DMPFOLD2_TPU_TRACE=<path>`` turns the tracer on for the CLI and the
service (``trace_from_env``) and writes the spans as a Chrome trace to
``<path>`` at exit.
"""

from __future__ import annotations

import atexit
import bisect
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

_sink_broken = False
TRACE_ENV = "DMPFOLD2_TPU_TRACE"
CHROME_PID = 7_000_000  # the spans' two process rows in a Chrome trace: this and the next
UNIT_CAPACITY = 256  # units the tracer keeps; older ones are dropped and counted


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
    """Aggregate throughput counters for a streaming/folding run. The rate's
    clock starts at the first dispatch (:meth:`start`, or the first
    :meth:`record` when nothing called it), not at construction."""

    targets: int = 0
    residues: int = 0
    started: float | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def start(self) -> None:
        """Start the clock, once: the batch engine calls it at each dispatch."""
        if self.started is None:
            with self._lock:
                if self.started is None:
                    self.started = time.time()

    def reset(self) -> None:
        """Zero the counts and stop the clock (after a warm-up)."""
        with self._lock:
            self.targets = self.residues = 0
            self.started = None

    def record(self, nres: int) -> None:
        self.start()
        with self._lock:
            self.targets += 1
            self.residues += int(nres)

    @property
    def seconds(self) -> float:
        return 0.0 if self.started is None else time.time() - self.started

    def targets_per_s(self) -> float:
        return self.targets / max(self.seconds, 1e-9)

    @classmethod
    def merge(cls, counters) -> "Counters":
        """Aggregate several runs' counters (the earliest start wins)."""
        merged = cls()
        merged.started = min((c.started for c in counters if c.started is not None),
                             default=None)
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


# ---------------------------------------------------------------- spans

class _Noop:
    """The span of a tracer that is off, or of a thread outside any unit."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One timed stage. ``ev`` holds its CUDA events, recorded on ``stream``
    (its unit's on this thread), until they are read; ``dev`` then holds
    their times on the host clock (ns)."""

    __slots__ = ("id", "name", "parent", "unit", "thread", "tid", "attrs", "t0", "t1",
                 "device", "stream", "ev", "dev")

    def __init__(self, sid, name, parent, unit, device, stream, attrs, thread):
        self.id, self.name, self.parent, self.unit = sid, name, parent, unit
        self.device, self.stream, self.attrs = device, stream, attrs
        self.thread, self.tid = thread  # the thread's name and native id
        self.t0 = self.t1 = None
        self.ev = self.dev = None


class _Unit:
    __slots__ = ("trace", "name", "root", "spans", "counters")

    def __init__(self, trace, name):
        self.trace, self.name = trace, name
        self.root = None
        self.spans: list = []
        self.counters: dict = {}


class _Open:
    """A span made the thread's current one by ``with``; on exit it is
    closed (unless ``close`` is false: another thread's span, adopted) and,
    with ``count``, counted as a wait."""

    __slots__ = ("tracer", "span", "close", "count")

    def __init__(self, tracer, span, close=True, count=False):
        self.tracer, self.span, self.close, self.count = tracer, span, close, count

    def __enter__(self):
        self.tracer._stack().append(self.span)
        return self.span

    def __exit__(self, *exc):
        self.tracer._stack().pop()
        if self.close:
            self.tracer.end(self.span)
        if self.count:
            self.tracer._count(self.span)
        return False


def _stream(device):
    """The calling thread's current stream on ``device`` if it is a CUDA
    device: a unit's spans on one thread record their events on it."""
    if device is None or device.type != "cuda":
        return None
    return torch.cuda.current_stream(device)


class Tracer:
    """Spans of the newest ``UNIT_CAPACITY`` units, on one clock; one object per
    process (``tracer``), shared by every thread. ``on`` is the switch that
    :func:`span` and :func:`wait` test."""

    def __init__(self):
        self.on = False
        self.capacity = UNIT_CAPACITY
        self.dropped = 0
        self._units: deque = deque()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._traces = itertools.count(1)
        self._wall: list = []       # (perf ns, wall ns)
        self._anchors: dict = {}    # CUDA device index -> [(perf ns, event)]

    # -- switch and anchors ------------------------------------------------

    def enable(self) -> None:
        """Turn spans on, keeping the newest ``capacity`` (``UNIT_CAPACITY``)
        units (older ones are dropped and counted), and anchor the clocks."""
        self.anchor()
        self.on = True

    def disable(self) -> None:
        """Turn spans off; what was recorded stays readable."""
        self.on = False

    def clear(self) -> None:
        with self._lock:
            self._units.clear()
            self.dropped = 0

    def anchor(self) -> None:
        """Pair the host clock with the wall clock and, on each visible CUDA
        device, with an event recorded once the device is idle (it
        synchronises: call it outside the timed path)."""
        best = None
        for _ in range(5):
            a, w, b = time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) // 2, w)
        with self._lock:
            self._wall.append(best[1:])
        if not torch.cuda.is_available():
            return
        for index in range(torch.cuda.device_count()):
            dev = torch.device("cuda", index)
            torch.cuda.synchronize(dev)
            best = None
            for _ in range(5):
                ev = torch.cuda.Event(enable_timing=True)
                a = time.perf_counter_ns()
                ev.record(torch.cuda.current_stream(dev))
                ev.synchronize()
                b = time.perf_counter_ns()
                if best is None or b - a < best[0]:
                    best = (b - a, (a + b) // 2, ev)
            with self._lock:
                self._anchors.setdefault(index, []).append(best[1:])

    def wall_ns(self, host_ns: float) -> float:
        """A host-clock time on the wall clock (``torch.profiler``'s base),
        through the nearest anchor."""
        with self._lock:
            pairs = list(self._wall)
        if not pairs:
            return host_ns - time.perf_counter_ns() + time.time_ns()
        p, w = min(pairs, key=lambda pw: abs(pw[0] - host_ns))
        return w + (host_ns - p)

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _thread(self) -> tuple:
        """(name, native id) of the calling thread, read once: the native id
        is a system call, slow on some machines."""
        who = getattr(self._local, "who", None)
        if who is None:
            who = self._local.who = (threading.current_thread().name,
                                     threading.get_native_id())
        return who

    def _frame(self):
        stack = self._stack()
        return stack[-1] if stack else None

    def _open(self, name, parent, unit, device, stream, attrs) -> Span:
        span = Span(next(self._ids), name, parent, unit, device, stream, attrs,
                    self._thread())
        if device is not None and device.type == "cuda":
            # both events made now: closing then only records one
            span.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            span.ev[0].record(stream)
        span.t0 = time.perf_counter_ns()
        unit.spans.append(span)
        return span

    def end(self, span: Span | None, at: int | None = None) -> None:
        """Close an explicitly opened span (None passes), at host time ``at``
        (``time.perf_counter_ns``) if given, else now."""
        if span is None or span.t1 is not None:
            return
        t1 = time.perf_counter_ns() if at is None else at
        if span.ev is not None:
            span.ev[1].record(span.stream)
        span.t1 = t1  # last: a reader on another thread takes a closed span's events as recorded

    def _count(self, span: Span) -> None:
        c = span.unit.counters
        with self._lock:
            c["waits"] = c.get("waits", 0) + 1
            c[span.name] = c.get(span.name, 0) + 1

    def _new_unit(self, name) -> _Unit:
        unit = _Unit(next(self._traces), name)
        with self._lock:
            self._units.append(unit)
            while len(self._units) > self.capacity:
                self._units.popleft()
                self.dropped += 1
        return unit

    def begin(self, name: str, **attrs) -> Span | None:
        """Open the root span of a new unit explicitly, host times only
        (closed by :meth:`end`, from any thread); None when off."""
        if not self.on:
            return None
        unit = self._new_unit(name)
        unit.root = self._open(name, None, unit, None, None, attrs)
        return unit.root

    def child(self, parent: Span | None, name: str, at: int | None = None) -> Span | None:
        """Open a span under ``parent`` explicitly, host times only, at host
        time ``at`` if given (closed by :meth:`end`, from any thread)."""
        if parent is None or not self.on:
            return None
        span = self._open(name, parent.id, parent.unit, None, None, {})
        if at is not None:
            span.t0 = at
        return span

    def adopt(self, parent: Span | None, device=None):
        """``with``: make ``parent`` (opened on another thread) the calling
        thread's current span, its device ``device``: the batch engine's
        worker records its fold under the batch."""
        if parent is None:
            return _NOOP
        proxy = Span(parent.id, parent.name, parent.parent, parent.unit, device,
                     _stream(device), parent.attrs, self._thread())
        return _Open(self, proxy, close=False)

    def unit(self, name: str, device=None):
        """``with``: the root span of a new unit on this thread."""
        if not self.on:
            return _NOOP
        unit = self._new_unit(name)
        unit.root = self._open(name, None, unit, device, _stream(device), {})
        return _Open(self, unit.root)

    def span(self, name: str, **attrs):
        """``with``: a span under the thread's current one (no-op outside a unit)."""
        top = self._frame()
        if top is None:
            return _NOOP
        return _Open(self, self._open(name, top.id, top.unit, top.device, top.stream, attrs))

    def wait(self, site: str):
        """``with``: span ``wait:<site>`` around a host wait on the device, counted."""
        top = self._frame()
        if top is None:
            return _NOOP
        return _Open(self, self._open("wait:" + site, top.id, top.unit, top.device, top.stream,
                                      {}), count=True)

    # -- reading -----------------------------------------------------------

    def _resolve(self, spans) -> None:
        """Read the CUDA events of ``spans`` (waiting for them) into host-clock ns."""
        pending = [s for s in spans if s.ev is not None and s.t1 is not None]
        if not pending:
            return
        devices = {s.device.index or 0 for s in pending}
        for index in devices:
            torch.cuda.synchronize(index)
        self.anchor()
        with self._lock:
            anchors = {i: list(a) for i, a in self._anchors.items()}
        for index in devices:
            rows = anchors.get(index)
            if not rows:  # a device the tracer was not anchored on: host times only
                continue
            hosts = [h for h, _ in rows]
            # each anchor's time on the first anchor's event clock, for the slopes
            ticks = [rows[0][1].elapsed_time(ev) * 1e6 for _, ev in rows]
            slopes = [(hosts[k + 1] - hosts[k]) / (ticks[k + 1] - ticks[k])
                      if ticks[k + 1] > ticks[k] else 1.0 for k in range(len(rows) - 1)] or [1.0]
            for s in pending:
                if (s.device.index or 0) != index:
                    continue
                k = max(0, min(bisect.bisect_right(hosts, s.t0) - 1, len(rows) - 1))
                slope = slopes[min(k, len(slopes) - 1)]
                h, ev = rows[k]
                s.dev = tuple(h + ev.elapsed_time(e) * 1e6 * slope for e in s.ev)
                s.ev = None

    def units(self) -> list:
        """Every unit in the buffer as a dict: ``trace``, ``name``, ``done``
        (its root closed), ``counters`` and ``spans``, each span a dict of
        ``id``, ``name``, ``parent``, ``thread`` (its name) and ``tid``
        (its native id), ``t0``, ``t1`` (host ns), ``d0``, ``d1`` (device ns
        on the host clock, or None) and its attributes. Reading waits for
        the device."""
        with self._lock:
            units = list(self._units)
        self._resolve([s for u in units for s in list(u.spans)])
        out = []
        for u in units:
            spans = []
            for s in list(u.spans):
                d0, d1 = s.dev if s.dev is not None else (None, None)
                spans.append({"id": s.id, "name": s.name, "parent": s.parent,
                              "thread": s.thread, "tid": s.tid, "t0": s.t0, "t1": s.t1,
                              "d0": d0, "d1": d1, **s.attrs})
            out.append({"trace": u.trace, "name": u.name, "done": u.root.t1 is not None,
                        "counters": dict(u.counters), "spans": spans})
        return out

    def chrome_events(self, base_ns: int = 0, lo_ns=None, hi_ns=None) -> list:
        """The spans as Chrome trace events (``ts`` in us from ``base_ns`` on
        the wall clock): host spans under process ``dmpfold2 spans (host)``,
        one row a thread; device spans under ``dmpfold2 spans (device)``,
        one row a unit. ``lo_ns`` / ``hi_ns`` (wall) keep the spans that
        overlap that window."""
        pids = {"host": CHROME_PID, "device": CHROME_PID + 1}
        events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": f"dmpfold2 spans ({kind})"}} for kind, pid in pids.items()]
        rows: dict = {}

        def row(kind, label):
            if (kind, label) not in rows:
                rows[kind, label] = len(rows) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": pids[kind],
                               "tid": rows[kind, label], "args": {"name": label}})
            return rows[kind, label]

        for u in self.units():
            for s in u["spans"]:
                if s["t1"] is None:
                    continue
                args = {k: v for k, v in s.items() if k not in ("t0", "t1", "d0", "d1", "tid")}
                args["trace"] = u["trace"]
                for kind, label, a, b in (("host", s["thread"], s["t0"], s["t1"]),
                                          ("device", f"{u['name']} {u['trace']}",
                                           s["d0"], s["d1"])):
                    if a is None:
                        continue
                    w0, w1 = self.wall_ns(a), self.wall_ns(b)
                    if (lo_ns is not None and w1 < lo_ns) or (hi_ns is not None and w0 > hi_ns):
                        continue
                    events.append({"ph": "X", "cat": "dmpfold2_span", "name": s["name"],
                                   "pid": pids[kind], "tid": row(kind, label),
                                   "ts": (w0 - base_ns) / 1e3, "dur": (w1 - w0) / 1e3,
                                   "args": args})
        return events

    def export_chrome(self, path: str) -> None:
        """Write the buffer's spans as a Chrome trace (``ts`` in wall-clock us)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.chrome_events(), "displayTimeUnit": "ms",
                       "dropped_units": self.dropped}, fh)


tracer = Tracer()


def span(name: str, **attrs):
    """``with obs.span(name):`` a stage of the current unit; off, a shared no-op."""
    if not tracer.on:
        return _NOOP
    return tracer.span(name, **attrs)


def wait(site: str):
    """``with obs.wait(site):`` a host wait on the device, spanned and counted."""
    if not tracer.on:
        return _NOOP
    return tracer.wait(site)


def unit(name: str, device=None):
    """``with obs.unit(name, device):`` the root span of a new unit."""
    if not tracer.on:
        return _NOOP
    return tracer.unit(name, device)


def trace_from_env() -> str | None:
    """``DMPFOLD2_TPU_TRACE=<path>``: turn the tracer on and write its spans
    to ``<path>`` as a Chrome trace at exit. Returns the path (or None)."""
    path = os.environ.get(TRACE_ENV)
    if not path:
        return None
    tracer.enable()
    atexit.register(tracer.export_chrome, path)
    return path


# ---------------------------------------------------------------- reading units

def tree_depths(spans: list) -> dict:
    """Span id -> depth in its unit (the root 0)."""
    by_id = {s["id"]: s for s in spans}
    depth: dict = {}

    def d(sid):
        if sid not in depth:
            parent = by_id[sid]["parent"]
            depth[sid] = 0 if parent not in by_id else d(parent) + 1
        return depth[sid]

    for s in spans:
        d(s["id"])
    return depth


def device_breakdown(unit: dict) -> list:
    """Each device root of a resolved unit (a span with device times whose
    parent has none: a ``fold``), broken down on its stream:

      * ``stages``: device ns by span name, each instant given to the
        innermost span over it;
      * ``gaps``: device ns by label where the stream held no stage's work:
        inside a ``wait:*`` span or under the root alone; each gap is put
        down to the innermost host span open at its middle;
      * ``covered``: the stage spans' own device ns, each its length less its
        children's, plus the gaps: equal to ``root`` unless spans overlap or
        leave their parent.
    """
    spans = [s for s in unit["spans"] if s["t1"] is not None]
    depth = tree_depths(spans)
    by_id = {s["id"]: s for s in spans}
    out = []
    for root in spans:
        if root["d0"] is None or (root["parent"] in by_id
                                  and by_id[root["parent"]]["d0"] is not None):
            continue
        under = _descendants(spans, root["id"])
        dev = [s for s in under if s["d0"] is not None]
        lo, hi = root["d0"], root["d1"]
        cuts = sorted({lo, hi} | {min(max(t, lo), hi) for s in dev for t in (s["d0"], s["d1"])})
        stages: dict = {}
        gaps: dict = {}
        host = sorted(under + [root], key=lambda s: s["t0"])
        for a, b in zip(cuts, cuts[1:]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            over = [s for s in dev if s["d0"] <= mid < s["d1"]]
            inner = max(over, key=lambda s: depth[s["id"]]) if over else root
            if inner is root or inner["name"].startswith("wait:"):
                label = _innermost_host(host, depth, mid, root)
                gaps[label] = gaps.get(label, 0.0) + (b - a)
            else:
                stages[inner["name"]] = stages.get(inner["name"], 0.0) + (b - a)
        own = 0.0
        for s in dev:
            if s["name"].startswith("wait:"):
                continue
            kids = [c for c in dev if c["parent"] == s["id"]]
            own += (s["d1"] - s["d0"]) - sum(c["d1"] - c["d0"] for c in kids)
        out.append({"root": hi - lo, "stages": stages, "gaps": gaps,
                    "covered": own + sum(gaps.values()), "span": root["id"]})
    return out


def _descendants(spans: list, sid) -> list:
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    out, todo = [], [sid]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append(c)
            todo.append(c["id"])
    return out


def _innermost_host(host: list, depth: dict, t: float, root: dict) -> str:
    """The name of the deepest span (of ``host``) open on the host at ``t``."""
    best = None
    for s in host:
        if s["t0"] > t:
            break
        if s["t1"] >= t and (best is None or depth[s["id"]] >= depth[best["id"]]):
            best = s
    return (best or root)["name"]


# ---------------------------------------------------------------- profiling

@contextmanager
def profile(trace_path: str):
    """Profile the enclosed block (host, and the CUDA device when there is
    one) with ``torch.profiler`` and write a Chrome trace to ``trace_path``.
    With the tracer on, the spans that overlap the block are written into
    the same trace, on the profiler's time base (the clocks are anchored at
    the block's start and end)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    traced = tracer.on
    if traced:
        tracer.anchor()
    lo = time.time_ns()
    with torch_profile(activities=activities) as prof:
        yield prof
    hi = time.time_ns()
    if traced:
        tracer.anchor()
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    if traced:
        with open(trace_path) as fh:
            trace = json.load(fh)
        base = int(trace.get("baseTimeNanoseconds", 0))
        trace["traceEvents"] += tracer.chrome_events(base, lo, hi)
        with open(trace_path, "w") as fh:
            json.dump(trace, fh)
