"""The traced run's instruments, all outside the program: host syncs counted
by torch's sync debug mode, and a ``torch.profiler`` window reduced to device
busy time, kernel sums and the host's activity in the device's idle gaps.
(The CUDA events around the features step wrap a program function, so they
sit with the other hooks in ``capture.py``.)"""

from __future__ import annotations

import bisect
import contextlib
import warnings
from collections import defaultdict

import torch

NAME_CHARS = 120  # a kernel's or host op's name is cut to this many characters
WINDOW = "bench_cuda.window"  # the span that marks the profiled window


class SyncCounter:
    """Host synchronisations on the card while ``counting()`` is open, from
    ``torch.cuda.set_sync_debug_mode("warn")``, in every thread."""

    def __init__(self):
        self.count = 0

    @contextlib.contextmanager
    def counting(self):
        if not torch.cuda.is_available():
            yield self
            return
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.count += sum("synchroniz" in str(w.message) for w in caught)


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _events(prof):
    """(device [(name, start_us, end_us)], host [(name, start_us, end_us)])."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if e.name != WINDOW:  # the window's own annotation on the device's timeline
                dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    return dev, host


def reduce_profile(prof) -> dict:
    """Busy seconds (the union of device activity inside the marked window),
    kernel sums by name, and the idle gaps' seconds by the innermost host op
    running at each gap's middle. The window is the ``WINDOW`` span's, so
    the profiler's own start-up, while earlier work drains, is left out."""
    dev, host = _events(prof)
    lo, hi = next((s, e) for name, s, e in host if name == WINDOW)
    window_s = (hi - lo) / 1e6
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    if not dev:
        return {"busy_s": None, "window_s": window_s, "kernels": [], "idle_by_host": []}
    busy = _union([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in busy)
    sums: dict = defaultdict(lambda: [0, 0.0])
    for name, s, e in dev:
        sums[name][0] += 1
        sums[name][1] += (e - s) / 1e6
    kernels = sorted(((n, c, t) for n, (c, t) in sums.items()), key=lambda k: -k[2])
    host = sorted((h for h in host if h[0] != WINDOW), key=lambda h: h[1])
    idle: dict = defaultdict(float)
    starts = [h[1] for h in host]
    gaps = [(lo, busy[0][0])] + [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    gaps.append((busy[-1][1], hi))
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        covering = [h for h in host[max(0, i - 4000):i] if h[2] >= mid]
        label = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "host idle"
        idle[label[:NAME_CHARS]] += (g1 - g0) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "kernels": kernels,
            "idle_by_host": sorted(idle.items(), key=lambda kv: -kv[1])}


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (host and CUDA) inside a ``WINDOW`` span; ``out``
    gets :func:`reduce_profile`'s dict."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    out.update(reduce_profile(prof))


def breakdown(profile: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten host ops under which the device idled longest."""
    return {"device_ops": [[n[:NAME_CHARS], t] for n, _, t in profile["kernels"][:10]],
            "idle_gaps": [[n, t] for n, t in profile["idle_by_host"][:10]]}
