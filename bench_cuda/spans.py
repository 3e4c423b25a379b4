"""The program's own spans and counters (``dmpfold2_tpu_torch.utils.obs``'s
``tracer``), read by the per-layer metrics of a traced run.

Importing this module turns the program's tracer on. ``run.py`` loads the
cell's per-layer readers, which import it, before the run starts, and only
with ``--trace 1``: the end-to-end run loads none, so there the tracer stays
off. A program without a tracer (no ``obs.tracer``) is left as it is, and
every reader of it gets None.

A unit is one batch (``batch``) or one fold (``fold``) of the program. The
readers keep the finished units of the cell's loop that ran the cell's own
pass count (``iterations + 1`` trunk passes), so the set-up's ``-n 1``
warm-up units are left out; the window's units and the profiled ones after
it are kept.
"""

from __future__ import annotations

import statistics

try:
    from dmpfold2_tpu_torch.utils import obs as _obs
except ImportError:  # a checkout without the program
    _obs = None

TRACER = getattr(_obs, "tracer", None)
if TRACER is not None and not TRACER.on:
    TRACER.enable()

_memo: dict = {}


def units(ctx) -> list | None:
    """The finished units of the cell's loop that ran its pass count, or
    None without a tracer or without such a unit."""
    if TRACER is None:
        return None
    root = "batch" if ctx["loop"] == "batch" else "fold"
    passes = int(ctx["iterations"]) + 1
    key = (id(ctx), root, passes)
    if key not in _memo:
        kept = [u for u in TRACER.units()
                if u["name"] == root and u["done"]
                and sum(s["name"] == "trunk" for s in u["spans"]) == passes]
        _memo.clear()
        _memo[key] = kept or None
    return _memo[key]


def device_ms(unit: dict, name: str) -> list:
    """Device milliseconds of each span ``name`` of ``unit`` that has device times."""
    return [(s["d1"] - s["d0"]) / 1e6 for s in unit["spans"]
            if s["name"] == name and s["d0"] is not None and s["d1"] is not None]


def host_ms(unit: dict, name: str) -> list:
    return [(s["t1"] - s["t0"]) / 1e6 for s in unit["spans"]
            if s["name"] == name and s["t1"] is not None]


def median_device_ms(ctx, name: str, per_unit: bool = False):
    """The median device time of a span ``name`` over the kept units (with
    ``per_unit``, of each unit's sum of them), or None."""
    kept = units(ctx)
    if not kept:
        return None
    if per_unit:
        values = [sum(ms) for ms in (device_ms(u, name) for u in kept) if ms]
    else:
        values = [v for u in kept for v in device_ms(u, name)]
    return statistics.median(values) if values else None


def mean_waits(ctx):
    """The mean count of host waits (``wait:*`` spans) a unit, or None."""
    kept = units(ctx)
    if not kept:
        return None
    return statistics.fmean(u["counters"].get("waits", 0) for u in kept)


def gap_ms(ctx):
    """The median, over the kept units, of each unit's device gaps on its
    stream (``obs.device_breakdown``), in ms, or None."""
    kept = units(ctx)
    if not kept or not hasattr(_obs, "device_breakdown"):
        return None
    values = [sum(sum(p["gaps"].values()) for p in parts) / 1e6
              for parts in (_obs.device_breakdown(u) for u in kept) if parts]
    return statistics.median(values) if values else None
