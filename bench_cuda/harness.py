"""The benchmark's data: ``BENCHMARK.json`` and the files it names, found by
name, and the result line built from a run's outcome.

  * a configuration: the file its ``configs`` entry names;
  * a traffic mix: ``traffic/<traffic>.json``, read by the generator it names
    (``traffic/<generator>.py``);
  * a cell's limits on the check's numbers: ``limits/<cell>.json``;
  * a metric, end-to-end or per-layer: ``metrics/<name>.py``, whose
    ``read(ctx)`` returns the value or None where it finds nothing to read.

A later cell, configuration or metric is a new file and a new entry; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dmpfold2_tpu")  # top-level module names


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in man['workloads']]}")


def config(man: dict, root: Path, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = HERE) -> dict:
    params = load_json(base / "traffic" / f"{name}.json")
    params["module"] = _module(base / "traffic" / f"{params['generator']}.py",
                               f"bench_cuda_traffic_{params['generator']}")
    return params


def limits(name: str, base: Path = HERE) -> dict:
    return load_json(base / "limits" / f"{name}.json")


def _module(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    if kind == "end_to_end":
        return [m for m in man[kind] if cell_name in m.get("workloads", [cell_name])]
    e2e = {m["name"] for m in metrics_of(man, cell_name, "end_to_end")}
    return [m for m in man[kind]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in e2e else [])]


def reader(name: str, base: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    return _module(path, "bench_cuda_metric_" + name.replace(".", "_")).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(entries: list, values: dict, *, correct: bool, attempted: int, failed: int,
                device: dict, checks: dict, breakdown: dict | None = None) -> dict:
    """The last line: each metric of ``entries`` that has a value, then the
    device, the breakdown where traced, and the compared numbers last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                        for m in entries if values.get(m["name"]) is not None},
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line
