"""A toy run of a cell on the CPU: the cell's own configuration and traffic
at toy widths and sizes, the program's plain versions, the cell's limits."""

from __future__ import annotations

from pathlib import Path

from bench_cuda import harness, runner

ROOT = Path(__file__).resolve().parents[2]
TOY_WIDTHS = {"width": 32, "cwidth": 16, "num_blocks": 2}
TOY_TRAFFIC = {"nseqs": [17, 32], "nres": [33, 40], "pool": 8, "batch_size": 2,
               "ahead": 2, "iterations": 2, "minsteps": 100, "warmup_iterations": 1,
               "warmup_minsteps": 100, "trace_units": 1}


def spec(cell_name: str, seed: int = 2 ** 33 + 5, seconds: float = 1.5, *, trace=False,
         control=False, precision: str | None = None, root: Path = ROOT) -> runner.Spec:
    man = harness.manifest(root)
    cell = harness.cell(man, cell_name)
    cfg = {**harness.config(man, root, cell["config"]), **TOY_WIDTHS}
    if precision is not None:
        cfg["precision"] = precision
    base = root / "bench_cuda"
    params = harness.traffic(cell["traffic"], base)
    params.update({k: v for k, v in TOY_TRAFFIC.items()
                   if k != "batch_size" or params["loop"] == "batch"})
    return runner.Spec(cell=cell_name, cfg=cfg, traffic=params,
                       limits=harness.limits(cell_name, base), seed=seed, seconds=seconds,
                       trace=trace, device="cpu", control=control)
