"""Run one cell of the benchmark of ``dmpfold2_tpu_torch`` once.

    python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the reference compared with
its limit (also the last lines of standard error). Exits non-zero and prints
no result without enough CUDA devices, when a run overruns its deadline, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DEADLINE_S = 345.0          # a run in a checkout whose kernels are built
FIRST_RUN_DEADLINE_S = 1150.0  # the first run, which builds them


def _die(code: int, msg: str) -> None:
    print(f"bench_cuda: {msg}", file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(code)


def _watchdog(seconds: float) -> threading.Timer:
    timer = threading.Timer(seconds, _die, (3, f"the run overran its {seconds:.0f} s deadline "
                                               "and was stopped; no result"))
    timer.daemon = True
    timer.start()
    return timer


def _kernels_built() -> bool:
    from dmpfold2_tpu_torch.kernels import _build

    return all(_build._lib_path(n).is_file() for n in _build.SIGNATURES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_cuda import harness

    man = harness.manifest(ROOT)
    cell = harness.cell(man, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _die(2, f"cell {cell['name']} needs {cell['chips']} CUDA device(s); found {found}")
    _watchdog(DEADLINE_S if _kernels_built() else FIRST_RUN_DEADLINE_S)
    torch.set_num_threads(4)

    from bench_cuda import runner, tracing

    cfg = harness.config(man, ROOT, cell["config"])
    tparams = harness.traffic(cell["traffic"])
    kind = "per_layer" if args.trace else "end_to_end"
    entries = harness.metrics_of(man, cell["name"], kind)
    readers = {m["name"]: harness.reader(m["name"]) for m in entries}
    spec = runner.Spec(cell=cell["name"], cfg=cfg, traffic=tparams,
                       limits=harness.limits(cell["name"]), seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace), t_start=T_START)
    out = runner.run(spec)
    # read once the window has closed: nvidia-smi takes a second or more
    print(f"bench_cuda: {torch.cuda.get_device_name(0)}, power limit {_power_limit()}",
          file=sys.stderr)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in (out.setup_parts or {}).items())
    print(f"bench_cuda: set-up {out.setup_s:.3f} s: {parts}", file=sys.stderr)
    print(f"bench_cuda: memory peak {out.memory_peak_bytes} bytes (the program's), "
          f"{out.memory_with_copies} with the check's copies", file=sys.stderr, flush=True)
    ctx = runner.context(spec, out)
    values = {name: read(ctx) for name, read in readers.items()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    breakdown = None
    if args.trace:
        prof = out.profile or {}
        device["busy_s"] = prof.get("busy_s")
        device["window_s"] = prof.get("window_s")
        if prof.get("kernels"):
            breakdown = tracing.breakdown(prof)
    bad = harness.forbidden_modules()
    if bad:
        _die(4, f"modules of JAX or the JAX package were loaded: {bad}; no result")
    for name, shown in out.checks.items():
        print(f"check {name}: {shown['value']!r} (limit {shown['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line = harness.result_line(entries, values, correct=out.correct, attempted=out.attempted,
                               failed=out.failed, device=device, checks=out.checks,
                               breakdown=breakdown)
    print(json.dumps(line), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc})"


if __name__ == "__main__":
    sys.exit(main())
