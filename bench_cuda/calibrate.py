"""Readings that set a cell's limits: the check's numbers for sound runs of
the program on many seeds, and for the control (the reference itself, one
precision down, in the program's place) on the same states, in one process.

    python3 bench_cuda/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 6] [--control 3]

Prints one JSON line per seed: {"seed", "program": {...}, "control": {...}}
(the control on the first ``--control`` seeds), then the largest program
reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = ap.parse_args(argv)

    import torch

    from bench_cuda import check, harness, runner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    man = harness.manifest(ROOT)
    cell = harness.cell(man, args.workload)
    cfg = harness.config(man, ROOT, cell["config"])
    tparams = harness.traffic(cell["traffic"])
    lims = harness.limits(cell["name"])
    seeds = [int(s) for s in args.seeds.split(",")]
    program, control = [], []
    for i, seed in enumerate(seeds):
        spec = runner.Spec(cell=cell["name"], cfg=cfg, traffic=tparams, limits=lims, seed=seed,
                           seconds=args.seconds, trace=False, control=i < args.control)
        out = runner.run(spec)
        program.append(out.numbers)
        if out.control is not None:
            control.append(out.control)
        print(json.dumps({"seed": seed, "units": out.units, "window_s": out.window_s,
                          "setup_s": out.setup_s, "program": out.numbers, "control": out.control}),
              flush=True)
    summary = {"program_max": check.worst(program),
               "control_min": {k: min((c[k] for c in control), default=None)
                               for k in check.NUMBERS}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
