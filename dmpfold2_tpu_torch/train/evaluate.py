"""Structure-quality evaluation over the validation clusters.

Counterpart of ``dmpfold2_tpu/train/evaluate.py``: the reference training
loop reports only its composite loss (train.py:397-400); choosing a model by
fold quality needs the validation targets folded and scored against their
structures. This folds each validation cluster's first member (the
reference's validation convention, train.py:163-170) through the batch
engine (``parallel/stream.BatchFolder``) and scores its CA trace against the
tdb coordinates (``score.tm_score``).

Usage:
  python -m dmpfold2_tpu_torch.train.evaluate --data-dir D --clusters c.lst \\
      --weights params.npz [-d cpu] [--iterations 10] [--minsteps 100] \\
      [--precision bf16|fp32|fp32_strict] [--batch-size 16] [--max-targets 50]

Prints one JSON line: {"targets", "skipped", "tm_mean", "tm_median",
"rmsd_mean", "targets_per_s", "seconds"}, and one record per target on
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..score import tm_score
from .dataset import DMPDataset, load_cluster_list


def evaluate(params, val_list, data_dir: str = ".", iterations: int = 10,
             minsteps: int = 100, precision: str = "bf16", batch_size: int = 16,
             max_targets: int | None = None, verbose: bool = True, device=None):
    """Fold the validation targets on ``device`` (default ``cuda``) and score
    them against their structures.

    Returns (summary dict, per-target records). A target whose fold failed,
    or whose structure cannot be superposed, is skipped and counted.
    """
    from ..parallel.stream import BatchFolder, Target

    ds = DMPDataset(val_list, data_dir, augment=False)
    n = len(ds) if max_targets is None else min(len(ds), max_targets)
    samples = [ds[i] for i in range(n)]
    targets = [Target(alnmat=s.alnmat) for s in samples]

    folder = BatchFolder(params, device=device, batch_size=batch_size, precision=precision)
    try:
        t0 = time.perf_counter()
        results = folder.fold_many(targets, iterations=iterations, minsteps=minsteps)
        elapsed = time.perf_counter() - t0
    finally:
        folder.close()

    records, skipped = [], 0
    for i, (s, r) in enumerate(zip(samples, results)):
        if r is None:
            skipped += 1
            continue
        pred_ca = np.asarray(r[0][:, 1, :], np.float64)
        native_ca = np.asarray(s.targets[:, 1, :], np.float64)
        try:
            sc = tm_score(pred_ca, native_ca)
        except ValueError:
            skipped += 1
            continue
        rec = {"index": i, "nres": int(s.alnmat.shape[1]), "nseqs": int(s.alnmat.shape[0]),
               "tm": sc["tm"], "rmsd": sc["rmsd"],
               "conf_mean": round(float(np.mean(r[1])), 4)}
        records.append(rec)
        if verbose:
            print(json.dumps(rec), file=sys.stderr, flush=True)

    tms = np.asarray([r["tm"] for r in records], np.float64)
    rmsds = np.asarray([r["rmsd"] for r in records], np.float64)
    summary = {
        "targets": len(records),
        "skipped": skipped,
        "tm_mean": round(float(tms.mean()), 4) if len(tms) else None,
        "tm_median": round(float(np.median(tms)), 4) if len(tms) else None,
        "rmsd_mean": round(float(rmsds.mean()), 4) if len(rmsds) else None,
        "targets_per_s": round(n / max(elapsed, 1e-9), 3),
        "seconds": round(elapsed, 3),
    }
    return summary, records


def main(argv=None):
    from ..engine.fold import load_weights

    ap = argparse.ArgumentParser(
        description="Fold the validation clusters and score CA TM/RMSD against the tdb "
                    "structures (PyTorch/CUDA)")
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--clusters", default="train_clust.lst")
    ap.add_argument("--weights", default=None, help="model weights (.npz or .pt state dict)")
    ap.add_argument("-d", "--device", default=None,
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--minsteps", type=int, default=100)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16", "fp32_strict"])
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-targets", type=int, default=None)
    ap.add_argument("--quiet", action="store_true",
                    help="no per-target records on stderr")
    args = ap.parse_args(argv)

    _, val_list = load_cluster_list(os.path.join(args.data_dir, args.clusters))
    summary, _ = evaluate(load_weights(args.weights), val_list, data_dir=args.data_dir,
                          iterations=args.iterations, minsteps=args.minsteps,
                          precision=args.precision, batch_size=args.batch_size,
                          max_targets=args.max_targets, verbose=not args.quiet,
                          device=args.device)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
