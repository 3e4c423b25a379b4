"""Command-line entry point: ``python -m dmpfold2_tpu_torch.cli -i input.aln > model.pdb``.

Counterpart of ``dmpfold2_tpu/cli.py``, flag-compatible with the reference
CLI (-i, -d, -t, -n, -m, -w). ``-d`` picks the torch device (default
``cuda``). Output is the reference's PDB bytes.

Batch mode: ``-i`` takes any number of alignments, and with ``-o OUTDIR``
they fold through the batch engine (``parallel/stream.BatchFolder``, the
path the HTTP service uses), ``--batch-size`` targets of one shape bucket
per batch, writing ``OUTDIR/<stem>.pdb`` per input.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .config import FoldConfig
from .engine.fold import DEFAULT_ITERATIONS, DEFAULT_MINSTEPS, aln_to_coords
from .utils import obs
from .utils.pdb import format_pdb


def _iterations_arg(value: str):
    """-n takes an int or 'auto' (recycling stops when the confidence plateaus)."""
    if value == "auto":
        return "auto"
    return int(value)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=(
            "The DMPfold2 method for fast and accurate protein structure "
            "prediction (PyTorch/CUDA engine). Prints a PDB format model file."))
    parser.add_argument("-i", "--input_file", type=str, required=True, nargs="+",
                        help="input sequence alignment(s) in aln (or .a3m) format; several "
                             "fold as one batched stream (needs -o)")
    parser.add_argument("-d", "--device", type=str, default=None, required=False,
                        help="torch device to run on: cuda (default) or cpu")
    parser.add_argument("-t", "--template", type=str, required=False, nargs="+",
                        help="use a PDB file as a template; in batch mode one per input, "
                             "in order, with '-' for a target without one")
    parser.add_argument("-n", "--iterations", type=_iterations_arg,
                        default=DEFAULT_ITERATIONS, required=False,
                        help="number of iteration cycles, or 'auto' to recycle "
                             "until the confidence plateaus")
    parser.add_argument("-m", "--minsteps", type=int, default=DEFAULT_MINSTEPS,
                        required=False, help="number of minimization steps")
    parser.add_argument("-w", "--model_weights", type=str, required=False,
                        help="model weights (.pt state dict or .npz)")
    parser.add_argument("--precision", type=str, default=None,
                        choices=["fp32", "bf16", "fp32_strict"],
                        help="compute policy: fp32 (default); bf16 (the trunk in bf16 "
                             "with fp32 accumulation); fp32_strict (fp32 as the reference "
                             "computes it, for comparing with a reference run: LU DCA "
                             "inverse, raw eigenvector signs)")
    parser.add_argument("--dca-method", dest="dca_method", type=str, default=None,
                        choices=["auto", "cholesky", "lu", "schur", "blocked"],
                        help="DCA covariance inverse: auto (default: lu for fp32_strict, "
                             "cholesky otherwise), lu, or cholesky, schur or blocked (the "
                             "JAX package's names for one route here: a Cholesky inverse, "
                             "blocked and in place once 21 x the padded length passes 8192, "
                             "buckets from 416)")
    parser.add_argument("-o", "--out-dir", dest="out_dir", type=str, default=None,
                        help="write <stem>.pdb per input here instead of stdout, through "
                             "the batch engine")
    parser.add_argument("--batch-size", dest="batch_size", type=int, default=16,
                        help="targets per batch in batch mode (per shape bucket)")
    return parser


def _run_batch(args, parser) -> None:
    """Fold many alignments through the batch engine, one PDB per input."""
    from .engine.fold import load_weights
    from .parallel.stream import BatchFolder, Target
    from .utils.aln import parse_aln
    from .utils.pdb import parse_template_ca

    inputs = args.input_file
    stems = [os.path.splitext(os.path.basename(p))[0] for p in inputs]
    dup = {s for s in stems if stems.count(s) > 1}
    if dup:
        parser.error(f"duplicate output stems {sorted(dup)}: inputs would overwrite each "
                     "other's PDBs; rename the files")
    templates: list[str | None] = [None] * len(inputs)
    if args.template is not None:
        if len(args.template) != len(inputs):
            parser.error(f"-t got {len(args.template)} templates for {len(inputs)} inputs; "
                         "batch mode takes one per input, in order ('-' for none)")
        templates = [None if t == "-" else t for t in args.template]
    if args.iterations == "auto":
        parser.error("-n auto is single-target only (a batch would wait for its slowest "
                     "member); use a fixed -n with -o")

    config = FoldConfig.from_cli_args(args)
    targets = []
    for path, template in zip(inputs, templates):
        alnmat = parse_aln(path)
        template_ca = parse_template_ca(template) if template is not None else None
        if template_ca is not None and template_ca.shape[0] != alnmat.shape[1]:
            # an input error, reported before any fold, not a batch failure
            parser.error(f"template {template} has {template_ca.shape[0]} CA atoms but "
                         f"{path} has {alnmat.shape[1]} residues — lengths must match")
        targets.append(Target(alnmat=alnmat, template_ca=template_ca))
    folder = BatchFolder(load_weights(config.weights_file), device=config.device,
                         batch_size=args.batch_size, precision=config.precision,
                         dca_method=config.dca_method)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    results = folder.fold_many(targets, iterations=config.iterations,
                               minsteps=config.minsteps)
    elapsed = time.perf_counter() - t0
    folder.close()
    failed = []
    for path, stem, target, result in zip(inputs, stems, targets, results):
        if result is None:  # the folder has logged the failure
            failed.append(path)
            continue
        with open(os.path.join(args.out_dir, stem + ".pdb"), "w") as fh:
            for line in format_pdb(*result, target.alnmat[0]):
                fh.write(line + "\n")
    ok = len(inputs) - len(failed)
    print(f"folded {ok}/{len(inputs)} targets in {elapsed:.2f}s "
          f"({ok / max(elapsed, 1e-9):.2f} targets/s) -> {args.out_dir}", file=sys.stderr)
    if failed:
        print("FAILED: " + " ".join(failed), file=sys.stderr)
        raise SystemExit(1)


def run_dmpfold(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    obs.trace_from_env()  # DMPFOLD2_TPU_TRACE=<path>: spans to a Chrome trace at exit
    if len(args.input_file) > 1 and args.out_dir is None:
        parser.error("multiple inputs need -o/--out-dir (one PDB per target)")
    if args.out_dir is not None:
        return _run_batch(args, parser)
    if args.template is not None and len(args.template) > 1:
        parser.error("several -t templates need batch mode (-o with as many -i inputs)")
    config = FoldConfig.from_cli_args(args)
    coords, confs, alnmat = aln_to_coords(args.input_file[0], return_alnmat=True,
                                          config=config)
    for line in format_pdb(coords, confs, alnmat[0]):
        print(line)


if __name__ == "__main__":
    run_dmpfold(sys.argv[1:])
