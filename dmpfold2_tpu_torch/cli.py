"""Command-line entry point: ``python -m dmpfold2_tpu_torch.cli -i input.aln > model.pdb``.

Counterpart of ``dmpfold2_tpu/cli.py`` for single targets, flag-compatible
with the reference CLI (-i, -d, -t, -n, -m, -w). ``-d`` picks the torch
device (default ``cuda``). Output is the reference's PDB bytes.
"""

from __future__ import annotations

import argparse
import sys

from .config import FoldConfig
from .engine.fold import DEFAULT_ITERATIONS, DEFAULT_MINSTEPS, aln_to_coords
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
                        help="input sequence alignment in aln (or .a3m) format")
    parser.add_argument("-d", "--device", type=str, default=None, required=False,
                        help="torch device to run on: cuda (default) or cpu")
    parser.add_argument("-t", "--template", type=str, required=False, nargs="+",
                        help="use a PDB file as a template")
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
                        help="compute policy: fp32 (default), or bf16 (the trunk in "
                             "bf16 with fp32 accumulation); fp32_strict is not yet "
                             "ported")
    parser.add_argument("-o", "--out-dir", dest="out_dir", type=str, default=None,
                        help="batch mode (not yet ported)")
    return parser


def run_dmpfold(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.out_dir is not None or len(args.input_file) > 1:
        raise NotImplementedError(
            "batch mode (-o, several -i inputs) is not yet ported to the PyTorch "
            "package (ROADMAP.md, queue 1 item 7: batched engine)")
    if args.template is not None and len(args.template) > 1:
        parser.error("one template per target: single-target mode takes one -t")
    config = FoldConfig.from_cli_args(args)
    coords, confs, alnmat = aln_to_coords(args.input_file[0], return_alnmat=True,
                                          config=config)
    for line in format_pdb(coords, confs, alnmat[0]):
        print(line)


if __name__ == "__main__":
    run_dmpfold(sys.argv[1:])
