#!/usr/bin/env python3
"""A/B of two checkouts of the PyTorch port (``dmpfold2_tpu_torch``) on one GPU.

    python3 scripts/port_ab.py OTHER_TREE [THIS_TREE] [--paths [--out FILE]]

Runs the trees in turns A, B, B, A (A = OTHER_TREE, B = THIS_TREE, default the
checkout holding this script), each turn a process that imports the
package from its tree, builds that tree's kernels into its own
``build/torch_kernels/`` and prints one JSON line:

* the device time per launch (torch.profiler) of vgru at PF10963's 256 x 88
  (depth 252), of conv5x5_maxout in stats mode at B 1, L 88 (nres 82) and in
  argmax mode at L 88 and L 352, and the conv wrapper's call time (CUDA
  events around back-to-back calls);
* the device time of one residue biGRU layer (rgru, T 88, B 1, H 256, 82
  valid steps, both directions): one ``gru_seq_bidir`` launch where the tree
  has it, else two ``gru_seq`` launches, one per direction, summed;
* the device time of gemm_maxout at B 1, L 88 (nres 82), the trunk's input
  layer with the tree's own weight packing;
* the device time of one refine launch (``refine_coords_batched`` at B 1,
  100 steps) on the fp32 fold's own first input (``chip_smoke._fold_trace``,
  L 88, nres 82) and on random walks at L 88 (nres 82) and at the largest
  bucket, L 1536 (nres 1536);
* the fp32 and bf16 default folds of PF10963 (``chip_smoke.phase_fold``: five
  timed folds, exact launch counts) and their device time by category
  (``chip_smoke.phase_profile``).

With ``--paths`` a turn measures the bf16 inference paths end to end
instead (a change that moves no kernel but what runs between them):
``chip_smoke``'s phases fold and profile in bf16, batch in bf16, serve and
long, each with its own checks and launch counts; ``--out`` appends each
turn's full JSON lines to a file.

Inputs are made from fixed seeds, so every turn sees the same data. The
measuring code is this checkout's ``chip_smoke.py``; only the package under
test changes between turns. Then one summary line with each tree's values
over its turns, sorted.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke(tree: str):
    """This checkout's chip_smoke module, running ``tree``'s package (imported
    first: chip_smoke puts its own checkout at the head of the path)."""
    sys.path.insert(0, tree)
    importlib.import_module("dmpfold2_tpu_torch")
    path = os.path.join(HERE, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _phase_lines(fn) -> dict:
    """phase name -> the JSON line each phase ``fn()`` runs prints."""
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        fn()
    rows = (json.loads(line) for line in lines.getvalue().splitlines() if line.startswith("{"))
    return {row["phase"]: row for row in rows if "phase" in row}


def measure_paths(tree: str) -> dict:
    """One ``--paths`` turn: the bf16 fold, batch, serve and long phases."""
    cs = _chip_smoke(tree)
    from dmpfold2_tpu_torch.kernels import _build, vgru
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    assert os.path.dirname(os.path.dirname(vgru.__file__)).startswith(os.path.abspath(tree))
    _build.build()
    params = init_params(seed=0, width=cs.WIDTH, cwidth=cs.CWIDTH, num_blocks=cs.BLOCKS)

    def run():
        cs.phase_fold(params, "bf16")
        cs.phase_profile(params, "bf16")
        cs.phase_batch(params, "bf16")
        cs.phase_serve(params)
        cs.phase_long(params)

    phases = _phase_lines(run)
    fold, prof, batch = phases["fold"], phases["profile"], phases["batch"]
    serve, long = phases["serve"], phases["long"]
    return {"tree": tree, "phases": phases, "summary": {
        "fold_wall_s_median": fold["wall_s_median"],
        "fold_held_wall_s_median": fold["held_folder_wall_s_median"],
        "fold_device_busy_ms": prof["device_busy_ms"],
        "fold_linalg_ms": prof["by_category_ms"].get("linalg", 0.0),
        "batch_targets_per_s": batch["targets_per_s"],
        "batch_256_linalg_ms": batch["profile_one_batch"]["by_category_ms"].get("linalg", 0.0),
        "batch_256_busy_ms": batch["profile_one_batch"]["device_busy_ms"],
        "serve_pf_req_per_s": serve["rounds"]["PF10963 x 16"]["req_per_s"],
        "serve_mixed_req_per_s": serve["rounds"]["mixed x 16"]["req_per_s"],
        "long_wall_s": long["wall_s"],
        "long_linalg_ms": long["profile"]["by_category_ms"].get("linalg", 0.0),
        "long_device_busy_ms": long["profile"]["device_busy_ms"]}}


def measure(tree: str) -> dict:
    """One turn: every number above for the package in ``tree``."""
    cs = _chip_smoke(tree)
    import numpy as np
    import torch

    from dmpfold2_tpu_torch.engine.fold import use_full_fp32
    from dmpfold2_tpu_torch.kernels import _build, conv_block, refine, rgru, vgru
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    assert os.path.dirname(os.path.dirname(vgru.__file__)).startswith(os.path.abspath(tree))
    _build.build()
    use_full_fp32()
    dev = torch.device("cuda")
    params = init_params(seed=0, width=cs.WIDTH, cwidth=cs.CWIDTH, num_blocks=cs.BLOCKS)
    rng = np.random.default_rng(0)
    res = {"tree": tree}

    layers = [{k: v.to(dev) for k, v in p.items()} for p in params["vgru"]]
    aln = torch.from_numpy(rng.integers(0, 22, (cs.N_PAD, cs.L_PAD)).astype(np.int32)).to(dev)
    depth = torch.full((cs.L_PAD,), cs.NSEQS, dtype=torch.int32, device=dev)
    res["vgru_ms"] = cs.device_ms(lambda: vgru.vgru_final_cols(layers, aln, depth),
                                  "vgru_kernel", reps=10)

    hid = cs.WIDTH // 2
    layer = {d: {k: v.to(dev) for k, v in params["coord_gru"][0][d].items()}
             for d in ("fwd", "bwd")}
    xf, xb = (torch.from_numpy(rng.normal(size=(cs.L_PAD, 1, 3 * hid)).astype(np.float32))
              .to(dev) for _ in range(2))
    valid = torch.tensor([cs.NRES], dtype=torch.int32, device=dev)
    if hasattr(rgru, "gru_seq_bidir"):
        res["rgru_layer_ms"] = cs.device_ms(
            lambda: rgru.gru_seq_bidir(layer["fwd"], layer["bwd"], xf, xb, valid), "rgru",
            reps=50)
    else:  # a tree from before the one-launch biGRU layer: a launch per direction
        for counts in cs.EXPECTED_LAUNCHES.values():
            counts["rgru"] = 70
        res["rgru_layer_ms"] = cs.device_ms(
            lambda: (rgru.gru_seq(layer["fwd"]["wh"], layer["fwd"]["bh"], xf, valid),
                     rgru.gru_seq(layer["bwd"]["wh"], layer["bwd"]["bh"], xb, valid,
                                  reverse=True)), "rgru", reps=50, per_call=2)

    k_pad = conv_block.gemm_k_pad(cs.GEMM_K_IN)
    gw, gb = conv_block.pack_gemm_weights(params["trunk"]["input"]["w"].to(dev),
                                          params["trunk"]["input"]["b"].to(dev), k_pad)
    xg = torch.zeros((1, cs.L_PAD, cs.L_PAD, k_pad))
    xg[..., :cs.GEMM_K_IN] = torch.from_numpy(
        rng.normal(size=(1, cs.L_PAD, cs.L_PAD, cs.GEMM_K_IN)).astype(np.float32))
    xg = xg.to(torch.bfloat16).to(dev)
    nr = torch.tensor([cs.NRES], dtype=torch.int32, device=dev)
    res["gemm_ms"] = cs.device_ms(lambda: conv_block.gemm_maxout_stats(xg, gw, gb, nr),
                                  "gemm_maxout_kernel", reps=50)

    mx = params["trunk"]["blocks"][0]["maxout"]
    wp, bp = conv_block.pack_conv5x5_weights(mx["w"].to(dev), mx["b"].to(dev))
    for l, nres in ((cs.L_PAD, cs.NRES), (352, 350)):
        x = torch.from_numpy(rng.normal(size=(1, l, l, cs.CWIDTH)).astype(np.float32))
        x = x.to(torch.bfloat16).to(dev)
        nr = torch.tensor([nres], dtype=torch.int32, device=dev)
        if l == cs.L_PAD:
            res["conv_stats_ms"] = cs.device_ms(
                lambda: conv_block.conv5x5_maxout_stats(x, wp, bp, nr), "conv5x5_maxout_kernel",
                reps=50)
            res["conv_stats_call_ms"] = cs.time_ms(
                lambda: conv_block.conv5x5_maxout_stats(x, wp, bp, nr), reps=50)
        res[f"conv_argmax_ms_L{l}"] = cs.device_ms(
            lambda: conv_block.conv5x5_maxout_argmax(x, wp, bp), "conv5x5_maxout_argmax_kernel",
            reps=20)

    fold_ca = cs._fold_trace(params)
    nr = torch.tensor([cs.NRES], dtype=torch.int32, device=dev)
    res["refine_ms_fold"] = cs.device_ms(
        lambda: refine.refine_coords_batched(fold_ca, cs.MINSTEPS, nr), "refine_kernel",
        reps=20)
    for n, nres in ((cs.L_PAD, cs.NRES), (1536, 1536)):
        ca = torch.from_numpy(cs._chain(n, np.random.default_rng(n))[None]).to(dev)
        nr = torch.tensor([nres], dtype=torch.int32, device=dev)
        res[f"refine_ms_L{n}"] = cs.device_ms(
            lambda: refine.refine_coords_batched(ca, cs.MINSTEPS, nr), "refine_kernel",
            reps=20 if n == cs.L_PAD else 5)

    for precision in ("fp32", "bf16"):
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            cs.phase_fold(params, precision)
            cs.phase_profile(params, precision)
        fold, prof = (json.loads(line) for line in lines.getvalue().splitlines())
        res[f"fold_{precision}"] = {"wall_s_median": fold["wall_s_median"],
                                    "wall_s_all": fold["wall_s_all"],
                                    "launches": fold["launches"],
                                    "device_busy_ms": prof["device_busy_ms"],
                                    "by_category_ms": prof["by_category_ms"]}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    ap.add_argument("this", nargs="?", default=HERE)
    ap.add_argument("--paths", action="store_true",
                    help="measure the bf16 inference paths instead of the kernels")
    ap.add_argument("--out", help="with --paths, append each turn's full JSON line to this file")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # a child process: measure one tree
    args = ap.parse_args()
    if args.turn:
        print(json.dumps((measure_paths if args.paths else measure)(args.turn)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    trees = {"A": os.path.abspath(args.other), "B": os.path.abspath(args.this)}
    turns = []
    for label in "ABBA":
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.other,
                               "--turn", trees[label]] + ["--paths"] * args.paths,
                              capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"turn {label} ({trees[label]}) exited {proc.returncode}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["label"] = label
        if args.paths:
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
            row = {"label": label, "tree": row["tree"], **row["summary"]}
        print(json.dumps(row), flush=True)
        turns.append(row)
    summary = {"card": smi}
    if args.paths:
        for label, tree in trees.items():
            mine = [t for t in turns if t["label"] == label]
            summary[label] = {"tree": tree, **{k: sorted(t[k] for t in mine) for k in mine[0]
                                               if k not in ("label", "tree")}}
        print(json.dumps(summary), flush=True)
        return
    for label, tree in trees.items():
        mine = [t for t in turns if t["label"] == label]
        summary[label] = {"tree": tree}
        for key in ("vgru_ms", "rgru_layer_ms", "gemm_ms", "conv_stats_ms", "conv_stats_call_ms",
                    "conv_argmax_ms_L88", "conv_argmax_ms_L352", "refine_ms_fold",
                    "refine_ms_L88", "refine_ms_L1536"):
            summary[label][key] = sorted(t[key] for t in mine)
        for precision in ("fp32", "bf16"):
            summary[label][f"fold_{precision}_wall_s_median"] = sorted(
                t[f"fold_{precision}"]["wall_s_median"] for t in mine)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
