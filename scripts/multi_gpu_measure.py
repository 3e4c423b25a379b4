#!/usr/bin/env python3
"""Measure the PyTorch port over several GPUs of one machine.

    python3 scripts/multi_gpu_measure.py [--procs 2] [--targets-per-bucket 32]

Two measurements, each printed as one JSON line, after the cards' names and
power limits (``nvidia-smi --query-gpu=name,power.limit``):

1. ``batch``: ``BatchFolder(mesh=make_mesh())`` (every visible card, one
   process, B 8 per card) against ``BatchFolder`` on one card (B 8), bf16,
   ``-n 10 -m 100``, on seeded alignments in the buckets of
   ``chip_smoke.py`` phase ``batch`` (256 x 88 and 256 x 256): targets/s of a
   timed run after a warm-up run, and whether every target got the same
   bits on both.
2. ``train``: one epoch of the training loop (``train.loop.main``, bf16, full
   width, micro-batch ``--procs``) in ``--procs`` processes, one card each,
   over NCCL (``--coordinator`` on localhost), against one process on one
   card with the same micro-batch: the epoch's wall time on each. The data
   are PF10963's alignment with seeded 82-residue targets, 8 training
   clusters; the validation split is cut to 2 clusters (the repository's
   list holds 300, a 300-fold validation per epoch). Rank 0's log is kept.

Weights are random (``init_params(seed=0)``). Needs at least ``--procs``
cards on one machine.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

N_TRAIN = 8
LOOP_ARGS = ["--clusters", "clusters.lst", "--epochs", "1", "--accum-steps", "2",
             "--no-restart", "--precision", "bf16"]


def _targets(per_bucket: int):
    rng = np.random.default_rng(17)
    shapes = [((129, 257), (81, 89))] * per_bucket + [((129, 257), (241, 257))] * per_bucket
    return [rng.integers(0, 22, (int(rng.integers(*s)), int(rng.integers(*r)))).astype(np.uint8)
            for s, r in shapes]


def measure_batch(params, per_bucket: int) -> dict:
    from dmpfold2_tpu_torch.parallel.mesh import make_mesh
    from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target

    targets = [Target(a) for a in _targets(per_bucket)]
    out = {}
    results = {}
    mesh = make_mesh()
    for name, kw in (("one_card", dict(device="cuda:0", batch_size=cs.BATCH_SIZE)),
                     ("mesh", dict(mesh=mesh, batch_size=cs.BATCH_SIZE * mesh.n_data))):
        bf = BatchFolder(params, precision="bf16", **kw)
        bf.fold_many(targets, cs.ITERATIONS, cs.MINSTEPS)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = bf.fold_many(targets, cs.ITERATIONS, cs.MINSTEPS)
        wall = time.perf_counter() - t0
        bf.close()
        out[name] = {"wall_s": wall, "targets_per_s": len(targets) / wall,
                     "batch_size": kw["batch_size"]}
    out["speedup"] = out["one_card"]["wall_s"] / out["mesh"]["wall_s"]
    out["same_bits"] = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                           for a, b in zip(results["one_card"], results["mesh"]))
    return {"measure": "batch", "cards": mesh.n_data, "targets": len(targets),
            "iterations": cs.ITERATIONS, "minsteps": cs.MINSTEPS, **out}


def _write_data(root: str) -> None:
    rng = np.random.default_rng(23)
    os.makedirs(os.path.join(root, "tdb"))
    os.makedirs(os.path.join(root, "aln"))
    names = [f"t{k}" for k in range(N_TRAIN + 2)]
    for name in names:
        with open(cs.EXAMPLE_ALN) as src, open(os.path.join(root, "aln", f"{name}.aln"), "w") as dst:
            dst.write(src.read())
        cs._write_tdb(os.path.join(root, "tdb", f"{name}.tdb"), cs._chain(cs.NRES, rng))
    with open(os.path.join(root, "clusters.lst"), "w") as fh:
        fh.write("\n".join(names) + "\n")


def _loop(data_dir: str, workdir: str, argv) -> float:
    """One epoch through the loop's CLI entry, the validation split cut to 2."""
    from dmpfold2_tpu_torch.train import dataset, loop

    os.makedirs(workdir, exist_ok=True)
    loop.load_cluster_list = lambda p: dataset.load_cluster_list(p, validation_clusters=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.main(["--data-dir", data_dir, "--workdir", workdir, *LOOP_ARGS, *argv])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def measure_train(procs: int) -> dict:
    torch.cuda.empty_cache()  # the batch measurement's cached blocks on cuda:0
    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        _write_data(data_dir)
        single = _loop(data_dir, os.path.join(root, "single"),
                       ["--micro-batch", str(procs), "-d", "cuda:0"])
        port = _free_port()
        logs = [os.path.join(root, f"rank{k}.log") for k in range(procs)]
        t0 = time.perf_counter()
        ranks = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(k), "--procs", str(procs),
             "--port", str(port), "--data-dir", data_dir, "--workdir", os.path.join(root, "dp")],
            stdout=open(logs[k], "w"), stderr=subprocess.STDOUT, cwd=REPO)
            for k in range(procs)]
        try:
            for p in ranks:
                p.wait(timeout=1800)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        launch_wall = time.perf_counter() - t0
        texts = [open(f).read() for f in logs]
        if any(p.returncode for p in ranks):
            raise RuntimeError(f"a rank failed:\n{texts[0][-3000:]}\n{texts[-1][-3000:]}")
        epoch = json.loads([line for line in texts[0].splitlines()
                            if line.startswith("{")][-1])["epoch_wall_s"]
    return {"measure": "train", "procs": procs, "backend": "nccl", "micro_batch": procs,
            "train_clusters": N_TRAIN, "single_epoch_s": single, "ddp_epoch_s": epoch,
            "ddp_processes_wall_s": launch_wall, "speedup": single / epoch,
            "rank0_log_tail": texts[0][-1500:]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--targets-per-bucket", type=int, default=32)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("multi_gpu_measure: needs CUDA GPUs")
    if args.rank is not None:  # one rank of measure_train
        wall = _loop(args.data_dir, args.workdir,
                     ["--micro-batch", str(args.procs), "--coordinator",
                      f"127.0.0.1:{args.port}", "--num-processes", str(args.procs),
                      "--process-id", str(args.rank)])
        print(json.dumps({"rank": args.rank, "epoch_wall_s": wall}), flush=True)
        return
    if torch.cuda.device_count() < args.procs:
        sys.exit(f"multi_gpu_measure: needs {args.procs} GPUs, found {torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from dmpfold2_tpu_torch.kernels import _build
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    _build.build()
    params = init_params(seed=0, width=cs.WIDTH, cwidth=cs.CWIDTH, num_blocks=cs.BLOCKS)
    print(json.dumps(measure_batch(params, args.targets_per_bucket)), flush=True)
    print(json.dumps(measure_train(args.procs)), flush=True)


if __name__ == "__main__":
    main()
