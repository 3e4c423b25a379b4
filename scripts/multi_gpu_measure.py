#!/usr/bin/env python3
"""Measure the PyTorch port over several GPUs of one machine.

    python3 scripts/multi_gpu_measure.py [--procs 2] [--targets-per-bucket 32]
    python3 scripts/multi_gpu_measure.py --seq
    python3 scripts/multi_gpu_measure.py --inverse-ab

Two measurements (or, with ``--seq`` or ``--inverse-ab``, the third or the
fourth alone), each printed as one
JSON line, after the cards' names and power limits (``nvidia-smi
--query-gpu=name,power.limit``):

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
3. ``seq`` (``--seq``, four cards): residue-axis sharding of one long
   target (``Folder(mesh=make_mesh(1, n))``), per engine (bf16, fp32) at
   ``-n 1 -m 10``: a seeded 64 x 1536 target unsharded, over 2 and over 4
   cards, and a seeded 64 x 2560 target (past the buckets: folded at its
   exact length) over 2 and 4 cards and unsharded, whose failure (out of
   memory) is recorded as its reading. Each: the wall times of 3 folds
   after a warm-up fold (their median and range), and each card's peak
   memory (``max_memory_allocated``). Then, per engine, seeded 64 x 3072,
   3584 and 4096 targets over 4 cards, one fold each without a warm-up:
   the longest target that folds.
   Then one bf16 trunk pass at L 1536 over 2 and 4 cards under
   torch.profiler: each card's device time by kind (the halo exchange's
   copies and joins, the norms' reductions, the two trunk kernels, the
   rest).
4. ``inverse_ab`` (``--inverse-ab``, one card): the bf16 fold of ``seq``'s
   64 x 2560 target on one card with the DCA inverse past
   ``ops/chol.py:BLOCKED_THRESHOLD`` blocked (the port's route) and stock
   (``cholesky_ex`` + ``cholesky_inverse``, the route before the blocked
   inverse: the threshold raised past n for that turn), in turns blocked,
   stock, stock, blocked; each turn as a ``seq`` reading (a warm-up fold,
   3 timed folds, the card's peak memory).

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


SEQ_TARGETS = ((64, 1536), (64, 2560))
# past L 2560, over four cards only, for the longest target that folds: one
# fold each, with no warm-up (its wall time includes the set-up of its shapes)
SEQ_LONGEST = ((64, 3072), (64, 3584), (64, 4096))
SEQ_RUN = (1, 10)  # iterations, minsteps
SEQ_REPEATS = 3    # timed folds per configuration, after a warm-up fold
# device kernel name fragments -> kind, first match wins
SEQ_KINDS = (("halo", ("Memcpy", "memcpy", "CatArrayBatchedCopy", "FillFunctor")),
             ("conv5x5_maxout", ("conv5x5_maxout_kernel",)),
             ("gemm_maxout", ("gemm_maxout_kernel",)),
             ("reduce", ("reduce_kernel",)))


def _seq_fold(params, alnmat, precision: str, devices, repeats: int = SEQ_REPEATS,
              warmup: bool = True) -> dict:
    """A warm-up fold and ``repeats`` timed folds of ``alnmat`` on a 1 x n
    mesh of ``devices`` (unsharded for one device): their wall times (each,
    the median and the range) and each card's peak memory; an error (out of
    memory) is the reading."""
    from dmpfold2_tpu_torch.engine.fold import Folder
    from dmpfold2_tpu_torch.parallel.mesh import make_mesh

    row = {"cards": len(devices)}
    folder = None
    for d in devices:
        torch.zeros(1, device=d)  # the card's allocator, whose peak is read below
        torch.cuda.reset_peak_memory_stats(d)
    try:
        folder = (Folder(params, device=devices[0], precision=precision) if len(devices) == 1
                  else Folder(params, mesh=make_mesh(1, len(devices), devices=devices),
                              precision=precision))
        run = dict(iterations=SEQ_RUN[0], minsteps=SEQ_RUN[1])
        if warmup:
            folder.fold(alnmat, **run)
        walls = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, confs = folder.fold(alnmat, **run)
            walls.append(time.perf_counter() - t0)
        row.update(wall_s=walls, wall_s_median=float(np.median(walls)),
                   wall_s_range=[min(walls), max(walls)], mean_conf=float(confs.mean()))
    except torch.cuda.OutOfMemoryError as exc:
        row["error"] = f"out of memory: {str(exc)[:300]}"
    except RuntimeError as exc:  # cuSOLVER reports its allocation failures as its own errors
        if "ALLOC" not in str(exc) and "memory" not in str(exc):
            raise
        row["error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
    row["peak_gb"] = [torch.cuda.max_memory_allocated(d) / 1e9 for d in devices]
    del folder
    torch.cuda.empty_cache()
    return row


def _trunk_profile(params, alnmat, n: int) -> dict:
    """One bf16 trunk pass of a fold of ``alnmat`` over n cards under
    torch.profiler: per card, device milliseconds by SEQ_KINDS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dmpfold2_tpu_torch.engine.fold import Folder
    from dmpfold2_tpu_torch.models import gruresnet
    from dmpfold2_tpu_torch.parallel.mesh import make_mesh

    captured = []
    real = gruresnet.trunk_apply_bf16

    def capture(*args):
        if not captured:
            captured.append(args)
        return real(*args)

    folder = Folder(params, mesh=make_mesh(1, n, devices=[f"cuda:{k}" for k in range(n)]),
                    precision="bf16")
    gruresnet.trunk_apply_bf16 = capture
    try:
        folder.fold(alnmat, iterations=0, minsteps=0)
    finally:
        gruresnet.trunk_apply_bf16 = real
    args = captured[0]
    with torch.inference_mode():
        for _ in range(2):  # the second: the profiler's own start-up is paid in the first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                real(*args)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    by_card: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:  # kernels and copies, not the ops launching them
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = us if us is not None else getattr(evt, "self_cuda_time_total", 0.0)
        kind = next((k for k, frags in SEQ_KINDS if any(f in evt.name for f in frags)), "other")
        card = by_card.setdefault(f"cuda:{evt.device_index}", {})
        card[kind] = card.get(kind, 0.0) + us / 1e3
    for card in by_card.values():
        total = sum(card.values())
        card["total_ms"] = total
        card["share"] = {k: v / total for k, v in card.items() if k != "total_ms" and total}
    del folder, captured, args
    torch.cuda.empty_cache()
    return {"cards": n, "wall_ms": wall * 1e3, "by_card_ms": by_card}


def _seq_alns() -> dict:
    rng = np.random.default_rng(29)
    return {l: rng.integers(0, 21, (n, l)).astype(np.uint8)
            for n, l in SEQ_TARGETS + SEQ_LONGEST}


def measure_seq(params) -> list:
    alns = _seq_alns()
    cards = [f"cuda:{k}" for k in range(4)]
    rows = []
    for precision in ("bf16", "fp32"):
        runs = [(l, n, {}) for l, counts in ((1536, (1, 2, 4)), (2560, (2, 4, 1)))
                for n in counts]
        runs += [(l, 4, {"repeats": 1, "warmup": False}) for _, l in SEQ_LONGEST]
        for l, n, kw in runs:
            row = _seq_fold(params, alns[l], precision, cards[:n], **kw)
            rows.append({"measure": "seq", "precision": precision, "shape": list(alns[l].shape),
                         "iterations": SEQ_RUN[0], "minsteps": SEQ_RUN[1],
                         "warm_up_fold": kw.get("warmup", True), **row})
            print(json.dumps(rows[-1]), flush=True)
    for n in (2, 4):
        rows.append({"measure": "seq_trunk_profile", "shape": list(alns[1536].shape),
                     **_trunk_profile(params, alns[1536], n)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


INVERSE_AB_TURNS = ("blocked", "stock", "stock", "blocked")


def measure_inverse_ab(params) -> list:
    from dmpfold2_tpu_torch.ops import chol

    aln = _seq_alns()[2560]
    default = chol.BLOCKED_THRESHOLD
    rows = []
    for route in INVERSE_AB_TURNS:
        chol.BLOCKED_THRESHOLD = default if route == "blocked" else 10 ** 9
        try:
            row = _seq_fold(params, aln, "bf16", ["cuda:0"])
        finally:
            chol.BLOCKED_THRESHOLD = default
        rows.append({"measure": "inverse_ab", "route": route, "precision": "bf16",
                     "shape": list(aln.shape), "iterations": SEQ_RUN[0],
                     "minsteps": SEQ_RUN[1], **row})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", action="store_true",
                    help="only the residue-axis sharding measurement (four cards)")
    ap.add_argument("--inverse-ab", action="store_true",
                    help="only the blocked-against-stock DCA inverse in the L 2560 fold "
                         "(one card)")
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
    need = 4 if args.seq else 1 if args.inverse_ab else args.procs
    if torch.cuda.device_count() < need:
        sys.exit(f"multi_gpu_measure: needs {need} GPUs, found {torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from dmpfold2_tpu_torch.kernels import _build
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    _build.build()
    params = init_params(seed=0, width=cs.WIDTH, cwidth=cs.CWIDTH, num_blocks=cs.BLOCKS)
    if args.seq or args.inverse_ab:
        from dmpfold2_tpu_torch.engine.fold import use_full_fp32

        use_full_fp32()
        (measure_seq if args.seq else measure_inverse_ab)(params)
        return
    print(json.dumps(measure_batch(params, args.targets_per_bucket)), flush=True)
    print(json.dumps(measure_train(args.procs)), flush=True)


if __name__ == "__main__":
    main()
