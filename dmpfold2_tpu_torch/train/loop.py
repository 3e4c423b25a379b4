"""Training loop: epochs over the cluster dataset with checkpoint and resume.

Counterpart of ``dmpfold2_tpu/train/loop.py`` (reference train.py:230-422):
shuffled clusters, a random recycling depth per micro-batch, fixed-seed
validation at nloops=2, best-validation, best-training and rolling saves.
Run as

    python -m dmpfold2_tpu_torch.train.loop --data-dir DIR [--precision bf16] [-d cpu]

on ``cuda`` unless ``-d cpu`` is given. Data-parallel training runs one
process per device in a ``torch.distributed`` group (NCCL on CUDA, gloo on
the CPU): ``torchrun --nproc-per-node N -m dmpfold2_tpu_torch.train.loop
--distributed ...``, or by hand ``--coordinator HOST:PORT --num-processes N
--process-id K`` on each process. The micro-batch is rounded up to a
multiple of the data axis and each rank loads, pads and trains on its own
slots only; the bucket is agreed by an all-gather, the gradients are
all-reduced in ``train_step``, rank 0's parameters are broadcast once at the
start, and only rank 0 writes checkpoints. The shuffle, recycling depths and
augmentation come from the same seeds on every rank.
"""

from __future__ import annotations

import argparse
import os
import queue
import random
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..engine.fold import resolve_device
from ..models import gruresnet
from ..ops.dropout import fold_in
from ..parallel.mesh import Mesh, owned_batch_indices, replicate_result
from ..utils import assets
from . import checkpoint as ckpt
from .dataset import DMPDataset, load_cluster_list, local_bucket, pad_to_bucket
from .step import TrainBatch, leaves, make_optimizer, train_step, trainable

VALIDATION_NLOOPS = 2


def _sample_rng(seed: int, epoch: int, index: int) -> random.Random:
    """Augmentation RNG of one (epoch, dataset index): derived, not
    sequential, as the JAX loop derives it."""
    return random.Random((seed * 1_000_003 + epoch) * 2_654_435_761 + index * 97 + 13)


def _make_batches(dataset, indices, micro_batch: int, drop_last: bool = True, rng_for=None,
                  owned: set[int] | None = None):
    """Yield lists of Samples (file IO, parsing, augmentation); with
    ``owned``, only those batch slots are loaded and the others are None."""
    end = len(indices) - micro_batch + 1 if drop_last else len(indices)
    for start in range(0, max(end, 0), micro_batch):
        yield [dataset.get(di, rng_for(di) if rng_for is not None else None)
               if owned is None or slot in owned else None
               for slot, di in enumerate(indices[start:start + micro_batch])]


def _prefetch(iterator, depth: int = 2):
    """Build upcoming micro-batches on a background thread while the device
    runs the current step, in the iterator's order; a producer's exception
    is raised on the consumer's thread, and a consumer that stops early stops
    the producer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    failure: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
        except BaseException as exc:  # re-raised on the consumer thread
            failure.append(exc)
        finally:
            _put(end)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


def _broadcast_params(params) -> None:
    """Every rank takes rank 0's parameters, in one flat broadcast."""
    params_l = leaves(params)
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in params_l])
        dist.broadcast(flat, src=0)
        start = 0
        for p in params_l:
            p.copy_(flat[start:start + p.numel()].view_as(p))
            start += p.numel()


def train(data_dir: str = ".", clusters: str = "train_clust.lst", workdir: str = ".",
          num_epochs: int = 1000, micro_batch: int | None = None,
          accum_steps: int | None = None, restart: bool | None = None,
          refine_steps: int | None = None, seed: int = 0, model_kwargs: dict | None = None,
          precision: str = "fp32", device=None, cfg: TrainConfig | None = None,
          mesh: Mesh | None = None):
    """Train from ``data_dir`` (``tdb/``, ``aln/`` and the cluster list) on
    ``device`` (default ``cuda``); returns the parameters. Explicit keyword
    arguments override ``cfg``'s fields.

    ``mesh`` (``parallel.mesh.make_mesh``, one data shard per process; in a
    process group, every rank calls ``train`` with the same arguments):
    data-parallel training on the mesh row's first device, which replaces
    ``device``; a row of ``n_seq > 1`` devices splits the trunk by rows.
    """
    cfg = cfg or TrainConfig()
    micro_batch = cfg.micro_batch if micro_batch is None else micro_batch
    accum_steps = cfg.batch_size if accum_steps is None else accum_steps
    restart = cfg.restart if restart is None else restart
    refine_steps = cfg.refine_steps if refine_steps is None else refine_steps
    world_size, rank, n_data, step_mesh = 1, 0, 1, None
    if mesh is not None:
        if mesh.n_local != 1:
            raise ValueError(f"train: a mesh with {mesh.n_local} data shards in one process; "
                             "data-parallel training runs one process per data shard "
                             "(torchrun, or --coordinator)")
        if device is not None:
            raise ValueError("train: pass a device or a mesh, not both")
        device = mesh.local_devices[0]
        world_size, rank, n_data = mesh.world_size, mesh.rank, mesh.n_data
        # the micro-batch splits evenly over the data axis
        micro_batch = -(-micro_batch // n_data) * n_data
        if mesh.n_seq > 1 or (dist.is_available() and dist.is_initialized()):
            step_mesh = mesh  # train_step splits the trunk over the row, all-reduces the group
    dev = resolve_device(device)
    clusters_path = os.path.join(data_dir, clusters)
    if not os.path.isfile(clusters_path):
        # the repository's own list (the reference's train_clust.lst), as the
        # JAX loop falls back to it
        print(f"{clusters_path} not found; using {assets.cluster_list_path()}")
        clusters_path = assets.cluster_list_path()
    train_list, validation_list = load_cluster_list(clusters_path)
    print(f"{len(train_list)} training / {len(validation_list)} validation clusters")

    params = gruresnet.init_params(seed, **(model_kwargs or {}))
    gruresnet.check_card_widths(params, precision, dev, training=True)  # before any upload
    lr = cfg.learning_rate_scratch
    if restart:
        best_train = os.path.join(workdir, ckpt.BEST_TRAIN)
        if os.path.isfile(best_train):
            params, n = ckpt.partial_restore(params, best_train)
            print(f"warm restart: {n} tensors restored from {best_train}")
            lr = cfg.learning_rate_restart  # reference train.py:263

    val_err_min = train_err_min = float("inf")
    start_epoch = 0
    state = ckpt.load_train_state(workdir)
    if state is not None:
        start_epoch = state["epoch"] + 1
        val_err_min, train_err_min = state["val_err_min"], state["train_err_min"]
        # the optimizer's moments belong to the LATEST parameters
        latest = os.path.join(workdir, ckpt.LATEST)
        if os.path.isfile(latest):
            params, n = ckpt.partial_restore(params, latest)
            with np.load(latest) as stamp:
                if "__epoch__" in stamp.files and int(stamp["__epoch__"]) != state["epoch"]:
                    print(f"WARNING: {ckpt.LATEST} is from epoch {int(stamp['__epoch__'])} "
                          f"but {ckpt.CHECKPOINT} is from epoch {state['epoch']}: the "
                          f"optimizer moments may not match the parameters")
            print(f"checkpoint loaded, resuming at epoch {start_epoch} ({n} tensors from "
                  f"{ckpt.LATEST})")
        else:
            print(f"checkpoint loaded, resuming at epoch {start_epoch} (WARNING: no "
                  f"{ckpt.LATEST}; the optimizer state may not match the parameters)")

    params = trainable(params, dev)
    if world_size > 1:
        # every rank starts from rank 0's parameters, initial or restored
        _broadcast_params(params)
    # accum_steps counts samples (the reference's 32-sample Adam step)
    optimizer = make_optimizer(params, lr, accum_steps=max(1, accum_steps // micro_batch))
    if state is not None:
        optimizer.load_state_dict(state["opt_state"])

    train_data = DMPDataset(train_list, data_dir, augment=True, crop_len=cfg.crop_len,
                            max_aln_size=cfg.max_aln_size)
    val_data = DMPDataset(validation_list, data_dir, augment=False, crop_len=cfg.crop_len,
                          max_aln_size=cfg.max_aln_size)
    step_seed = seed + 1
    # a rank loads only its own slots of each training micro-batch
    owned = owned_batch_indices(mesh, micro_batch) if world_size > 1 else None

    def global_bucket(samples) -> tuple[int, int]:
        """The micro-batch's bucket: the largest of the ranks' (an
        all-gather, issued here on the main thread, never by the prefetch
        thread, so every rank issues its collectives in the same order)."""
        buckets = replicate_result([local_bucket([s for s in samples if s is not None])])
        return max(b[0] for b in buckets), max(b[1] for b in buckets)

    def my_slots(samples: list) -> list:
        """This rank's share of a whole (validation) batch, padded to a
        multiple of the data axis by repeating its last sample."""
        padded = samples + [samples[-1]] * (-len(samples) % n_data)
        per = len(padded) // n_data
        return padded[rank * per:(rank + 1) * per]

    for epoch in range(start_epoch, start_epoch + num_epochs):
        t0 = time.time()
        py_rng = random.Random(seed * 1_000_003 + epoch)
        indices = list(range(len(train_data)))
        py_rng.shuffle(indices)

        train_err, train_samples, train_bad = 0.0, 0, 0
        for k, samples in enumerate(_prefetch(_make_batches(
                train_data, indices, micro_batch,
                rng_for=lambda di: _sample_rng(seed, epoch, di), owned=owned))):
            mine = [s for s in samples if s is not None]
            batch = TrainBatch(*pad_to_bucket(mine, global_bucket(samples)))
            nloops = py_rng.randint(0, cfg.max_iterations)
            metrics = train_step(params, optimizer, batch, fold_in(fold_in(step_seed, epoch), k),
                                 nloops=nloops, refine_steps=refine_steps, precision=precision,
                                 mesh=step_mesh)
            if np.isfinite(metrics["loss"]):
                train_err += metrics["loss"] * len(samples)
                train_samples += len(samples)
            else:
                train_bad += 1

        # fixed seeds: validation's teacher-forcing draws repeat every epoch.
        # Every rank loads the whole batch (its padding repeats the last
        # sample, which the padding slot's rank could not otherwise supply)
        # and the true samples' gathered losses are summed.
        val_err, val_samples, val_bad = 0.0, 0, 0
        for k, samples in enumerate(_prefetch(_make_batches(
                val_data, list(range(len(val_data))), micro_batch, drop_last=False))):
            batch = TrainBatch(*pad_to_bucket(my_slots(samples), local_bucket(samples)))
            metrics = train_step(params, optimizer, batch, fold_in(1, k), nloops=VALIDATION_NLOOPS,
                                 refine_steps=refine_steps, train=False, precision=precision,
                                 mesh=step_mesh)
            losses = np.asarray(replicate_result(metrics["sample_loss"]))[:len(samples)]
            if np.isfinite(losses).all():
                val_err += float(losses.sum())
                val_samples += len(samples)
            else:
                val_bad += 1

        print(f"Epoch {epoch + 1} took {time.time() - t0:.1f}s  "
              f"train {train_err / max(train_samples, 1):.6f}  "
              f"val {val_err / max(val_samples, 1):.6f}")
        sys.stdout.flush()

        # an epoch with non-finite batches must not look better by summing
        # fewer terms; only rank 0 writes (the workdir is shared)
        writer = rank == 0
        if val_bad == 0 and val_samples > 0 and val_err < val_err_min:
            val_err_min = val_err
            if writer:
                ckpt.save_params(os.path.join(workdir, ckpt.BEST_VAL), params)
                print("Saving best-validation model...")
        if train_bad == 0 and train_samples > 0 and train_err < train_err_min:
            train_err_min = train_err
            if writer:
                ckpt.save_params(os.path.join(workdir, ckpt.BEST_TRAIN), params)
                print("Saving best-training model...")
        if writer:
            ckpt.save_train_state(workdir, epoch, optimizer.state_dict(), val_err_min,
                                  train_err_min, params=params)

    return params


def main(argv=None):
    cfg = TrainConfig()
    ap = argparse.ArgumentParser(description="Train the GRUResNet (PyTorch port)")
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--clusters", default="train_clust.lst")
    ap.add_argument("--workdir", default=".")
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--micro-batch", type=int, default=cfg.micro_batch)
    ap.add_argument("--accum-steps", type=int, default=cfg.batch_size)
    ap.add_argument("--refine-steps", type=int, default=cfg.refine_steps)
    ap.add_argument("--no-restart", action="store_true")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("-d", "--device", default=None,
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--cwidth", type=int, default=128)
    ap.add_argument("--num-blocks", type=int, default=16)
    ap.add_argument("--mesh", default=None, metavar="DATA[xSEQ]|auto",
                    help="data-parallel training over a mesh: DATA processes, each with a row "
                         "of SEQ devices over which the pair trunk is split by rows; 'auto' = "
                         "the whole process group, one device each")
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group from the env:// variables torchrun sets "
                         "(every process runs the same command)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="join a process group by hand at tcp://HOST:PORT; requires "
                         "--num-processes and --process-id on every process")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    if args.coordinator is not None and (args.num_processes is None
                                         or args.process_id is None):
        ap.error("--coordinator requires --num-processes and --process-id")
    if args.coordinator is None and (args.num_processes is not None
                                     or args.process_id is not None):
        ap.error("--num-processes/--process-id only apply with --coordinator "
                 "(use --distributed for torchrun's environment)")

    mesh, device = None, args.device
    if args.distributed or args.coordinator is not None or args.mesh is not None:
        from ..parallel.mesh import initialize_distributed, mesh_shape, parse_mesh

        if args.distributed or args.coordinator is not None:
            n_seq = 1 if args.mesh is None else mesh_shape(args.mesh)[1]
            device = initialize_distributed(args.coordinator, args.num_processes,
                                            args.process_id, device=args.device,
                                            devices_per_process=n_seq)
            if args.mesh is None:
                args.mesh = "auto"  # the whole group
        mesh = parse_mesh(args.mesh, device)
        device = None
    return train(args.data_dir, args.clusters, args.workdir, args.epochs, args.micro_batch,
                 args.accum_steps, restart=not args.no_restart, refine_steps=args.refine_steps,
                 precision=args.precision, device=device, mesh=mesh,
                 model_kwargs=dict(width=args.width, cwidth=args.cwidth,
                                   num_blocks=args.num_blocks))


if __name__ == "__main__":
    main()
