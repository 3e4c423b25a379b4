"""Batch folding engine: many targets, grouped by shape bucket, folded in
batches, on one device or data-parallel over a mesh.

Counterpart of ``dmpfold2_tpu/parallel/stream.py``:

  * targets are grouped by (nseqs, nres) shape bucket,
  * each group is cut into batches of ``batch_size``; a partial batch is
    padded by repeating its last target (so a bucket runs one shape per batch
    size) and the copies are dropped on the way out,
  * each batch runs the natively batched forward
    (``engine.fold.fold_padded_batch``): one launch of each kernel serves the
    whole batch, with per-target ``nseqs`` and ``nres``, and the engine's MDS
    (``engine.fold.resolve_mds_impl``: subspace iteration in bf16),
  * results come back in input order.

Data parallelism (``mesh``, ``parallel/mesh.py``): the batch size is a
multiple of the mesh's data axis and each batch splits into ``batch / n_data``
slots per data shard. The parameters are uploaded once per device (one held
:class:`Folder` each); each local shard runs the same ``fold_padded_batch``,
with the same kernels, on its own device, worker threads and streams, as
JAX's ``shard_map`` runs the program per shard. In a process group every
process walks the same work list, folds only the slots of its own shards,
and after each batch's wait gathers the results (``mesh.replicate_result``,
on the caller's thread: workers issue no collective), so every process holds
every result. Counters count local targets; ``global_counters()`` merges
them across the group.

A mesh whose rows hold ``n_seq > 1`` devices: each data shard's batch folds
on its row, the pair trunk split by rows over it (``Folder(mesh=...)``,
``parallel/sharding.py``), and its worker thread sets its stream on every
device of the row. JAX folds the same batch under ``shard_map``, where the
seq axis is manual and the pair constraints stay off, so each seq device
computes the whole batch; the results are the same.

Pipelining: up to ``max_inflight`` batches are in flight. ``dispatch`` pads a
batch on the host and hands it to a worker thread, which uploads it, folds it
on its own CUDA stream and fetches the results; ``retire`` waits for that
worker. A worker thread, not an asynchronous launch, because the fold waits
on the device inside: ``torch.linalg.eigh`` checks its status on the host
once per trunk pass. PyTorch releases the interpreter lock while it launches
and waits, so one batch's host work overlaps another's device work.

Failure tolerance: a batch (a shard of one, under a mesh) that fails, at
dispatch or in its worker, is folded again target by target on the same
device with the same kernels (after a CUDA out-of-memory error the
allocator's cache is emptied first); a target that fails alone gives ``None``
and a ``target_error`` log line.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..engine.buckets import bucket_shape
from ..engine.fold import Folder, fold_padded_batch, pad_target
from ..utils import obs
from ..utils.obs import Counters, global_counters, log_target
from .mesh import Mesh, replicate_result


@dataclass
class Target:
    alnmat: np.ndarray
    template_ca: np.ndarray | None = None


class PendingFolds:
    """Handle for an in-flight :meth:`BatchFolder.fold_many_async` call.

    ``wait()`` drives the remaining dispatch/retire pipeline to completion
    and returns the result list (idempotent: later calls return the same
    list)."""

    def __init__(self, wait_fn):
        self._wait_fn = wait_fn
        self._results = None
        self._done = False

    def wait(self):
        if not self._done:
            self._results = self._wait_fn()
            self._done = True
        return self._results


def _pad_batch(targets: Sequence[Target], n_pad: int, l_pad: int):
    """Host inputs of one batch: (B, n_pad, l_pad) int32 alignments,
    (B, l_pad, l_pad) dmap channels, and the per-target sizes."""
    padded = [pad_target(t.alnmat, t.template_ca, n_pad, l_pad) for t in targets]
    aln_b = np.stack([a for a, _ in padded])
    dmap_b = np.stack([d for _, d in padded])
    nseqs = [int(t.alnmat.shape[0]) for t in targets]
    nres = [int(t.alnmat.shape[1]) for t in targets]
    return aln_b, dmap_b, nseqs, nres


def _fold_batch(folder: Folder, aln_b: np.ndarray, dmap_b: np.ndarray, nseqs, nres,
                iterations: int, minsteps: int):
    """One batch on ``folder``'s device (or mesh row), on the calling
    thread's current streams: upload, fold, fetch -> ((B, l_pad, 5, 3),
    (B, l_pad)) numpy. Each blocking copy waits for the stream."""
    dev = folder.device
    with torch.inference_mode():
        with obs.wait("upload"):
            aln = torch.from_numpy(aln_b).to(dev)
        with obs.wait("upload"):
            dmap = torch.from_numpy(dmap_b).to(dev)
        coords, confs, _ = fold_padded_batch(
            folder.params, aln, nseqs, nres, dmap, max(int(iterations), 0),
            max(int(minsteps), 0), precision=folder.precision, dca_method=folder.dca_method,
            seq_row=folder.seq_row)
        with obs.wait("fetch"):
            coords = coords.cpu()
        with obs.wait("fetch"):
            confs = confs.cpu()
        return coords.numpy(), confs.numpy()


# the CUDA devices on which this process made its first linear-algebra call
_linalg_ready: set = set()
_linalg_lock = threading.Lock()


def _load_linalg(device: torch.device) -> None:
    """torch loads its CUDA linear-algebra library at the first linalg call,
    and when two threads make that first call at once one of them fails
    ("lazy wrapper should be called at most once"): make it here, once per
    device, before any worker runs, with each call the folds make (``eigh``
    and the subspace MDS's ``qr``)."""
    with _linalg_lock:
        if device not in _linalg_ready:
            torch.linalg.eigh(torch.eye(2, device=device))
            torch.linalg.qr(torch.eye(2, device=device))
            _linalg_ready.add(device)


class _Shard:
    """One data shard's resources: the held :class:`Folder` of its device
    (or mesh row), ``depth`` worker threads and, per worker, a stream on
    each CUDA device of the row."""

    def __init__(self, folder: Folder, depth: int):
        self.folder = folder
        self.executor = ThreadPoolExecutor(depth, thread_name_prefix="dmpfold2-batch")
        self.streams: queue.Queue = queue.Queue()
        cuda = [d for d in dict.fromkeys(folder.devices) if d.type == "cuda"]
        for _ in range(depth):
            self.streams.put([torch.cuda.Stream(d) for d in cuda])

    def run(self, batch_span, queue_span, *args):
        """A worker's job: one batch on a free set of streams of this shard.
        Returns (the batch's results, the host times (``perf_counter_ns``)
        at which the streams were held and the fetch ended); the tracer's
        ``batch.queue`` span ends at the first, and its ``fold`` span (under
        the batch's) holds the upload, fold and fetch."""
        streams = self.streams.get()
        held = time.perf_counter_ns()
        obs.tracer.end(queue_span, at=held)
        try:
            with contextlib.ExitStack() as ctx:
                for stream in streams:  # each makes its device current
                    ctx.enter_context(torch.cuda.stream(stream))
                if streams:  # the fold starts on the row's first device
                    ctx.enter_context(torch.cuda.device(streams[0].device))
                with obs.tracer.adopt(batch_span, self.folder.device), obs.span("fold"):
                    out = _fold_batch(self.folder, *args)
                return out, held, time.perf_counter_ns()
        finally:
            self.streams.put(streams)


class BatchFolder:
    """Groups targets by bucket and folds them in batches, on one device or
    data-parallel over a ``mesh``.

    ``params`` are uploaded once per device (through a held :class:`Folder`,
    which also folds requeued targets with the same ``precision`` and
    ``dca_method``). ``device`` defaults to ``cuda`` and raises without it;
    with a ``mesh`` (``parallel.mesh.make_mesh``) the mesh's devices are used
    and ``device`` must be None; a mesh row of several devices splits each
    fold's pair trunk over them. ``max_inflight`` batches run at once, each
    shard of each on its own worker thread and, on CUDA devices, its own
    streams. Batches are buckets, so the batch engine always pads to them.
    """

    def __init__(self, params, device=None, batch_size: int = 1, precision: str = "fp32",
                 verbose: bool = False, counters: Counters | None = None,
                 max_inflight: int = 2, dca_method: str = "auto", mesh: Mesh | None = None):
        if mesh is not None and device is not None:
            raise ValueError("BatchFolder: pass a device or a mesh, not both")
        rows = list(mesh.devices) if mesh is not None else [(device,)]
        folders: dict = {}
        for row in rows:
            if row not in folders:
                folders[row] = Folder(params, precision=precision, dca_method=dca_method,
                                      **({"mesh": Mesh((row,))} if mesh is not None
                                         else {"device": device}))
        self.mesh = mesh
        # one held Folder per distinct row, the first shard's first
        self.folders = list(folders.values())
        self.folder = self.folders[0]
        self.device = self.folder.device
        self.precision = precision
        self.batch_size = batch_size
        self.verbose = verbose
        self.counters = counters if counters is not None else Counters()
        self.max_inflight = max(int(max_inflight), 1)
        self._shards = [_Shard(folders[row], self.max_inflight) for row in rows]
        for folder in self.folders:
            if folder.device.type == "cuda":
                _load_linalg(folder.device)
            for dev in folder.devices:
                if dev.type == "cuda":
                    # the workers' streams read the parameters the current stream uploaded
                    torch.cuda.synchronize(dev)

    def close(self) -> None:
        """Stop the worker threads once the batches in flight have finished."""
        for shard in self._shards:
            shard.executor.shutdown(wait=True)

    def global_counters(self) -> Counters:
        """The whole process group's counters (``utils.obs.global_counters``);
        a collective in a process group."""
        return global_counters(self.counters)

    def _fold_single(self, target: Target, iterations: int, minsteps: int,
                     folder: Folder | None = None):
        """One target alone on ``folder`` (default: the first shard's)."""
        return (folder or self.folder).fold(target.alnmat, target.template_ca, iterations,
                                            minsteps)

    def fold_many(self, targets: Sequence[Target], iterations: int = 10, minsteps: int = 100):
        """Fold all targets; returns results in input order as
        [(coords (nres, 5, 3), confs (nres,)) or None for a failed target].
        In a process group every process calls it with the same targets and
        gets every result."""
        return self.fold_many_async(targets, iterations, minsteps).wait()

    def fold_many_async(self, targets: Sequence[Target], iterations: int = 10,
                        minsteps: int = 100) -> PendingFolds:
        """Start folding without waiting for results.

        Pads and hands to the workers up to ``max_inflight`` batches and
        returns a :class:`PendingFolds` whose ``wait()`` drives the rest of
        the pipeline and returns the result list (in a process group, call
        ``wait()`` from the main thread: it gathers each batch's results).
        """
        if iterations == "auto":
            raise ValueError("-n auto is single-target only: use a fixed number of "
                             "iterations in batch mode")
        n_data = self.mesh.n_data if self.mesh is not None else 1
        first_shard = self.mesh.first_shard if self.mesh is not None else 0
        gather = self.mesh is not None and self.mesh.world_size > 1
        # the batch splits evenly over the data shards
        batch = -(-max(int(self.batch_size), 1) // n_data) * n_data
        per = batch // n_data
        groups: dict[tuple[int, int], list[int]] = {}
        for i, t in enumerate(targets):
            groups.setdefault(bucket_shape(*t.alnmat.shape), []).append(i)
        results: list = [None] * len(targets)

        def dispatch(bucket, chunk):
            """Pad this process's shards of one batch (a partial batch repeats
            its last target) and hand each to its shard's workers; does not
            wait for the device. A shard of padding alone is not folded.
            Starts the counters' clock and the batch's root span (``batch``,
            ended in ``retire``)."""
            t_start = time.perf_counter()
            self.counters.start()
            root = obs.tracer.begin("batch", bucket=list(bucket), size=len(chunk))
            take = list(chunk) + [chunk[-1]] * (batch - len(chunk))
            shards = []
            for j, shard in enumerate(self._shards):
                lo = (first_shard + j) * per
                if lo >= len(chunk):
                    continue
                rec = dict(shard=shard, chunk=chunk[lo:lo + per])
                try:
                    aln_b, dmap_b, nseqs_b, nres_b = _pad_batch(
                        [targets[i] for i in take[lo:lo + per]], *bucket)
                    submitted = time.perf_counter_ns()
                    rec.update(nseqs_b=nseqs_b, nres_b=nres_b, submitted=submitted,
                               future=shard.executor.submit(
                                   shard.run, root,
                                   obs.tracer.child(root, "batch.queue", at=submitted),
                                   aln_b, dmap_b, nseqs_b, nres_b, iterations, minsteps))
                except Exception as exc:  # noqa: BLE001 - dispatch failure: requeue singly
                    rec["error"] = exc
                shards.append(rec)
            return dict(bucket=bucket, chunk=chunk, shards=shards, t_start=t_start, span=root)

        def requeue(bucket, chunk, folder, exc):
            """A batch (shard) failed: fold each target alone, on the same
            device with the same kernels, so one bad target cannot sink its
            batchmates; a target that fails alone is skipped and logged."""
            log_target("batch_failed", 0, 0, bucket, 0.0, None, event="batch_error",
                       error=str(exc)[:200])
            if isinstance(exc, torch.cuda.OutOfMemoryError):
                torch.cuda.empty_cache()
            for ti in chunk:
                try:
                    results[ti] = self._fold_single(targets[ti], iterations, minsteps, folder)
                    self.counters.record(results[ti][0].shape[0])
                except Exception as exc2:  # noqa: BLE001 - logged; the run goes on
                    results[ti] = None
                    log_target(f"target[{ti}]", *targets[ti].alnmat.shape, None, 0.0, None,
                               event="target_error", error=str(exc2)[:200])

        def retire(rec):
            """Wait for one batch's shards, scatter their results and, in a
            process group, gather every process's."""
            local = []
            for sh in rec["shards"]:
                exc = sh.get("error")
                if exc is None:
                    try:
                        (coords, confs), held, done = sh["future"].result()
                    except Exception as err:  # noqa: BLE001 - failure tolerance: requeue
                        exc = err
                if exc is not None:
                    requeue(rec["bucket"], sh["chunk"], sh["shard"].folder, exc)
                else:
                    elapsed = time.perf_counter() - rec["t_start"]
                    for bi, ti in enumerate(sh["chunk"]):
                        nr = sh["nres_b"][bi]
                        results[ti] = (coords[bi, :nr], confs[bi, :nr])
                        self.counters.record(nr)
                        if self.verbose:
                            # per-target time = the worker's fold / batch size; the wait
                            # for a worker (queue_s) and dispatch -> retire apart
                            log_target(f"target[{ti}]", sh["nseqs_b"][bi], nr, rec["bucket"],
                                       (done - held) / 1e9 / batch,
                                       float(confs[bi, :nr].mean()),
                                       queue_s=round((held - sh["submitted"]) / 1e9, 4),
                                       fold_s=round((done - held) / 1e9, 4),
                                       batch_seconds=round(elapsed, 4), batch_size=batch)
                local += [results[ti] for ti in sh["chunk"]]
            if gather:
                # the processes' slots are contiguous in rank order
                for ti, res in zip(rec["chunk"], replicate_result(local)):
                    results[ti] = res
            obs.tracer.end(rec["span"])

        work = [(bucket, idxs[start:start + batch])
                for bucket, idxs in groups.items()
                for start in range(0, len(idxs), batch)]
        inflight: list = []

        def pump(block: bool):
            """Advance the dispatch/retire pipeline; with ``block`` drain it."""
            while work:
                if len(inflight) >= self.max_inflight:
                    if not block:
                        return
                    retire(inflight.pop(0))
                inflight.append(dispatch(*work.pop(0)))
            if block:
                while inflight:
                    retire(inflight.pop(0))

        pump(block=False)

        def wait():
            pump(block=True)
            return results

        return PendingFolds(wait)
