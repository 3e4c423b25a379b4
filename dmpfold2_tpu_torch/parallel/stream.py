"""Batch folding engine: many targets, grouped by shape bucket, folded in
batches on one device.

Counterpart of ``dmpfold2_tpu/parallel/stream.py`` on one device (the mesh,
its multi-host ownership and ``global_counters`` wait for multi-GPU):

  * targets are grouped by (nseqs, nres) shape bucket,
  * each group is cut into batches of ``batch_size``; a partial batch is
    padded by repeating its last target (so a bucket runs one shape per batch
    size) and the copies are dropped on the way out,
  * each batch runs the natively batched forward
    (``engine.fold.fold_padded_batch``): one launch of each kernel serves the
    whole batch, with per-target ``nseqs`` and ``nres``,
  * results come back in input order.

Pipelining: up to ``max_inflight`` batches are in flight. ``dispatch`` pads a
batch on the host and hands it to a worker thread, which uploads it, folds it
on its own CUDA stream and fetches the results; ``retire`` waits for that
worker. A worker thread, not an asynchronous launch, because the fold waits
on the device inside: ``torch.linalg.eigh`` checks its status on the host
once per trunk pass. PyTorch releases the interpreter lock while it launches
and waits, so one batch's host work overlaps another's device work.

Failure tolerance: a batch that fails, at dispatch or in its worker, is
folded again target by target on the same device with the same kernels (after
a CUDA out-of-memory error the allocator's cache is emptied first); a target
that fails alone gives ``None`` and a ``target_error`` log line.
"""

from __future__ import annotations

import contextlib
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..engine.buckets import bucket_shape
from ..engine.fold import Folder, fold_padded_batch, pad_target
from ..utils.obs import Counters, log_target


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
    """One batch on ``folder``'s device, on the calling thread's current
    stream: upload, fold, fetch -> ((B, l_pad, 5, 3), (B, l_pad)) numpy."""
    dev = folder.device
    with torch.inference_mode():
        coords, confs, _ = fold_padded_batch(
            folder.params, torch.from_numpy(aln_b).to(dev), nseqs, nres,
            torch.from_numpy(dmap_b).to(dev), max(int(iterations), 0), max(int(minsteps), 0),
            precision=folder.precision, dca_method=folder.dca_method)
        return coords.cpu().numpy(), confs.cpu().numpy()


class BatchFolder:
    """Groups targets by bucket and folds them in batches on one device.

    ``params`` are uploaded once (through a held :class:`Folder`, which also
    folds requeued targets with the same ``precision`` and ``dca_method``).
    ``device`` defaults to ``cuda`` and raises without it. ``max_inflight``
    batches run at once, each on its own worker thread and, on a CUDA device,
    its own stream. Batches are buckets, so the batch engine always pads to
    them.
    """

    def __init__(self, params, device=None, batch_size: int = 1, precision: str = "fp32",
                 verbose: bool = False, counters: Counters | None = None,
                 max_inflight: int = 2, dca_method: str = "auto"):
        self.folder = Folder(params, device=device, precision=precision, dca_method=dca_method)
        self.device = self.folder.device
        self.precision = precision
        self.batch_size = batch_size
        self.verbose = verbose
        self.counters = counters if counters is not None else Counters()
        self.max_inflight = max(int(max_inflight), 1)
        self._executor = ThreadPoolExecutor(self.max_inflight,
                                            thread_name_prefix="dmpfold2-batch")
        self._streams: queue.Queue = queue.Queue()
        for _ in range(self.max_inflight):
            self._streams.put(torch.cuda.Stream(self.device) if self.device.type == "cuda"
                              else None)
        if self.device.type == "cuda":
            # torch loads its CUDA linear-algebra library at the first linalg
            # call, and when two threads make that first call at once one of
            # them fails ("lazy wrapper should be called at most once"): load
            # it here, before any worker runs
            torch.linalg.eigh(torch.eye(2, device=self.device))
            # the workers' streams read the parameters the current stream uploaded
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Stop the worker threads once the batches in flight have finished."""
        self._executor.shutdown(wait=True)

    def _run_on_stream(self, *args):
        """A worker's job: one batch on a free stream of this folder."""
        stream = self._streams.get()
        try:
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            with ctx:
                return _fold_batch(self.folder, *args)
        finally:
            self._streams.put(stream)

    def _fold_single(self, target: Target, iterations: int, minsteps: int):
        return self.folder.fold(target.alnmat, target.template_ca, iterations, minsteps)

    def fold_many(self, targets: Sequence[Target], iterations: int = 10, minsteps: int = 100):
        """Fold all targets; returns results in input order as
        [(coords (nres, 5, 3), confs (nres,)) or None for a failed target]."""
        return self.fold_many_async(targets, iterations, minsteps).wait()

    def fold_many_async(self, targets: Sequence[Target], iterations: int = 10,
                        minsteps: int = 100) -> PendingFolds:
        """Start folding without waiting for results.

        Pads and hands to the workers up to ``max_inflight`` batches and
        returns a :class:`PendingFolds` whose ``wait()`` drives the rest of
        the pipeline and returns the result list.
        """
        if iterations == "auto":
            raise ValueError("-n auto is single-target only: use a fixed number of "
                             "iterations in batch mode")
        batch = max(int(self.batch_size), 1)
        groups: dict[tuple[int, int], list[int]] = {}
        for i, t in enumerate(targets):
            groups.setdefault(bucket_shape(*t.alnmat.shape), []).append(i)
        results: list = [None] * len(targets)

        def dispatch(bucket, chunk):
            """Pad one batch (a partial one repeats its last target) and hand
            it to a worker; does not wait for the device."""
            take = list(chunk) + [chunk[-1]] * (batch - len(chunk))
            aln_b, dmap_b, nseqs_b, nres_b = _pad_batch([targets[i] for i in take], *bucket)
            future = self._executor.submit(self._run_on_stream, aln_b, dmap_b, nseqs_b,
                                           nres_b, iterations, minsteps)
            return dict(bucket=bucket, chunk=chunk, pad_to=batch, nseqs_b=nseqs_b,
                        nres_b=nres_b, future=future, t_start=time.perf_counter())

        def requeue(bucket, chunk, exc):
            """A whole batch failed: fold each target alone, on the same
            device with the same kernels, so one bad target cannot sink its
            batchmates; a target that fails alone is skipped and logged."""
            log_target("batch_failed", 0, 0, bucket, 0.0, None, event="batch_error",
                       error=str(exc)[:200])
            if isinstance(exc, torch.cuda.OutOfMemoryError):
                torch.cuda.empty_cache()
            for ti in chunk:
                try:
                    results[ti] = self._fold_single(targets[ti], iterations, minsteps)
                    self.counters.record(results[ti][0].shape[0])
                except Exception as exc2:  # noqa: BLE001 - logged; the run goes on
                    results[ti] = None
                    log_target(f"target[{ti}]", *targets[ti].alnmat.shape, None, 0.0, None,
                               event="target_error", error=str(exc2)[:200])

        def retire(rec):
            """Wait for one batch in flight and scatter its results."""
            try:
                coords, confs = rec["future"].result()
            except Exception as exc:  # noqa: BLE001 - failure tolerance: requeue singly
                requeue(rec["bucket"], rec["chunk"], exc)
                return
            elapsed = time.perf_counter() - rec["t_start"]
            for bi, ti in enumerate(rec["chunk"]):
                nr = rec["nres_b"][bi]
                results[ti] = (coords[bi, :nr], confs[bi, :nr])
                self.counters.record(nr)
                if self.verbose:
                    # per-target time = batch wall-clock / batch size; under
                    # pipelining it spans dispatch -> fetch (queue wait included)
                    log_target(f"target[{ti}]", rec["nseqs_b"][bi], nr, rec["bucket"],
                               elapsed / rec["pad_to"], float(confs[bi, :nr].mean()),
                               batch_seconds=round(elapsed, 4), batch_size=rec["pad_to"])

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
                bucket, chunk = work.pop(0)
                try:
                    inflight.append(dispatch(bucket, chunk))
                except Exception as exc:  # noqa: BLE001 - dispatch failure: requeue singly
                    requeue(bucket, chunk, exc)
            if block:
                while inflight:
                    retire(inflight.pop(0))

        pump(block=False)

        def wait():
            pump(block=True)
            return results

        return PendingFolds(wait)
