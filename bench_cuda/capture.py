"""The benchmark's only hooks into the program, behind one helper.

Every function of the program that the harness wraps is named here, once
(``SEAMS``), and wrapped through :class:`Patches`; nothing else in the
benchmark patches the program. The seams are the stable stages of a fold:

  * ``parallel.stream._fold_batch``: the batch engine's one call per batch on
    its worker thread, with the batch's host alignments; the thread picks up
    its record there (``Recorder.claim``);
  * ``models.gruresnet.trunk_apply_bf16`` and ``trunk_apply``: each trunk
    pass's (distance, confidence) map;
  * ``models.gruresnet.mds_coords``: each MDS embedding;
  * ``kernels.rgru.bigru_stack``: the residue biGRU, then each coordinate
    biGRU;
  * ``kernels.refine.refine_coords_batched``: both refinements' input and
    output;
  * ``models.trunk.input_layer_bf16``, ``_input_layer``,
    ``resnet_block_fused_norm``, ``resnet_block``: each trunk layer's output,
    in the sampled passes, for every target of the batch (the check holds
    the trunk layer by layer, since a whole bf16 trunk amplifies its
    rounding);
  * ``engine.fold.pair_features``: CUDA events around the features step
    (:class:`FeatureSpans`, traced runs only).

Spans inside the program should replace these hooks once it has them.

Only a thread that holds a record (``Recorder.local.rec``) copies anything;
every other call passes straight through. The copies stay on the card, and
their bytes are kept out of the program's memory peak (:meth:`Recorder.peaks`).
"""

from __future__ import annotations

import hashlib
import importlib
import threading

import numpy as np
import torch

PKG = "dmpfold2_tpu_torch"
SEAMS = {
    "batch": ("parallel.stream", ("_fold_batch",)),
    "trunk": ("models.gruresnet", ("trunk_apply_bf16", "trunk_apply")),
    "mds": ("models.gruresnet", ("mds_coords",)),
    "gru": ("kernels.rgru", ("bigru_stack",)),
    "refine": ("kernels.refine", ("refine_coords_batched",)),
    "layer": ("models.trunk", ("input_layer_bf16", "_input_layer", "resnet_block_fused_norm",
                               "resnet_block")),
    "features": ("engine.fold", ("pair_features",)),
}
BLOCK_BYTES = 512  # the caching allocator rounds every block up to this


class Patches:
    """Wraps the program's functions of one seam kind and undoes it."""

    def __init__(self):
        self._undo: list = []

    def wrap(self, seam: str, make) -> None:
        """Replace each function of ``SEAMS[seam]`` by ``make(original)``."""
        modname, names = SEAMS[seam]
        module = importlib.import_module(f"{PKG}.{modname}")
        for name in names:
            orig = getattr(module, name)
            setattr(module, name, make(orig))
            self._undo.append((module, name, orig))

    def undo(self) -> None:
        while self._undo:
            module, name, orig = self._undo.pop()
            setattr(module, name, orig)


def batch_key(aln: np.ndarray) -> str:
    """A batch's identity: the digest of its first alignment."""
    a = np.ascontiguousarray(aln, dtype=np.uint8)
    return hashlib.sha1(a.tobytes() + str(a.shape).encode()).hexdigest()


def new_record(key: str) -> dict:
    return {"key": key, "hgru": [], "trunk": [], "mds": [], "coord": [], "refine": [],
            "layers": {}}


class Recorder:
    """Records the sampled folds' stages; ``claim(key)`` decides, for the
    batch engine, whether the batch whose first alignment has digest ``key``
    is recorded. Inside the trunk, every layer's output is recorded only in
    the passes ``layer_passes``."""

    def __init__(self, layer_passes=(0,)):
        self.layer_passes = set(layer_passes)
        self.local = threading.local()
        self.records: list = []
        self.claim = lambda key: False
        self._lock = threading.Lock()
        self._patches = Patches()
        self._held = 0             # bytes of the copies on the card
        self._program_peak = 0     # the peak with those bytes taken out
        self._total_peak = 0       # the peak as the card saw it

    def _rec(self):
        return getattr(self.local, "rec", None)

    def start(self, key: str) -> dict:
        rec = new_record(key)
        with self._lock:
            self.records.append(rec)
        self.local.rec = rec
        return rec

    def stop(self) -> None:
        self.local.rec = None

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` for the check. On the card, the peak up to here is
        closed with the bytes held so far taken out, and the peak restarts
        once the copy is held, so that :meth:`peaks` reads the program's own."""
        if not t.is_cuda:
            return t.detach().clone()
        with self._lock:
            seg = torch.cuda.max_memory_allocated(t.device)
            self._total_peak = max(self._total_peak, seg)
            self._program_peak = max(self._program_peak, seg - self._held)
            copy = t.detach().clone()
            torch.cuda.reset_peak_memory_stats(t.device)
            self._held += -(-copy.nbytes // BLOCK_BYTES) * BLOCK_BYTES
        return copy

    def peaks(self, device) -> tuple:
        """(the program's memory peak, the peak with the check's copies)."""
        seg = torch.cuda.max_memory_allocated(device)
        with self._lock:
            return (max(self._program_peak, seg - self._held), max(self._total_peak, seg))

    def install(self) -> None:
        def record(field):
            def make(orig):
                def hooked(*args, **kw):
                    out = orig(*args, **kw)
                    rec = self._rec()
                    if rec is not None:
                        rec[field].append(self.keep(out))
                    return out
                return hooked
            return make

        def gru(orig):
            def hooked(layers, x, valid_len):
                out = orig(layers, x, valid_len)
                rec = self._rec()
                if rec is not None:
                    # the residue biGRU runs before the first trunk pass, the
                    # coordinate biGRU after each
                    rec["coord" if rec["trunk"] else "hgru"].append(self.keep(out))
                return out
            return hooked

        def refine(orig):
            def hooked(coords, n_steps, nres):
                out = orig(coords, n_steps, nres)
                rec = self._rec()
                if rec is not None:
                    rec["refine"].append((self.keep(coords), self.keep(out)))
                return out
            return hooked

        def layer(orig):
            def hooked(*args, **kw):
                outs = orig(*args, **kw)
                rec = self._rec()
                if rec is not None and len(rec["trunk"]) in self.layer_passes:
                    rec["layers"].setdefault(len(rec["trunk"]), []).append(self.keep(outs[0]))
                return outs
            return hooked

        def batch(orig):
            def hooked(folder, aln_b, dmap_b, nseqs, nres, *args):
                key = batch_key(aln_b[0, :nseqs[0], :nres[0]])
                if not self.claim(key):
                    return orig(folder, aln_b, dmap_b, nseqs, nres, *args)
                self.start(key)
                try:
                    return orig(folder, aln_b, dmap_b, nseqs, nres, *args)
                finally:
                    self.stop()
            return hooked

        self._patches.wrap("trunk", record("trunk"))
        self._patches.wrap("mds", record("mds"))
        self._patches.wrap("gru", gru)
        self._patches.wrap("refine", refine)
        self._patches.wrap("batch", batch)
        self._patches.wrap("layer", layer)

    def uninstall(self) -> None:
        self._patches.undo()


class FeatureSpans:
    """CUDA events around each ``engine.fold.pair_features`` call while installed."""

    def __init__(self):
        self.spans: list = []
        self._patches = Patches()

    def install(self) -> None:
        def make(orig):
            def timed(alnmat, *args, **kw):
                if alnmat.device.type != "cuda":
                    return orig(alnmat, *args, **kw)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = orig(alnmat, *args, **kw)
                end.record()
                self.spans.append((start, end))
                return out
            return timed

        self._patches.wrap("features", make)

    def uninstall(self) -> None:
        self._patches.undo()

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.spans]
