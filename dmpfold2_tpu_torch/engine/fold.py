"""The folding engine: from an MSA to a structure on one device.

Counterpart of ``dmpfold2_tpu/engine/fold.py`` for the single-target fold
(and, in :func:`fold_padded_batch`, the batch engine's device body) in
three engines: ``fp32``; ``bf16`` (the trunk in bf16 with fp32
accumulation; everything else as in fp32); and ``fp32_strict``, the fp32
engine as the reference computes it, for comparing with a reference run: the
LU DCA inverse (the reference's ``torch.inverse``) and the raw eigenvector
signs of ``eigh``, with TF32 off as in every engine. Host code parses and pads;
everything after runs on the chosen device: one-hot, reweighting, DCA, the
network with recycling, refinement and backbone completion. On a CUDA device
the vertical GRU, the residue GRUs, the refinement loop and, in bf16, the
trunk's input layer and block convs run as hand-written CUDA kernels
(``kernels/``); on the CPU their plain versions run. Nothing else chooses
between them: the device of the tensors does.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``, and
raise if CUDA is missing.

One long target over several devices: ``Folder(params, mesh=make_mesh(1,
n_seq))`` splits the pair trunk by rows over the mesh row
(``parallel/sharding.py``); the row's first device computes the features and
runs the rest of the network.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import FoldConfig, check_precision
from ..features.dca import NUM_DCA_CHANNELS, check_method, dca_or_zero
from ..features.msa import msa_one_hot, reweight
from ..kernels import _build
from ..models import gruresnet
from ..parallel.sharding import SeqShards
from ..utils import aln as aln_io
from ..utils import obs
from ..utils import pdb as pdb_io
from ..weights import load_npz, load_pt, params_to
from .buckets import bucket_shape

DEFAULT_ITERATIONS = FoldConfig.iterations
DEFAULT_MINSTEPS = FoldConfig.minsteps
# `-n auto` recycles until the confidence plateaus, capped here
AUTO_ITERATIONS_CAP = 30
AUTO_PATIENCE = 2


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; CUDA that is missing raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the PyTorch port runs on the GPU by default; "
            "pass device='cpu' (CLI: -d cpu) to run its plain versions on the CPU")
    return dev


def resolve_dca_method(setting: str, precision: str) -> str:
    """The DCA inverse a fold runs: an explicit setting (one of
    ``features.dca.METHODS``) wins; ``"auto"`` is ``"lu"`` for ``fp32_strict``
    (the reference's ``torch.inverse`` is an LU inverse, and the Cholesky
    inverse differs from it at about 1e-6, which recycling can amplify) and
    ``"cholesky"`` otherwise (half the operations of LU on a positive definite
    matrix; the blocked inverse above ``ops/chol.py:BLOCKED_THRESHOLD``), the
    JAX package's choice off the TPU."""
    if setting != "auto":
        check_method(setting)
        return setting
    return "lu" if precision == "fp32_strict" else "cholesky"


def use_full_fp32() -> None:
    """fp32 means fp32: turn TF32 off for matmuls and cuDNN convolutions.

    cuDNN convolutions default to TF32 (about three decimal digits), which the
    fp32 engine must not use. Both engines call this: the bf16 engine's fp32
    parts (DCA, GRUs, MDS, the trunk head) stay full fp32 too. The JAX bf16
    engine runs its DCA matmuls at a lower precision ("high"), but TF32 here
    is a process-wide PyTorch switch, so an engine that turned it on would
    leak it into an fp32 fold in the same process.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_mds_impl(precision: str) -> str:
    """The MDS of an engine: the top-8 eigenpairs by subspace iteration in
    bf16, the full ``eigh`` in ``fp32`` and ``fp32_strict`` (the reference
    computes a full symeig, network.py:247). JAX's ``resolve_mds_impl``
    without its backend test: an engine computes the same function on the
    card and on the CPU."""
    return "subspace" if precision == "bf16" else "eigh"


def pair_features(alnmat: torch.Tensor, nseqs, nres, dmap_channel: torch.Tensor,
                  dca_method: str = "cholesky") -> torch.Tensor:
    """(B, n_pad, l_pad) int32 alignments, per-target sizes (sequences of
    ints), (B, l_pad, l_pad) dmap channels -> (B, l_pad, l_pad, 443) pair
    features [DCA 442 | dmap 1], one target at a time (the (21L)^2 DCA
    inverse of a whole batch at once would need B times the memory; a single
    sequence gives zero DCA), each target's DCA written straight into its
    slice. ``dca_method`` as :func:`resolve_dca_method` gives it. The
    tracer's span ``features``."""
    with obs.span("features"):
        batch, _, l_pad = alnmat.shape
        x2 = torch.empty((batch, l_pad, l_pad, NUM_DCA_CHANNELS + 1), device=alnmat.device)
        for b in range(batch):
            oh = msa_one_hot(alnmat[b], nseqs[b], nres[b])
            w = reweight(oh, nres[b])
            dca_or_zero(oh, w, nseqs[b], nres[b], method=dca_method,
                        out=x2[b, :, :, :NUM_DCA_CHANNELS])
            del oh, w
        x2[..., NUM_DCA_CHANNELS] = dmap_channel
        return x2


def fold_padded_batch(params, alnmat: torch.Tensor, nseqs, nres, dmap_channel: torch.Tensor,
                      nloops: int, refine_steps: int, adaptive: bool = False,
                      precision: str = "fp32", dca_method: str = "cholesky", seq_row=None):
    """(B, n_pad, l_pad) int32 alignments of one bucket on the device,
    per-target sizes (sequences of ints), (B, l_pad, l_pad) dmap channels ->
    (coords (B, l_pad, 5, 3), confidences (B, l_pad), recycles run).
    ``params`` as ``gruresnet.pack_params`` gives them for ``precision``;
    ``dca_method`` as :func:`resolve_dca_method` gives it. ``fp32_strict``
    keeps the raw eigenvector signs; the MDS is :func:`resolve_mds_impl`'s.
    ``seq_row``: (device, trunk parameters there) for each device of a mesh
    row whose first device holds ``alnmat`` and ``params``: the trunk split
    by rows over them."""
    x2 = pair_features(alnmat, nseqs, nres, dmap_channel, dca_method)
    seq = None
    if seq_row is not None:
        seq = SeqShards.split([d for d, _ in seq_row], alnmat.shape[2])
        params = {**params, "trunk": [t for _, t in seq_row[:seq.n]]}
    return gruresnet.forward_inference(params, alnmat, x2, nseqs, nres, nloops, refine_steps,
                                       adaptive_recycle=adaptive,
                                       adaptive_patience=AUTO_PATIENCE, precision=precision,
                                       canonical_signs=precision != "fp32_strict",
                                       mds_impl=resolve_mds_impl(precision), seq=seq)


def fold_padded(params, alnmat: torch.Tensor, nseqs: int, nres: int,
                dmap_channel: torch.Tensor, nloops: int, refine_steps: int,
                adaptive: bool = False, precision: str = "fp32", dca_method: str = "cholesky",
                seq_row=None):
    """(n_pad, l_pad) int32 alignment on the device -> (coords (l_pad, 5, 3),
    confidences (l_pad,), recycles run): :func:`fold_padded_batch` at B 1."""
    coords, confs, used = fold_padded_batch(params, alnmat[None], [nseqs], [nres],
                                            dmap_channel[None], nloops, refine_steps,
                                            adaptive=adaptive, precision=precision,
                                            dca_method=dca_method, seq_row=seq_row)
    return coords[0], confs[0], used


def pad_target(alnmat: np.ndarray, template_ca: np.ndarray | None, n_pad: int, l_pad: int):
    """One target's host inputs at its bucket's shape: the (n_pad, l_pad)
    int32 alignment and the (l_pad, l_pad) dmap channel."""
    nseqs, nres = alnmat.shape
    aln_p = np.zeros((n_pad, l_pad), np.int32)
    aln_p[:nseqs, :nres] = alnmat
    return aln_p, _build_dmap_channel(l_pad, nres, template_ca)


def _build_dmap_channel(l_pad: int, nres: int, template_ca: np.ndarray | None) -> np.ndarray:
    """Last input channel: template CA distance map, or -1 fill (predict.py:142-145).

    Valid L x L region only; zero outside.
    """
    dmap = np.zeros((l_pad, l_pad), np.float32)
    if template_ca is None:
        dmap[:nres, :nres] = -1.0
    else:
        if template_ca.shape[0] != nres:
            raise ValueError(
                f"template has {template_ca.shape[0]} CA atoms but alignment "
                f"has {nres} residues — lengths must match")
        diffs = template_ca[:, None, :] - template_ca[None, :, :]
        dmap[:nres, :nres] = np.sqrt((diffs ** 2).sum(-1))
    return dmap


class Folder:
    """Holds the parameters on one device, or on each device of one mesh
    row, and folds single targets.

    With ``precision="bf16"`` the trunk weights are packed for the bf16
    kernels here, once per device, not per fold. On a CUDA device, widths
    the kernels cannot run raise ``ValueError`` before any upload.
    ``dca_method`` is resolved once (:func:`resolve_dca_method`).
    ``use_buckets=False`` folds at the target's exact (nseqs, nres) instead
    of its bucket's shape.

    ``mesh`` (``parallel.mesh.make_mesh(1, n_seq)``, in place of ``device``):
    each fold's pair trunk split by rows over the row's devices (the
    counterpart of JAX's ``Folder.fold`` under ``jax.set_mesh(mesh)`` and
    ``pair_sharding("seq")``); its first device holds the features and the
    rest of the network.
    """

    def __init__(self, params, device=None, precision: str = "fp32",
                 dca_method: str = "auto", use_buckets: bool = True, mesh=None):
        check_precision(precision)
        self.dca_method = resolve_dca_method(dca_method, precision)
        row = (device,)
        if mesh is not None:
            if device is not None:
                raise ValueError("Folder: pass a device or a mesh, not both")
            if mesh.n_local != 1 or mesh.world_size != 1:
                raise ValueError(f"Folder: a mesh of one row (1 x n_seq) in one process; got "
                                 f"{mesh.shape} over {mesh.world_size} processes (BatchFolder "
                                 "spreads batches over a data axis)")
            row = mesh.devices[0]
        self.devices = row = tuple(resolve_device(d) for d in row)
        self.device = row[0]
        gruresnet.check_card_widths(params, precision, self.device)
        use_full_fp32()
        by_device: dict = {}
        for dev in row:
            if dev not in by_device:
                by_device[dev] = gruresnet.pack_params(params_to(params, dev), precision)
        self.params = by_device[self.device]
        # (device, its trunk) per device of a seq row; None folds on one device
        self.seq_row = (tuple((dev, by_device[dev]["trunk"]) for dev in row)
                        if len(row) > 1 else None)
        self.precision = precision
        self.use_buckets = use_buckets

    def fold(self, alnmat: np.ndarray, template_ca: np.ndarray | None = None,
             iterations=DEFAULT_ITERATIONS, minsteps: int = DEFAULT_MINSTEPS):
        """Fold one target. Returns ((nres, 5, 3) coords, (nres,) confidences).

        ``iterations`` may be ``"auto"``: recycle until the best mean
        confidence has not improved for 2 recycles, at most
        ``AUTO_ITERATIONS_CAP``. The tracer's unit ``fold``.
        """
        with obs.unit("fold", self.device):
            coords, confs, _ = self.fold_async(alnmat, template_ca, iterations, minsteps)()
        return coords, confs

    def fold_async(self, alnmat: np.ndarray, template_ca: np.ndarray | None = None,
                   iterations=DEFAULT_ITERATIONS, minsteps: int = DEFAULT_MINSTEPS):
        """Run one fold on the calling thread; returns a callable that fetches
        ``(coords, confs, recycles run)`` to the host.

        This does not return before the device has run most of the fold:
        ``torch.linalg.eigh`` waits for its status on the host once per trunk
        pass (the full MDS in fp32, the q x q Rayleigh-Ritz step of the
        subspace MDS in bf16), and ``"auto"`` also reads each recycle's
        confidence to decide whether to go on. To keep a thread free, fold
        through ``parallel.stream.BatchFolder``, whose workers run the batches.
        """
        adaptive = iterations == "auto"
        nloops = AUTO_ITERATIONS_CAP if adaptive else max(int(iterations), 0)
        nseqs, nres = alnmat.shape
        aln_p, dmap = pad_target(alnmat, template_ca,
                                 *bucket_shape(nseqs, nres, self.use_buckets))
        with torch.inference_mode():
            with obs.wait("upload"):
                aln_d = torch.from_numpy(aln_p).to(self.device)
            with obs.wait("upload"):
                dmap_d = torch.from_numpy(dmap).to(self.device)
            coords, confs, used = fold_padded(
                self.params, aln_d, nseqs, nres, dmap_d, nloops, max(int(minsteps), 0),
                adaptive=adaptive, precision=self.precision, dca_method=self.dca_method,
                seq_row=self.seq_row)

        def fetch():
            with obs.wait("fetch"):
                coords_h = coords[:nres].cpu()
            with obs.wait("fetch"):
                confs_h = confs[:nres].cpu()
            return coords_h.numpy(), confs_h.numpy(), used

        return fetch

    def warmup(self, shapes=((256, 96),), iterations: int = 1, minsteps: int = 1) -> None:
        """Fold an all-zero alignment of each (nseqs, nres) shape once.

        On a CUDA device this first builds every kernel (one nvcc per
        source, all started together), then the folds create the cuBLAS,
        cuDNN and cuSOLVER handles and fill the caching allocator for those
        buckets, so the first real fold pays none of it.
        """
        if self.device.type == "cuda":
            _build.build()
        for nseqs, nres in shapes:
            self.fold(np.zeros((nseqs, nres), np.uint8), iterations=iterations,
                      minsteps=minsteps)


def _default_weight_paths():
    modeldir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "trained_model")
    paths = [os.path.join(modeldir, f"FINAL_fullmap_e2e_model_part{i}.pt") for i in (1, 2)]
    return modeldir, paths


def load_weights(weights_file: str | None = None):
    """Parameters from ``weights_file`` (``.npz`` or a torch ``.pt`` state
    dict), or else from ``trained_model/`` inside the package.

    The port has no download path: without a file it raises.
    """
    if weights_file is not None:
        if weights_file.endswith(".npz"):
            return load_npz(weights_file)
        return load_pt([weights_file])
    modeldir, paths = _default_weight_paths()
    native = os.path.join(modeldir, "params.npz")
    if os.path.isfile(native):
        return load_npz(native)
    if all(os.path.isfile(p) for p in paths):
        return load_pt(paths)
    raise FileNotFoundError(
        f"no model weights: pass -w/--model_weights (.npz or .pt), or place "
        f"params.npz or the two released FINAL_fullmap_e2e_model_part*.pt files "
        f"in {modeldir}. The port does not download weights.")


def aln_to_coords(input_file: str, device=None, template: str | None = None,
                  iterations=None, minsteps: int | None = None,
                  weights_file: str | None = None, return_alnmat: bool = False,
                  params=None, config: FoldConfig | None = None):
    """Reference API (predict.py:74): aln file -> ((nres, 5, 3) coords, (nres,) confs).

    ``device`` is a torch device (default ``cuda``). ``params`` skips weight
    loading. Explicit keyword arguments override ``config``'s fields.
    """
    cfg = config or FoldConfig()
    if iterations is None:
        iterations = cfg.iterations
    if minsteps is None:
        minsteps = cfg.minsteps
    if template is None:
        template = cfg.template
    if weights_file is None:
        weights_file = cfg.weights_file
    if device is None:
        device = cfg.device
    check_precision(cfg.precision)  # fail before parsing or loading
    resolve_dca_method(cfg.dca_method, cfg.precision)  # likewise
    folder_device = resolve_device(device)
    alnmat = aln_io.parse_aln(input_file)
    template_ca = pdb_io.parse_template_ca(template) if template is not None else None
    if params is None:
        params = load_weights(weights_file)
    folder = Folder(params, device=folder_device, precision=cfg.precision,
                    dca_method=cfg.dca_method, use_buckets=cfg.use_buckets)
    coords, confs = folder.fold(alnmat, template_ca, iterations, minsteps)
    if return_alnmat:
        return coords, confs, alnmat
    return coords, confs
