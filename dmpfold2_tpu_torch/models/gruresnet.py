"""GRUResNet: the folding network (MSA -> coordinates + confidence).

Counterpart of ``dmpfold2_tpu/models/gruresnet.py:init_params``, ``forward``
and ``forward_batched``: inference on a batch of targets
(:func:`forward_inference`, and :func:`forward` at B 1) and training
(:func:`forward_batched`):

  MSA rows --[2-layer GRU over rows, final state]--> (L, 512)
  --[2-layer biGRU over residues]--> mat1d --outer product--> (L, L, 512)
  concat [pair | DCA 442 | dmap 1] -> 2D trunk -> distance map + confidence
  -> MDS -> coords head (3-layer biGRU + linear)
  -> recycling, keeping the pass with the best mean confidence
  -> CA refinement -> backbone completion.

The vertical GRU, the residue GRUs and the refinement loop go through the
wrappers in ``kernels/``, which launch the hand-written CUDA kernels on a CUDA
device and run their plain versions on the CPU. With ``precision="bf16"``
the trunk runs ``trunk.trunk_apply_bf16`` (its convs through
``kernels/conv_block.py``) on a bf16 input built once per fold; the rest
stays fp32.

The trunk runs over row shards (``seq``, a ``parallel.sharding.SeqShards``;
by default one, the whole map on the leader's device). The leader (the
row's first device) runs the MSA embedding, MDS, the coordinate GRUs,
recycling, refinement and completion; each shard builds its rows of the
pair input from a copy of ``mat1d`` and its rows of the features, runs the
trunk on them and the head's rows come back to the leader.

Shapes are padded: (n_pad, l_pad) from the alignment, with the true (nseqs,
nres) given as ints. Outputs at padded positions are garbage and are sliced
off by the caller.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import conv_block, refine, rgru, vgru
from ..ops.dropout import fold_in
from ..utils.aln import NUM_CLASSES as NUM_AA_CLASSES  # 22
from . import gru
from .geometry import calpha_to_main_chain, mds_coords, refine_coords
from ..features.dca import NUM_DCA_CHANNELS
from ..parallel.sharding import SeqShards, scatter_rows
from ..utils import obs
from ..weights import params_to
from .trunk import PackedTrunk, pack_bf16, trunk_apply, trunk_apply_bf16, trunk_params

WIDTH = 512
CWIDTH = 128
GRU_DROPOUT = 0.1  # between the residue GRUs' layers, in training


def init_params(seed: int = 0, width: int = WIDTH, cwidth: int = CWIDTH, num_blocks: int = 16):
    """Random parameters with the reference initializers, from ``seed`` (CPU)."""
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(width)
    return {
        "vgru": gru.unigru_stack_params(gen, 2, NUM_AA_CLASSES, width),
        "hgru": gru.bigru_stack_params(gen, 2, width, width // 2),
        "trunk": trunk_params(gen, NUM_DCA_CHANNELS + width + 1, cwidth, num_blocks),
        "coord_gru": gru.bigru_stack_params(gen, 3, width + 8, width // 2),
        "coord_fc": (torch.rand((width, 3), generator=gen) * 2.0 - 1.0) * bound,
    }


def check_card_widths(params, precision: str, device, *, training: bool = False) -> None:
    """Raise ``ValueError`` when the CUDA kernels on ``device`` cannot run a
    model of ``params``' widths at ``precision``, naming each broken limit;
    do nothing for the CPU, whose plain versions run any width.

    Shape arithmetic on the parameters, so callers run it before any upload;
    each limit is the kernel module's own (``width_error``). A fold runs
    vgru (width), rgru (width / 2, hgru and coord_gru) and, in bf16, the
    trunk's input GEMM and block conv; a training step runs its GRUs as plain
    scans and its block convs through the conv kernel's argmax mode, so only
    the bf16 block conv limits it. The kernels' row-slab forms (a seq mesh)
    have the same limits.
    """
    if torch.device(device).type != "cuda":
        return
    broken = []
    if not training:
        msg = vgru.width_error(len(params["vgru"]), params["vgru"][0]["wh"].shape[0])
        if msg:
            broken.append(f"vgru (width): {msg}")
        for name in ("hgru", "coord_gru"):
            msg = rgru.width_error(params[name][0]["fwd"]["wh"].shape[0])
            if msg:
                broken.append(f"rgru ({name}, width / 2): {msg}")
    if precision == "bf16":
        trunk = params["trunk"]
        for c_out, c_in in sorted({tuple(b["maxout"]["w"].shape[:2]) for b in trunk["blocks"]}):
            msg = conv_block.conv_width_error(c_in, c_out)
            if msg:
                broken.append(f"the bf16 block conv (cwidth -> 4 x cwidth): {msg}")
        msg = conv_block.gemm_width_error(trunk["input"]["w"].shape[0])
        if msg and not training:
            broken.append(f"the bf16 input GEMM (3 x cwidth outputs): {msg}")
    if broken:
        raise ValueError(f"the CUDA kernels cannot run this model in {precision}: "
                         + "; ".join(broken) + ". Run it with device='cpu' (CLI: -d cpu)")


def pack_params(params, precision: str):
    """The parameters as :func:`forward` takes them at ``precision``: for
    ``bf16`` the trunk packed once for its kernels (``trunk.pack_bf16``)."""
    if precision == "bf16":
        return {**params, "trunk": pack_bf16(params["trunk"])}
    return params


def forward(params, alnmat: torch.Tensor, x2: torch.Tensor, nseqs: int, nres: int,
            nloops: int, refine_steps: int, *, adaptive_recycle: bool = False,
            adaptive_patience: int = 2, precision: str = "fp32",
            canonical_signs: bool = True, mds_impl: str = "eigh"):
    """Run the network on one target: :func:`forward_inference` at B 1.

    Args:
      alnmat: (n_pad, l_pad) int residue classes (0-21), right-padded.
      x2: (l_pad, l_pad, 443) pair features [DCA 442 | dmap seed 1].
      nseqs, nres: true sizes.
      Others as :func:`forward_inference`.

    Returns:
      coords (l_pad, 5, 3), confidence (l_pad,), and the recycles run (int).
    """
    coords, confs, iterations = forward_inference(
        params, alnmat[None], x2[None], [nseqs], [nres], nloops, refine_steps,
        adaptive_recycle=adaptive_recycle, adaptive_patience=adaptive_patience,
        precision=precision, canonical_signs=canonical_signs, mds_impl=mds_impl)
    return coords[0], confs[0], iterations


def forward_inference(params, alnmat: torch.Tensor, x2: torch.Tensor, nseqs, nres,
                      nloops: int, refine_steps: int, *, adaptive_recycle: bool = False,
                      adaptive_patience: int = 2, precision: str = "fp32",
                      canonical_signs: bool = True, mds_impl: str = "eigh", seq=None):
    """Run the network on a batch of targets of one bucket, for inference.

    The counterpart of the JAX ``forward_batched`` (:247-375) as the batch
    engine runs it, with the kernel implementations (vgru, rgru, refine, and
    in bf16 the fused trunk), and of the JAX ``forward`` at B 1: each kernel
    is launched once for the whole batch, with per-target lengths.

    Args:
      params: from :func:`init_params` or ``weights.py``, on ``alnmat``'s
          device, through :func:`pack_params` for ``precision``.
      alnmat: (B, n_pad, l_pad) int residue classes (0-21), right-padded.
      x2: (B, l_pad, l_pad, 443) pair features [DCA 442 | dmap seed 1], zero
          outside each target's valid block.
      nseqs, nres: per-target true sizes, sequences of ints.
      nloops: recycles; with ``adaptive_recycle`` (B 1 only) a cap, stopping
          once the best mean confidence has not improved for
          ``adaptive_patience`` recycles in a row (``-n auto``).
      refine_steps: refinement steps, before and after recycling.
      precision: ``fp32`` (or ``fp32_strict``, the same network), or
          ``bf16``: the trunk in bf16 with fp32 accumulation
          (``trunk.trunk_apply_bf16``); everything else fp32.
      canonical_signs: MDS eigenvector signs made canonical
          (``geometry.mds_coords``); ``False`` keeps the raw signs of
          ``eigh`` (``fp32_strict``).
      mds_impl: ``"eigh"`` or ``"subspace"``, the top-8 eigenpairs by
          subspace iteration (``geometry.mds_coords``; the bf16 engine's).
      seq: a ``parallel.sharding.SeqShards`` over l_pad whose leader holds
          ``alnmat``: the trunk split by rows over its devices; then
          ``params["trunk"]`` is a list, the trunk on each shard's device.

    Returns:
      coords (B, l_pad, 5, 3), confidences (B, l_pad), and the recycles run.
      Each target keeps the pass with its own best mean confidence.

    The tracer's spans (``utils/obs.py``), in order: ``embed``,
    ``pair_input``, then per pass ``trunk``, ``mds`` and ``coord`` (with the
    pass ``index``), the first ``refine``, one ``recycle`` per recycle (the
    dmap, that pass's ``trunk``, ``mds`` and ``coord``, the best-pass
    update), the second ``refine`` and ``complete``.
    """
    batch, n_rows, l_pad = alnmat.shape
    if adaptive_recycle and batch != 1:
        raise ValueError("adaptive recycling (-n auto) folds one target at a time")
    device = alnmat.device
    with obs.span("embed"):
        with obs.wait("sizes"):  # a blocking copy to the device
            nres_t = torch.tensor([int(n) for n in nres], dtype=torch.int32, device=device)
        with obs.wait("sizes"):
            nseqs_t = torch.tensor([int(n) for n in nseqs], dtype=torch.int32, device=device)
        row_mask = (torch.arange(l_pad, device=device)[None, :] < nres_t[:, None]).float()
        pair_mask = row_mask[:, :, None] * row_mask[:, None, :]                       # (B, L, L)
        nres_f = nres_t.float()

        # MSA embedding: the vertical GRU over rows, columns = B * L residue
        # positions, each frozen at its own target's depth; then the horizontal
        # biGRU over residues, batch = targets
        aln_cols = alnmat.to(torch.int32).permute(1, 0, 2).reshape(n_rows, batch * l_pad)
        seq_embed = vgru.vgru_final_cols(params["vgru"], aln_cols.contiguous(),
                                         nseqs_t.repeat_interleave(l_pad))           # (B*L, 512)
        hin = seq_embed.reshape(batch, l_pad, -1).transpose(0, 1)                    # (L, B, 512)
        mat1d = rgru.bigru_stack(params["hgru"], hin, nres_t).transpose(0, 1)
        mat1d = mat1d * row_mask[..., None]                                           # (B, L, 512)

    trunks = params["trunk"]
    if seq is None:
        seq, trunks = SeqShards.split([device], l_pad), [trunks]
    with obs.span("pair_input"):
        trunk_pass = _trunk_pass(trunks, mat1d, x2, pair_mask, nres_t, seq, precision == "bf16")

    def run_iteration(dmap_channel, index):
        with obs.span("trunk", index=index):
            out = trunk_pass(dmap_channel)
            dm = out[..., 0]
            conf = (out[..., 1] * row_mask[:, None, :]).sum(dim=2) / nres_f[:, None]
        with obs.span("mds", index=index):
            mds = mds_coords(dm, nres_t, canonical_signs=canonical_signs,
                             impl=mds_impl)                                           # (B, L, 8)
        with obs.span("coord", index=index):
            coordembed = torch.cat([mat1d, mds], dim=2).transpose(0, 1)              # (L, B, 520)
            gru_out = rgru.bigru_stack(params["coord_gru"], coordembed, nres_t).transpose(0, 1)
            return gru_out @ params["coord_fc"], conf                         # (B, L, 3), (B, L)

    def mean_conf(conf):
        return (conf * row_mask).sum(dim=1) / nres_f                                  # (B,)

    # initial pass: dmap channel from x2 (template distances or -1 fill)
    ca, conf = run_iteration(x2[..., -1], 0)
    with obs.span("refine", index=0):
        ca = refine.refine_coords_batched(ca.contiguous(), refine_steps, nres_t)
        best_mean, best_conf, best_coords = mean_conf(conf), conf, ca

    # recycling: predicted distances fed back as the last input channel. The
    # best pass per target is tracked on the device; only -n auto reads it
    # on the host.
    iterations, stall = 0, 0
    while iterations < nloops and stall < adaptive_patience:
        with obs.span("recycle", index=iterations + 1):
            diffs = ca[:, :, None, :] - ca[:, None, :, :]
            dmap = torch.sqrt(torch.clamp(diffs.square().sum(dim=3), min=1e-8)) * pair_mask
            ca, conf = run_iteration(dmap, iterations + 1)
            mean_new = mean_conf(conf)
            better = mean_new > best_mean
            best_mean = torch.where(better, mean_new, best_mean)
            best_conf = torch.where(better[:, None], conf, best_conf)
            best_coords = torch.where(better[:, None, None], ca, best_coords)
            iterations += 1
            if adaptive_recycle:
                with obs.wait("adaptive"):
                    improved = bool(better[0])
                stall = 0 if improved else stall + 1

    with obs.span("refine", index=1):
        best_coords = refine.refine_coords_batched(best_coords.contiguous(), refine_steps,
                                                   nres_t)
    with obs.span("complete"):
        coords = calpha_to_main_chain(best_coords, nres_t)
        return coords, torch.sigmoid(best_conf), iterations


def _bf16_input(packed, pair: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The bf16 engine's trunk input: a (B, R, L, k_pad) bf16 map [pair |
    DCA 442 | (the dmap slot) | zeros to k_pad], the width the GEMM kernel
    reads, and the dmap channel's slot."""
    if not isinstance(packed, PackedTrunk):
        raise TypeError("precision='bf16' needs the trunk packed by "
                        "gruresnet.pack_params(params, 'bf16')")
    width = pair.shape[3]
    slot = width + NUM_DCA_CHANNELS
    resinp = torch.zeros((*pair.shape[:3], packed.k_pad), dtype=torch.bfloat16,
                         device=pair.device)
    resinp[..., :width] = pair
    resinp[..., width:slot] = x2[..., :-1]
    return resinp, slot


def _shard_rows(seq, mat1d: torch.Tensor, x2: torch.Tensor, pair_mask: torch.Tensor):
    """Each shard's rows of the trunk input's parts, on its device: (pair
    rows (B, R_k, L, 512) from a copy of ``mat1d``, x2 rows, mask rows (B,
    R_k, L, 1)); one shard's are views of the whole map's."""
    mats = seq.replicate(mat1d.to)
    pairs = [m[:, seq.rows(k), None, :] * m[:, None, :, :] for k, m in enumerate(mats)]
    return pairs, scatter_rows(seq, x2), scatter_rows(seq, pair_mask[..., None])


def _trunk_pass(trunks: list, mat1d: torch.Tensor, x2: torch.Tensor, pair_mask: torch.Tensor,
                nres_t: torch.Tensor, seq, bf16_engine: bool):
    """The trunk input's rows built once on each shard's device; returns a
    function that scatters a pass's (B, L, L) dmap channel by rows, runs the
    trunk over the shards and returns its (B, L, L, 2) output on the leader.

    ``bf16_engine``: the bf16 fold's input, (B, R_k, L, k_pad) [pair | DCA
    442 | the dmap slot | zeros] (:func:`_bf16_input`), each pass's dmap
    written into its slot in place (passes run in stream order), through
    ``trunk_apply_bf16``; otherwise ``trunk_apply`` on the 955 channels,
    with the keywords the function is given."""
    pairs, x2s, masks = _shard_rows(seq, mat1d, x2, pair_mask)
    if bf16_engine:
        inputs = [_bf16_input(t, p, x) for t, p, x in zip(trunks, pairs, x2s)]
        del pairs, x2s
        resinps = [r for r, _ in inputs]
        slot = inputs[0][1]

        def trunk_pass(dmap_channel):
            for resinp, rows in zip(resinps, scatter_rows(seq, dmap_channel)):
                resinp[..., slot] = rows
            return trunk_apply_bf16(trunks, resinps, masks, nres_t, seq)

        return trunk_pass
    bases = [torch.cat([p, x[..., :-1]], dim=3) for p, x in zip(pairs, x2s)]   # 954 channels
    del pairs, x2s

    def trunk_pass(dmap_channel, **kw):
        resinps = [torch.cat([base, rows[..., None]], dim=3)
                   for base, rows in zip(bases, scatter_rows(seq, dmap_channel))]
        return trunk_apply(trunks, resinps, masks, seq, **kw)

    return trunk_pass


def forward_batched(params, alnmat: torch.Tensor, x2: torch.Tensor, nseqs, nres,
                    nloops: int, refine_steps: int, *, rngs: dict | None = None,
                    remat=False, compute_dtype=torch.float32, shard=None, seq=None):
    """Batched training forward, differentiable: (B, N, L) alignments ->
    ((B, L, 5, 3) coords, (B, L) confidences).

    Counterpart of the JAX ``gruresnet.forward_batched`` (:247-375) as the
    training step runs it: the GRUs, MDS and refinement in fp32 plain
    PyTorch, differentiated by autograd (the inference kernels have no
    backward; the JAX training path runs its scans too), the trunk through
    ``trunk.trunk_apply`` in ``compute_dtype``.

    Args:
      params: fp32 parameters (``init_params`` layout) on ``alnmat``'s device.
      x2: (B, L, L, 443) pair features [DCA 442 | dmap seed 1].
      nseqs, nres: per-target true sizes, sequences of ints.
      nloops: recycles (an int: the loop is unrolled for the backward).
      rngs: dropout seeds {"hgru", "init", "recycle"} (``ops.dropout``); None
          turns dropout off. Recycle i uses ``fold_in(rngs["recycle"], i)``.
      shard: ``(offset, total)``: this batch is rows ``offset ..`` of a
          data-parallel global batch of ``total``; each dropout mask is drawn
          at the global shape and these rows kept (``ops.dropout``).
      remat: the step's tier (``train/step.py:resolve_remat``): False, True or
          "save_conv" for the trunk; "recycle" / "recycle_save_conv" also
          checkpoint each trunk-and-coordinate pass (full-body or save_conv
          block remat inside the replay).
      seq: a ``parallel.sharding.SeqShards`` over L whose leader holds the
          parameters: the trunk split by rows over its devices, its
          parameters copied to each shard's device on every forward
          (differentiably, so the gradients land on the leader's leaves);
          the rest runs on the leader.
    """
    batch, n_rows, l_pad = alnmat.shape
    device = alnmat.device
    nres_l, nseqs_l = [int(n) for n in nres], [int(n) for n in nseqs]
    remat_recycle = remat in ("recycle", "recycle_save_conv")
    if remat_recycle:
        remat = "save_conv" if remat == "recycle_save_conv" else True
    nres_t = torch.tensor(nres_l, dtype=torch.int32, device=device)
    row_mask = (torch.arange(l_pad, device=device)[None, :] < nres_t[:, None]).float()  # (B, L)
    pair_mask = row_mask[:, :, None] * row_mask[:, None, :]                           # (B, L, L)
    nres_f = nres_t.float()
    seed = (lambda name: None) if rngs is None else rngs.get

    # vertical GRU over rows: columns = B * L residue positions, each frozen
    # at its own target's depth; chunk-checkpointed when remat is on
    x = F.one_hot(alnmat.long(), NUM_AA_CLASSES).float()                              # (B, N, L, 22)
    x_cols = x.permute(1, 0, 2, 3).reshape(n_rows, batch * l_pad, NUM_AA_CLASSES)
    col_valid = torch.tensor(nseqs_l, dtype=torch.int32, device=device).repeat_interleave(l_pad)
    seq_embed = gru.unigru_stack_final(params["vgru"], x_cols, col_valid,
                                       remat_chunk=128 if remat else 0)
    hin = seq_embed.reshape(batch, l_pad, -1).transpose(0, 1)                         # (L, B, 512)
    mat1d = gru.bigru_stack(params["hgru"], hin, nres_t, dropout_rate=GRU_DROPOUT,
                            seed=seed("hgru"), shard=shard)
    mat1d = mat1d.transpose(0, 1) * row_mask[..., None]                               # (B, L, 512)
    trunk_kw = dict(remat=remat, compute_dtype=compute_dtype, dropout_shard=shard)
    if seq is None:
        seq = SeqShards.split([device], l_pad)
    # .to() copies (none on the leader), which autograd differentiates back
    # to the leader's leaves
    trunks = seq.replicate(lambda d: params_to(params["trunk"], d))
    trunk_pass = _trunk_pass(trunks, mat1d, x2, pair_mask, nres_t, seq, False)

    def run_trunk(dmap_channel, trunk_seed):
        return trunk_pass(dmap_channel, dropout_seed=trunk_seed, **trunk_kw)

    def run_iteration(dmap_channel, it_seed):
        trunk_seed = coord_seed = None
        if it_seed is not None:
            trunk_seed, coord_seed = fold_in(it_seed, 0), fold_in(it_seed, 1)
        out = run_trunk(dmap_channel, trunk_seed)
        dm = out[..., 0]
        conf = (out[..., 1] * row_mask[:, None, :]).sum(dim=2) / nres_f[:, None]
        # eigh: the subspace MDS is inference-only (JAX's has no VJP)
        mds = torch.stack([mds_coords(dm[b], nres_l[b]) for b in range(batch)])    # (B, L, 8)
        coordembed = torch.cat([mat1d, mds], dim=2).transpose(0, 1)
        gru_out = gru.bigru_stack(params["coord_gru"], coordembed, nres_t,
                                  dropout_rate=GRU_DROPOUT, seed=coord_seed, shard=shard)
        return gru_out.transpose(0, 1) @ params["coord_fc"], conf                     # (B, L, 3)

    def iteration(dmap_channel, it_seed):
        if remat_recycle and torch.is_grad_enabled():
            return checkpoint(run_iteration, dmap_channel, it_seed, use_reentrant=False)
        return run_iteration(dmap_channel, it_seed)

    def refine_b(ca):
        return torch.stack([refine_coords(ca[b], refine_steps, nres_l[b]) for b in range(batch)])

    ca, conf = iteration(x2[..., -1], seed("init"))
    ca = refine_b(ca)
    best_conf, best_coords = conf, ca
    best_mean = (conf * row_mask).sum(dim=1) / nres_f                                 # (B,)
    for i in range(nloops):
        diffs = ca[:, :, None, :] - ca[:, None, :, :]
        dmap = torch.sqrt(torch.clamp(diffs.square().sum(dim=3), min=1e-8)) * pair_mask
        it_seed = None if rngs is None else fold_in(rngs["recycle"], i)
        ca, conf = iteration(dmap, it_seed)
        mean_new = (conf * row_mask).sum(dim=1) / nres_f
        better = mean_new > best_mean
        best_mean = torch.where(better, mean_new, best_mean)
        best_conf = torch.where(better[:, None], conf, best_conf)
        best_coords = torch.where(better[:, None, None], ca, best_coords)

    best_coords = refine_b(best_coords)
    coords = torch.stack([calpha_to_main_chain(best_coords[b], nres_l[b]) for b in range(batch)])
    return coords, torch.sigmoid(best_conf)
