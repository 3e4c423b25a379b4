"""Training step: teacher forcing, the batched loss, Adam with accumulation.

Counterpart of ``dmpfold2_tpu/train/step.py`` on its natively batched path
(``batch_loss_native``, the path the JAX loop takes off-mesh; reference
train.py:230-374): random recycling depth, refinement differentiated
through, 50% teacher forcing of the distance-map channel with noised
ground-truth CAs, Adam, gradient accumulation, a non-finite guard.

Data-parallel training (``train_step(mesh=...)``, one process per device):
each rank runs this native batch path on its shard of the micro-batch. Its
loss is its samples' summed losses over the GLOBAL batch size, and the
gradients and metrics are all-reduced (sum) in one collective; every rank
then holds the same summed gradients, so every rank takes or skips the same
steps. Randomness is shard-invariant: sample i of the global batch draws its
teacher forcing from ``fold_in(seed, i)`` and its dropout rows from masks
drawn at the global shape. The JAX package's
vmapped per-sample path (``native_batch=False``) exists for GSPMD sharding
and is not ported.

Residue-axis sharding (a mesh whose rows hold ``n_seq > 1`` devices): each
process's data shard runs the same native batch path with its trunk split
by rows over its row (``gruresnet.forward_batched(seq=...)``); the dropout
masks are the rows of the unsharded draw, so the step is the unsharded one.

With ``precision="bf16"`` the trunk runs in bf16 with every block conv
through ``kernels/conv_block.py:conv5x5_maxout_diff``: on a CUDA device the
argmax mode of the hand-written conv kernel and its backward, on the CPU the
kernel's plain version. The rest stays fp32. The reference's in-place noise
bug (train.py:313-314 noises the loss target's CA trace too) is reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..engine.fold import use_full_fp32
from ..features.dca import dca_or_zero
from ..features.msa import msa_one_hot, reweight
from ..models import gruresnet
from ..ops.dropout import fold_in
from ..parallel.sharding import SeqShards
from ..weights import keypaths
from .loss import fold_loss

REFINE_STEPS = TrainConfig.refine_steps
MAX_ITERATIONS = TrainConfig.max_iterations
TEACHER_PROB = 0.5
TEACHER_NOISE = 0.5  # Angstrom, the std of the noise on the teacher's CAs


class TrainBatch(NamedTuple):
    """One padded micro-batch (host arrays, ``dataset.pad_to_bucket``)."""

    alnmat: np.ndarray   # (B, N, L) int32
    targets: np.ndarray  # (B, L, 5, 3) ground-truth atoms
    nseqs: np.ndarray    # (B,)
    nres: np.ndarray     # (B,)


def trainable(params, device):
    """A copy of the parameters on ``device`` as fp32 leaves that require
    grad; TF32 off (``engine.fold.use_full_fp32``): the fp32 parts must stay
    fp32."""
    use_full_fp32()

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v) for v in node]
        return node.detach().to(device, torch.float32, copy=True).requires_grad_()

    return copy(params)


def leaves(params) -> list:
    """The parameter tensors in a fixed order (sorted JAX key paths)."""
    return [leaf for _, leaf in keypaths(params)]


def draw_prep(seed: int, l_pad: int, teacher_prob: float = TEACHER_PROB):
    """One sample's teacher-forcing draws from ``seed`` (on the CPU, so every
    device draws the same): (use teacher forcing?, (l_pad, 3) standard
    normal noise)."""
    gen = torch.Generator().manual_seed(seed)
    use_tf = bool(torch.rand((), generator=gen) < teacher_prob)
    return use_tf, torch.randn((l_pad, 3), generator=gen)


def prep_sample(alnmat: torch.Tensor, targets: torch.Tensor, nseqs: int, nres: int,
                use_tf: bool, noise: torch.Tensor):
    """One sample's inputs: (x2 (L, L, 443), targets (L, 5, 3)).

    DCA features without gradients (train.py:175); the dmap channel is the
    distance map of the target's CAs plus ``TEACHER_NOISE * noise`` when
    ``use_tf``, else -1 on the valid block. A pure function of its inputs,
    so tests feed it JAX's bits (the JAX ``_prep_sample``).
    """
    l_pad = alnmat.shape[1]
    row = (torch.arange(l_pad, device=alnmat.device) < nres).float()
    pair_mask = row[:, None] * row[None, :]
    with torch.no_grad():
        oh = msa_one_hot(alnmat, nseqs, nres)
        dca = dca_or_zero(oh, reweight(oh, nres), nseqs, nres)
    noised_ca = targets[:, 1, :] + TEACHER_NOISE * noise.to(targets.device)
    if use_tf:
        diffs = noised_ca[:, None, :] - noised_ca[None, :, :]
        dmap_seed = torch.sqrt(torch.clamp(diffs.square().sum(dim=2), min=1e-16)) * pair_mask
        # the reference bug (train.py:313-314): the loss target's CA trace is
        # the noised one
        targets = targets.clone()
        targets[:, 1, :] = noised_ca
    else:
        dmap_seed = torch.where(pair_mask > 0, -1.0, 0.0)
    return torch.cat([dca, dmap_seed[:, :, None]], dim=2), targets


def resolve_remat(params, batch_size: int, l_pad: int, nloops: int, fused: bool):
    """The step's rematerialization tier, the JAX ``_resolve_remat``
    (step.py:93-146) with its thresholds, which were sized for a 16 GB TPU
    (retuning them for 80 GB is ROADMAP work).

    ``"save_conv"`` keeps each block's conv output (and, fused, its int8
    index) and replays the norm + scse tail; True checkpoints whole blocks;
    ``"recycle"`` / ``"recycle_save_conv"`` also checkpoint each pass. The
    trunk's geometry comes from ``params``.
    """
    blocks = params["trunk"]["blocks"]
    num_blocks, cwidth = len(blocks), blocks[0]["maxout"]["w"].shape[1]
    in_channels = params["trunk"]["input"]["w"].shape[1]  # 955 on flagship
    area = batch_size * l_pad * l_pad
    # full-body remat still banks, per trunk pass: the block carries + the
    # full-channel pass input (bf16)
    per_pass = area * (num_blocks * cwidth + in_channels) * 2
    if (nloops + 1) * per_pass > 9e9:
        one_pass_sc = num_blocks * area * cwidth * 6
        return "recycle_save_conv" if one_pass_sc <= 7e9 else "recycle"
    per_elem = 6 if fused else 12  # bytes per (L^2, cwidth) element saved
    est = (nloops + 1) * num_blocks * area * cwidth * per_elem
    return "save_conv" if est <= 8e9 else True


def batch_loss_native(params, alnmat: torch.Tensor, targets: torch.Tensor, nseqs, nres,
                      draws, *, nloops: int, refine_steps: int = REFINE_STEPS,
                      dropout_seed: int | None = None, precision: str = "fp32", remat=True,
                      slot_offset: int = 0, global_batch: int | None = None, seq=None):
    """The batched micro-batch loss: the samples' losses summed over the
    global batch size (their mean when this is the whole batch), and metrics
    likewise.

    ``alnmat`` (B, N, L) and ``targets`` (B, L, 5, 3) on the device; ``nseqs``
    and ``nres`` sequences of ints; ``draws``: per sample (use_tf, noise) as
    :func:`draw_prep` gives. Each sample's prep runs on its own, one after
    another (the (21L)^2 DCA inverse of a whole batch at once would need B
    times the memory). ``dropout_seed`` None turns dropout off. Under data
    parallelism these B samples are slots ``slot_offset ..`` of a global
    batch of ``global_batch`` (default B), and the dropout masks are drawn
    for it. ``seq``: a ``parallel.sharding.SeqShards``, the trunk split by
    rows over its devices.
    """
    x2s, tgts = [], []
    for i, (use_tf, noise) in enumerate(draws):
        x2, tgt = prep_sample(alnmat[i], targets[i], int(nseqs[i]), int(nres[i]), use_tf, noise)
        x2s.append(x2)
        tgts.append(tgt)
    total = len(draws) if global_batch is None else global_batch
    shard = None if total == len(draws) else (slot_offset, total)
    rngs = None
    if dropout_seed is not None:
        rngs = {name: fold_in(dropout_seed, k) for k, name in enumerate(("hgru", "init",
                                                                          "recycle"))}
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    coords, confs = gruresnet.forward_batched(
        params, alnmat, torch.stack(x2s), nseqs, nres, nloops, refine_steps, rngs=rngs,
        remat=remat, compute_dtype=dtype, shard=shard, seq=seq)
    per_sample = [fold_loss(coords[i], confs[i], tgts[i], int(nres[i]))
                  for i in range(len(draws))]
    losses = torch.stack([loss for loss, _ in per_sample])
    metrics = {k: torch.stack([m[k] for _, m in per_sample]).sum() / total
               for k in per_sample[0][1]}
    metrics["sample_loss"] = losses.detach()
    return losses.sum() / total, metrics


class Optimizer:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) over the
    parameter leaves, with ``optax.MultiSteps`` accumulation: for
    ``accum_steps`` k > 1 each micro-step folds its gradient into a running
    mean (``acc += (g - acc) / (n + 1)``) and every k-th takes one Adam step
    on the mean."""

    def __init__(self, params, learning_rate: float = 1e-4, accum_steps: int = 1):
        self.params = leaves(params)
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8)
        self.accum_steps = accum_steps
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params] if accum_steps > 1 else None)

    @torch.no_grad()
    def update(self, grads) -> bool:
        """Fold in one micro-step's gradients; True when the parameters moved."""
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return False
            grads = self.acc
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True

    def state_dict(self) -> dict:
        """Moments, step counts and the accumulation buffer, on the CPU."""
        return {"adam": _to_cpu(self.adam.state_dict()), "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.cpu() for a in self.acc]}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.mini_step = state["mini_step"]
        if self.acc is not None and state["acc"] is not None:
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_cpu(v) for v in obj]
    return obj


def make_optimizer(params, learning_rate: float = 1e-4, accum_steps: int = 1) -> Optimizer:
    """Adam (reference lr: 1e-4 restart, 3e-4 scratch), averaging
    ``accum_steps`` micro-steps' gradients per update."""
    return Optimizer(params, learning_rate, accum_steps)


def train_step(params, optimizer: Optimizer | None, batch: TrainBatch, seed: int, *,
               nloops: int, refine_steps: int = REFINE_STEPS, train: bool = True,
               precision: str = "fp32", native_batch: bool = True, mesh=None) -> dict:
    """One micro-step on ``params``' device; returns metrics as floats.

    ``seed`` draws the step's randomness: sample i's teacher forcing from
    ``fold_in(seed, i)``, the dropout from ``fold_in(fold_in(seed, 0), 2)``.
    ``train=False`` evaluates without dropout or gradients and leaves
    everything untouched. Otherwise the gradients go to ``optimizer``; a
    step whose gradients are not all finite is skipped (``skipped`` 1): the
    parameters, Adam's moments and the accumulation buffer stay as they
    were, as the reference's GradScaler skips (train.py:213-217, 373-374).
    On a CUDA device, widths the kernels cannot run raise ``ValueError``
    before the batch is uploaded.

    ``mesh`` (``parallel.mesh.make_mesh``, one data shard per process):
    ``batch`` is this rank's shard, global slots ``rank * B ..`` of a
    micro-batch of ``n_data * B``; the metrics but ``sample_loss`` (this
    shard's) are the global batch's, and in a process group the gradients
    are all-reduced before the finiteness check and the update (a
    collective: every rank calls it with a shard of the same bucket). With
    ``n_seq > 1`` the parameters are on the row's first device and the
    trunk is split by rows over the row.
    """
    if not native_batch:
        raise NotImplementedError(
            "train_step: native_batch=False (the JAX package's vmapped per-sample path, which "
            "exists for GSPMD mesh sharding) is not ported: under data parallelism each rank "
            "runs the native batch path (train_step(mesh=...))")
    device = leaves(params)[0].device
    gruresnet.check_card_widths(params, precision, device, training=True)
    alnmat = torch.from_numpy(np.asarray(batch.alnmat, np.int32)).to(device)
    targets = torch.from_numpy(np.asarray(batch.targets, np.float32)).to(device)
    batch_size, l_pad = alnmat.shape[0], alnmat.shape[2]
    offset, total = 0, batch_size
    seq = None
    if mesh is not None:
        if mesh.n_local != 1:
            raise ValueError("train_step: data-parallel training runs one process per data "
                             f"shard (this mesh has {mesh.n_local} local shards); launch one "
                             "process per mesh row (torchrun, or --coordinator)")
        offset, total = mesh.first_shard * batch_size, mesh.n_data * batch_size
        if mesh.n_seq > 1:
            row = mesh.devices[0]
            if torch.device(row[0]) != device:
                raise ValueError(f"train_step: the parameters must be on the mesh row's first "
                                 f"device {row[0]} (they are on {device})")
            seq = SeqShards.split(row, l_pad)
    group = mesh is not None and dist.is_available() and dist.is_initialized()
    draws = [draw_prep(fold_in(seed, offset + i), l_pad) for i in range(batch_size)]
    fused = precision == "bf16"
    remat = resolve_remat(params, batch_size, l_pad, nloops, fused)
    kw = dict(nloops=nloops, refine_steps=refine_steps, precision=precision, remat=remat,
              slot_offset=offset, global_batch=total, seq=seq)

    if not train:
        with torch.no_grad():
            _, metrics = batch_loss_native(params, alnmat, targets, batch.nseqs, batch.nres,
                                           draws, **kw)
        if group:
            _all_reduce(metrics)
        return _host(metrics)

    loss, metrics = batch_loss_native(params, alnmat, targets, batch.nseqs, batch.nres, draws,
                                      dropout_seed=fold_in(fold_in(seed, 0), 2), **kw)
    params_l = leaves(params)
    grads = torch.autograd.grad(loss, params_l, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params_l, grads)]
    if group:
        grads = _all_reduce(metrics, grads)
    # after the all-reduce every rank holds the same bits of the summed
    # gradients, so every rank reads the same flag and takes or skips the step
    ok = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
    out = _host(metrics)
    out["skipped"] = 0.0 if ok else 1.0
    out["updated"] = bool(ok and optimizer.update(grads))
    out["remat"] = remat
    return out


def _all_reduce(metrics: dict, grads: list = ()) -> list:
    """Sum the gradients and the scalar metrics (each this shard's share of
    the global mean; ``sample_loss`` stays this shard's) over the process
    group in one flat all-reduce: the metrics in place, the gradients
    returned."""
    names = [k for k in metrics if k != "sample_loss"]
    tensors = list(grads) + [metrics[k].detach() for k in names]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
    metrics.update(zip(names, out[len(out) - len(names):]))
    return out[:len(out) - len(names)]


def _host(metrics: dict) -> dict:
    return {k: (v.tolist() if k == "sample_loss" else float(v.detach()))
            for k, v in metrics.items()}
