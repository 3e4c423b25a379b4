#!/usr/bin/env python3
"""Does the data-parallel step part from the whole-batch step by sum order,
or by a coupling between the samples of a batch?

    python3 scripts/ddp_batch_witness.py [--device cuda|cpu] [--toy]

On the two-sample micro-batch of ``chip_smoke.py`` phase ``multi`` (d)
(PF10963's alignment with two seeded 82-residue targets; full width 512/128,
16 blocks, random weights ``init_params(seed=0)``; ``--toy`` 32/16/2), at
nloops 0 and refine 0, with train_step's teacher forcing and dropout and
cuDNN's deterministic algorithms, it takes the gradient of the training loss
in these ways, for the model as it is ("random") and with the coordinate
head scaled by 256 ("spread", as phase ``train``), in fp32 and bf16:

- ``whole``: the micro-batch at B 2, as the single-process step runs it;
- ``repeat``: ``whole`` again; its bits must be ``whole``'s, or the reads
  below mix in run-to-run noise;
- ``shard``: each sample alone at B 1 at its global slot, the two gradients
  summed, as two data-parallel ranks compute it;
- ``ulp``: ``whole`` with every weight moved by one fp32 ulp (seeded
  directions): the same program, moved at the rounding floor;
- ``whole`` and ``shard`` with MDS's input detached (``no_mds``): no
  gradient through the eigendecomposition of the trunk's distance map.

It prints the card's name and power limit (on a GPU), then one JSON line:
per case the samples' losses, and per comparison the cosine of each
top-level parameter group's gradient and the largest relative loss
difference.

Reading it: where whole and shard part by the batch shape's sum order, one
ulp in the weights moves the gradient about as far (``whole~ulp`` as low as
``whole~shard``), and with the MDS gradient cut whole and shard agree
(``no_mds whole~shard`` cosines near 1). A coupling between samples shows
the other way round: ``whole~ulp`` near 1, and ``whole~shard`` low with the
MDS gradient cut as well.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from dmpfold2_tpu_torch.models import gruresnet  # noqa: E402
from dmpfold2_tpu_torch.ops.dropout import fold_in  # noqa: E402
from dmpfold2_tpu_torch.train import step  # noqa: E402

ULP_SEED = 7


@contextlib.contextmanager
def _mds_detached():
    """MDS's input detached inside ``gruresnet.forward_batched``."""
    original = gruresnet.mds_coords
    gruresnet.mds_coords = lambda dm, nres, *a, **k: original(dm.detach(), nres, *a, **k)
    try:
        yield
    finally:
        gruresnet.mds_coords = original


def _grads(params, batch, device, precision: str, split: bool, head_scale: float,
           ulp: bool = False):
    """The training loss's gradient on ``batch`` at nloops 0, refine 0:
    the whole batch at once, or (``split``) each sample alone at its global
    slot, summed -> (sample losses, gradient per top-level group on the CPU)."""
    weights = step.trainable(params, device)
    params_l = step.leaves(weights)
    with torch.no_grad():
        weights["coord_fc"].mul_(head_scale)
        if ulp:
            gen = torch.Generator().manual_seed(ULP_SEED)
            for p in params_l:
                up = torch.rand(p.shape, generator=gen) < 0.5
                p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf).to(device)))
    total, l_pad = batch.alnmat.shape[0], batch.alnmat.shape[2]
    parts = [[i] for i in range(total)] if split else [list(range(total))]
    losses, summed = [], None
    for idx in parts:
        sl = slice(idx[0], idx[0] + len(idx))
        loss, metrics = step.batch_loss_native(
            weights, torch.from_numpy(batch.alnmat[sl]).to(device),
            torch.from_numpy(batch.targets[sl]).to(device), batch.nseqs[sl], batch.nres[sl],
            [step.draw_prep(fold_in(smoke.DDP_SEED, i), l_pad) for i in idx], nloops=0,
            refine_steps=0, dropout_seed=fold_in(fold_in(smoke.DDP_SEED, 0), 2),
            precision=precision,
            remat=step.resolve_remat(weights, len(idx), l_pad, 0, precision == "bf16"),
            slot_offset=idx[0], global_batch=total)
        g = torch.autograd.grad(loss, params_l, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(params_l, g)]
        summed = g if summed is None else [a + b for a, b in zip(summed, g)]
        losses += metrics["sample_loss"].tolist()
    return losses, smoke._by_group(weights, summed)


def _compare(a, b) -> dict:
    (loss_a, grad_a), (loss_b, grad_b) = a, b
    cos = {name: smoke._cosine(grad_a[name], g) for name, g in grad_b.items()}
    return {"loss_rel_diff": max(abs(x - y) / abs(y) for x, y in zip(loss_a, loss_b)),
            "grad_cosine": cos, "grad_cosine_min": min(cos.values())}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--toy", action="store_true", help="widths 32/16/2")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("ddp_batch_witness: CUDA is not available (pass --device cpu)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(),
              flush=True)
        from dmpfold2_tpu_torch.kernels import _build

        _build.build()  # every kernel, one nvcc per source, all started together
    widths = (32, 16, 2) if args.toy else (smoke.WIDTH, smoke.CWIDTH, smoke.BLOCKS)
    params = gruresnet.init_params(seed=0, width=widths[0], cwidth=widths[1],
                                   num_blocks=widths[2])
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as data_dir:
        smoke._write_ddp_data(data_dir, np.random.default_rng(5))  # phase multi's data
        batch = smoke._ddp_batch(data_dir)
    rows = []
    for model, head_scale in (("random", 1.0), ("spread", smoke.HEAD_SCALE)):
        for precision in ("fp32", "bf16"):
            run = lambda split, **kw: _grads(params, batch, device, precision, split,  # noqa: E731
                                             head_scale, **kw)
            whole, repeat, shard, ulp = run(False), run(False), run(True), run(False, ulp=True)
            with _mds_detached():
                whole_cut, shard_cut = run(False), run(True)
            rows.append({
                "model": model, "precision": precision,
                "sample_loss": {"whole": whole[0], "shard": shard[0], "ulp": ulp[0]},
                "repeat_same_bits": repeat[0] == whole[0] and all(
                    torch.equal(repeat[1][k], whole[1][k]) for k in whole[1]),
                "whole~shard": _compare(whole, shard), "whole~ulp": _compare(whole, ulp),
                "no_mds whole~shard": _compare(whole_cut, shard_cut)})
            print(json.dumps({k: rows[-1][k] for k in ("model", "precision")}
                             | {k: rows[-1][k]["grad_cosine_min"] for k in
                                ("whole~shard", "whole~ulp", "no_mds whole~shard")}),
                  file=sys.stderr, flush=True)
    print(json.dumps({"witness": "ddp_batch", "device": str(device),
                      "widths": widths, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
