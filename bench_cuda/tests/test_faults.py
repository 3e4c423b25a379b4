"""With the timed path broken underneath, the check comes out false: a step
that returns its state unchanged, half of a batch left out, one target of a
batch computed from another's data, an answer altered where it is produced.
Toy widths on the CPU, the cells' own limits."""

from __future__ import annotations

import threading

import pytest
import torch

from bench_cuda import runner
from bench_cuda.tests import toy
from dmpfold2_tpu_torch.kernels import refine
from dmpfold2_tpu_torch.models import gruresnet, trunk
from dmpfold2_tpu_torch.parallel import stream

CELLS = ["bf16-pfam256-b8", "bf16-long3000x720"]


def _stale_trunk(monkeypatch):
    """Every recycle's trunk pass returns the fold's first pass's output."""
    state = threading.local()
    fold = gruresnet.forward_inference

    def fresh(*args, **kw):
        state.first = None
        return fold(*args, **kw)

    monkeypatch.setattr(gruresnet, "forward_inference", fresh)
    for name in ("trunk_apply_bf16", "trunk_apply"):
        def stale(*args, orig=getattr(gruresnet, name), **kw):
            out = orig(*args, **kw)
            if getattr(state, "first", None) is None:
                state.first = out
            return state.first

        monkeypatch.setattr(gruresnet, name, stale)


def _refine_unchanged(monkeypatch):
    monkeypatch.setattr(refine, "refine_coords_batched",
                        lambda coords, n_steps, nres: coords.clone())


def _answer_altered(monkeypatch):
    orig = gruresnet.calpha_to_main_chain

    def altered(ca, nres):
        out = orig(ca, nres).clone()
        out[..., 0, 3, :] += 0.25  # one atom of each target's first residue
        return out

    monkeypatch.setattr(gruresnet, "calpha_to_main_chain", altered)


def _half_batch(monkeypatch):
    """Only the first half of each batch is folded; its answers fill the rest."""
    orig = stream._fold_batch

    def half(folder, aln_b, dmap_b, nseqs, nres, *args):
        h = max(1, len(nseqs) // 2)
        coords, confs = orig(folder, aln_b[:h], dmap_b[:h], nseqs[:h], nres[:h], *args)
        reps = -(-len(nseqs) // h)
        return (torch.cat([torch.from_numpy(coords)] * reps)[:len(nseqs)].numpy(),
                torch.cat([torch.from_numpy(confs)] * reps)[:len(nseqs)].numpy())

    monkeypatch.setattr(stream, "_fold_batch", half)


def _neighbour_slot(slot: int):
    """Every trunk block hands target ``slot`` of the batch the output of the
    next target, as a wrong per-target offset in a batched kernel would."""
    def plant(monkeypatch):
        for name in ("resnet_block_fused_norm", "resnet_block"):
            def wrong(*args, orig=getattr(trunk, name), **kw):
                outs = orig(*args, **kw)
                first = outs[0].clone()
                first[slot] = outs[0][(slot + 1) % first.shape[0]]
                return [first, *outs[1:]]

            monkeypatch.setattr(trunk, name, wrong)
    return plant


FAULTS = {"stale_trunk": _stale_trunk, "refine_unchanged": _refine_unchanged,
          "answer_altered": _answer_altered, "half_batch": _half_batch}
BATCH_ONLY = {"half_batch"}  # a one-target cell has no batch to halve
CASES = [(cell, fault) for cell in CELLS for fault in sorted(FAULTS)
         if fault not in BATCH_ONLY or cell == "bf16-pfam256-b8"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = runner.run(toy.spec(cell))
    assert not out.correct, out.checks


@pytest.mark.parametrize("slot", range(4))
def test_one_wrong_target_of_a_batch_fails(slot, monkeypatch):
    """Whichever target of a batch of four its trunk gets wrong, the trunk's
    number fails: every target's layers are checked."""
    spec = toy.spec("bf16-pfam256-b8")
    spec.traffic["batch_size"] = 4
    _neighbour_slot(slot)(monkeypatch)
    out = runner.run(spec)
    assert not out.correct, out.checks
    assert out.checks["trunk"]["value"] > out.checks["trunk"]["limit"], out.checks
