"""The general traffic generator: seeded alignments and how they are sent.

A traffic file (``traffic/<name>.json``) names this generator and gives its
parameters:

  * ``loop``: ``"batch"`` (a held ``BatchFolder`` fed batch after batch,
    ``ahead`` batches submitted beyond the one waited for) or ``"single"``
    (a held ``Folder``, one target at a time, back to back);
  * ``nseqs``, ``nres``: inclusive [low, high] ranges of alignment depth and
    length;
  * ``pool``: how many distinct alignments are made; the run cycles through
    them;
  * ``batch_size``, ``max_inflight``, ``ahead`` (loop ``batch``);
  * ``iterations``, ``minsteps``: the fold's recycles and refinement steps;
  * ``warmup_iterations``, ``warmup_minsteps``: the set-up fold at the same
    shapes;
  * ``check_units``, ``check_within``, ``trace_units``: the batches (or
    folds) that the reference judges, drawn from the seed among the first
    ``check_within`` of the window, and those a traced run profiles after it.

A batch mix lies in one shape bucket (the benchmark's frozen table), so
every batch the engine runs is one submitted batch.

Every seed gets the same (nseqs, nres) and the same batches of them: an
even grid over the ranges, grouped once for all seeds, in an order drawn
from the seed; the residues (classes 0-21, 21 the gap) are drawn from the
seed too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bench_cuda import yardstick

LOOPS = ("batch", "single")
AA_CLASSES = 22


@dataclass
class Traffic:
    loop: str
    alignments: list
    iterations: int
    minsteps: int
    warmup_iterations: int
    warmup_minsteps: int
    batch_size: int = 1
    max_inflight: int = 1
    ahead: int = 0

    def batches(self):
        """Endless batches of ``batch_size`` alignments, cycling the pool."""
        i = 0
        while True:
            yield [self.alignments[(i + k) % len(self.alignments)]
                   for k in range(self.batch_size)]
            i += self.batch_size


def _grid(lo: int, hi: int, n: int) -> np.ndarray:
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def sizes(params: dict, seed: int) -> list[tuple[int, int]]:
    """The pool's (nseqs, nres) pairs: one fixed set for every seed (an even
    grid of each, paired by a fixed shuffle) and, for the batch loop, one
    fixed grouping into batches, so every seed runs the same batches; the
    seed draws the order of the batches and of the targets in each."""
    n = int(params["pool"])
    nseqs = _grid(*params["nseqs"], n)
    nres = _grid(*params["nres"], n)[np.random.default_rng(0).permutation(n)]
    pairs = [(int(a), int(b)) for a, b in zip(nseqs, nres)]
    size = int(params.get("batch_size", 1)) if params["loop"] == "batch" else 1
    n_groups = -(-n // size)
    groups = [pairs[g::n_groups] for g in range(n_groups)]  # each batch spans the ranges
    rng = np.random.default_rng([int(seed), 1])
    return [groups[g][i] for g in rng.permutation(len(groups))
            for i in rng.permutation(len(groups[g]))]


def make(params: dict, seed: int) -> Traffic:
    """The cell's traffic from its parameters and the run's seed."""
    if params["loop"] not in LOOPS:
        raise ValueError(f"unknown loop {params['loop']!r}; expected one of {LOOPS}")
    shapes = sizes(params, seed)
    if params["loop"] == "batch" and len({yardstick.bucket(*s) for s in shapes}) > 1:
        raise ValueError(f"a batch mix must lie in one shape bucket; {params['nseqs']} x "
                         f"{params['nres']} spans several")
    rng = np.random.default_rng([int(seed), 2])
    alignments = [rng.integers(0, AA_CLASSES, shape, dtype=np.uint8)
                  for shape in shapes]
    batch_size = int(params.get("batch_size", 1)) if params["loop"] == "batch" else 1
    return Traffic(loop=params["loop"], alignments=alignments,
                   iterations=int(params["iterations"]), minsteps=int(params["minsteps"]),
                   warmup_iterations=int(params["warmup_iterations"]),
                   warmup_minsteps=int(params["warmup_minsteps"]),
                   batch_size=batch_size,
                   max_inflight=int(params.get("max_inflight", 1)),
                   ahead=int(params.get("ahead", 0)))
