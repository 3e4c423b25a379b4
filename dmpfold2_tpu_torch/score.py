"""Model-quality scoring: CA TM-score / RMSD between two structures.

Counterpart of ``dmpfold2_tpu/score.py``, this package's own numpy copy (the
reference computes TM only inside its training loss, train.py:207-225). It
implements the standard CA-based TM-score
(Zhang & Skolnick 2004): d0 = 1.24*cbrt(N-15) - 1.8, maximized over
superpositions found by iterative distance-cutoff refinement from multiple
fragment seeds — a simplified variant of the original TMscore program's
search (global seed plus L/2 and L/4 sliding fragments with a clamped
d0_search cutoff; the original additionally runs L/8... windows and a
GDT-style cutoff ladder, so scores can differ slightly in rare cases).
Pure numpy; structures are host-side inputs.

Usage:
    python -m dmpfold2_tpu_torch.score model.pdb native.pdb
    -> {"tm": 0.87, "rmsd": 1.9, "nres": 82}
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .utils.pdb import parse_template_ca


def _kabsch(p: np.ndarray, q: np.ndarray):
    """Rotation + translation minimizing RMSD of p onto q."""
    pc, qc = p.mean(0), q.mean(0)
    cov = (p - pc).T @ (q - qc)
    u, _, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return rot, qc - rot @ pc


def _apply(rot, trans, p):
    return p @ rot.T + trans


def tm_d0(nres: int) -> float:
    """Standard CA TM-score normalization length scale."""
    if nres <= 21:  # d0 < 0.5 region: TMscore clamps to 0.5
        return 0.5
    return max(1.24 * np.cbrt(nres - 15.0) - 1.8, 0.5)


def _tm_terms(pred_sup: np.ndarray, ref: np.ndarray, d0: float) -> np.ndarray:
    dsq = np.sum(np.square(pred_sup - ref), axis=1)
    return 1.0 / (1.0 + dsq / (d0 * d0))


def tm_score(pred_ca: np.ndarray, ref_ca: np.ndarray) -> dict:
    """CA TM-score of ``pred_ca`` against ``ref_ca`` (both (N, 3), same N).

    Returns {"tm", "rmsd", "nres"}: ``tm`` maximized over the fragment-seeded
    iterative superposition search (normalized by N = the common length),
    ``rmsd`` from the global (all-atom Kabsch) superposition.
    """
    pred = np.asarray(pred_ca, np.float64)
    ref = np.asarray(ref_ca, np.float64)
    if pred.shape != ref.shape or pred.ndim != 2 or pred.shape[1] != 3:
        raise ValueError(
            f"structures must share (N, 3) CA shapes; got {pred.shape} vs {ref.shape}")
    n = pred.shape[0]
    if n < 3:
        raise ValueError("need at least 3 CA atoms to superpose")
    d0 = tm_d0(n)
    # selection cutoff: the original TMscore clamps its search cutoff to
    # [4.5, 8.0] (d0 itself, unclamped, still normalizes the TM terms) —
    # an unbounded cutoff would keep outlier residues in the superposition
    # set for long chains (d0 > 8) and report non-canonical values
    d0_search = min(max(d0, 4.5), 8.0)

    rot, trans = _kabsch(pred, ref)
    rmsd = float(np.sqrt(np.mean(np.sum(np.square(_apply(rot, trans, pred) - ref), 1))))

    # seed windows: whole chain, then L/2 and L/4 fragments at half-window
    # stride (the original TMscore's seed schedule)
    seeds = [np.arange(n)]
    for frac in (2, 4):
        w = max(n // frac, 4)
        for start in range(0, n - w + 1, max(w // 2, 1)):
            seeds.append(np.arange(start, start + w))

    best_tm = 0.0
    for seed in seeds:
        sel = seed
        for _ in range(20):  # iterative cutoff refinement
            if len(sel) < 3:
                break
            rot, trans = _kabsch(pred[sel], ref[sel])
            terms = _tm_terms(_apply(rot, trans, pred), ref, d0)
            best_tm = max(best_tm, float(terms.mean()))
            d = np.sqrt(np.sum(np.square(_apply(rot, trans, pred) - ref), 1))
            cutoff = d0_search
            new_sel = np.flatnonzero(d < cutoff)
            while len(new_sel) < 4 and cutoff < 50.0:  # grow until usable
                cutoff += 0.5
                new_sel = np.flatnonzero(d < cutoff)
            if len(new_sel) == len(sel) and np.array_equal(new_sel, sel):
                break
            sel = new_sel

    return {"tm": round(best_tm, 4), "rmsd": round(rmsd, 4), "nres": n}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="CA TM-score / RMSD between a model and a native structure")
    ap.add_argument("model", help="predicted structure (PDB)")
    ap.add_argument("native", help="native / reference structure (PDB)")
    args = ap.parse_args(argv)
    pred = parse_template_ca(args.model)
    ref = parse_template_ca(args.native)
    if pred.shape[0] != ref.shape[0]:
        print(f"error: CA counts differ ({pred.shape[0]} vs {ref.shape[0]}); "
              "score needs a 1:1 residue correspondence", file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps(tm_score(pred, ref)))


if __name__ == "__main__":
    main()
