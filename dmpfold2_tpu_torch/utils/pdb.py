"""PDB reading (template CA extraction) and writing.

Counterpart of ``dmpfold2_tpu/utils/pdb.py``. The writer gives the
reference's bytes: a ``REMARK  CONF:`` line with the mean confidence, then per
residue the N/CA/C/O/CB atoms (CB skipped for glycine) with the confidence in
the B-factor column, then ``END``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .aln import AA3, GLYCINE

ATOM_NAMES = (" N  ", " CA ", " C  ", " O  ", " CB ")


def parse_template_ca(path: str) -> np.ndarray:
    """CA coordinates from fixed-column ATOM records -> (n, 3) float32."""
    with open(path) as fh:
        return parse_template_ca_lines(fh, origin=path)


def parse_template_ca_text(text: str) -> np.ndarray:
    """:func:`parse_template_ca` from PDB text in memory (an HTTP request's template)."""
    return parse_template_ca_lines(text.splitlines(), origin="<text>")


def parse_template_ca_lines(lines: Iterable[str], origin: str = "?") -> np.ndarray:
    coords = []
    for line in lines:
        if line[:4] == "ATOM" and line[12:16] == " CA ":
            # primary conformer only: alternate-location records would
            # duplicate residues
            if len(line) > 16 and line[16] not in (" ", "A"):
                continue
            coords.append([float(line[30:38]), float(line[38:46]), float(line[46:54])])
    if not coords:
        raise ValueError(f"no CA atoms found in template {origin}")
    return np.asarray(coords, dtype=np.float32)


def format_pdb(coords: np.ndarray, confs: np.ndarray, seq_classes: np.ndarray) -> Iterable[str]:
    """Yield PDB lines for (nres, 5, 3) coords with (nres,) confidences.

    ``seq_classes`` is the encoded first alignment row (residue names and the
    glycine CB skip).
    """
    coords = np.asarray(coords)
    confs = np.asarray(confs)
    seq_classes = np.asarray(seq_classes)
    yield "REMARK  CONF:  %s" % float(confs.mean())
    atomnum = 1
    for ri in range(coords.shape[0]):
        rclass = int(seq_classes[ri])
        for ai, an in enumerate(ATOM_NAMES):
            if rclass != GLYCINE or ai != 4:
                yield "ATOM   %4d %s %s  %4d    %8.3f%8.3f%8.3f  1.00%6.2f" % (
                    atomnum,
                    an,
                    AA3[rclass] if rclass < len(AA3) else "UNK",
                    ri + 1,
                    float(coords[ri, ai, 0]),
                    float(coords[ri, ai, 1]),
                    float(coords[ri, ai, 2]),
                    float(confs[ri]),
                )
                atomnum += 1
    yield "END"
