"""Alignment (.aln / .a3m) parsing and residue encoding.

Counterpart of ``dmpfold2_tpu/utils/aln.py``. The reference encoding: lines starting with '>' are skipped, the others are
alignment rows; residues map through the 28-character table
'ARNDCQEGHILKMFPSTWYVBJOUXZ-.' -> 'ABCDEFGHIJKLMNOPQRSTUUUUUUVV', giving
classes 0-19 for the amino acids, 20 for ambiguous residues and 21 for gaps.
The MSA is capped at MAX_SEQS rows.
"""

from __future__ import annotations

import numpy as np

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
NUM_CLASSES = 22  # 20 aa + ambiguous + gap

GLYCINE = AA_ORDER.index("G")  # glycine has no CB atom

MAX_SEQS = 3000

_TRANS = str.maketrans("ARNDCQEGHILKMFPSTWYVBJOUXZ-.", "ABCDEFGHIJKLMNOPQRSTUUUUUUVV")

AA3 = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
]


def encode_rows(rows: list[str]) -> np.ndarray:
    """Encode equal-length alignment rows to an (nseqs, nres) uint8 array.

    Characters outside the 28-character table raise: passing them through
    would give class indices the network treats as absent residues.
    """
    if not rows:
        raise ValueError("empty alignment")
    length = len(rows[0])
    for r in rows:
        if len(r) != length:
            raise ValueError("alignment rows have unequal lengths")
    joined = "".join(rows).translate(_TRANS).encode("latin-1")
    mat = np.frombuffer(joined, dtype=np.uint8) - ord("A")
    if mat.size and mat.max() >= NUM_CLASSES:
        bad = chr(ord("A") + int(mat.max()))
        raise ValueError(
            f"alignment contains characters outside the amino-acid alphabet "
            f"(e.g. {bad!r} after translation) — lowercase rows suggest an "
            f"a3m file; rename to .a3m or convert with a3m_to_rows()")
    return mat.reshape(len(rows), length)


def a3m_to_rows(text: str) -> list[str]:
    """a3m -> aln rows: drop '>' headers and lowercase insertion states."""
    rows = []
    for line in text.splitlines():
        if line.startswith(">") or not line.strip():
            continue
        rows.append("".join(c for c in line.rstrip() if not c.islower()))
    return rows


def parse_aln(path: str, max_seqs: int = MAX_SEQS) -> np.ndarray:
    """Parse an aln (or ``.a3m``) file into an (nseqs, nres) uint8 class matrix.

    An aln file goes through the native parser (``utils/native.py``) where
    it built; the pure-Python path gives the same matrix.
    """
    from . import native

    if not path.endswith(".a3m") and native.available():
        with open(path, "rb") as fh:
            return native.encode_aln_bytes(fh.read(), max_seqs)
    with open(path) as fh:
        if path.endswith(".a3m"):
            rows = a3m_to_rows(fh.read())
        else:
            rows = [s for s in (line.rstrip() for line in fh
                                if not line.startswith(">")) if s]
    return encode_rows(rows)[:max_seqs]
