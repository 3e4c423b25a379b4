"""Paths of the repository's data files: the example alignment and template,
and the training cluster list.

Counterpart of ``dmpfold2_tpu/utils/assets.py`` without its reference-mount
fallback. The files are the ones the repository already holds beside the JAX
package (``dmpfold2_tpu/example/``, ``dmpfold2_tpu/train_clust.lst``); they
are read as data, so nothing of the JAX package is imported.
"""

from __future__ import annotations

import os

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "dmpfold2_tpu")


def example_aln_path() -> str:
    """The PF10963 example alignment (252 sequences x 82 residues)."""
    return os.path.join(DATA_DIR, "example", "PF10963.aln")


def example_template_path() -> str:
    """The 3FGX example template PDB."""
    return os.path.join(DATA_DIR, "example", "3FGX.pdb")


def cluster_list_path() -> str:
    """The training cluster list (26,048 clusters at 30% sequence identity;
    the first 300 are validation)."""
    return os.path.join(DATA_DIR, "train_clust.lst")
