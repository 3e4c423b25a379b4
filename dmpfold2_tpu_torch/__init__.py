"""dmpfold2_tpu_torch: the DMPfold2 folding engine in PyTorch, with CUDA kernels
written by hand for Hopper (H100).

The port of the JAX package ``dmpfold2_tpu``, module for module. It imports
neither JAX nor ``dmpfold2_tpu``. Public API mirrors the reference's two
symbols (reference: dmpfold/__init__.py:1).
"""

from .cli import run_dmpfold
from .engine.fold import aln_to_coords

__all__ = ["aln_to_coords", "run_dmpfold"]
__version__ = "0.1.0"
