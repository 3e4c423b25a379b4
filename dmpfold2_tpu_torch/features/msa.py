"""MSA featurization: one-hot encoding and sequence reweighting.

Counterpart of ``dmpfold2_tpu/features/msa.py``. Padded rows and residue
columns beyond the true (nseqs, nres) are zero, so padding contributes
nothing downstream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import obs

NUM_DCA_CLASSES = 21  # 20 aa + merged ambiguous/gap class


def msa_one_hot(alnmat: torch.Tensor, nseqs: int, nres: int) -> torch.Tensor:
    """(N, L) int -> (N, L, 21) float32 one-hot, gap merged into class 20."""
    n_pad, l_pad = alnmat.shape
    oh = F.one_hot(alnmat.long().clamp(max=20), NUM_DCA_CLASSES).float()
    oh[nseqs:] = 0.0
    oh[:, nres:] = 0.0
    return oh


def reweight(msa1hot: torch.Tensor, nres: int, cutoff: float = 0.8) -> torch.Tensor:
    """Per-sequence weights: 1 / #sequences sharing > cutoff identity.

    Identity counts are integers, exact in a float32 product (TF32 is off in
    the fp32 engine). Padded rows get weight zero.
    """
    flat = msa1hot.reshape(msa1hot.shape[0], -1)
    id_mtx = flat @ flat.T
    # the threshold is rounded in float32, as the JAX package rounds it
    id_min = torch.tensor(float(nres), dtype=torch.float32) * cutoff
    with obs.wait("reweight"):  # a blocking copy to the device
        id_min = id_min.to(flat.device)
    neighbors = (id_mtx > id_min).float().sum(dim=-1)
    row_valid = flat.sum(dim=-1) > 0
    return torch.where(row_valid, 1.0 / neighbors.clamp(min=1.0),
                       torch.zeros_like(neighbors))
