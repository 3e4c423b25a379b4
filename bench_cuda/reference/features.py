"""Pair features of one alignment at its exact size, in plain PyTorch.

The DMPfold2 reference's featurisation (predict.py, network.py): a one-hot
MSA with the gap merged into class 20, sequence weights of 1 / (sequences
above 80% identity), and the shrunk-covariance DCA: the weighted covariance
of the flattened one-hot MSA, ridge 4.5 / sqrt(sum of weights), inverted,
rearranged into 21 x 21 coupling blocks per pair, plus one APC-corrected
contact channel. The inverse is the stock Cholesky inverse of the positive
definite covariance. Nothing is padded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NUM_CLASSES = 21
PENALTY = 4.5
IDENTITY_CUTOFF = 0.8


def one_hot(aln: torch.Tensor) -> torch.Tensor:
    """(N, L) residue classes 0-21 -> (N, L, 21) float32, class 21 merged into 20."""
    return F.one_hot(aln.long().clamp(max=20), NUM_CLASSES).float()


def seq_weights(oh: torch.Tensor) -> torch.Tensor:
    """1 / the number of sequences (itself included) sharing more than 80% identity."""
    n, l, _ = oh.shape
    flat = oh.reshape(n, -1)
    ident = flat @ flat.T
    threshold = torch.tensor(float(l), dtype=torch.float32) * IDENTITY_CUTOFF
    return 1.0 / (ident > threshold.to(flat.device)).float().sum(dim=-1)


def dca(oh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, L, 21) one-hot, (N,) weights -> (L, L, 442) couplings and contacts;
    a single sequence gives zeros."""
    n, l, ns = oh.shape
    if n < 2:
        return torch.zeros((l, l, ns * ns + 1), device=oh.device)
    x = oh.reshape(n, l * ns)
    wsum = w.sum()
    num_points = wsum - torch.sqrt(wsum / n)
    mean = (x * w[:, None]).sum(dim=0, keepdim=True) / num_points
    xc = (x - mean) * torch.sqrt(w[:, None])
    cov = xc.T @ xc / num_points
    del xc
    cov.diagonal().add_(PENALTY / torch.sqrt(wsum))
    factor = torch.linalg.cholesky(cov)
    del cov
    inv = torch.cholesky_inverse(factor)
    del factor
    x1 = inv.reshape(l, ns, l, ns).permute(0, 2, 1, 3)
    couplings = x1.reshape(l, l, ns * ns).clone()
    contacts = torch.sqrt((x1[:, :, :-1, :-1] ** 2).sum(dim=(2, 3)))
    del inv, x1
    off_diag = 1.0 - torch.eye(l, device=oh.device)
    contacts = contacts * off_diag
    apc = contacts.sum(dim=0, keepdim=True) * contacts.sum(dim=1, keepdim=True) / contacts.sum()
    return torch.cat([couplings, ((contacts - apc) * off_diag)[..., None]], dim=-1)


def pair_features(aln: torch.Tensor) -> torch.Tensor:
    """(N, L) alignment -> (L, L, 442) DCA features."""
    oh = one_hot(aln)
    return dca(oh, seq_weights(oh))
