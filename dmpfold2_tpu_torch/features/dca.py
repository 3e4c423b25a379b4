"""Shrunk-covariance DCA features (the 442-channel pair input).

Counterpart of ``dmpfold2_tpu/features/dca.py``: weighted covariance of the
flattened one-hot MSA, ridge-regularized and inverted, rearranged to per-pair
coupling blocks, plus one APC-corrected contact channel. Padded rows carry
zero weight and padded residue columns are zero, so the padded covariance is
block-diagonal and the valid block of the inverse equals the unpadded inverse.

The inverse (``method``): ``"lu"`` (``fp32_strict``: the reference's
``torch.inverse``) or a Cholesky-type method, ``"cholesky"`` (the default
engines), ``"blocked"`` or ``"schur"``. The JAX package's names are all
taken; the three Cholesky-type ones choose one route by size: one factor of
the positive definite covariance and its inverse up to
``ops/chol.py:BLOCKED_THRESHOLD``, the blocked inverse in place above it.
The factors run through their ``_ex`` forms, which leave the status on the
device, so the fold does not wait on the host here.

Memory: the covariance is one (21L)^2 buffer (the product, then the division
and the ridge in place); the blocked inverse overwrites it; the features are
written straight into ``out`` (the fold's pair input), the contact norms a
few rows at a time. Past the threshold the step holds about two (21L)^2
buffers, ``out`` included.
"""

from __future__ import annotations

import torch

from ..ops import chol

NUM_DCA_CHANNELS = 442  # 21*21 couplings + 1 APC-corrected contact channel
METHODS = ("cholesky", "lu", "schur", "blocked")
# rows of the contact norms reduced at a time: each chunk's temporary is
# CONTACT_ROWS x 20 x L x 20 floats, small beside the (21L)^2 inverse
CONTACT_ROWS = 64


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown DCA method {method!r}; expected one of {METHODS}")


def _spd_inverse(cov_reg: torch.Tensor, method: str) -> torch.Tensor:
    """The inverse of the regularized covariance (positive definite by
    construction); the blocked route returns ``cov_reg`` itself, overwritten."""
    if method == "lu":
        return torch.linalg.inv_ex(cov_reg).inverse
    if cov_reg.shape[-1] > chol.BLOCKED_THRESHOLD:
        return chol.blocked_spd_inverse_(cov_reg)
    return torch.cholesky_inverse(torch.linalg.cholesky_ex(cov_reg).L)


def fast_dca(msa1hot: torch.Tensor, weights: torch.Tensor, nseqs: int, nres: int,
             penalty: float = 4.5, method: str = "cholesky",
             out: torch.Tensor | None = None) -> torch.Tensor:
    """DCA couplings + contacts -> (L, L, 442) float32, zero outside nres,
    written into ``out`` (an (L, L, 442) float32 tensor or view, such as the
    fold's input slice; allocated when None) and returned."""
    check_method(method)
    n_pad, l_pad, ns = msa1hot.shape
    x = msa1hot.reshape(n_pad, l_pad * ns)

    wsum = weights.sum()
    wmean = wsum / nseqs
    num_points = wsum - torch.sqrt(wmean)

    mean = (x * weights[:, None]).sum(dim=0, keepdim=True) / num_points
    xc = x - mean
    xc *= torch.sqrt(weights[:, None])
    del x, mean

    cov = xc.T @ xc
    del xc
    cov /= num_points
    cov.diagonal().add_(penalty / torch.sqrt(wsum))

    inv_cov = _spd_inverse(cov, method)
    del cov  # the stock inverses are new buffers; the blocked inverse is this one

    if out is None:
        out = torch.empty((l_pad, l_pad, NUM_DCA_CHANNELS), device=msa1hot.device)
    x1 = inv_cov.reshape(l_pad, ns, l_pad, ns)  # a copy of a column-major stock inverse
    out[..., :ns * ns].unflatten(-1, (ns, ns)).copy_(x1.permute(0, 2, 1, 3))

    off_diag = 1.0 - torch.eye(l_pad, device=out.device)
    # couplings over the 20 aa classes only (class 20 = ambiguous/gap dropped)
    x3 = torch.empty((l_pad, l_pad), device=out.device)
    for i in range(0, l_pad, CONTACT_ROWS):
        x3[i:i + CONTACT_ROWS] = torch.sqrt(
            (x1[i:i + CONTACT_ROWS, :-1, :, :-1] ** 2).sum(dim=(1, 3)))
    del inv_cov, x1
    x3 *= off_diag
    apc = x3.sum(dim=0, keepdim=True) * x3.sum(dim=1, keepdim=True) / x3.sum()
    out[..., ns * ns] = (x3 - apc) * off_diag
    out[nres:] = 0.0
    out[:, nres:] = 0.0
    return out


def dca_or_zero(msa1hot: torch.Tensor, weights: torch.Tensor, nseqs: int, nres: int,
                penalty: float = 4.5, method: str = "cholesky",
                out: torch.Tensor | None = None) -> torch.Tensor:
    """A single sequence gives zero features (reference predict.py:139)."""
    check_method(method)
    if nseqs > 1:
        return fast_dca(msa1hot, weights, nseqs, nres, penalty, method, out)
    if out is None:
        l_pad = msa1hot.shape[1]
        return torch.zeros((l_pad, l_pad, NUM_DCA_CHANNELS), device=msa1hot.device)
    return out.zero_()
