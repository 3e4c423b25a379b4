"""Shrunk-covariance DCA features (the 442-channel pair input).

Counterpart of ``dmpfold2_tpu/features/dca.py``: weighted covariance of the
flattened one-hot MSA, ridge-regularized and inverted, rearranged to per-pair
coupling blocks, plus one APC-corrected contact channel. Padded rows carry
zero weight and padded residue columns are zero, so the padded covariance is
block-diagonal and the valid block of the inverse equals the unpadded inverse.

The inverse (``method``): ``"cholesky"`` (the default engines: the
covariance is positive definite, so one factor and its inverse) or ``"lu"``
(``fp32_strict``: the reference's ``torch.inverse``, an LU inverse). Both run
in cuSOLVER on the card through their ``_ex`` forms, which leave the status on
the device, so the fold does not wait on the host here. The JAX package's
``"schur"`` and ``"blocked"`` exist to keep the inverse on the TPU's matrix
unit (``ops/chol.py``) and are refused.
"""

from __future__ import annotations

import torch

NUM_DCA_CHANNELS = 442  # 21*21 couplings + 1 APC-corrected contact channel
METHODS = ("cholesky", "lu")


def check_method(method: str) -> None:
    if method in ("schur", "blocked"):
        raise ValueError(
            f"DCA method {method!r} exists to keep the (21L)^2 inverse on the TPU's matrix "
            "unit (the JAX package's ops/chol.py); on the GPU cuSOLVER computes it: use "
            "'cholesky' or 'lu'")
    if method not in METHODS:
        raise ValueError(f"unknown DCA method {method!r}; expected one of {METHODS}")


def _spd_inverse(cov_reg: torch.Tensor, method: str) -> torch.Tensor:
    # the _ex forms: the factor's status stays on the device (no host sync);
    # the regularized covariance is positive definite by construction
    if method == "lu":
        return torch.linalg.inv_ex(cov_reg).inverse
    return torch.cholesky_inverse(torch.linalg.cholesky_ex(cov_reg).L)


def fast_dca(msa1hot: torch.Tensor, weights: torch.Tensor, nseqs: int, nres: int,
             penalty: float = 4.5, method: str = "cholesky") -> torch.Tensor:
    """DCA couplings + contacts -> (L, L, 442) float32, zero outside nres."""
    check_method(method)
    n_pad, l_pad, ns = msa1hot.shape
    x = msa1hot.reshape(n_pad, l_pad * ns)

    wsum = weights.sum()
    wmean = wsum / nseqs
    num_points = wsum - torch.sqrt(wmean)

    mean = (x * weights[:, None]).sum(dim=0, keepdim=True) / num_points
    xc = (x - mean) * torch.sqrt(weights[:, None])

    cov = (xc.T @ xc) / num_points
    ridge = penalty / torch.sqrt(wsum)
    cov_reg = cov + torch.eye(l_pad * ns, device=x.device) * ridge

    inv_cov = _spd_inverse(cov_reg, method)

    x1 = inv_cov.reshape(l_pad, ns, l_pad, ns)
    features = x1.permute(0, 2, 1, 3).reshape(l_pad, l_pad, ns * ns)

    off_diag = 1.0 - torch.eye(l_pad, device=x.device)
    # couplings over the 20 aa classes only (class 20 = ambiguous/gap dropped)
    x3 = torch.sqrt((x1[:, :-1, :, :-1] ** 2).sum(dim=(1, 3))) * off_diag
    apc = x3.sum(dim=0, keepdim=True) * x3.sum(dim=1, keepdim=True) / x3.sum()
    contacts = (x3 - apc) * off_diag

    out = torch.cat([features, contacts[:, :, None]], dim=2)
    out[nres:] = 0.0
    out[:, nres:] = 0.0
    return out


def dca_or_zero(msa1hot: torch.Tensor, weights: torch.Tensor, nseqs: int, nres: int,
                penalty: float = 4.5, method: str = "cholesky") -> torch.Tensor:
    """A single sequence gives zero features (reference predict.py:139)."""
    check_method(method)
    if nseqs > 1:
        return fast_dca(msa1hot, weights, nseqs, nres, penalty, method)
    l_pad = msa1hot.shape[1]
    return torch.zeros((l_pad, l_pad, NUM_DCA_CHANNELS), device=msa1hot.device)
