"""Training losses: TM-score via Kabsch superposition, confidence and steric terms.

Counterpart of ``dmpfold2_tpu/train/loss.py`` (reference train.py:207-225
tmscore, 303-346 loss assembly). Every function takes the true size, so a
padded sample trains as its unpadded self. Differentiable with autograd.
"""

from __future__ import annotations

import math

import torch

COV_DIST = 3.78


def _cbrt(v: float) -> float:
    return math.copysign(abs(v) ** (1.0 / 3.0), v)


def tmscore(target_atoms: torch.Tensor, pred_atoms: torch.Tensor, n_atoms: int | None = None):
    """(A, 3) target and predicted atoms -> (A,) per-atom TM terms after the
    optimal superposition of the first ``n_atoms`` rows (the rest get zero
    weight; their terms are meaningless)."""
    a_pad = target_atoms.shape[0]
    n_atoms = a_pad if n_atoms is None else n_atoms
    mask = (torch.arange(a_pad, device=target_atoms.device) < n_atoms)[:, None]
    zero = torch.zeros((), device=target_atoms.device)
    p = torch.where(mask, target_atoms, zero)
    q = torch.where(mask, pred_atoms, zero)
    p = torch.where(mask, p - p.sum(dim=0) / n_atoms, zero)
    q = torch.where(mask, q - q.sum(dim=0) / n_atoms, zero)

    cov = p.T @ q  # (3, 3)
    # non-finite atoms (a sample the step's guard then skips) give NaN terms,
    # as XLA's SVD does; torch's would raise on the CPU, so it gets zeros
    finite = torch.isfinite(cov).all()
    u, _, vt = torch.linalg.svd(torch.where(finite, cov, 0.0))
    v = vt.T
    det = torch.linalg.det(v @ u.T)
    d = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    rot = torch.where(finite, v @ d @ u.T, float("nan"))

    diffs = p @ rot.T - q
    d0sq = (_cbrt(1.24 * n_atoms / 5.0 - 15.0) - 1.8) ** 2
    return 1.0 / (1.0 + diffs.square().sum(dim=1) / d0sq)


def steric_loss(ca_coords: torch.Tensor, nres: int | None = None) -> torch.Tensor:
    """CA stereochemistry penalty (reference train.py:336-339)."""
    l_pad = ca_coords.shape[0]
    nres = l_pad if nres is None else nres
    idx = torch.arange(l_pad, device=ca_coords.device)
    valid = idx < nres

    dsq = (ca_coords[:, None, :] - ca_coords[None, :, :]).square().sum(dim=2)
    pair_valid = valid[:, None] & valid[None, :]
    triu = (idx[None, :] - idx[:, None]) >= 2
    clash = torch.where(triu & pair_valid, torch.relu(9.0 - dsq), 0.0).sum()

    adj_valid = idx[:-1] + 1 < nres
    # the 1e-16 floor keeps the backward finite at coincident CAs
    adj_d = torch.sqrt(torch.clamp((ca_coords[1:] - ca_coords[:-1]).square().sum(dim=1),
                                   min=1e-16))
    bond = torch.where(adj_valid, (adj_d - COV_DIST).square(), 0.0).sum() / 64.0
    return torch.tanh(clash + bond)


def fold_loss(pred_coords: torch.Tensor, confs: torch.Tensor, target_coords: torch.Tensor,
              nres: int | None = None):
    """(L, 5, 3) predicted atoms, (L,) confidences, (L, 5, 3) targets ->
    (loss, metrics dict of scalar tensors) (reference train.py:330-341)."""
    l_pad = pred_coords.shape[0]
    nres = l_pad if nres is None else nres
    n_atoms = 5 * nres
    device = pred_coords.device

    tms = tmscore(target_coords.reshape(-1, 3), pred_coords.reshape(-1, 3), n_atoms)
    atom_mask = torch.arange(5 * l_pad, device=device) < n_atoms
    coord_loss = torch.where(atom_mask, 1.0 - tms, 0.0).sum() / (5.0 * nres)

    res_mask = torch.arange(l_pad, device=device) < nres
    tm_ca = tms[1::5].detach()  # CA atoms
    conf_loss = torch.where(res_mask, (confs - tm_ca).abs(), 0.0).sum() / nres

    steric = steric_loss(pred_coords[:, 1, :], nres)
    loss = coord_loss + conf_loss + 0.02 * steric
    metrics = {"loss": loss, "coord_loss": coord_loss, "conf_loss": conf_loss,
               "steric_loss": steric,
               "tm_ca": torch.where(res_mask, tms[1::5], 0.0).sum().detach() / nres}
    return loss, metrics
