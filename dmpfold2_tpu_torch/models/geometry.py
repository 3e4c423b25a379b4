"""Geometry: MDS coordinate seeding, CA-trace refinement, backbone completion.

Counterpart of ``dmpfold2_tpu/models/geometry.py`` (``mds_coords`` with its
``eigh`` and ``subspace`` branches, the plain ``refine_coords``,
``calpha_to_main_chain``). All functions are mask-aware: positions at or
past ``nres`` are padding.
"""

from __future__ import annotations

import math

import torch

from ..ops.eigh import subspace_topk
from ..utils import obs

VDW_DIST = 3.0
COV_DIST = 3.78
K_VDW = 100.0
K_COV = 100.0
STEP_SIZE = 0.001
# below this map size a q = 32 basis cannot give 8 full eigenpairs without
# shrinking, so mds_coords(impl="subspace") runs eigh there (JAX's gate;
# tests set it to 0 to run the subspace path at toy sizes)
SUBSPACE_MIN_L = 32


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics: v / max(||v||, eps)."""
    n = torch.sqrt(torch.clamp(v.square().sum(dim=-1, keepdim=True), min=eps * eps))
    return v / n


def zeroed_gram(dm: torch.Tensor, nres) -> tuple[torch.Tensor, torch.Tensor]:
    """The Gram matrix MDS decomposes, with padding zeroed: distance-map
    channel (..., L, L) -> ((..., L, L) Gram, (..., L) bool valid columns).
    Symmetrize, abs, Gram matrix from the first row/column; rows/columns at
    or past ``nres`` (an int or a tensor of the leading shape) are zero."""
    l_pad = dm.shape[-1]
    dm = (0.5 * (dm + dm.transpose(-1, -2))).abs()
    gram = 0.5 * (dm[..., 0:1, :].square() + dm[..., :, 0:1].square() - dm.square())
    col = torch.arange(l_pad, device=dm.device) < torch.as_tensor(nres, device=dm.device)[..., None]
    return gram * (col[..., :, None] & col[..., None, :]), col


def mds_gram(dm: torch.Tensor, nres) -> torch.Tensor:
    """The Gram matrix ``eigh`` decomposes: :func:`zeroed_gram` with distinct
    very negative diagonal entries on the padded coordinates, so the valid
    block's spectrum is kept and the padding eigenpairs sink below it."""
    gram, col = zeroed_gram(dm, nres)
    idx = torch.arange(dm.shape[-1], device=dm.device)
    pad_diag = torch.where(col, torch.zeros((), device=dm.device),
                           -(1e6 + idx.to(dm.dtype)))
    return gram + torch.diag_embed(pad_diag)


def mds_coords(dm: torch.Tensor, nres, n_dims: int = 8,
               canonical_signs: bool = True, impl: str = "eigh") -> torch.Tensor:
    """Distance-map channel (..., L, L) -> top-``n_dims`` MDS embedding (..., L, n_dims).

    ``nres``: an int, or a tensor of the leading (batch) shape: each map's
    true length. ``impl="eigh"``: ``eigh`` of :func:`mds_gram` (one call for
    the whole batch), the largest eigenpairs. ``impl="subspace"``: the top
    ``n_dims`` eigenpairs of :func:`zeroed_gram` by subspace iteration
    (``ops/eigh.py``), the bf16 engine's choice (inference only); below
    ``SUBSPACE_MIN_L`` it runs ``eigh``, with its bits.

    ``canonical_signs``: make the eigenvector signs canonical
    (largest-|component| positive), so LAPACK and cuSOLVER, and a batch and a
    single map, agree. ``False`` keeps the raw signs of ``eigh``, as the
    reference does (network.py:247): the ``fp32_strict`` engine's choice.
    """
    if impl not in ("eigh", "subspace"):
        raise ValueError(f"unknown MDS impl {impl!r}: eigh or subspace")
    if impl == "subspace" and dm.shape[-1] < SUBSPACE_MIN_L:
        impl = "eigh"
    if impl == "subspace":
        # no diagonal shift: one product with the zeroed Gram removes the
        # start basis' padding components, and squaring a -1e6 diagonal
        # would swamp the iteration. A valid block with fewer than n_dims
        # positive eigenvalues (nres < ~10) can let padding's exact-zero
        # eigenpairs take trailing slots; the clamp below keeps them at
        # sqrt(1e-8) scale (JAX geometry.py:75-95)
        gram, _ = zeroed_gram(dm, nres)
    else:
        gram = mds_gram(dm, nres)
    # a non-finite map (a training step on NaN inputs, which the step's guard
    # then skips) gives NaN coordinates for its target, as XLA's eigh does;
    # torch's eigh would raise on the CPU instead, so it is handed zeros
    finite = torch.isfinite(gram).all(dim=-1).all(dim=-1)[..., None, None]
    gram = torch.where(finite, gram, 0.0)
    if impl == "subspace":
        w8, v8 = subspace_topk(gram, k=n_dims)
    else:
        with obs.wait("eigh"):  # eigh reads its status on the host
            w, v = torch.linalg.eigh(gram)
        w8, v8 = w[..., -n_dims:], v[..., -n_dims:]
    w8 = w8.clamp(min=1e-8)
    if canonical_signs:
        comp = v8.gather(-2, v8.abs().argmax(dim=-2, keepdim=True))               # (..., 1, n)
        v8 = v8 * torch.where(comp < 0, -1.0, 1.0)
    return torch.where(finite, v8 * torch.sqrt(w8)[..., None, :], float("nan"))


def refine_step(coords: torch.Tensor, valid: torch.Tensor, adj_valid: torch.Tensor) -> torch.Tensor:
    """One Euler step of the reference force field (network.py:111-135)."""
    diffs = coords[None, :, :] - coords[:, None, :]  # diffs[i, j] = c[j] - c[i]
    sq = diffs.square().sum(dim=2)
    dists = torch.clamp(torch.sqrt(torch.clamp(sq, min=1e-12)), 0.01, 10.0)
    norm_diffs = diffs / dists[:, :, None]
    violate = torch.where(dists < VDW_DIST, VDW_DIST - dists, torch.zeros_like(dists))
    violate = violate * (valid[:, None] & valid[None, :])
    accels = (K_VDW * violate[:, :, None] * norm_diffs).sum(dim=0)

    adiffs = coords[1:] - coords[:-1]
    adists = torch.clamp(torch.sqrt(torch.clamp(adiffs.square().sum(dim=1), min=1e-12)), min=0.1)
    anorm = adiffs / adists[:, None]
    aviolate = torch.clamp(adists - COV_DIST, max=3.0) * adj_valid
    acc_cov = K_COV * aviolate[:, None] * anorm
    accels = accels.clone()
    accels[:-1] += acc_cov
    accels[1:] += -acc_cov
    return coords + torch.clamp(accels, -100.0, 100.0) * STEP_SIZE


def refine_coords(coords: torch.Tensor, n_steps: int, nres: int) -> torch.Tensor:
    """Plain CA-trace refinement: (L, 3) -> (L, 3); padding feels no force."""
    idx = torch.arange(coords.shape[0], device=coords.device)
    valid = idx < nres
    adj_valid = (idx[:-1] + 1 < nres).to(coords.dtype)
    for _ in range(n_steps):
        coords = refine_step(coords, valid, adj_valid)
    return coords


def calpha_to_main_chain(ca: torch.Tensor, nres) -> torch.Tensor:
    """Levitt-method backbone completion: (..., L, 3) CA traces -> (..., L, 5, 3)
    N/CA/C/O/CB.

    ``nres``: an int, or a tensor of the leading (batch) shape. The terminal
    dummy CAs are taken at each chain's true end, so padded tails do not take
    part (reference network.py:141-177).
    """
    l_pad = ca.shape[-2]
    idx = torch.arange(l_pad, device=ca.device)
    last = torch.as_tensor(nres, device=ca.device).expand(ca.shape[:-2]) - 1      # (...)

    def take(i):
        """ca at row clamp(i, 0, L - 1) of each chain: (...) -> (..., 3)."""
        i = i.clamp(0, l_pad - 1)[..., None, None].expand(*i.shape, 1, 3)
        return ca.gather(-2, i)[..., 0, :]

    ca_last, ca_last1, ca_last2 = take(last), take(last - 1), take(last - 2)
    ca0, ca1, ca2 = ca[..., 0, :], ca[..., 1, :], ca[..., 2, :]

    # dummy terminal CAs at 3.82 A along the local cross product
    nterm = ca0 + 3.82 * _normalize(torch.linalg.cross(ca0 - ca1, ca2 - ca1))
    cterm = ca_last + 3.82 * _normalize(
        torch.linalg.cross(ca_last - ca_last1, ca_last2 - ca_last1))

    prev = torch.cat([nterm[..., None, :], ca[..., :-1, :]], dim=-2)   # prev[i] = ca[i-1]
    nxt = torch.cat([ca[..., 1:, :], ca[..., -1:, :]], dim=-2)         # nxt[i] = ca[i+1]
    at_last = (idx == last[..., None])[..., None]                        # (..., L, 1)
    nxt = torch.where(at_last, cterm[..., None, :], nxt)

    vec_can = prev - ca
    vec_cac = nxt - ca
    crossv = _normalize(torch.linalg.cross(vec_can, vec_cac))
    mid = 0.5 * (ca + prev)

    coords_n = mid - vec_can / 8.0 + crossv / 4.0

    c_shift = mid + vec_can / 8.0 - crossv / 2.0
    o_shift = mid - 1.8 * crossv
    c_next = torch.cat([c_shift[..., 1:, :], c_shift[..., -1:, :]], dim=-2)
    o_next = torch.cat([o_shift[..., 1:, :], o_shift[..., -1:, :]], dim=-2)

    lastc = last.clamp(0, l_pad - 1)[..., None, None].expand(*last.shape, 1, 3)
    cross_last = crossv.gather(-2, lastc)[..., 0, :]
    mid_end = 0.5 * (cterm + ca_last)
    c_cterm = mid_end - (cterm - ca_last) / 8.0 + cross_last / 2.0
    o_cterm = mid_end + 2.0 * cross_last

    coords_c = torch.where(at_last, c_cterm[..., None, :], c_next)
    coords_o = torch.where(at_last, o_cterm[..., None, :], o_next)

    # CB via tetrahedral construction from N, C, CA
    vec_n_ca = ca - coords_n
    vec_c_ca = ca - coords_c
    cross_nc = torch.linalg.cross(vec_n_ca, vec_c_ca)
    vec_ca_cb = vec_n_ca + vec_c_ca
    ang = math.pi / 2.0 - math.asin(1.0 / math.sqrt(3.0))

    def norm(v):
        return torch.sqrt(torch.clamp(v.square().sum(dim=-1, keepdim=True), min=1e-24))

    sx = 1.5 * math.cos(ang) / norm(vec_ca_cb)
    sy = 1.5 * math.sin(ang) / norm(cross_nc)
    coords_cb = ca + sx * vec_ca_cb + sy * cross_nc

    return torch.stack([coords_n, ca, coords_c, coords_o, coords_cb], dim=-2)
