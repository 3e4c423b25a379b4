"""Memory-bounded inverses of the DCA covariance (symmetric positive definite).

Counterpart of ``dmpfold2_tpu/ops/chol.py``'s blocked inverse, with its
constants. ``features/dca.py`` runs :func:`blocked_spd_inverse_` for every
Cholesky-type method (``"cholesky"``, ``"blocked"``, ``"schur"``) above
``BLOCKED_THRESHOLD``. JAX's recursive Schur inverse has no counterpart: on
the H100 at n 15456 it took more time and more memory than this one.

:func:`blocked_spd_inverse_` inverts in place: the covariance's own buffer
becomes its inverse, and the temporaries are one column or row panel
(``panel`` x n). LAPACK's potrf, trtri and lauum, blocked by panels, with
each product on the lower-triangular blocks only (about n^3 operations in
all, n^3 / 3 each), then the upper triangle filled from the lower. The
factor's status stays on the device (the ``_ex`` forms), so there is no host
sync; an indefinite matrix gives non-finite values, as the stock inverse
does. JAX pads the matrix to a multiple of the panel with an identity block;
here the last panel is shorter, which is the same function on the valid block.
"""

from __future__ import annotations

import torch

BLOCKED_THRESHOLD = 8192  # "cholesky" above this size runs the blocked inverse
DEFAULT_PANEL = 1024


def _panels(n: int, panel: int) -> list[tuple[int, int]]:
    return [(s, min(s + panel, n)) for s in range(0, n, panel)]


def _lower_cholesky_(a: torch.Tensor, blocks) -> None:
    """potrf: the lower Cholesky factor over ``a``'s lower triangle (right
    looking: each panel's diagonal block factored, the strip below solved,
    the trailing lower blocks updated), the strict upper triangle zeroed."""
    for k, (s, e) in enumerate(blocks):
        l11 = torch.linalg.cholesky_ex(a[s:e, s:e]).L  # reads the lower triangle only
        a[s:e, s:e] = l11
        a[s:e, e:] = 0.0
        if e == a.shape[0]:
            break
        # L21 = A21 L11^-T
        a[e:, s:e] = torch.linalg.solve_triangular(l11.T, a[e:, s:e], upper=True, left=False)
        l21 = a[e:, s:e]
        for sj, ej in blocks[k + 1:]:
            # the block column's lower part; its diagonal block's upper half
            # is updated too and overwritten when that block is factored
            a[sj:, sj:ej].addmm_(l21[sj - e:], l21[sj - e:ej - e].T, alpha=-1.0)


def _lower_inverse_(a: torch.Tensor, blocks) -> None:
    """trtri: X = L^-1 over L, by row panels (JAX ``_blocked_lower_inverse``):
    X[k, :e] = L_kk^-1 [-(L[k, :s] X[:s, :s]) | I]. The products run on the
    lower-triangular blocks of X only; the upper triangle stays zero."""
    for s, e in blocks:
        rhs = torch.empty((e - s, e), dtype=a.dtype, device=a.device)
        for sj, ej in blocks:
            if sj >= s:
                break
            # X[sj:s, sj:ej] is lower block-triangular: rows from sj on
            torch.mm(a[s:e, sj:s], a[sj:s, sj:ej], out=rhs[:, sj:ej])
        rhs[:, :s].neg_()
        rhs[:, s:].zero_()
        rhs[:, s:].diagonal().fill_(1.0)
        a[s:e, :e] = torch.linalg.solve_triangular(a[s:e, s:e], rhs, upper=False)
        a[s:e, s:e] = a[s:e, s:e].tril()


def _gram_lower_(a: torch.Tensor, blocks) -> None:
    """lauum: X^T X over X's lower triangle, in LAPACK ``dlauum``'s order:
    for each row panel, X_kk^T times the strip left of the diagonal block
    (trmm), the diagonal block X_kk^T X_kk, then the rows below: a gemm into
    the strip and a syrk into the diagonal block."""
    for s, e in blocks:
        xkk = a[s:e, s:e].clone()
        if s:
            a[s:e, :s] = xkk.T @ a[s:e, :s]
        a[s:e, s:e] = xkk.T @ xkk
        if e < a.shape[0]:
            below = a[e:, s:e]
            if s:
                a[s:e, :s].addmm_(below.T, a[e:, :s])
            a[s:e, s:e].addmm_(below.T, below)


def _fill_upper_(a: torch.Tensor, blocks) -> None:
    """The upper triangle from the lower, a row panel at a time; each diagonal
    block symmetrized from its own lower triangle."""
    for s, e in blocks:
        d = a[s:e, s:e]
        d.copy_(d.tril() + d.tril(-1).T)
        a[s:e, e:] = a[e:, s:e].T


def blocked_spd_inverse_(a: torch.Tensor, panel: int = DEFAULT_PANEL) -> torch.Tensor:
    """Inverse of a symmetric positive-definite (n, n) matrix, in place on
    ``a`` (returned): inv = L^-T L^-1. Reads the lower triangle of ``a``."""
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected a square matrix, got {tuple(a.shape)}")
    blocks = _panels(a.shape[0], panel)
    _lower_cholesky_(a, blocks)
    _lower_inverse_(a, blocks)
    _gram_lower_(a, blocks)
    _fill_upper_(a, blocks)
    return a

