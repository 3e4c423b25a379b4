"""MDS, refinement and backbone completion, in plain PyTorch.

The reference network's geometry (network.py): the Gram matrix of the
predicted distance map, its top 8 eigenpairs as coordinates (canonical
signs: each eigenvector's largest component positive); the Euler steps of the
CA force field; the Levitt-style completion of N, C, O and CB. The bf16
engine's MDS is the top 8 by subspace iteration from a fixed start basis,
which four rounds do not converge for a near-degenerate tail: the reference
follows that algorithm (``subspace_top8``) with the same start basis (JAX's
``random.normal(PRNGKey(0), (L, 32))``, rebuilt here with numpy).
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_DIMS = 8
SUBSPACE_Q, SUBSPACE_ITERS, SUBSPACE_MIN_L = 32, 4, 32
VDW_DIST, COV_DIST, K_VDW, K_COV, STEP_SIZE = 3.0, 3.78, 100.0, 100.0, 0.001

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _threefry(x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, key (0, 0)."""
    ks = (np.uint32(0), np.uint32(0), np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ ((x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r)))
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def start_basis(l: int, q: int) -> np.ndarray:
    """JAX's ``random.normal(PRNGKey(0), (l, q), float32)``: threefry bits,
    a uniform on [nextafter(-1, 0), 1), sqrt(2) times XLA's fp32 erf_inv."""
    with np.errstate(over="ignore"):
        idx = np.arange(l * q, dtype=np.uint64)
        b0, b1 = _threefry((idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32))
    bits = b0 ^ b1
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, f * (np.float32(1.0) - lo) + lo)
    w = -np.log1p(-u * u)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(small, np.float32(a), np.float32(b)) + p * w
    erfinv = np.where(np.abs(u) == 1.0, u * np.finfo(np.float32).max, p * u)
    return (np.float32(math.sqrt(2.0)) * erfinv).astype(np.float32).reshape(l, q)


def gram(dm: torch.Tensor, nres) -> torch.Tensor:
    """(..., L, L) predicted distances -> the Gram matrix from the first
    residue, rows and columns at or past ``nres`` (an int, or one per map)
    zero."""
    dm = (0.5 * (dm + dm.transpose(-1, -2))).abs()
    g = 0.5 * (dm[..., 0:1, :].square() + dm[..., :, 0:1].square() - dm.square())
    valid = (torch.arange(dm.shape[-1], device=dm.device)
             < torch.as_tensor(nres, device=dm.device)[..., None])
    return g * (valid[..., :, None] & valid[..., None, :])


def _embed(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Eigenpairs (..., 8), (..., L, 8) -> coordinates, each eigenvector's
    largest component made positive."""
    w = w.clamp(min=1e-8)
    comp = v.gather(-2, v.abs().argmax(dim=-2, keepdim=True))
    return v * torch.where(comp < 0, -1.0, 1.0) * torch.sqrt(w)[..., None, :]


def mds_eigh(dm: torch.Tensor, nres: int) -> torch.Tensor:
    """(L_pad, L_pad) map -> (L_pad, 8): the full eigendecomposition of the
    valid block's Gram, zero rows past ``nres``."""
    g = gram(dm, nres)[:nres, :nres]
    w, v = torch.linalg.eigh(g)
    out = torch.zeros((dm.shape[0], N_DIMS), device=dm.device)
    out[:nres] = _embed(w[-N_DIMS:], v[:, -N_DIMS:])
    return out


def mds_subspace(dm: torch.Tensor, nres, basis: torch.Tensor) -> torch.Tensor:
    """(..., L_pad, L_pad) maps -> (..., L_pad, 8) by subspace iteration on
    the padded Gram from ``basis`` (L_pad, 32): M^2 rounds with Householder
    QR, then the Rayleigh-Ritz pairs; below 32 rows the full
    eigendecomposition (one map)."""
    l_pad = dm.shape[-1]
    if l_pad < SUBSPACE_MIN_L:
        if dm.dim() == 2:
            return mds_eigh(dm, int(nres))
        return torch.stack([mds_eigh(d, int(n)) for d, n in zip(dm, nres)])
    m = gram(dm, nres)
    qb = torch.linalg.qr(m @ basis).Q
    for _ in range(SUBSPACE_ITERS):
        qb = torch.linalg.qr(m @ (m @ qb)).Q
    t = qb.mT @ (m @ qb)
    w, u = torch.linalg.eigh(0.5 * (t + t.mT))
    return _embed(w[..., -N_DIMS:], qb @ u[..., -N_DIMS:])


def eigen_error(dm: torch.Tensor, nres: int, emb: torch.Tensor) -> float:
    """How far an (nres, 8) embedding is from the top 8 eigenpairs of the
    map's Gram, over the Gram's spectral norm, in fp64: each column's
    direction v an eigenvector (|G v - r v|, r = v'Gv), its scale the
    eigenvalue's (|e|^2 against r, clamped at 1e-8 as the MDS clamps), and r
    the exact k-th largest eigenvalue. Any basis of a degenerate eigenspace
    passes."""
    g = gram(dm, nres)[:nres, :nres].double()
    exact = torch.linalg.eigvalsh(g)
    norm = exact.abs().max().clamp(min=1e-300)
    e = emb.double()
    sq = e.square().sum(dim=0)                                       # (8,)
    v = e / torch.sqrt(sq.clamp(min=1e-300))[None, :]
    gv = g @ v
    r = (v * gv).sum(dim=0)
    resid = (gv - v * r[None, :]).norm(dim=0)
    lo = 1e-8
    scale = (sq - r.clamp(min=lo)).abs()
    rank = (r.clamp(min=lo) - exact[-N_DIMS:].clamp(min=lo)).abs()
    return float(torch.stack([resid, scale, rank]).max() / norm)


def refine(ca: torch.Tensor, steps: int) -> torch.Tensor:
    """(L, 3) CA trace -> after ``steps`` Euler steps of the force field:
    clash repulsion below 3 A, bond springs to 3.78 A, accelerations clipped
    to 100, step 0.001."""
    for _ in range(steps):
        d = ca[None, :, :] - ca[:, None, :]
        dist = torch.sqrt(d.square().sum(dim=2).clamp(min=1e-12)).clamp(0.01, 10.0)
        push = torch.where(dist < VDW_DIST, VDW_DIST - dist, torch.zeros_like(dist))
        acc = (K_VDW * push[:, :, None] * d / dist[:, :, None]).sum(dim=0)
        b = ca[1:] - ca[:-1]
        blen = torch.sqrt(b.square().sum(dim=1).clamp(min=1e-12)).clamp(min=0.1)
        spring = K_COV * (blen - COV_DIST).clamp(max=3.0)[:, None] * b / blen[:, None]
        acc = acc.clone()
        acc[:-1] += spring
        acc[1:] -= spring
        ca = ca + acc.clamp(-100.0, 100.0) * STEP_SIZE
    return ca


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(v.square().sum(dim=-1, keepdim=True).clamp(min=1e-24))


def complete(ca: torch.Tensor) -> torch.Tensor:
    """(L, 3) CA trace -> (L, 5, 3) N, CA, C, O, CB, with dummy CAs 3.82 A
    beyond each end along the local cross product."""
    nterm = ca[0] + 3.82 * _unit(torch.linalg.cross(ca[0] - ca[1], ca[2] - ca[1]))
    cterm = ca[-1] + 3.82 * _unit(torch.linalg.cross(ca[-1] - ca[-2], ca[-3] - ca[-2]))
    prev = torch.cat([nterm[None], ca[:-1]])
    nxt = torch.cat([ca[1:], cterm[None]])
    to_prev, to_next = prev - ca, nxt - ca
    cross = _unit(torch.linalg.cross(to_prev, to_next))
    mid = 0.5 * (ca + prev)
    n_atom = mid - to_prev / 8.0 + cross / 4.0
    c_shift = mid + to_prev / 8.0 - cross / 2.0
    o_shift = mid - 1.8 * cross
    mid_end = 0.5 * (cterm + ca[-1])
    c_end = mid_end - (cterm - ca[-1]) / 8.0 + cross[-1] / 2.0
    o_end = mid_end + 2.0 * cross[-1]
    c_atom = torch.cat([c_shift[1:], c_end[None]])
    o_atom = torch.cat([o_shift[1:], o_end[None]])
    v_n, v_c = ca - n_atom, ca - c_atom
    perp = torch.linalg.cross(v_n, v_c)
    bis = v_n + v_c
    ang = math.pi / 2.0 - math.asin(1.0 / math.sqrt(3.0))
    norm = lambda v: torch.sqrt(v.square().sum(dim=-1, keepdim=True).clamp(min=1e-24))  # noqa: E731
    cb = ca + 1.5 * math.cos(ang) / norm(bis) * bis + 1.5 * math.sin(ang) / norm(perp) * perp
    return torch.stack([n_atom, ca, c_atom, o_atom, cb], dim=1)
