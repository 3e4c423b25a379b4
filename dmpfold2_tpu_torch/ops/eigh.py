"""Top-k symmetric eigenpairs by subspace iteration: the bf16 engine's MDS.

Counterpart of ``dmpfold2_tpu/ops/eigh.py``. The MDS head needs only the 8
algebraically largest eigenpairs of the (L, L) Gram matrix; the reference
computes a full ``symeig`` and keeps the last 8 columns (network.py:246-250).
Subspace iteration computes the same top 8 with GEMMs, an (L, q) QR per
round and one q x q ``eigh``:

  repeat iters times:  Y <- M (M Q);  Q <- qr(Y).Q        # M^2 keeps |w| order
  Rayleigh-Ritz:       T = Q^T M Q;  eigh(T) -> Ritz pairs  # q x q

M^2 converges the subspace towards the largest-|w| eigenpairs (a Gram of a
non-Euclidean distance map has negative eigenvalues); the Rayleigh-Ritz step
orders the candidates algebraically, as ``eigh``'s ascending tail is, with
the oversampled basis (q > k) holding any large negative directions. The
orthonormalization is Householder QR: MDS Grams have a low effective rank,
so the iterated basis is ill-conditioned and a Gram-based one collapses in
fp32.

Four rounds do not converge a near-degenerate tail of the top 8, so the
start basis shows in the result. :func:`start_basis` is JAX's own,
``jax.random.normal(jax.random.PRNGKey(0), (l, q), float32)``, computed here
with numpy (threefry-2x32 in JAX's partitionable mode, the uniform of
``jax.random.uniform`` and XLA's fp32 ``erf_inv`` polynomial), so the port
and the JAX package iterate from the same basis.

Inference only (no backward); training and the fp32 engines keep the full
``eigh``.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..utils import obs

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA

# XLA's fp32 ErfInv (M. Giles, "Approximating the erfinv function"):
# coefficients for w = -log1p(-x^2) below 5 and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Random123; JAX ``prng.py``
    ``_threefry2x32_lowering``) of the uint32 counter words ``x0``, ``x1``
    under ``key``."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0] ^ key[1] ^ _THREEFRY_PARITY))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's fp32 ``erf_inv``, evaluated in fp32 with numpy."""
    one = np.float32(1.0)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, np.float32(lo), np.float32(hi)) + p * w
    return np.where(np.abs(x) == one, x * np.finfo(np.float32).max, p * x)


@functools.lru_cache(maxsize=None)
def _start_basis_np(l: int, q: int) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(0), (l, q), float32)`` in numpy."""
    with np.errstate(over="ignore"):
        idx = np.arange(l * q, dtype=np.uint64)
        hi, lo = (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)
        b0, b1 = threefry2x32((0, 0), hi, lo)  # PRNGKey(0) is the key (0, 0)
    bits = b0 ^ b1
    # jax.random.uniform on [nextafter(-1, 0), 1): 23 mantissa bits in [1, 2)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo_val = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo_val, floats * (np.float32(1.0) - lo_val) + lo_val)
    out = np.float32(np.sqrt(2.0)) * _erfinv_f32(u)
    out.setflags(write=False)
    return out.reshape(l, q)


_basis_cache: dict = {}
_basis_lock = threading.Lock()


def start_basis(l: int, q: int, device=None) -> torch.Tensor:
    """The (l, q) fp32 start basis of :func:`subspace_topk` on ``device``
    (JAX's ``jax.random.normal(PRNGKey(0), (l, q))``). Built on the host once
    per (l, q) and held per device; safe to call from several threads (the
    batch engine's workers). On a CUDA device the copy is waited for once,
    so a worker on another stream reads a finished tensor."""
    device = torch.device("cpu" if device is None else device)
    key = (l, q, device)
    basis = _basis_cache.get(key)
    if basis is None:
        with _basis_lock:
            basis = _basis_cache.get(key)
            if basis is None:
                with torch.inference_mode(False), obs.wait("start_basis"):
                    # a plain tensor, also when made in a fold
                    basis = torch.from_numpy(_start_basis_np(l, q).copy()).to(device)
                if device.type == "cuda":
                    with obs.wait("start_basis"):
                        torch.cuda.synchronize(device)
                _basis_cache[key] = basis
    return basis


def subspace_topk(m: torch.Tensor, k: int = 8, q: int = 32, iters: int = 4,
                  basis: torch.Tensor | None = None):
    """Top-``k`` algebraic eigenpairs of symmetric (..., L, L) matrices ``m``.

    Returns ``(w, v)``, ``w`` (..., k) ascending and ``v`` (..., L, k): the
    layout of ``torch.linalg.eigh(m)``'s last ``k`` columns. The batch shares
    one start basis, :func:`start_basis` unless ``basis`` (L, q) is given.

    ``m`` must be exactly symmetric. Rows and columns that are zero
    (padding) give exact-zero eigenvalues, and the returned eigenvectors are
    zero there after the first product, as a full ``eigh`` of the block
    matrix gives.
    """
    l = m.shape[-1]
    q = min(q, l)
    k = min(k, q)
    m = m.float()
    y0 = start_basis(l, q, m.device) if basis is None else basis.to(m)
    qb = torch.linalg.qr(m @ y0).Q
    for _ in range(iters):
        qb = torch.linalg.qr(m @ (m @ qb)).Q  # M^2: converge by |w|
    # Rayleigh-Ritz on M itself: the candidates in algebraic order
    t = qb.mT @ (m @ qb)
    with obs.wait("eigh"):  # eigh reads its status on the host
        w, u = torch.linalg.eigh(0.5 * (t + t.mT))
    return w[..., -k:], qb @ u[..., -k:]
