"""The port's memory-bounded DCA inverse (``ops/chol.py``) and its routing in
``features/dca.py``, against the JAX package on the CPU: the blocked inverse
with tests/test_blocked_chol.py's cases and bounds, the DCA features of each
of JAX's methods against the port's route for that name, the routing by size,
the stock routes' bits against the formula the port ran before it wrote into
the fold's buffer, and the ``gpu`` test on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmpfold2_tpu.features import dca as jax_dca
from dmpfold2_tpu.features import msa as jax_msa
from dmpfold2_tpu.ops import chol as jax_chol
from dmpfold2_tpu.utils import assets
from dmpfold2_tpu_torch.engine import fold
from dmpfold2_tpu_torch.features import dca, msa
from dmpfold2_tpu_torch.ops import chol
from dmpfold2_tpu_torch.utils import aln

EXAMPLE_ALN = assets.example_aln_path()
# tests/test_blocked_chol.py's bounds against jnp.linalg.inv
ATOL, RTOL = 5e-4, 1e-3
# a stock fp32 Cholesky inverse, and the DCA features of two methods, agree
# within this share of the largest magnitude (tests/test_torch_strict.py's
# LU-vs-Cholesky rule)
REL_TOL = 1e-5
# the contact channel reduced in row chunks against in one piece
CHUNK_REL_TOL = 1e-6


def _spd(n, seed=0, cond=5.0):
    """tests/test_blocked_chol.py's matrices."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)).astype(np.float32) * 0.2
    return a @ a.T + cond * np.eye(n, dtype=np.float32)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("n,panel", [(64, 16), (96, 32), (70, 16), (128, 128),
                                     (100, 32), (301, 64), (256, 32)])
def test_blocked_inverse_matches_jax(n, panel):
    """In place, against JAX's blocked inverse and ``jnp.linalg.inv`` (JAX's
    bounds) and a stock fp32 Cholesky inverse (1e-5 of its largest entry);
    exactly symmetric. tests/test_blocked_chol.py's cases, then short last
    panels of 4 and 45 rows and four whole panels."""
    a = _spd(n, seed=n)
    work = torch.from_numpy(a.copy())
    ours = chol.blocked_spd_inverse_(work, panel=panel)
    assert ours.data_ptr() == work.data_ptr() and ours.shape == (n, n)
    theirs = np.asarray(jax_chol.blocked_spd_inverse(jnp.asarray(a), panel=panel))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jnp.linalg.inv(jnp.asarray(a))),
                               atol=ATOL, rtol=RTOL)
    stock = torch.cholesky_inverse(torch.linalg.cholesky(torch.from_numpy(a)))
    assert _rel(ours, stock) <= REL_TOL
    assert torch.equal(ours, ours.T)


def test_blocked_inverse_identity():
    a = _spd(80, seed=1)
    inv = chol.blocked_spd_inverse_(torch.from_numpy(a.copy()), panel=16)
    np.testing.assert_allclose(a @ inv.numpy(), np.eye(80), atol=2e-4)


# ---------------------------------------------------------------- features

@pytest.fixture(scope="module")
def pf():
    """PF10963 (252 x 82): n = 1722, two blocked panels, the last short."""
    return aln.parse_aln(EXAMPLE_ALN)


def _padded(mat, pad):
    n, l = mat.shape
    out = np.zeros((n + pad[0], l + pad[1]), np.int32)
    out[:n, :l] = mat
    return out


def _port_inputs(mat, n, l):
    oh = msa.msa_one_hot(torch.from_numpy(mat), n, l)
    return oh, msa.reweight(oh, l)


@pytest.mark.parametrize("pad", [(0, 0), (4, 6)])
@pytest.mark.parametrize("method", ["schur", "blocked"])
def test_fast_dca_matches_jax(pf, method, pad):
    """JAX ``fast_dca`` with its Schur or blocked inverse against the port's
    route for that name (the stock factor at n 1722), padded or not, within
    1e-5 of max |ref|."""
    n, l = pf.shape
    mat = _padded(pf, pad)
    ours = dca.fast_dca(*_port_inputs(mat, n, l), n, l, method=method)
    oh_j = jax_msa.msa_one_hot(jnp.asarray(mat), n, l)
    theirs = np.asarray(jax_dca.fast_dca(oh_j, jax_msa.reweight(oh_j, l), n, l, method=method))
    assert ours.shape == (l + pad[1], l + pad[1], dca.NUM_DCA_CHANNELS)
    assert _rel(ours, theirs) <= REL_TOL


def _spy(monkeypatch, name):
    calls = []
    real = getattr(chol, name)

    def recording(*args, **kw):
        calls.append(args[0].shape[-1])
        return real(*args, **kw)

    monkeypatch.setattr(chol, name, recording)
    return calls


@pytest.mark.parametrize("method", ["cholesky", "schur", "blocked"])
def test_routing_by_size(pf, method, monkeypatch):
    """The Cholesky-type methods are one route chosen by size: at n = 1722
    the stock factor, the bits of ``"cholesky"``; with the threshold below n
    the blocked inverse, once a call, the same bits for each name and within
    1e-5 of the stock factor's features. ``"lu"`` never runs it."""
    n, l = pf.shape
    oh, w = _port_inputs(_padded(pf, (0, 0)), n, l)
    blocked = _spy(monkeypatch, "blocked_spd_inverse_")
    stock = dca.fast_dca(oh, w, n, l, method="cholesky")
    assert torch.equal(dca.fast_dca(oh, w, n, l, method=method), stock)
    assert blocked == []
    monkeypatch.setattr(chol, "BLOCKED_THRESHOLD", 21 * l - 1)
    routed = dca.fast_dca(oh, w, n, l, method=method)
    assert blocked == [21 * l]
    assert torch.equal(routed, dca.fast_dca(oh, w, n, l, method="cholesky"))
    assert not torch.equal(routed, stock) and _rel(routed, stock) <= REL_TOL
    dca.fast_dca(oh, w, n, l, method="lu")
    assert blocked == [21 * l] * 2


def _fast_dca_before(msa1hot, weights, nseqs, nres, method, penalty=4.5):
    """The port's fast_dca as it was before it wrote into the fold's buffer
    (stock inverses only): the reference for the bits of the stock routes."""
    n_pad, l_pad, ns = msa1hot.shape
    x = msa1hot.reshape(n_pad, l_pad * ns)
    wsum = weights.sum()
    num_points = wsum - torch.sqrt(wsum / nseqs)
    mean = (x * weights[:, None]).sum(dim=0, keepdim=True) / num_points
    xc = (x - mean) * torch.sqrt(weights[:, None])
    cov = (xc.T @ xc) / num_points
    cov_reg = cov + torch.eye(l_pad * ns) * (penalty / torch.sqrt(wsum))
    inv_cov = (torch.linalg.inv_ex(cov_reg).inverse if method == "lu"
               else torch.cholesky_inverse(torch.linalg.cholesky_ex(cov_reg).L))
    x1 = inv_cov.reshape(l_pad, ns, l_pad, ns)
    features = x1.permute(0, 2, 1, 3).reshape(l_pad, l_pad, ns * ns)
    off_diag = 1.0 - torch.eye(l_pad)
    x3 = torch.sqrt((x1[:, :-1, :, :-1] ** 2).sum(dim=(1, 3))) * off_diag
    apc = x3.sum(dim=0, keepdim=True) * x3.sum(dim=1, keepdim=True) / x3.sum()
    contacts = (x3 - apc) * off_diag
    out = torch.cat([features, contacts[:, :, None]], dim=2)
    out[nres:] = 0.0
    out[:, nres:] = 0.0
    return out


@pytest.mark.parametrize("rows", [dca.CONTACT_ROWS, 7])
@pytest.mark.parametrize("method", ["cholesky", "lu"])
def test_stock_routes_keep_their_bits(pf, method, rows, monkeypatch):
    """Below the threshold ``"cholesky"`` and ``"lu"`` compute what they did:
    the couplings the same bits, the contact channel the same bits in one
    chunk and within 1e-6 of max |ref| in chunks of 7 rows; the same through
    ``pair_features`` into the fold's (B, L, L, 443) input."""
    monkeypatch.setattr(dca, "CONTACT_ROWS", rows)
    n, l = pf.shape
    mat = _padded(pf, (4, 6))
    oh, w = _port_inputs(mat, n, l)
    ref = _fast_dca_before(oh, w, n, l, method)
    ours = dca.fast_dca(oh, w, n, l, method=method)
    assert torch.equal(ours[..., :-1], ref[..., :-1])
    if rows >= l + 6:
        assert torch.equal(ours[..., -1], ref[..., -1])
    else:
        assert _rel(ours[..., -1], ref[..., -1]) <= CHUNK_REL_TOL
    dmap = torch.from_numpy(fold._build_dmap_channel(l + 6, l, None))
    x2 = fold.pair_features(torch.from_numpy(mat)[None], [n], [l], dmap[None], method)
    assert torch.equal(x2[0, ..., :-1], ours) and torch.equal(x2[0, ..., -1], dmap)


@pytest.mark.parametrize("route", ["stock", "blocked"])
def test_out_buffer_and_single_sequence(pf, route, monkeypatch):
    """``out``: a strided slice of a larger buffer is written in place and
    returned, by either route; a single sequence zeroes it."""
    if route == "blocked":
        monkeypatch.setattr(chol, "BLOCKED_THRESHOLD", 0)
    n, l = pf.shape
    oh, w = _port_inputs(_padded(pf, (0, 0)), n, l)
    big = torch.full((l, l, dca.NUM_DCA_CHANNELS + 1), 7.0)
    got = dca.dca_or_zero(oh, w, n, l, out=big[..., :-1])
    assert got.data_ptr() == big.data_ptr()
    assert torch.equal(big[..., :-1], dca.fast_dca(oh, w, n, l))
    assert (big[..., -1] == 7.0).all()
    dca.dca_or_zero(oh[:1], w[:1], 1, l, out=big[..., :-1])
    assert (big[..., :-1] == 0.0).all() and (big[..., -1] == 7.0).all()


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("n", [1848, 8736])
def test_inverses_on_the_card(n):
    """The blocked inverse on the card, in place, against ``cholesky_inverse``
    within 1e-5 of max |ref|, at PF10963's bucket (21 x 88) and the first
    bucket past the threshold (21 x 416); its temporaries at most three
    panels (panel x n floats each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.from_numpy(_spd(n, seed=n, cond=n / 16.0)).cuda()
    ref = torch.cholesky_inverse(torch.linalg.cholesky(a))
    chol.blocked_spd_inverse_(a[:64, :64].clone(), panel=16)  # the libraries' workspaces
    work = a.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = chol.blocked_spd_inverse_(work)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert out.data_ptr() == work.data_ptr()
    assert extra <= 3 * min(chol.DEFAULT_PANEL, n) * n * 4
    assert _rel(out.cpu(), ref.cpu()) <= REL_TOL
