"""MSA features of the PyTorch port against the JAX package, with the
tolerances of tests/test_features.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmpfold2_tpu.features import dca as jax_dca
from dmpfold2_tpu.features import msa as jax_msa
from dmpfold2_tpu.utils import assets
from dmpfold2_tpu_torch.features import dca, msa
from dmpfold2_tpu_torch.utils import aln

EXAMPLE_ALN = assets.example_aln_path()


@pytest.fixture(scope="module")
def small_msa():
    return aln.parse_aln(EXAMPLE_ALN)[:40, :30].copy()


def _pad(mat, n_pad, l_pad):
    out = np.zeros((n_pad, l_pad), np.int32)
    out[:mat.shape[0], :mat.shape[1]] = mat
    return out


def _port_features(mat, nseqs, nres):
    oh = msa.msa_one_hot(torch.from_numpy(mat.astype(np.int32)), nseqs, nres)
    w = msa.reweight(oh, nres)
    return oh, w


def _jax_features(mat, nseqs, nres):
    oh = jax_msa.msa_one_hot(jnp.asarray(mat.astype(np.int32)), nseqs, nres)
    w = jax_msa.reweight(oh, nres)
    return oh, w


@pytest.mark.parametrize("pad", [(0, 0), (8, 6)])
def test_one_hot_and_reweight_match(small_msa, pad):
    n, l = small_msa.shape
    mat = _pad(small_msa, n + pad[0], l + pad[1])
    oh, w = _port_features(mat, n, l)
    oh_j, w_j = _jax_features(mat, n, l)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(oh_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-6)
    assert w[n:].sum() == 0


def test_fast_dca_matches(small_msa):
    n, l = small_msa.shape
    oh, w = _port_features(small_msa, n, l)
    oh_j, w_j = _jax_features(small_msa, n, l)
    ours = dca.fast_dca(oh, w, n, l).numpy()
    theirs = np.asarray(jax_dca.fast_dca(oh_j, w_j, n, l, method="cholesky"))
    assert ours.shape == (l, l, 442)
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("pad", [(8, 6), (24, 2)])
def test_fast_dca_padded_matches(small_msa, pad):
    n, l = small_msa.shape
    mat = _pad(small_msa, n + pad[0], l + pad[1])
    oh, w = _port_features(mat, n, l)
    oh_j, w_j = _jax_features(mat, n, l)
    ours = dca.fast_dca(oh, w, n, l).numpy()
    theirs = np.asarray(jax_dca.fast_dca(oh_j, w_j, n, l, method="cholesky"))
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-3)
    # padding invariant against the unpadded port features, and zero outside
    base = dca.fast_dca(*_port_features(small_msa, n, l), n, l).numpy()
    np.testing.assert_allclose(ours[:l, :l], base, atol=1e-4, rtol=1e-3)
    assert np.all(ours[l:] == 0) and np.all(ours[:, l:] == 0)


def test_dca_single_sequence_zero(small_msa):
    l = small_msa.shape[1]
    oh, w = _port_features(small_msa[:1], 1, l)
    out = dca.dca_or_zero(oh, w, 1, l)
    assert out.shape == (l, l, 442)
    assert out.abs().sum() == 0
    theirs = np.asarray(jax_dca.dca_or_zero(*_jax_features(small_msa[:1], 1, l), 1, l))
    np.testing.assert_array_equal(out.numpy(), theirs)


def test_dca_or_zero_computes_for_two_or_more(small_msa):
    n, l = small_msa.shape
    oh, w = _port_features(small_msa, n, l)
    np.testing.assert_array_equal(dca.dca_or_zero(oh, w, n, l).numpy(),
                                  dca.fast_dca(oh, w, n, l).numpy())
