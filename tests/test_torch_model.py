"""The PyTorch port's model against the JAX package: weights, trunk, geometry
and the whole forward, with the tolerances of tests/test_model_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmpfold2_tpu.models import geometry as jax_geometry
from dmpfold2_tpu.models import gruresnet as jax_gruresnet
from dmpfold2_tpu.models import trunk as jax_trunk
from dmpfold2_tpu.weights import convert_state_dict, save_params
from dmpfold2_tpu_torch.models import geometry, gruresnet, trunk
from dmpfold2_tpu_torch.weights import load_npz, load_state_dict, params_from_jax

from torch_oracle import OracleGRUResNet

N, L = 12, 18


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """(path, tensor) pairs of a port parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [(f"{k}.{p}", v) for k in sorted(tree) for p, v in _leaves(tree[k])]
    if isinstance(tree, list):
        return [(f"{i}.{p}", v) for i, t in enumerate(tree) for p, v in _leaves(t)]
    return [("", tree)]


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype == torch.float32, path
        assert torch.equal(x, y), path


def _oracle_tree(width, cwidth, blocks, seed):
    """A JAX parameter tree from the torch oracle's random reference weights
    (as tests/test_model_parity.py builds its parameters)."""
    torch.manual_seed(seed)
    sd = OracleGRUResNet(width, cwidth, blocks).eval().state_dict()
    return _np_tree(convert_state_dict(sd, num_blocks=blocks))


@pytest.fixture(scope="module")
def toy_jax():
    """Toy 32/16/2 weights with ``coord_fc`` scaled by 256, so the predicted CA
    trace has protein-like spacing (a few A between neighbours). Unscaled,
    the random head collapses all 18 CAs into a few hundredths of an A,
    where 100 refinement steps are chaotic: rounding noise grows into
    tenths of an A, and no two implementations can agree."""
    tree = _oracle_tree(32, 16, 2, seed=7)
    tree["coord_fc"] = tree["coord_fc"] * np.float32(256.0)
    return tree


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    aln = rng.integers(0, 22, size=(N, L)).astype(np.int32)
    x2 = rng.normal(size=(L, L, 443)).astype(np.float32) * 0.1
    x2 = (x2 + x2.transpose(1, 0, 2)) / 2
    return aln, x2


# ---------------------------------------------------------------- weights

def test_params_from_jax_layouts(toy_jax):
    ours = params_from_jax(toy_jax)
    assert len(ours["trunk"]["blocks"]) == 2
    np.testing.assert_array_equal(ours["trunk"]["blocks"][1]["maxout"]["w"].numpy(),
                                  toy_jax["trunk"]["blocks"]["maxout"]["w"][1].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ours["vgru"][0]["wi"].numpy(), toy_jax["vgru"][0]["wi"])
    np.testing.assert_array_equal(ours["coord_gru"][2]["bwd"]["wh"].numpy(),
                                  toy_jax["coord_gru"][2]["bwd"]["wh"])


def test_load_npz_round_trip(toy_jax, tmp_path):
    path = str(tmp_path / "toy.npz")
    save_params(path, toy_jax, extra={"__step": np.asarray(3)})
    _assert_same_tree(load_npz(path), params_from_jax(toy_jax))


def test_load_state_dict_matches_converter():
    torch.manual_seed(3)
    sd = OracleGRUResNet(32, 16, 3).eval().state_dict()
    ours = load_state_dict(sd)
    assert len(ours["trunk"]["blocks"]) == 3
    _assert_same_tree(ours, params_from_jax(_np_tree(convert_state_dict(sd, num_blocks=3))))


# ---------------------------------------------------------------- trunk and geometry

@pytest.mark.parametrize("l_pad", [10, 14])
def test_trunk_apply_matches(toy_jax, l_pad):
    rng = np.random.default_rng(1)
    nres = 10
    x = np.zeros((1, l_pad, l_pad, 32 + 443), np.float32)
    x[:, :nres, :nres] = rng.normal(size=(1, nres, nres, 32 + 443))
    mask = np.zeros((1, l_pad, l_pad, 1), np.float32)
    mask[:, :nres, :nres] = 1.0
    ours = trunk.trunk_apply([params_from_jax(toy_jax)["trunk"]], [torch.from_numpy(x)],
                             [torch.from_numpy(mask)]).numpy()
    theirs = np.asarray(jax_trunk.trunk_apply(toy_jax["trunk"], jnp.asarray(x), jnp.asarray(mask)))
    assert ours.shape == (1, l_pad, l_pad, 2)
    np.testing.assert_allclose(ours, theirs, atol=2e-4)
    assert np.all(ours[:, nres:] == 0) and np.all(ours[:, :, nres:] == 0)


@pytest.mark.parametrize("l_pad", [20, 32])
def test_mds_coords_matches(l_pad):
    rng = np.random.default_rng(8)
    dm = np.zeros((l_pad, l_pad), np.float32)
    dm[:20, :20] = np.abs(rng.normal(size=(20, 20))) * 5
    ours = geometry.mds_coords(torch.from_numpy(dm), 20).numpy()
    theirs = np.asarray(jax_geometry.mds_coords(jnp.asarray(dm), 20))
    np.testing.assert_allclose(ours, theirs, atol=2e-4)
    assert np.abs(ours[20:]).max(initial=0.0) < 1e-6


@pytest.mark.parametrize("l_pad", [30, 45])
def test_calpha_to_main_chain_matches(l_pad):
    ca = np.zeros((l_pad, 3), np.float32)
    ca[:30] = np.random.default_rng(5).normal(size=(30, 3)) * 5
    ours = geometry.calpha_to_main_chain(torch.from_numpy(ca), 30).numpy()
    theirs = np.asarray(jax_geometry.calpha_to_main_chain(jnp.asarray(ca), 30))
    assert ours.shape == (l_pad, 5, 3)
    np.testing.assert_allclose(ours[:30], theirs[:30], atol=1e-4)


# ---------------------------------------------------------------- whole forward

def _run_port(params, aln, x2, nloops, steps, n_pad=None, l_pad=None):
    n, l = aln.shape
    aln_p = np.zeros((n_pad or n, l_pad or l), np.int32)
    aln_p[:n, :l] = aln
    x2_p = np.zeros((l_pad or l, l_pad or l, 443), np.float32)
    x2_p[:l, :l] = x2
    coords, confs, iters = gruresnet.forward(params, torch.from_numpy(aln_p),
                                             torch.from_numpy(x2_p), n, l, nloops, steps)
    assert iters == nloops
    return coords.numpy()[:l], confs.numpy()[:l]


_jax_forward = jax.jit(jax_gruresnet.forward,
                       static_argnames=("adaptive_recycle", "with_aux"))


def _run_jax(params, aln, x2, nloops, steps):
    n, l = aln.shape
    coords, confs = _jax_forward(params, jnp.asarray(aln), jnp.asarray(x2), n, l,
                                 jnp.asarray(nloops), jnp.asarray(steps))
    return np.asarray(coords), np.asarray(confs)


@pytest.mark.parametrize("nloops,steps,conf_tol,coord_tol",
                         [(0, 0, 2e-4, 5e-3), (2, 0, 2e-4, 5e-3), (1, 5, 2e-4, 5e-3),
                          (10, 100, 5e-4, 5e-2)])
def test_toy_forward_matches_jax(toy_jax, inputs, nloops, steps, conf_tol, coord_tol):
    aln, x2 = inputs
    ours_c, ours_f = _run_port(params_from_jax(toy_jax), aln, x2, nloops, steps)
    ref_c, ref_f = _run_jax(toy_jax, aln, x2, nloops, steps)
    np.testing.assert_allclose(ours_f, ref_f, atol=conf_tol)
    np.testing.assert_allclose(ours_c, ref_c, atol=coord_tol)


def test_forward_padding_invariant(toy_jax, inputs):
    aln, x2 = inputs
    params = params_from_jax(toy_jax)
    base_c, base_f = _run_port(params, aln, x2, 1, 3)
    pad_c, pad_f = _run_port(params, aln, x2, 1, 3, n_pad=N + 6, l_pad=L + 10)
    np.testing.assert_allclose(pad_f, base_f, atol=1e-4)
    np.testing.assert_allclose(pad_c, base_c, atol=5e-3)


def test_forward_adaptive_recycle_count(toy_jax, inputs):
    aln, x2 = inputs
    n, l = aln.shape
    _, _, ours = gruresnet.forward(params_from_jax(toy_jax), torch.from_numpy(aln),
                                   torch.from_numpy(x2), n, l, 30, 0, adaptive_recycle=True)
    *_, aux = _jax_forward(toy_jax, jnp.asarray(aln), jnp.asarray(x2), n, l,
                           jnp.asarray(30), jnp.asarray(0), adaptive_recycle=True,
                           with_aux=True)
    assert 1 <= ours <= 30
    assert ours == int(aux["iterations"])


def test_full_width_forward_matches_jax():
    """512/128/16 at N=8, L=14, -n 1 -m 5 (the weights and inputs of
    tests/test_model_parity.py::test_full_size_forward_matches_oracle)."""
    tree = _oracle_tree(512, 128, 16, seed=42)
    rng = np.random.default_rng(10)
    aln = rng.integers(0, 22, size=(8, 14)).astype(np.int32)
    x2 = rng.normal(size=(14, 14, 443)).astype(np.float32) * 0.1
    x2 = (x2 + x2.transpose(1, 0, 2)) / 2
    ours_c, ours_f = _run_port(params_from_jax(tree), aln, x2, 1, 5)
    ref_c, ref_f = _run_jax(tree, aln, x2, 1, 5)
    np.testing.assert_allclose(ours_f, ref_f, atol=5e-4)
    np.testing.assert_allclose(ours_c, ref_c, atol=1e-2)
