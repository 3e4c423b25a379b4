"""The port's subspace-iteration MDS (``dmpfold2_tpu_torch/ops/eigh.py`` and
``mds_coords(impl="subspace")``) against the JAX package on the CPU.

Mirrors tests/test_subspace_eigh.py, with JAX's tolerances, and holds the
port against JAX's own functions: the start basis against
``jax.random.normal(PRNGKey(0), (l, 32))``, ``subspace_topk`` given JAX's
basis against JAX's ``subspace_topk``, ``mds_coords`` and the fp32 forward
with ``mds_impl="subspace"`` against JAX's, and the engines' choice (subspace
in bf16, ``eigh`` in fp32 and ``fp32_strict``) in ``Folder``,
``BatchFolder`` and against JAX's ``resolve_mds_impl`` on its accelerator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmpfold2_tpu.engine import fold as jax_fold
from dmpfold2_tpu.models import geometry as jax_geometry
from dmpfold2_tpu.models import gruresnet as jax_gruresnet
from dmpfold2_tpu.ops.eigh import subspace_topk as jax_subspace_topk
from dmpfold2_tpu_torch.engine import fold
from dmpfold2_tpu_torch.models import geometry, gruresnet
from dmpfold2_tpu_torch.ops import eigh
from dmpfold2_tpu_torch.parallel import stream
from dmpfold2_tpu_torch.weights import params_from_jax


@pytest.fixture
def force_subspace(monkeypatch):
    """Both packages keep the full eigh below SUBSPACE_MIN_L; force the
    subspace path so it runs at toy sizes."""
    monkeypatch.setattr(jax_geometry, "SUBSPACE_MIN_L", 0)
    monkeypatch.setattr(geometry, "SUBSPACE_MIN_L", 0)


def _sym(rng, l, spectrum):
    """Symmetric matrix with the given eigenvalues (random basis)."""
    q, _ = np.linalg.qr(rng.normal(size=(l, l)))
    return ((q * spectrum) @ q.T).astype(np.float32)


def _realistic_dm(rng, l_pad, nres):
    """Distance maps of points with 8 well-separated spatial scales (the
    anchored Gram then has a realistic decaying top-8 spectrum); ``nres`` an
    int or one per map."""
    nres = [nres] if isinstance(nres, int) else nres
    dm = np.zeros((len(nres), l_pad, l_pad), np.float32)
    for b, n in enumerate(nres):
        pts = rng.normal(size=(n, 8)) * np.geomspace(8.0, 1.0, 8)
        dm[b, :n, :n] = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    return dm


def _jax_basis(l, q=32):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (l, q), jnp.float32))


def _aligned(got, ref):
    """``got``'s columns with the signs of ``ref``'s (by their dot product)."""
    return got * np.where((got * ref).sum(axis=-2, keepdims=True) < 0, -1.0, 1.0)


# ---------------------------------------------------------------- the start basis

@pytest.mark.parametrize("l", [32, 88, 256, 736])
def test_start_basis_matches_jax(l):
    """The numpy threefry-2x32 / uniform / erf_inv against JAX's draw: within
    1e-5 relative (XLA's fp32 log1p rounds a few entries one ulp apart)."""
    ref = _jax_basis(l)
    got = eigh.start_basis(l, 32).numpy()
    assert got.shape == (l, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    assert eigh.start_basis(l, 32) is eigh.start_basis(l, 32, "cpu")  # held, not rebuilt


def test_threefry_known_answer():
    """Random123's published threefry2x32_20 answers (kat_vectors)."""
    for key, ctr, want in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                           ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                            (0x1CB996FC, 0xBB002BE7)),
                           ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                            (0xC4923A9C, 0x483DF7A0))):
        x0, x1 = eigh.threefry2x32(key, np.array([ctr[0]], np.uint32),
                                   np.array([ctr[1]], np.uint32))
        assert (int(x0[0]), int(x1[0])) == want


# ---------------------------------------------------------------- subspace_topk

def test_topk_matches_eigh_separated_spectrum():
    rng = np.random.default_rng(0)
    l = 96
    spectrum = np.sort(rng.uniform(0.5, 1.5, l) * np.geomspace(1e-3, 100.0, l))
    m = torch.from_numpy(_sym(rng, l, spectrum))
    w, v = eigh.subspace_topk(m, k=8)
    w_ref, v_ref = torch.linalg.eigh(m)
    np.testing.assert_allclose(w.numpy(), w_ref[-8:].numpy(), rtol=2e-4)
    dots = np.abs((v * v_ref[:, -8:]).sum(dim=0).numpy())
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)


def test_topk_indefinite_algebraic_ordering():
    """Large-|w| negative eigenvalues must not displace the algebraic top 8."""
    rng = np.random.default_rng(1)
    l = 64
    spectrum = np.concatenate([np.array([-90.0, -40.0, -10.0]),
                               np.geomspace(1e-4, 1.0, l - 11), np.geomspace(2.0, 60.0, 8)])
    w, _ = eigh.subspace_topk(torch.from_numpy(_sym(rng, l, np.sort(spectrum))), k=8)
    np.testing.assert_allclose(w.numpy(), np.geomspace(2.0, 60.0, 8), rtol=2e-4)


@pytest.mark.parametrize("case", ["separated", "gram88", "gram256"])
def test_topk_with_jax_basis_matches_jax(case):
    """Given JAX's start basis, the port's iteration is JAX's: Ritz values
    within rtol 1e-5, the top-8 coordinates v sqrt(w) within 1e-4 of their
    scale; the port's own basis gives the same within 1e-4 too."""
    rng = np.random.default_rng(4)
    if case == "separated":
        spectrum = np.sort(rng.uniform(0.5, 1.5, 96) * np.geomspace(1e-3, 100.0, 96))
        m = _sym(rng, 96, spectrum)
    else:
        l = int(case[4:])
        dm = torch.from_numpy(_realistic_dm(rng, l, l - 6))
        m = geometry.zeroed_gram(dm, l - 6)[0][0].numpy()
    w_ref, v_ref = (np.asarray(a) for a in jax_subspace_topk(jnp.asarray(m), k=8))
    ref = v_ref * np.sqrt(np.maximum(w_ref, 1e-8))
    scale = np.abs(ref).max()
    for basis in (torch.from_numpy(_jax_basis(m.shape[0])), None):
        w, v = (a.numpy() for a in eigh.subspace_topk(torch.from_numpy(m), k=8, basis=basis))
        np.testing.assert_allclose(w, w_ref, rtol=1e-5)
        got = _aligned(v * np.sqrt(np.maximum(w, 1e-8)), ref)
        np.testing.assert_allclose(got, ref, atol=1e-4 * scale)


# ---------------------------------------------------------------- mds_coords

@pytest.mark.parametrize("l_pad,nres", [(96, 82), (256, 241), (736, 720)])
def test_mds_subspace_matches_jax_and_eigh(l_pad, nres, force_subspace):
    """The port's subspace MDS against JAX's and against the port's eigh
    branch: 2e-3 of the coordinate scale (JAX's own bound)."""
    dm = _realistic_dm(np.random.default_rng(2), l_pad, nres)
    got = geometry.mds_coords(torch.from_numpy(dm), nres, impl="subspace")[0].numpy()
    theirs = np.asarray(jax_geometry.mds_coords(jnp.asarray(dm[0]), nres, impl="subspace"))
    ref = geometry.mds_coords(torch.from_numpy(dm), nres, impl="eigh")[0].numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, theirs, atol=2e-3 * scale)
    np.testing.assert_allclose(got, ref, atol=2e-3 * scale)
    assert np.all(got[nres:] == 0.0)


def test_mds_subspace_padding_zero_and_stable(force_subspace):
    """Padded rows are exactly zero; padded and unpadded maps agree on the
    valid block (their start bases differ in shape, so to the iteration's
    convergence, not bitwise)."""
    rng = np.random.default_rng(3)
    nres = 30
    dm_pad = torch.from_numpy(_realistic_dm(rng, 48, nres))[0]
    out_pad = geometry.mds_coords(dm_pad, nres, impl="subspace").numpy()
    assert np.all(out_pad[nres:] == 0.0)
    out = geometry.mds_coords(dm_pad[:nres, :nres], nres, impl="subspace").numpy()
    np.testing.assert_allclose(out_pad[:nres], out, atol=2e-3 * np.abs(out).max())


def test_subspace_gate_small_buckets_fall_back():
    """Below SUBSPACE_MIN_L (32, JAX's) impl="subspace" is eigh, the same
    bits; at the Pfam bucket L 88 the subspace path runs."""
    rng = np.random.default_rng(7)
    assert geometry.SUBSPACE_MIN_L == jax_geometry.SUBSPACE_MIN_L == 32
    small = torch.from_numpy(_realistic_dm(rng, geometry.SUBSPACE_MIN_L - 8, 12))
    assert torch.equal(geometry.mds_coords(small, 12, impl="subspace"),
                       geometry.mds_coords(small, 12, impl="eigh"))
    dm = torch.from_numpy(_realistic_dm(rng, 88, 82))
    ref = geometry.mds_coords(dm, 82, impl="eigh").numpy()
    got = geometry.mds_coords(dm, 82, impl="subspace").numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max())
    assert not np.array_equal(got, ref)
    with pytest.raises(ValueError, match="unknown MDS impl"):
        geometry.mds_coords(dm, 82, impl="lobpcg")


def test_subspace_tiny_nres():
    """A rank-deficient valid Gram (nres 6): padding's exact-zero eigenpairs
    may take trailing top-8 slots; the sqrt(1e-8) clamp bounds them. Finite,
    the valid rows within 5e-2 of scale of eigh's and of JAX's, the padded
    rows at most 1e-3."""
    l_pad, nres = 64, 6
    dm = _realistic_dm(np.random.default_rng(13), l_pad, nres)
    ref = geometry.mds_coords(torch.from_numpy(dm), nres, impl="eigh")[0].numpy()
    got = geometry.mds_coords(torch.from_numpy(dm), nres, impl="subspace")[0].numpy()
    theirs = np.asarray(jax_geometry.mds_coords(jnp.asarray(dm[0]), nres, impl="subspace"))
    assert np.isfinite(got).all()
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(got[:nres], ref[:nres], atol=5e-2 * scale)
    np.testing.assert_allclose(got[:nres], theirs[:nres], atol=5e-2 * scale)
    assert np.abs(got[nres:]).max() <= 1e-3


def test_batch_matches_maps_one_at_a_time():
    """B 3 with per-target nres against each map alone: within 1e-4 of scale
    (the batch shares one start basis), padding exactly zero; a non-finite
    map gives NaN coordinates for its target only."""
    nres = [88, 61, 40]
    dm = torch.from_numpy(_realistic_dm(np.random.default_rng(5), 88, nres))
    batch = geometry.mds_coords(dm, torch.tensor(nres), impl="subspace")
    for b, n in enumerate(nres):
        alone = geometry.mds_coords(dm[b:b + 1], torch.tensor([n]), impl="subspace")[0]
        scale = alone.abs().max().item()
        assert (batch[b] - alone).abs().max().item() <= 1e-4 * scale
        assert torch.all(batch[b, n:] == 0)
    dm[1, 3, 5] = float("nan")
    out = geometry.mds_coords(dm, torch.tensor(nres), impl="subspace")
    assert torch.isnan(out[1]).all()
    assert torch.equal(out[0], batch[0]) and torch.equal(out[2], batch[2])


# ---------------------------------------------------------------- the forward

_jax_forward = jax.jit(jax_gruresnet.forward, static_argnames=("mds_impl",))


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_subspace_matches_jax(seed, force_subspace):
    """The fp32 forward with mds_impl="subspace" against JAX's, at
    tests/test_subspace_eigh.py's settings (toy 64/32/4, 12 x 24, nloops 2,
    refine 10) and bounds (coordinates 0.05, confidences 5e-3)."""
    tree = jax_gruresnet.init_params(jax.random.PRNGKey(seed), width=64, cwidth=32,
                                     num_blocks=4)
    rng = np.random.default_rng(seed)
    nseqs, nres = 12, 24
    aln = rng.integers(0, 21, (nseqs, nres)).astype(np.int32)
    x2 = (rng.normal(size=(nres, nres, 443)) * 0.1).astype(np.float32)
    x2[:, :, -1] = -1.0
    ref_c, ref_f = _jax_forward(tree, jnp.asarray(aln), jnp.asarray(x2), nseqs, nres,
                                jnp.asarray(2), jnp.asarray(10), mds_impl="subspace")
    params = params_from_jax(jax.tree.map(np.asarray, tree))
    with torch.inference_mode():
        coords, confs, _ = gruresnet.forward(params, torch.from_numpy(aln), torch.from_numpy(x2),
                                             nseqs, nres, 2, 10, mds_impl="subspace")
    assert np.abs(coords.numpy() - np.asarray(ref_c)).max() < 0.05
    assert np.abs(confs.numpy() - np.asarray(ref_f)).max() < 5e-3


# ---------------------------------------------------------------- the engines

@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32_strict"])
def test_resolve_mds_impl_matches_jax_on_its_accelerator(precision, monkeypatch):
    """The port's choice is JAX's on the TPU, on every device."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert fold.resolve_mds_impl(precision) == jax_fold.resolve_mds_impl(precision)


@pytest.fixture(scope="module")
def toy_params():
    tree = jax.tree.map(np.asarray, jax_gruresnet.init_params(jax.random.PRNGKey(0), width=32,
                                                              cwidth=16, num_blocks=2))
    tree["coord_fc"] = tree["coord_fc"] * np.float32(256.0)
    return params_from_jax(tree)


@pytest.mark.parametrize("engine", ["single", "batch"])
@pytest.mark.parametrize("precision,impl", [("fp32", "eigh"), ("bf16", "subspace"),
                                            ("fp32_strict", "eigh")])
def test_engines_choose_the_mds(toy_params, monkeypatch, engine, precision, impl):
    """Every MDS call of a Folder or BatchFolder fold asks for the engine's
    implementation, at a bucket (40) where the subspace path runs."""
    seen = []
    orig = gruresnet.mds_coords

    def spy(dm, nres, n_dims=8, canonical_signs=True, impl="eigh"):
        seen.append(impl)
        return orig(dm, nres, n_dims, canonical_signs=canonical_signs, impl=impl)

    monkeypatch.setattr(gruresnet, "mds_coords", spy)
    aln = np.random.default_rng(0).integers(0, 21, (10, 37)).astype(np.uint8)
    if engine == "single":
        c, f = fold.Folder(toy_params, device="cpu", precision=precision).fold(
            aln, iterations=1, minsteps=2)
        results = [(c, f)]
    else:
        bf = stream.BatchFolder(toy_params, device="cpu", batch_size=2, precision=precision)
        results = bf.fold_many([stream.Target(aln), stream.Target(aln[:, :33])],
                               iterations=1, minsteps=2)
        bf.close()
    assert seen == [impl, impl]
    assert all(np.isfinite(c).all() and np.isfinite(f).all() for c, f in results)


def test_bf16_fold_matches_jax_bf16_folder(toy_params, monkeypatch):
    """The port's bf16 Folder against JAX's bf16 Folder with JAX's
    accelerator choice of MDS (subspace): the same bucket (32 x 40), the
    initial pass and 5 refinement steps; confidences within phase cpu's bf16
    bound (0.025) and the CA trace within 0.25 A."""
    monkeypatch.setattr(jax_fold, "resolve_mds_impl",
                        lambda p: "subspace" if p == "bf16" else "eigh")
    tree = jax.tree.map(np.asarray, jax_gruresnet.init_params(jax.random.PRNGKey(0), width=32,
                                                              cwidth=16, num_blocks=2))
    tree["coord_fc"] = tree["coord_fc"] * np.float32(256.0)
    aln = np.random.default_rng(1).integers(0, 21, (30, 37)).astype(np.uint8)
    ours_c, ours_f = fold.Folder(toy_params, device="cpu", precision="bf16").fold(
        aln, iterations=0, minsteps=5)
    jax.clear_caches()
    ref_c, ref_f = jax_fold.Folder(tree, precision="bf16").fold(aln, iterations=0, minsteps=5)
    np.testing.assert_allclose(ours_f, np.asarray(ref_f), atol=0.025)
    np.testing.assert_allclose(ours_c[:, 1], np.asarray(ref_c)[:, 1], atol=0.25)
