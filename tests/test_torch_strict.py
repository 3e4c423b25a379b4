"""The PyTorch port's fidelity engine ``fp32_strict`` and the fold's knobs
``dca_method`` and ``use_buckets``, against the JAX package on the CPU: the
DCA method table, the LU DCA, the raw eigenvector signs and their wiring in
both engines, the whole strict fold, exact shapes, and the CLI and service
options. The ``gpu`` tests hold the same on a card at a small width.

Weights: the JAX package's toy model (32/16/2) with ``coord_fc`` scaled by
256, as in tests/test_torch_stream.py (protein-like CA spacing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmpfold2_tpu.engine import fold as jax_fold
from dmpfold2_tpu.features import dca as jax_dca
from dmpfold2_tpu.features import msa as jax_msa
from dmpfold2_tpu.models import geometry as jax_geometry
from dmpfold2_tpu.models import gruresnet as jax_gruresnet
from dmpfold2_tpu.models.gruresnet import init_params as jax_init_params
from dmpfold2_tpu.utils import assets
from dmpfold2_tpu.weights import save_params
from dmpfold2_tpu_torch import serve as serve_mod
from dmpfold2_tpu_torch.cli import run_dmpfold
from dmpfold2_tpu_torch.config import FoldConfig
from dmpfold2_tpu_torch.engine import fold
from dmpfold2_tpu_torch.features import dca, msa
from dmpfold2_tpu_torch.models import geometry, gruresnet
from dmpfold2_tpu_torch.parallel import stream
from dmpfold2_tpu_torch.utils import aln
from dmpfold2_tpu_torch.weights import params_from_jax

from test_torch_serve import _Built, _capture_serve

EXAMPLE_ALN = assets.example_aln_path()
# the whole fold against JAX (tests/test_model_parity.py's toy bounds)
CONF_TOL, CA_TOL = 2e-4, 5e-3
# exact shape against bucketed (tests/test_engine.py:61-62)
EXACT_CONF_TOL, EXACT_COORD_TOL = 1e-4, 5e-3


@pytest.fixture(scope="module")
def tree():
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), width=32,
                                                    cwidth=16, num_blocks=2))
    tree["coord_fc"] = tree["coord_fc"] * np.float32(256.0)
    return tree


@pytest.fixture(scope="module")
def params(tree):
    return params_from_jax(tree)


@pytest.fixture(scope="module")
def example():
    """PF10963 cut to 30 x 37: bucket (32, 40), so the exact shape differs."""
    return aln.parse_aln(EXAMPLE_ALN)[:30, :37].copy()


# ---------------------------------------------------------------- DCA method

@pytest.mark.parametrize("setting", ["auto", "cholesky", "lu", "schur", "blocked"])
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32_strict"])
def test_resolve_dca_method_matches_jax(setting, precision):
    """JAX's table on its CPU backend (tests/test_io.py:71-89): auto is lu
    for fp32_strict and cholesky otherwise; an explicit setting wins."""
    assert jax.default_backend() == "cpu"
    assert fold.resolve_dca_method(setting, precision) == \
        jax_fold.resolve_dca_method(setting, precision)


def _features(mat, nseqs, nres):
    oh = msa.msa_one_hot(torch.from_numpy(mat.astype(np.int32)), nseqs, nres)
    oh_j = jax_msa.msa_one_hot(jnp.asarray(mat.astype(np.int32)), nseqs, nres)
    return (oh, msa.reweight(oh, nres)), (oh_j, jax_msa.reweight(oh_j, nres))


@pytest.mark.parametrize("pad", [(0, 0), (8, 6)])
def test_fast_dca_lu_matches_jax(example, pad):
    """The LU DCA against JAX ``fast_dca(method="lu")`` within 1e-5 of the
    features' largest magnitude, padded or not."""
    n, l = example.shape
    mat = np.zeros((n + pad[0], l + pad[1]), np.int32)
    mat[:n, :l] = example
    (oh, w), (oh_j, w_j) = _features(mat, n, l)
    ours = dca.fast_dca(oh, w, n, l, method="lu").numpy()
    theirs = np.asarray(jax_dca.fast_dca(oh_j, w_j, n, l, method="lu"))
    assert ours.shape == (l + pad[1], l + pad[1], 442)
    assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()
    chol = dca.dca_or_zero(oh, w, n, l, method="cholesky").numpy()
    assert np.abs(ours - chol).max() <= 1e-5 * np.abs(chol).max()


def test_unknown_dca_method_raises(example, params):
    """Every method the JAX package has is taken (tests/test_torch_chol.py);
    a name it does not have is refused before any work."""
    n, l = example.shape
    (oh, w), _ = _features(example, n, l)
    for call in (lambda: dca.fast_dca(oh, w, n, l, method="qr"),
                 lambda: dca.dca_or_zero(oh, w, n, l, method="qr"),
                 lambda: fold.Folder(params, device="cpu", dca_method="qr"),
                 lambda: fold.resolve_dca_method("qr", "fp32")):
        with pytest.raises(ValueError, match="unknown DCA method 'qr'"):
            call()


# ---------------------------------------------------------------- raw signs

def _distance_maps(l_pad, nres, seed=0):
    rng = np.random.default_rng(seed)
    ca = np.cumsum(rng.normal(size=(len(nres), l_pad, 3)) * 2.2, axis=1)
    return np.linalg.norm(ca[:, :, None] - ca[:, None], axis=-1).astype(np.float32)


@pytest.mark.parametrize("l_pad", [24, 40])
def test_mds_raw_signs_match_jax(l_pad):
    """``mds_coords(canonical_signs=False)`` against JAX's, column by column
    up to sign, and exactly ``eigh``'s own top-8 columns (scaled)."""
    nres = [l_pad - 3, l_pad]
    dm = _distance_maps(l_pad, nres)
    ours = geometry.mds_coords(torch.from_numpy(dm), torch.tensor(nres),
                               canonical_signs=False).numpy()
    for b, nr in enumerate(nres):
        theirs = np.asarray(jax_geometry.mds_coords(jnp.asarray(dm[b]), nr,
                                                    canonical_signs=False))
        signs = np.sign((ours[b] * theirs).sum(axis=0))
        np.testing.assert_allclose(ours[b], theirs * signs, atol=2e-3 * np.abs(theirs).max())
    # the wiring: the raw columns are eigh's, unmodified; canonical differs by signs only
    canon = geometry.mds_coords(torch.from_numpy(dm), torch.tensor(nres)).numpy()
    assert np.array_equal(np.abs(canon), np.abs(ours))
    w, v = torch.linalg.eigh(geometry.mds_gram(torch.from_numpy(dm), torch.tensor(nres)))
    expect = v[..., -8:] * torch.sqrt(w[..., -8:].clamp(min=1e-8))[:, None, :]
    assert torch.equal(torch.from_numpy(ours), expect)


@pytest.fixture
def mds_spy(monkeypatch):
    """Record ``canonical_signs`` of every MDS call the port's forward makes."""
    seen = []
    orig = gruresnet.mds_coords

    def spy(dm, nres, n_dims=8, canonical_signs=True, **kw):
        seen.append(bool(canonical_signs))
        return orig(dm, nres, n_dims, canonical_signs=canonical_signs, **kw)

    monkeypatch.setattr(gruresnet, "mds_coords", spy)
    return seen


@pytest.mark.parametrize("engine", ["single", "batch"])
@pytest.mark.parametrize("precision,canonical", [("fp32_strict", False), ("fp32", True),
                                                 ("bf16", True)])
def test_engines_pass_raw_signs_only_in_strict(params, example, mds_spy, engine, precision,
                                               canonical):
    """The spy of JAX tests/test_eigh_signs.py:139-175, in both engines:
    fp32_strict asks for raw signs, the other engines for canonical ones."""
    if engine == "single":
        fold.Folder(params, device="cpu", precision=precision).fold(
            example, iterations=1, minsteps=1)
    else:
        bf = stream.BatchFolder(params, device="cpu", batch_size=2, precision=precision)
        assert all(r is not None for r in bf.fold_many(
            [stream.Target(example), stream.Target(example[:20])], iterations=1, minsteps=1))
        bf.close()
    assert len(mds_spy) == 2 and all(s is canonical for s in mds_spy), mds_spy


# ---------------------------------------------------------------- the strict fold

def test_strict_fold_matches_jax(tree, params, example, monkeypatch):
    """The whole fp32_strict fold against JAX ``Folder(precision=
    "fp32_strict")`` at ``-n 0 -m 5``: the initial pass is the one MDS call
    that runs (the recycle loop's body is traced, not run). The two CPU
    LAPACKs may give other raw signs, so JAX's MDS columns are aligned to
    the port's recorded ones by the sign of their dot product (a
    like-for-like comparison); the number of columns flipped is printed."""
    nseqs, nres = example.shape
    recorded = []
    orig = gruresnet.mds_coords

    def record(dm, nr, n_dims=8, canonical_signs=True, **kw):
        out = orig(dm, nr, n_dims, canonical_signs=canonical_signs, **kw)
        recorded.append((canonical_signs, out[0].numpy().copy()))
        return out

    monkeypatch.setattr(gruresnet, "mds_coords", record)
    folder = fold.Folder(params, device="cpu", precision="fp32_strict")
    assert folder.dca_method == "lu"
    ours_c, ours_f = folder.fold(example, iterations=0, minsteps=5)
    assert [c for c, _ in recorded] == [False]
    port_mds = jnp.asarray(recorded[0][1])

    flips = []
    jax_orig = jax_gruresnet.mds_coords

    def aligned(dm, nres=None, n_dims=8, canonical_signs=True, **kw):
        assert canonical_signs is False
        out = jax_orig(dm, nres, n_dims, canonical_signs=canonical_signs, **kw)
        sign = jnp.where(jnp.sum(out * port_mds, axis=0) < 0, -1.0, 1.0)
        jax.debug.callback(lambda s: flips.append(int((np.asarray(s) < 0).sum())), sign)
        return out * sign

    monkeypatch.setattr(jax_gruresnet, "mds_coords", aligned)
    jax.clear_caches()  # the fold must be traced with the aligned MDS
    ref_c, ref_f = jax_fold.Folder(tree, precision="fp32_strict").fold(
        example, iterations=0, minsteps=5)
    assert len(flips) == 1
    print(f"\nfp32_strict vs JAX: aligned {flips[0]} of 8 MDS columns by sign; "
          f"conf {np.abs(ours_f - ref_f).max():.2e}, "
          f"CA {np.abs(ours_c[:, 1] - ref_c[:, 1]).max():.2e} A")
    np.testing.assert_allclose(ours_f, ref_f, atol=CONF_TOL)
    np.testing.assert_allclose(ours_c[:, 1], ref_c[:, 1], atol=CA_TOL)


@pytest.mark.parametrize("precision", ["fp32", "fp32_strict"])
def test_exact_shape_matches_bucketed(params, example, precision):
    """``use_buckets=False`` folds at 30 x 37 and agrees with the bucketed
    (32 x 40) fold on the valid region (tests/test_engine.py:55-62)."""
    exact = fold.Folder(params, device="cpu", precision=precision, use_buckets=False)
    padded = fold.Folder(params, device="cpu", precision=precision)
    shapes = []
    orig = gruresnet.forward_inference

    def spy(p, alnmat, *a, **kw):
        shapes.append(tuple(alnmat.shape[1:]))
        return orig(p, alnmat, *a, **kw)

    gruresnet.forward_inference = spy
    try:
        c1, f1 = exact.fold(example, iterations=1, minsteps=5)
        c2, f2 = padded.fold(example, iterations=1, minsteps=5)
    finally:
        gruresnet.forward_inference = orig
    assert shapes == [(30, 37), (32, 40)]
    np.testing.assert_allclose(f1, f2, atol=EXACT_CONF_TOL)
    np.testing.assert_allclose(c1, c2, atol=EXACT_COORD_TOL)


def test_exact_shape_matches_jax(tree, params, example):
    """The exact-shape fold against JAX's ``Folder(use_buckets=False)``."""
    ours_c, ours_f = fold.Folder(params, device="cpu", use_buckets=False).fold(
        example, iterations=1, minsteps=5)
    ref_c, ref_f = jax_fold.Folder(tree, use_buckets=False).fold(example, iterations=1,
                                                                 minsteps=5)
    np.testing.assert_allclose(ours_f, ref_f, atol=CONF_TOL)
    np.testing.assert_allclose(ours_c[:, 1], ref_c[:, 1], atol=CA_TOL)


def test_aln_to_coords_passes_the_config(params, monkeypatch):
    seen = {}
    orig = fold.Folder.__init__

    def init(self, *a, **kw):
        seen.update(kw)
        orig(self, *a, **kw)

    monkeypatch.setattr(fold.Folder, "__init__", init)
    cfg = FoldConfig(precision="fp32_strict", dca_method="cholesky", use_buckets=False)
    coords, confs = fold.aln_to_coords(EXAMPLE_ALN, device="cpu", params=params, iterations=0,
                                       minsteps=0, config=cfg)
    assert coords.shape == (82, 5, 3) and np.isfinite(coords).all()
    assert seen == {"device": torch.device("cpu"), "precision": "fp32_strict",
                    "dca_method": "cholesky", "use_buckets": False}


def test_strict_batch_matches_single(params):
    """The batch engine in fp32_strict (LU, raw signs) against the single
    strict fold on tests/test_torch_stream.py's targets and bounds, with the
    same settings on its held Folder, which folds requeued targets."""
    bf = stream.BatchFolder(params, device="cpu", batch_size=2, precision="fp32_strict")
    assert (bf.folder.precision, bf.folder.dca_method) == ("fp32_strict", "lu")
    rng = np.random.default_rng(0)
    targets = [rng.integers(0, 22, s).astype(np.uint8) for s in ((8, 20), (12, 25))]
    results = bf.fold_many([stream.Target(t) for t in targets], iterations=1, minsteps=3)
    bf.close()
    for t, (cb, fb) in zip(targets, results):
        c1, f1 = bf.folder.fold(t, iterations=1, minsteps=3)
        np.testing.assert_allclose(fb, f1, atol=1e-4)
        np.testing.assert_allclose(cb, c1, atol=1e-2)
    explicit = stream.BatchFolder(params, device="cpu", precision="fp32_strict",
                                  dca_method="cholesky")
    assert explicit.folder.dca_method == "cholesky"
    explicit.close()


# ---------------------------------------------------------------- CLI and service

@pytest.fixture(scope="module")
def toy_npz(tree, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("strict") / "toy.npz")
    save_params(path, tree)
    return path


def test_cli_strict_fold_writes_pdb(toy_npz, capsys):
    run_dmpfold(["-i", EXAMPLE_ALN, "-d", "cpu", "-w", toy_npz, "-n", "0", "-m", "2",
                 "--precision", "fp32_strict", "--dca-method", "lu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("REMARK  CONF:") and lines[-1] == "END"
    assert sum(line.startswith("ATOM") for line in lines) == 406


@pytest.mark.parametrize("argv,expect", [
    ([], ("fp32", "auto")),
    (["--precision", "fp32_strict"], ("fp32_strict", "auto")),
    (["--precision", "fp32_strict", "--dca-method", "cholesky"], ("fp32_strict", "cholesky")),
    (["--dca-method", "lu"], ("fp32", "lu")),
])
def test_cli_batch_mode_carries_precision_and_dca_method(toy_npz, tmp_path, monkeypatch,
                                                         argv, expect):
    seen = []
    orig = stream.BatchFolder

    def recording(*a, **kw):
        seen.append((kw["precision"], kw["dca_method"]))
        return orig(*a, **kw)

    monkeypatch.setattr(stream, "BatchFolder", recording)
    a = tmp_path / "a.aln"
    a.write_text("ARNDCQEGHILK\nARNDCQEGHILR\n")
    run_dmpfold(["-i", str(a), "-o", str(tmp_path / "out"), "-d", "cpu", "-w", toy_npz,
                 "-n", "0", "-m", "1"] + argv)
    assert seen == [expect]
    assert (tmp_path / "out" / "a.pdb").read_text().endswith("END\n")


def test_cli_refuses_unknown_dca_method(toy_npz):
    with pytest.raises(SystemExit):
        run_dmpfold(["-i", EXAMPLE_ALN, "-d", "cpu", "-w", toy_npz, "--dca-method", "qr"])


@pytest.mark.parametrize("method", ["schur", "blocked"])
def test_memory_bounded_dca_methods_fold(toy_npz, params, method, capsys):
    """``--dca-method schur|blocked`` folds PF10963 through the CLI (a held
    ``Folder``), and the batch engine folds two targets with it."""
    run_dmpfold(["-i", EXAMPLE_ALN, "-d", "cpu", "-w", toy_npz, "-n", "0", "-m", "2",
                 "--dca-method", method])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("REMARK  CONF:") and lines[-1] == "END"
    assert sum(line.startswith("ATOM") for line in lines) == 406
    bf = stream.BatchFolder(params, device="cpu", batch_size=2, dca_method=method)
    try:
        assert bf.folder.dca_method == method
        rng = np.random.default_rng(1)
        targets = [stream.Target(rng.integers(0, 22, s).astype(np.uint8))
                   for s in ((8, 20), (12, 25))]
        for coords, confs in bf.fold_many(targets, iterations=0, minsteps=1):
            assert np.isfinite(coords).all() and np.isfinite(confs).all()
    finally:
        bf.close()


def test_service_folds_in_strict(params, monkeypatch):
    """``serve --precision fp32_strict``: the parser takes it, and the
    service folds a request with it through its batch engine."""
    service = serve_mod.FoldService(params, precision="fp32_strict", device="cpu",
                                    batch_window_s=0.0)
    try:
        assert service.folder.precision == "fp32_strict" and service.folder.dca_method == "lu"
        pdb = service.fold_aln_text("ARNDCQEGHILK\nARNDCQEGHILR\n", iterations=0, minsteps=1)
        assert pdb.startswith("REMARK  CONF:") and pdb.rstrip().endswith("END")
    finally:
        service.close()
    # the parser takes the precision and the residue-axis mesh: serve() is
    # handed both (and raises here in place of building the server)
    _capture_serve(monkeypatch)
    with pytest.raises(_Built) as built:
        serve_mod.main(["--precision", "fp32_strict", "--mesh", "2x2", "-d", "cpu"])
    args, kw = built.value.args
    assert args[3] == "fp32_strict" and kw["mesh"].shape == {"data": 2, "seq": 2}


# ---------------------------------------------------------------- on the card

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.gpu
def test_strict_card_checks():
    """Phase strict of chip_smoke.py at a small width (64/16/2 fp32, which
    the card's kernels run): LU features card vs CPU within 1e-4 and LU vs
    Cholesky on the card within 1e-5 (of max |ref|); the raw v8 of a batch
    of 3 the same bits as each map's own call; the strict fold's confidence
    at -n 0 -m 0 within 5e-4 of the CPU's; an exact-shape fold on the card."""
    _require_cuda()
    mat = aln.parse_aln(EXAMPLE_ALN)
    n, l = mat.shape
    (oh, w), _ = _features(mat, n, l)
    lu_cpu = dca.fast_dca(oh, w, n, l, method="lu")
    lu_gpu = dca.fast_dca(oh.cuda(), w.cuda(), n, l, method="lu").cpu()
    chol_gpu = dca.fast_dca(oh.cuda(), w.cuda(), n, l, method="cholesky").cpu()
    scale = lu_cpu.abs().max().item()
    assert (lu_gpu - lu_cpu).abs().max().item() <= 1e-4 * scale
    assert (lu_gpu - chol_gpu).abs().max().item() <= 1e-5 * scale

    nres = [88, 82, 61]
    dm = torch.from_numpy(_distance_maps(88, nres)).cuda()
    nr = torch.tensor(nres, device="cuda")
    batch = geometry.mds_coords(dm, nr, canonical_signs=False)
    for b in range(3):
        assert torch.equal(batch[b], geometry.mds_coords(dm[b:b + 1], nr[b:b + 1],
                                                         canonical_signs=False)[0])

    params = gruresnet.init_params(seed=0, width=64, cwidth=16, num_blocks=2)
    _, f_cpu = fold.Folder(params, device="cpu", precision="fp32_strict").fold(mat, iterations=0, minsteps=0)
    c_gpu, f_gpu = fold.Folder(params, device="cuda", precision="fp32_strict").fold(mat, iterations=0, minsteps=0)
    assert np.abs(f_gpu - f_cpu).max() <= 5e-4
    c_exact, f_exact = fold.Folder(params, device="cuda", precision="fp32_strict",
                                   use_buckets=False).fold(mat, iterations=0, minsteps=0)
    assert np.abs(f_exact - f_gpu).max() <= 5e-4
    assert np.abs(c_exact[:, 1] - c_gpu[:, 1]).max() <= 1e-2
