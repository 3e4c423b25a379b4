"""The PyTorch port's scoring (``score.py``), validation evaluation
(``train/evaluate.py``) and host utilities (``utils/flops.py``,
``utils/native.py``, ``utils/assets.py``) against the JAX package's on the
CPU. The ``gpu`` test runs evaluation on a card at a small width."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dmpfold2_tpu import score as jax_score
from dmpfold2_tpu.models.gruresnet import init_params as jax_init_params
from dmpfold2_tpu.train import evaluate as jax_evaluate
from dmpfold2_tpu.utils import aln as jax_aln
from dmpfold2_tpu.utils import assets as jax_assets
from dmpfold2_tpu.utils import flops as jax_flops
from dmpfold2_tpu.weights import load_params, save_params
from dmpfold2_tpu_torch import score
from dmpfold2_tpu_torch.parallel import stream
from dmpfold2_tpu_torch.train import dataset, evaluate, loop
from dmpfold2_tpu_torch.utils import aln, assets, flops, native
from dmpfold2_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_PDB = assets.example_template_path()


def _random_chain(n, seed=0):
    """tests/test_score.py's CA walk with 3.8 A steps."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    return np.cumsum(steps * 3.8, axis=0).astype(np.float64)


def _rotated(ca):
    theta = 1.1
    rot = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1.0]])
    return ca @ rot.T + np.array([5.0, -3.0, 12.0])


def _half_scrambled():
    ca = _random_chain(100, seed=3)
    decoy = ca.copy()
    decoy[50:] = _random_chain(50, seed=5) + 40.0
    return decoy, ca


def _noisy(sigma, seed):
    ca = _random_chain(80, seed=1)
    return ca + sigma * np.random.default_rng(seed).normal(size=ca.shape), ca


# tests/test_score.py's cases: (model, native)
SCORE_CASES = {
    "identity": lambda: (_random_chain(60), _random_chain(60)),
    "rigid_motion": lambda: (_rotated(_random_chain(60)), _random_chain(60)),
    "small_noise": lambda: _noisy(0.5, 2),
    "large_noise": lambda: _noisy(5.0, 2),
    "half_scrambled": _half_scrambled,
    "short_chain": lambda: (_random_chain(12, seed=8), _random_chain(12, seed=9)),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_tm_score_equals_jax(case):
    model, native_ca = SCORE_CASES[case]()
    assert score.tm_score(model, native_ca) == jax_score.tm_score(model, native_ca)


def test_tm_d0_and_shape_checks_equal_jax():
    for n in (3, 10, 21, 22, 50, 200, 1000):
        assert score.tm_d0(n) == jax_score.tm_d0(n)
    ca = _random_chain(20)
    with pytest.raises(ValueError, match="share"):
        score.tm_score(ca, ca[:10])
    with pytest.raises(ValueError, match="at least 3"):
        score.tm_score(ca[:2], ca[:2])


def _run_score(*paths):
    return subprocess.run([sys.executable, "-m", "dmpfold2_tpu_torch.score", *paths],
                          capture_output=True, text=True, cwd=REPO, timeout=120)


def test_score_cli_round_trip(tmp_path):
    res = _run_score(EXAMPLE_PDB, EXAMPLE_PDB)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == {"tm": 1.0, "rmsd": 0.0, "nres": 192}
    short = tmp_path / "short.pdb"
    short.write_text("".join([line for line in open(EXAMPLE_PDB)
                              if line.startswith("ATOM")][:40]))
    res = _run_score(str(short), EXAMPLE_PDB)
    assert res.returncode == 1 and "differ" in res.stderr


# ---------------------------------------------------------------- evaluate

ATOM_OFFSETS = np.array([[-1.2, 0.6, 0.3], [1.3, 0.5, -0.2], [1.9, 1.4, 0.4],
                         [-0.4, -1.3, 0.9]], np.float32)


def write_eval_data(root, shapes, seed=0):
    """Seeded validation targets: ``tdb/t<i>.tdb`` (a 3.8 A CA walk, the
    other atoms at fixed offsets), ``aln/t<i>.aln`` (headerless rows of the
    given (nseqs, nres)) and ``clusters.lst`` with one cluster each."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "tdb"))
    os.makedirs(os.path.join(root, "aln"))
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV-"))
    for i, (nseqs, nres) in enumerate(shapes):
        ca = _random_chain(nres, seed=100 + i).astype(np.float32)
        atoms = np.concatenate([ca[:, None] + ATOM_OFFSETS[None, :1], ca[:, None],
                                ca[:, None] + ATOM_OFFSETS[None, 1:]], axis=1)
        with open(os.path.join(root, "tdb", f"t{i}.tdb"), "w") as fh:
            fh.write("# seeded target\n")
            for res in atoms:
                fh.write(" " * 5 + "A" + " " * 33
                         + "".join(f"{v:9.3f}" for v in res.ravel()) + "\n")
        rows = ["".join(r) for r in letters[rng.integers(0, 21, (nseqs, nres))]]
        with open(os.path.join(root, "aln", f"t{i}.aln"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "clusters.lst"), "w") as fh:
        fh.write("".join(f"t{i}\n" for i in range(len(shapes))))


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    write_eval_data(root, [(10, 20), (12, 25), (9, 37)])
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), width=32,
                                                    cwidth=16, num_blocks=2))
    tree["coord_fc"] = tree["coord_fc"] * np.float32(256.0)
    weights = os.path.join(root, "toy.npz")
    save_params(weights, tree)
    return root, weights


def test_evaluate_matches_jax(eval_setup, capsys):
    """The port's evaluate CLI on the CPU against JAX ``evaluate`` on the
    same weights (an .npz) and targets: the same summary, TM within 1e-3."""
    root, weights = eval_setup
    kw = dict(iterations=1, minsteps=3, precision="fp32", batch_size=2)
    _, val_list = jax_evaluate.load_cluster_list(os.path.join(root, "clusters.lst"))
    ref, ref_records = jax_evaluate.evaluate(load_params(weights), val_list, data_dir=root,
                                             verbose=False, **kw)
    capsys.readouterr()
    evaluate.main(["--data-dir", root, "--clusters", "clusters.lst", "--weights", weights,
                   "-d", "cpu", "--iterations", "1", "--minsteps", "3", "--precision", "fp32",
                   "--batch-size", "2"])
    out = capsys.readouterr()
    ours = json.loads(out.out.strip().splitlines()[-1])
    records = [json.loads(line) for line in out.err.splitlines() if line.startswith("{")]
    assert set(ours) == set(ref)
    assert (ours["targets"], ours["skipped"]) == (ref["targets"], ref["skipped"]) == (3, 0)
    for key in ("tm_mean", "tm_median"):
        assert abs(ours[key] - ref[key]) <= 1e-3, (key, ours, ref)
    assert abs(ours["rmsd_mean"] - ref["rmsd_mean"]) <= 1e-2
    assert [r["index"] for r in records] == [r["index"] for r in ref_records] == [0, 1, 2]
    for r, q in zip(records, ref_records):
        assert (r["nres"], r["nseqs"]) == (q["nres"], q["nseqs"])
        assert abs(r["tm"] - q["tm"]) <= 1e-3


def test_evaluate_records_are_the_scores_of_the_folds(eval_setup, monkeypatch):
    """Every record is ``score.tm_score`` of the returned CA trace against
    the tdb's, in the default bf16 engine; a failed fold is skipped and
    counted, and targets/s counts every target."""
    root, weights = eval_setup
    _, val_list = dataset.load_cluster_list(os.path.join(root, "clusters.lst"))
    folds = []
    real = stream.BatchFolder.fold_many

    def recording(self, targets, *a, **kw):
        results = real(self, targets, *a, **kw)
        folds.extend(results)
        return results[:-1] + [None]

    monkeypatch.setattr(stream.BatchFolder, "fold_many", recording)
    summary, records = evaluate.evaluate(params_from_jax(load_params(weights)), val_list,
                                         data_dir=root, iterations=0, minsteps=2, batch_size=2,
                                         verbose=False, device="cpu")
    assert (summary["targets"], summary["skipped"]) == (2, 1)
    ds = dataset.DMPDataset(val_list, root, augment=False)
    for rec in records:
        expect = score.tm_score(np.asarray(folds[rec["index"]][0][:, 1], np.float64),
                                np.asarray(ds[rec["index"]].targets[:, 1], np.float64))
        assert (rec["tm"], rec["rmsd"]) == (expect["tm"], expect["rmsd"])
    assert summary["targets_per_s"] == pytest.approx(3 / summary["seconds"], rel=0.05)


# ---------------------------------------------------------------- flops

@pytest.mark.parametrize("shape", [(256, 88, 10, 100, 512, 128, 16), (64, 40, 3, 10, 32, 16, 2),
                                   (1024, 352, 0, 0, 512, 128, 16)])
def test_flops_equal_jax(shape):
    nseqs, nres, nloops, minsteps, width, cwidth, blocks = shape
    kw = dict(width=width, cwidth=cwidth, num_blocks=blocks)
    assert flops.fold_flops(nseqs, nres, nloops, minsteps, **kw) == \
        jax_flops.fold_flops(nseqs, nres, nloops, minsteps, mds="eigh", **kw)
    assert flops.trunk_pass_flops(nres, width, cwidth, blocks) == \
        jax_flops.trunk_pass_flops(nres, width, cwidth, blocks)
    assert flops.mds_flops(nres) == jax_flops.mds_flops(nres, "eigh")


def test_mfu_takes_the_named_peak():
    assert flops.mfu(67e12, 1.0, flops.PEAK_FP32_FLOPS) == 1.0
    assert flops.mfu(989e12, 2.0, flops.PEAK_BF16_TENSOR) == 0.5
    with pytest.raises(TypeError):
        flops.mfu(1.0, 1.0)


# ---------------------------------------------------------------- native parsers

@pytest.fixture
def native_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native parsers are not built")
    assert native.available()
    assert str(native._lib_path()).startswith(os.path.join(REPO, "build", "native"))


def _both(monkeypatch, parse, *args):
    """parse(*args) through the native and the pure-Python path: ("ok",
    result) or ("err", None) each."""
    out = []
    for use_native in (True, False):
        monkeypatch.setattr(native, "available", lambda v=use_native: v)
        try:
            out.append(("ok", parse(*args)))
        except ValueError:
            out.append(("err", None))
    monkeypatch.undo()
    return out


def test_native_aln_fuzz_matches_python(native_lib, tmp_path, monkeypatch):
    """tests/test_native_io.py's aln fuzz inputs: the native and the
    pure-Python paths of ``utils/aln.parse_aln`` take and reject the same
    inputs, with the same bytes, which are JAX's."""
    rng = np.random.default_rng(17)
    alphabet = list("ARNDCQEGHILKMFPSTWYVBJOUXZ-.")
    n_ok = 0
    for trial in range(60):
        n_rows = int(rng.integers(1, 12))
        width = int(rng.integers(1, 30))
        lines = []
        for _ in range(n_rows):
            if rng.random() < 0.15:
                lines.append(">header " + "x" * int(rng.integers(0, 5)))
                continue
            if rng.random() < 0.1:
                lines.append("")
                continue
            row_w = width + (int(rng.integers(1, 4)) if rng.random() < 0.1 else 0)
            row = "".join(rng.choice(alphabet) for _ in range(row_w))
            if rng.random() < 0.2:
                row += rng.choice([" ", "\t", "\r", " \t "])
            lines.append(row)
        text = "\n".join(lines) + ("\n" if rng.random() < 0.8 else "")
        p = tmp_path / f"f{trial}.aln"
        p.write_text(text)
        cap = int(rng.integers(1, aln.MAX_SEQS))
        (sn, mn), (sp, mp) = _both(monkeypatch, aln.parse_aln, str(p), cap)
        assert sn == sp, f"trial {trial}: native={sn} python={sp}\n{text!r}"
        if sn == "ok":
            n_ok += 1
            assert mn.dtype == mp.dtype == np.uint8
            assert mn.tobytes() == mp.tobytes() and mn.shape == mp.shape
            assert mn.tobytes() == jax_aln.parse_aln(str(p), max_seqs=cap).tobytes()
    assert n_ok > 10
    (sn, mn), (sp, mp) = _both(monkeypatch, aln.parse_aln, jax_assets.example_aln_path())
    assert sn == sp == "ok" and mn.shape == (252, 82) and mn.tobytes() == mp.tobytes()


def test_native_tdb_fuzz_matches_python(native_lib, tmp_path, monkeypatch):
    """tests/test_native_io.py's tdb fuzz inputs (comments, blank lines,
    varied magnitudes) through ``train/dataset.parse_tdb``'s two paths."""
    rng = np.random.default_rng(23)
    letters = "ARNDCQEGHILKMFPSTWYVX"
    for trial in range(25):
        lines = []
        for _ in range(int(rng.integers(1, 12))):
            if rng.random() < 0.2:
                lines.append("# comment")
            if rng.random() < 0.1:
                lines.append("")
            row = list(" " * 39)
            row[5] = letters[int(rng.integers(0, len(letters)))]
            vals = rng.normal(size=15) * (10.0 ** float(rng.integers(-2, 3)))
            lines.append("".join(row) + "".join(f"{v:9.3f}" for v in vals))
        p = tmp_path / f"t{trial}.tdb"
        p.write_text("\n".join(lines) + "\n")
        (sn, (nc, nx)), (sp, (pc, px)) = _both(monkeypatch, dataset.parse_tdb, str(p))
        assert sn == sp == "ok"
        assert nc.tobytes() == pc.tobytes() and nx.tobytes() == px.tobytes(), trial


def test_native_falls_back_without_a_compiler(monkeypatch, tmp_path):
    """No g++: ``available()`` is false and the parsers run in Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert native.encode_aln_bytes(b"AR\nAR\n") is None
    p = tmp_path / "x.aln"
    p.write_text(">h\nARN\nAR-\n")
    assert aln.parse_aln(str(p)).tolist() == [[0, 1, 2], [0, 1, 21]]


# ---------------------------------------------------------------- assets

def test_assets_resolve_to_the_repository_files():
    assert assets.example_aln_path() == jax_assets.example_aln_path()
    assert assets.example_template_path() == jax_assets.example_template_path()
    assert assets.cluster_list_path() == jax_assets.cluster_list_path()
    for path in (assets.example_aln_path(), assets.example_template_path(),
                 assets.cluster_list_path()):
        assert os.path.isfile(path)


def test_training_loop_falls_back_to_the_cluster_list(tmp_path, monkeypatch):
    """Without ``clusters`` in the data directory the loop reads the
    repository's list (JAX train/loop.py:144-153)."""
    read = []

    def stop(path, *a, **kw):
        read.append(path)
        raise RuntimeError("stop")

    monkeypatch.setattr(loop, "load_cluster_list", stop)
    with pytest.raises(RuntimeError, match="stop"):
        loop.train(str(tmp_path), device="cpu")
    assert read == [assets.cluster_list_path()]
    (tmp_path / "train_clust.lst").write_text("a\n")
    with pytest.raises(RuntimeError, match="stop"):
        loop.train(str(tmp_path), device="cpu")
    assert read[1] == os.path.join(str(tmp_path), "train_clust.lst")


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_evaluate_on_card(tmp_path):
    """Phase evaluate of chip_smoke.py at a small width (64/16/2, which the
    fp32 kernels run): every target folded on the card in fp32_strict, each
    record the score of its fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    write_eval_data(str(tmp_path), [(10, 20), (12, 25), (9, 37)])
    _, val_list = dataset.load_cluster_list(str(tmp_path / "clusters.lst"))
    summary, records = evaluate.evaluate(init_params(seed=0, width=64, cwidth=16, num_blocks=2),
                                         val_list, data_dir=str(tmp_path), iterations=1,
                                         minsteps=3, precision="fp32_strict", batch_size=2,
                                         verbose=False)
    assert (summary["targets"], summary["skipped"]) == (3, 0)
    assert all(0.0 <= r["tm"] <= 1.0 and np.isfinite(r["rmsd"]) for r in records)
