"""The PyTorch port's engine and CLI on the bundled example, against the JAX
package's golden output and its own fold."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dmpfold2_tpu.engine.fold import Folder as JaxFolder
from dmpfold2_tpu.models.gruresnet import init_params as jax_init_params
from dmpfold2_tpu.utils import assets
from dmpfold2_tpu.weights import save_params
from dmpfold2_tpu_torch import aln_to_coords
from dmpfold2_tpu_torch.cli import run_dmpfold
from dmpfold2_tpu_torch.engine import fold
from dmpfold2_tpu_torch.utils import aln, pdb
from dmpfold2_tpu_torch.weights import params_from_jax

from test_golden import GOLDEN_TOY, _compare_to_golden

EXAMPLE_ALN = assets.example_aln_path()
EXAMPLE_PDB = assets.example_template_path()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "dmpfold2_tpu_torch", "dmpfold2_tpu_torch.cli", "dmpfold2_tpu_torch.config",
    "dmpfold2_tpu_torch.weights", "dmpfold2_tpu_torch.engine.fold",
    "dmpfold2_tpu_torch.engine.buckets", "dmpfold2_tpu_torch.features.msa",
    "dmpfold2_tpu_torch.features.dca", "dmpfold2_tpu_torch.ops.norm",
    "dmpfold2_tpu_torch.models.gru", "dmpfold2_tpu_torch.models.trunk",
    "dmpfold2_tpu_torch.models.geometry", "dmpfold2_tpu_torch.models.gruresnet",
    "dmpfold2_tpu_torch.kernels._build", "dmpfold2_tpu_torch.kernels.vgru",
    "dmpfold2_tpu_torch.kernels.rgru", "dmpfold2_tpu_torch.kernels.refine",
    "dmpfold2_tpu_torch.kernels.conv_block",
    "dmpfold2_tpu_torch.utils.aln", "dmpfold2_tpu_torch.utils.pdb",
    "dmpfold2_tpu_torch.ops.dropout", "dmpfold2_tpu_torch.train.loss",
    "dmpfold2_tpu_torch.train.dataset", "dmpfold2_tpu_torch.train.checkpoint",
    "dmpfold2_tpu_torch.train.step", "dmpfold2_tpu_torch.train.loop",
    "dmpfold2_tpu_torch.utils.obs", "dmpfold2_tpu_torch.parallel.stream",
    "dmpfold2_tpu_torch.serve", "dmpfold2_tpu_torch.score",
    "dmpfold2_tpu_torch.train.evaluate", "dmpfold2_tpu_torch.utils.flops",
    "dmpfold2_tpu_torch.utils.native", "dmpfold2_tpu_torch.utils.assets",
]


@pytest.fixture(scope="module")
def toy_tree():
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), width=32,
                                                    cwidth=16, num_blocks=2))


@pytest.fixture(scope="module")
def toy_npz(toy_tree, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "toy.npz")
    save_params(path, toy_tree)
    return path


def test_golden_pf10963(toy_tree):
    """The port's fold of PF10963 with the golden file's weights (JAX
    init_params(PRNGKey(0), 32, 16, 2), -n 1 -m 10)."""
    alnmat = aln.parse_aln(EXAMPLE_ALN)
    coords, confs = fold.Folder(params_from_jax(toy_tree), device="cpu").fold(
        alnmat, iterations=1, minsteps=10)
    _compare_to_golden(list(pdb.format_pdb(coords, confs, alnmat[0])), GOLDEN_TOY, 0.02)


def test_cli_writes_golden_pdb(toy_npz):
    out = subprocess.run(
        [sys.executable, "-m", "dmpfold2_tpu_torch.cli", "-i", EXAMPLE_ALN, "-d", "cpu",
         "-w", toy_npz, "-n", "1", "-m", "10"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    _compare_to_golden(out.stdout.splitlines(), GOLDEN_TOY, 0.02)


def test_template_auto_fold_matches_jax(toy_tree):
    """A template fold with -n auto: same structure and recycle count as JAX.
    The template is the first 82 CAs of the bundled 3FGX (192 CAs), a real
    trace of the alignment's length."""
    alnmat = aln.parse_aln(EXAMPLE_ALN)[:60]
    template_ca = pdb.parse_template_ca(EXAMPLE_PDB)[:82]
    ours_c, ours_f, ours_n = fold.Folder(params_from_jax(toy_tree), device="cpu").fold_async(
        alnmat, template_ca, iterations="auto", minsteps=10)()
    jax_folder = JaxFolder(toy_tree)
    ref_c, ref_f = jax_folder.fold(alnmat, template_ca, iterations="auto", minsteps=10)
    assert ours_n == jax_folder.last_auto_iterations
    assert 1 <= ours_n <= fold.AUTO_ITERATIONS_CAP
    np.testing.assert_allclose(ours_f, ref_f, atol=2e-4)
    np.testing.assert_allclose(ours_c, ref_c, atol=0.02)


def test_template_length_mismatch_raises(toy_tree):
    with pytest.raises(ValueError, match="lengths must match"):
        fold.Folder(params_from_jax(toy_tree), device="cpu").fold(
            aln.parse_aln(EXAMPLE_ALN)[:, :40], pdb.parse_template_ca(EXAMPLE_PDB))


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'dmpfold2_tpu' or m.startswith('dmpfold2_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_folder_defaults_to_cuda(monkeypatch, toy_tree):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fold.Folder(params_from_jax(toy_tree))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aln_to_coords(EXAMPLE_ALN, params=params_from_jax(toy_tree))


def test_no_weights_raises_without_download():
    with pytest.raises(FileNotFoundError, match="does not download"):
        aln_to_coords(EXAMPLE_ALN, device="cpu")


def test_cli_bf16_fold_writes_pdb(toy_npz, capsys):
    """``--precision bf16`` folds (the kernels' plain versions on the CPU)."""
    run_dmpfold(["-i", EXAMPLE_ALN, "-d", "cpu", "-w", toy_npz, "-n", "1", "-m", "10",
                 "--precision", "bf16"])
    lines = capsys.readouterr().out.splitlines()
    atoms = [line for line in lines if line.startswith("ATOM")]
    assert lines[0].startswith("REMARK  CONF:") and lines[-1] == "END"
    assert len(atoms) == 406  # PF10963: 82 residues x 5 atoms, less glycine CBs
    xyz = np.array([[float(a[30:38]), float(a[38:46]), float(a[46:54])] for a in atoms])
    assert np.isfinite(xyz).all()


# ---------------------------------------------------------------- batch mode

# three seeded alignments: two in bucket (16, 32), one in (16, 40)
BATCH_SHAPES = {"a": (12, 20), "b": (9, 25), "c": (10, 40)}


@pytest.fixture(scope="module")
def batch_inputs(toy_tree, tmp_path_factory):
    """The toy weights with ``coord_fc`` scaled by 256 (protein-like CA
    spacing, as tests/test_torch_stream.py uses) and three alignment files."""
    root = tmp_path_factory.mktemp("batch")
    tree = dict(toy_tree, coord_fc=toy_tree["coord_fc"] * np.float32(256.0))
    weights = str(root / "scaled.npz")
    save_params(weights, tree)
    rng = np.random.default_rng(5)
    paths = []
    for stem, shape in BATCH_SHAPES.items():
        rows = rng.integers(0, 20, shape)
        path = root / f"{stem}.aln"
        path.write_text("".join("".join(aln.AA_ORDER[c] for c in row) + "\n" for row in rows))
        paths.append(str(path))
    return weights, paths


def _pdb_atoms(lines):
    atoms = [line for line in lines if line.startswith("ATOM")]
    xyz = np.array([[float(a[30:38]), float(a[38:46]), float(a[46:54])] for a in atoms])
    return xyz, np.array([float(a[60:66]) for a in atoms])


def test_cli_batch_writes_one_pdb_per_input(batch_inputs, tmp_path, capsys):
    """``-o`` with three inputs at --batch-size 2: one PDB each, equal to the
    single-target CLI's within tests/test_torch_stream.py's batch-vs-single
    bounds (confidence 1e-4, coordinates 1e-2 A) plus the PDB's rounding."""
    weights, paths = batch_inputs
    common = ["-d", "cpu", "-w", weights, "-n", "1", "-m", "10"]
    run_dmpfold(["-i", *paths, "-o", str(tmp_path), "--batch-size", "2"] + common)
    assert "folded 3/3 targets" in capsys.readouterr().err
    for path, stem in zip(paths, BATCH_SHAPES):
        run_dmpfold(["-i", path] + common)
        single = capsys.readouterr().out.splitlines()
        batch = (tmp_path / f"{stem}.pdb").read_text().splitlines()
        assert batch[0].startswith("REMARK  CONF:") and batch[-1] == "END"
        (bx, bb), (sx, sb) = _pdb_atoms(batch), _pdb_atoms(single)
        assert bx.shape == sx.shape
        np.testing.assert_allclose(bx, sx, atol=1e-2 + 1e-3)
        np.testing.assert_allclose(bb, sb, atol=1e-4 + 1e-2)  # B-factor: 2 decimals


@pytest.mark.parametrize("case,match", [
    ("duplicate stems", "duplicate output stems"),
    ("template count", "templates for 3 inputs"),
    ("template length", "lengths must match"),
    ("auto", "single-target only"),
])
def test_cli_batch_input_errors(batch_inputs, tmp_path, capsys, case, match):
    weights, paths = batch_inputs
    argv = ["-i", *paths, "-o", str(tmp_path / "out"), "-d", "cpu", "-w", weights]
    if case == "duplicate stems":
        other = tmp_path / "a.aln"
        other.write_text(open(paths[0]).read())
        argv[1:4] = [paths[0], str(other), paths[1]]
    elif case == "template count":
        argv += ["-t", EXAMPLE_PDB, "-"]
    elif case == "template length":
        argv += ["-t", EXAMPLE_PDB, "-", "-"]
    else:
        argv += ["-n", "auto"]
    with pytest.raises(SystemExit) as exc:
        run_dmpfold(argv)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_cli_batch_failed_target_exits_1(batch_inputs, tmp_path, capsys, monkeypatch):
    from dmpfold2_tpu_torch.parallel import stream

    def fail(*args, **kwargs):
        raise RuntimeError("injected failure")

    weights, paths = batch_inputs
    real_single = stream.BatchFolder._fold_single

    def fail_b(self, target, *a):
        if target.alnmat.shape == BATCH_SHAPES["b"]:
            raise RuntimeError("injected single failure")
        return real_single(self, target, *a)

    monkeypatch.setattr(stream, "_fold_batch", fail)
    monkeypatch.setattr(stream.BatchFolder, "_fold_single", fail_b)
    with pytest.raises(SystemExit) as exc:
        run_dmpfold(["-i", *paths, "-o", str(tmp_path), "-d", "cpu", "-w", weights, "-n", "0",
                     "-m", "0"])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "folded 2/3 targets" in err and f"FAILED: {paths[1]}" in err
    assert sorted(os.listdir(tmp_path)) == ["a.pdb", "c.pdb"]


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=300)


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = _run_smoke(str(tmp_path), str(script))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
