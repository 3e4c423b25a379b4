"""Host IO of the PyTorch port against the JAX package: alignment parsing,
PDB writing, template CA parsing and shape buckets."""

import os

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

from dmpfold2_tpu.engine import buckets as jax_buckets
from dmpfold2_tpu.utils import aln as jax_aln
from dmpfold2_tpu.utils import assets
from dmpfold2_tpu.utils import pdb as jax_pdb
from dmpfold2_tpu_torch.engine import buckets
from dmpfold2_tpu_torch.utils import aln, pdb

EXAMPLE_ALN = assets.example_aln_path()
EXAMPLE_PDB = assets.example_template_path()


def test_constants_match():
    assert aln.NUM_CLASSES == jax_aln.NUM_CLASSES
    assert aln.GLYCINE == jax_aln.GLYCINE
    assert aln.MAX_SEQS == jax_aln.MAX_SEQS
    assert aln.AA3 == jax_aln.AA3
    assert aln._TRANS == jax_aln._TRANS


def test_parse_aln_identical_on_example():
    ours = aln.parse_aln(EXAMPLE_ALN)
    theirs = jax_aln.parse_aln(EXAMPLE_ALN)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (252, 82)


def test_parse_aln_caps_rows(tmp_path):
    path = tmp_path / "deep.aln"
    path.write_text(">h\n" + "ACDE-\n" * 40)
    np.testing.assert_array_equal(aln.parse_aln(str(path), max_seqs=7),
                                  jax_aln.parse_aln(str(path), max_seqs=7))


def test_parse_a3m_identical(tmp_path):
    path = tmp_path / "x.a3m"
    path.write_text(">q\nACDEFGHIKL\n>s1\nAC-EFaaGHIKL\n\n>s2\nACDxEFGHIKL\n>s3\n.CDEFGHIKX\n")
    ours = aln.parse_aln(str(path))
    np.testing.assert_array_equal(ours, jax_aln.parse_aln(str(path)))
    assert ours.shape == (4, 10)


def test_parse_aln_rejects_lowercase(tmp_path):
    path = tmp_path / "bad.aln"
    path.write_text("ACDEF\nACdEF\n")
    with pytest.raises(ValueError, match="outside the amino-acid alphabet"):
        aln.parse_aln(str(path))


def test_format_pdb_identical_lines():
    rng = np.random.default_rng(0)
    seq = aln.parse_aln(EXAMPLE_ALN)[0]
    coords = (rng.normal(size=(len(seq), 5, 3)) * 30).astype(np.float32)
    confs = rng.uniform(size=len(seq)).astype(np.float32)
    ours = list(pdb.format_pdb(coords, confs, seq))
    assert ours == list(jax_pdb.format_pdb(coords, confs, seq))
    assert sum(line.startswith("ATOM") for line in ours) == 406


def test_parse_template_ca_agrees():
    ours = pdb.parse_template_ca(EXAMPLE_PDB)
    theirs = jax_pdb.parse_template_ca(EXAMPLE_PDB)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("enable", [True, False])
def test_bucket_shape_grid(enable):
    for nseqs in list(range(1, 80, 7)) + [255, 256, 257, 2999, 3000, 3001, 5000]:
        for nres in list(range(1, 140, 3)) + [255, 256, 257, 1023, 1536, 1537, 2000]:
            assert buckets.bucket_shape(nseqs, nres, enable) == \
                jax_buckets.bucket_shape(nseqs, nres, enable), (nseqs, nres)


def test_example_files_exist():
    assert os.path.isfile(EXAMPLE_ALN) and os.path.isfile(EXAMPLE_PDB)
