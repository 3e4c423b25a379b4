"""Training dataset: tdb/aln parsing, augmentation, bucketing.

Counterpart of ``dmpfold2_tpu/train/dataset.py`` (reference train.py:37-56
cluster list, 96-198 DMPDataset), kept as this package's own copy:

  * tdb files: one residue per non-comment line, residue letter at column 5,
    five atoms (N, CA, C, O, CB) of 9-char floats from column 39
    (train.py:117-124), through the native parser (``utils/native.py``)
    where it built, else in pure Python, with the same arrays.
  * augmentation: random cluster member, terminal-gap crop from a random
    row, random crop to ``crop_len``, log-uniform row subsampling under the
    ``max_aln_size`` area budget (train.py:138-162), the same draws from the
    same ``random.Random``.
  * DCA runs on the device inside the train step; the host only parses,
    augments and pads to a bucket.

Validation takes the deterministic path: first member, row/length caps
(train.py:163-170).
"""

from __future__ import annotations

import math
import os
import random
from dataclasses import dataclass

import numpy as np

from ..config import TrainConfig
from ..engine.buckets import bucket_shape
from ..utils.aln import encode_rows

MAXALNSZ = TrainConfig.max_aln_size
DEF_CROPLEN = TrainConfig.crop_len
VALIDATION_CLUSTERS = 300  # reference train.py:49

_AA_NUM = {c: i for i, c in enumerate("ARNDCQEGHILKMFPSTWYV")}
for c in "BJOUXZ":
    _AA_NUM[c] = 20


def load_cluster_list(path: str, validation_clusters: int = VALIDATION_CLUSTERS):
    """train_clust.lst -> (train_list, validation_list) of member-id lists.

    The first 300 non-empty clusters are validation (train.py:37-56); blank
    lines do not count.
    """
    train_list, validation_list = [], []
    with open(path) as fh:
        for line in fh:
            members = line.rstrip().split()
            if not members:
                continue
            (validation_list if len(validation_list) < validation_clusters
             else train_list).append(members)
    return train_list, validation_list


def parse_tdb(path: str):
    """tdb file -> (residue classes (L,) int32, coords (L, 5, 3) float32)."""
    from ..utils import native

    if native.available():
        with open(path, "rb") as fh:
            return native.parse_tdb_bytes(fh.read())
    classes, coords = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            classes.append(_AA_NUM.get(line[5], 21))
            coords.append([[float(line[39 + i * 27 + j * 9: 39 + i * 27 + (j + 1) * 9])
                            for j in range(3)] for i in range(5)])
    return np.asarray(classes, np.int32), np.asarray(coords, np.float32)


def parse_aln_rows(path: str) -> np.ndarray:
    """Training-format alignment: raw rows, no FASTA headers, no row cap
    (train.py:130-134). Header rows would encode to garbage classes, so they
    raise."""
    with open(path) as fh:
        rows = [r for r in fh.read().splitlines() if r]
    if any(r.startswith(">") for r in rows):
        raise ValueError(f"{path}: training alignments must be headerless (reference "
                         "train.py:130 format); strip FASTA headers or convert with "
                         "utils.aln.parse_aln")
    return encode_rows(rows)


@dataclass
class Sample:
    alnmat: np.ndarray   # (N, L) uint8, unpadded
    targets: np.ndarray  # (L, 5, 3)


class DMPDataset:
    """Cluster-based dataset with the reference's augmentation."""

    def __init__(self, sample_list, data_dir: str = ".", augment: bool = True,
                 rng: random.Random | None = None, crop_len: int = DEF_CROPLEN,
                 max_aln_size: int = MAXALNSZ):
        self.sample_list = sample_list
        self.data_dir = data_dir
        self.augment = augment
        self.rng = rng or random.Random()
        self.crop_len = crop_len
        self.max_aln_size = max_aln_size
        # file loads: a data-parallel rank loads only its own batch slots
        self.reads = 0

    def __len__(self) -> int:
        return len(self.sample_list)

    def __getitem__(self, idx: int) -> Sample:
        return self.get(idx)

    def get(self, idx: int, rng: random.Random | None = None) -> Sample:
        """Load (and augment) one sample; ``rng`` overrides the dataset's
        sequential RNG for this sample's draws (the loop derives one per
        epoch and index, ``loop._sample_rng``)."""
        rng = rng or self.rng
        members = self.sample_list[idx]
        targid = rng.choice(members) if self.augment else members[0]
        self.reads += 1
        _, targets = parse_tdb(os.path.join(self.data_dir, "tdb", targid + ".tdb"))
        alnmat = parse_aln_rows(os.path.join(self.data_dir, "aln", targid + ".aln"))
        if self.augment:
            alnmat, targets = self._augment(alnmat, targets, rng)
        else:
            alnmat = alnmat[:1000]
            if alnmat.shape[1] > self.crop_len:
                alnmat = alnmat[:, :self.crop_len]
                targets = targets[:self.crop_len]
        return Sample(alnmat, targets)

    def _augment(self, alnmat: np.ndarray, targets: np.ndarray, rng: random.Random):
        nseqs, length = alnmat.shape

        # crop terminal gaps of a random row (train.py:139-144)
        row = rng.randint(0, nseqs - 1)
        aalocs = np.where(alnmat[row] < 21)[0]
        if len(aalocs):
            alnmat = alnmat[:, aalocs[0]:aalocs[-1] + 1]
            targets = targets[aalocs[0]:aalocs[-1] + 1]
            length = alnmat.shape[1]

        # random crop to crop_len (train.py:146-151)
        if length > self.crop_len:
            lcut = rng.randint(0, length - self.crop_len)
            alnmat = alnmat[:, lcut:lcut + self.crop_len]
            targets = targets[lcut:lcut + self.crop_len]
            length = self.crop_len

        # log-uniform row subsample under the area budget (train.py:152-162)
        maxseqs = min(1000, self.max_aln_size // length)
        if nseqs > 1:
            p = (1 + int(math.exp(rng.random() * math.log(nseqs - 1)))) / nseqs
            rowmask = np.asarray([rng.random() < p for _ in range(nseqs)], bool)
            rowmask[0] = True
            alnmat = alnmat[rowmask][:maxseqs]
        return alnmat, targets


def local_bucket(samples: list) -> tuple[int, int]:
    """The common bucket of the samples."""
    n_pad = l_pad = 0
    for s in samples:
        n, l = bucket_shape(*s.alnmat.shape)
        n_pad, l_pad = max(n_pad, n), max(l_pad, l)
    return n_pad, l_pad


def pad_to_bucket(samples: list, bucket: tuple[int, int] | None = None):
    """Samples padded to a common bucket -> (alnmat (B, N, L) int32, targets
    (B, L, 5, 3) float32, nseqs (B,) int32, nres (B,) int32)."""
    n_pad, l_pad = bucket if bucket is not None else local_bucket(samples)
    b = len(samples)
    alnmat = np.zeros((b, n_pad, l_pad), np.int32)
    targets = np.zeros((b, l_pad, 5, 3), np.float32)
    nseqs = np.zeros((b,), np.int32)
    nres = np.zeros((b,), np.int32)
    for i, s in enumerate(samples):
        n, l = s.alnmat.shape
        alnmat[i, :n, :l] = s.alnmat
        targets[i, :l] = s.targets
        nseqs[i], nres[i] = n, l
    return alnmat, targets, nseqs, nres
