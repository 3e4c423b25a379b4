"""ctypes bindings for the native alignment and tdb parsers (``native/dmpio.cpp``).

Counterpart of ``dmpfold2_tpu/utils/native.py``. A host parser, not a device
kernel: ``g++`` builds ``native/dmpio.cpp`` at first use into
``build/native/`` beside the package, named by a hash of the source and the
flags (a changed source is rebuilt). Where no compiler exists or the build
fails, :func:`available` is false and the callers (``utils/aln.parse_aln``,
``train/dataset.parse_tdb``) run their pure-Python parsers, which give the
same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parent.parent.parent
SOURCE = REPO_DIR / "native" / "dmpio.cpp"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdmpio-{digest.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """The library, built if it is not current; None without a compiler."""
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.is_file():
        return None
    lib = _lib_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")  # processes may build at once
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.dmpio_encode_aln.restype = ctypes.c_int
        lib.dmpio_encode_aln.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.dmpio_parse_tdb.restype = ctypes.c_int32
        lib.dmpio_parse_tdb.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native parsers run (else the pure-Python ones do)."""
    return _load() is not None


def encode_aln_bytes(text: bytes, max_seqs: int = 0):
    """Native aln encoding: bytes -> (nseqs, nres) uint8 array, or None
    without the library. ``max_seqs`` 0 keeps every row."""
    lib = _load()
    if lib is None:
        return None
    cap = len(text) + 1  # characters bound the cells
    out = np.empty((cap,), np.uint8)
    nseqs, nres = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.dmpio_encode_aln(text, len(text), max_seqs,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                              ctypes.byref(nseqs), ctypes.byref(nres))
    if rc != 0:
        raise ValueError(f"dmpio_encode_aln failed with code {rc}")
    mat = out[: nseqs.value * nres.value].reshape(nseqs.value, nres.value).copy()
    if mat.size and mat.max() >= 22:
        # the Python encoder's rejection (utils/aln.encode_rows): both paths
        # take the same inputs
        raise ValueError("alignment contains characters outside the amino-acid alphabet "
                         "— lowercase rows suggest an a3m file; rename to .a3m")
    return mat


def parse_tdb_bytes(text: bytes, max_residues: int = 100000):
    """Native tdb parse: bytes -> (classes (L,) int32, coords (L, 5, 3)
    float32), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    classes = np.empty((max_residues,), np.int32)
    coords = np.empty((max_residues, 5, 3), np.float32)
    n = lib.dmpio_parse_tdb(text, len(text),
                            classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            max_residues)
    if n < 0:
        raise ValueError(f"dmpio_parse_tdb failed with code {n}")
    return classes[:n].copy(), coords[:n].copy()
