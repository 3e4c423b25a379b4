"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
``build/torch_kernels/`` beside the package, named by a hash of the source and
the flags, so a changed source is rebuilt and an unchanged one is reused.
Only the sources in this package are compiled. A missing ``nvcc`` or a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of each library's entry points: {name: argtypes}
SIGNATURES = {
    "vgru": {"vgru_final_cols": [_P, _P, _I, _I, _I] + [_P] * 8 + [_P, _P, _P]},
    "rgru": {"rgru_seq": [_P] * 8 + [_I] * 5 + [_P]},
    "refine": {"refine_coords_batched": [_P] * 3 + [_I] * 3 + [_P]},
    "conv5x5_maxout": {"conv5x5_maxout_stats": [_P] * 6 + [_I] * 7 + [_P],
                       "conv5x5_maxout_argmax": [_P] * 5 + [_I] * 6 + [_P]},
    "gemm_maxout": {"gemm_maxout_stats": [_P] * 6 + [_I] * 6 + [_P]},
    "block_tail": {"block_tail": [_P] * 9 + [_I] * 4 + [_P]},
}

_lock = threading.Lock()
count_lock = threading.Lock()  # the launch counters: batches in flight launch from threads
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{CSRC_DIR} at first use and need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # headers may be shared
        if src.suffix == ".cuh" or src.stem == name:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[Path, subprocess.Popen] | None:
    """Start nvcc for ``name`` unless its library is current; returns the job."""
    lib = _lib_path(name)
    if lib.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def _finish_build(name: str, job: tuple[Path, subprocess.Popen]) -> None:
    lib, proc = job
    log, _ = proc.communicate()
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build the named kernels, all nvcc processes started together.

    Returns each kernel's compiler log (``-Xptxas -v``: registers, shared
    memory, spills); an up-to-date library returns the log of its build.
    """
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish_build(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[1].poll() is None:
                    job[1].kill()
                    job[1].wait()
    logs = {}
    for n in names:
        log = _lib_path(n).with_suffix(".log")
        logs[n] = log.read_text() if log.is_file() else ""
    return logs


def load(name: str, entry: str | None = None):
    """The C entry point ``entry`` of library ``name`` (its only one when
    ``entry`` is None), building the library if needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _loaded[name] = lib
    entries = SIGNATURES[name]
    if entry is None:
        (entry,) = entries
    fn = getattr(lib, entry)
    fn.argtypes = entries[entry]
    fn.restype = ctypes.c_int
    return fn
