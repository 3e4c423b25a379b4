"""Vertical GRU over MSA rows: CUDA kernel wrapper and its plain version.

Replaces the TPU kernel ``dmpfold2_tpu/kernels/vgru.py:vgru_final_cols_pallas``
with ``csrc/vgru.cu``. A 2-layer GRU scanned over the alignment rows for
independent columns (residue positions); each column freezes at its own valid
depth; returns layer 2's final state (n_cols, H).

The kernel is one persistent cooperative grid, one block per 4 hidden units
with its slice of the weights resident in shared memory for the whole scan,
and one grid barrier per row (see the note in ``csrc/vgru.cu``). It takes the
parameters as they are (no packing) and a scratch of 4 x H x n_cols fp32 for
the two layers' double-buffered states, which the wrapper allocates.

On a CUDA tensor the wrapper launches the kernel or raises: also when the
card cannot hold all H / 4 blocks at once, since a grid barrier without
co-residency could hang. On a CPU tensor it runs :func:`vgru_final_cols_plain`.
"""

from __future__ import annotations

import torch

from ..models import gru
from ..utils.aln import NUM_CLASSES
from . import _build

MAX_HIDDEN = 512  # H / 4 blocks, each with its weight slice in shared memory, all resident

launches = 0  # kernel launches since the last reset


def vgru_final_cols_plain(layers, aln_cols: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``gru.unigru_stack_final`` on the one-hot rows."""
    classes = torch.arange(NUM_CLASSES, device=aln_cols.device)
    x = (aln_cols.long()[..., None] == classes).float()  # a class outside [0, 22) is all zeros
    return gru.unigru_stack_final(layers, x, col_valid)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"vgru: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device} (contiguous={t.is_contiguous()})")


def width_error(n_layers: int, hidden: int) -> str | None:
    """Why the kernel cannot run a GRU of ``n_layers`` x ``hidden``, or None."""
    if n_layers != 2:
        return f"the kernel runs the reference's 2-layer GRU (got {n_layers} layers)"
    if hidden % 32 or hidden > MAX_HIDDEN:
        return f"hidden size {hidden} must be a multiple of 32, at most {MAX_HIDDEN}"
    return None


def vgru_final_cols(layers, aln_cols: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """(n_rows, n_cols) int32 alignment, (n_cols,) int32 depths -> (n_cols, H) fp32."""
    global launches
    if aln_cols.device.type == "cpu":
        return vgru_final_cols_plain(layers, aln_cols, col_valid)
    device = aln_cols.device
    n_rows, n_cols = aln_cols.shape
    hidden = layers[0]["wh"].shape[0]
    msg = width_error(len(layers), hidden)
    if msg:
        raise ValueError(f"vgru: {msg}")
    _check(aln_cols, "aln_cols", torch.int32, (n_rows, n_cols), device)
    _check(col_valid, "col_valid", torch.int32, (n_cols,), device)
    _check(layers[0]["wi"], "wi1", torch.float32, (NUM_CLASSES, 3 * hidden), device)
    for i, p in enumerate(layers):
        for key, shape in (("wh", (hidden, 3 * hidden)), ("bi", (3 * hidden,)),
                           ("bh", (3 * hidden,))):
            _check(p[key], f"{key}{i + 1}", torch.float32, shape, device)
    _check(layers[1]["wi"], "wi2", torch.float32, (hidden, 3 * hidden), device)
    out = torch.empty((n_cols, hidden), dtype=torch.float32, device=device)
    if n_cols == 0:
        return out
    state = torch.empty((4, hidden, n_cols), dtype=torch.float32, device=device)
    fn = _build.load("vgru")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        l1, l2 = layers
        err = fn(aln_cols.data_ptr(), col_valid.data_ptr(), n_rows, n_cols, hidden,
                 l1["wi"].data_ptr(), l1["wh"].data_ptr(), l2["wi"].data_ptr(),
                 l2["wh"].data_ptr(), l1["bi"].data_ptr(), l1["bh"].data_ptr(),
                 l2["bi"].data_ptr(), l2["bh"].data_ptr(), state.data_ptr(), out.data_ptr(),
                 stream)
    with _build.count_lock:
        launches += 1
    torch.cuda.check_error(err)
    return out
