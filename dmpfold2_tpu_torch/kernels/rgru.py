"""Residue GRU sequence pass: CUDA kernel wrapper and its plain version.

Replaces the TPU kernel ``dmpfold2_tpu/kernels/rgru.py:gru_seq_pallas`` with
``csrc/rgru.cu``: one GRU layer-direction over a precomputed input projection
(T, B, 3H), returning every step's state (T, B, H), with the forward-freeze /
reverse-zero masking of ``models/gru.py``. The input projection stays a
``torch.matmul`` outside the kernel, as the JAX wrapper keeps it outside its
kernel.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor it
runs :func:`gru_seq_plain`. One launch is one layer-direction pass.
"""

from __future__ import annotations

import torch

from ..models import gru
from . import _build

launches = 0  # kernel launches since the last reset


def gru_seq_plain(wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor,
                  col_valid: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the recurrence of the JAX ``gru_scan`` over a given ``xproj``."""
    return gru.gru_scan_projected(wh, bh, xproj, col_valid, reverse=reverse)


def gru_seq(wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor,
            col_valid: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """(T, B, 3H) fp32 projection, (B,) int32 lengths -> (T, B, H) fp32."""
    global launches
    if xproj.device.type == "cpu":
        return gru_seq_plain(wh, bh, xproj, col_valid, reverse=reverse)
    device = xproj.device
    seq_len, batch, three_h = xproj.shape
    hidden = three_h // 3
    for name, t, dtype, shape in (("xproj", xproj, torch.float32, (seq_len, batch, 3 * hidden)),
                                  ("wh", wh, torch.float32, (hidden, 3 * hidden)),
                                  ("bh", bh, torch.float32, (3 * hidden,)),
                                  ("col_valid", col_valid, torch.int32, (batch,))):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"rgru: {name} must be a contiguous {dtype} tensor of shape "
                             f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    if hidden % 32 or hidden > 1024 or hidden % (1024 // hidden):
        raise ValueError(f"rgru: unsupported hidden size {hidden}")
    out = torch.empty((seq_len, batch, hidden), dtype=torch.float32, device=device)
    if seq_len == 0 or batch == 0:
        return out
    fn = _build.load("rgru")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(xproj.data_ptr(), wh.data_ptr(), bh.data_ptr(), col_valid.data_ptr(),
                 seq_len, batch, hidden, int(reverse), out.data_ptr(), stream)
    launches += 1
    torch.cuda.check_error(err)
    return out


def bigru_stack(layers, x: torch.Tensor, valid_len) -> torch.Tensor:
    """Multi-layer biGRU over residues (inference): (T, B, C) -> (T, B, 2H),
    :func:`models.gru.bigru_stack` with this kernel's recurrence.

    ``valid_len``: scalar or (B,) true lengths.
    """
    valid = torch.as_tensor(valid_len, dtype=torch.int32, device=x.device)
    valid = valid.expand(x.shape[1]).contiguous()
    return gru.bigru_stack(layers, x, valid, scan=gru_seq)
