"""Residue GRU sequence passes: CUDA kernel wrappers and their plain versions.

Replaces the TPU kernel ``dmpfold2_tpu/kernels/rgru.py:gru_seq_pallas`` with
``csrc/rgru.cu``: the recurrence of a GRU layer over a precomputed input
projection (T, B, 3H), returning every step's state, with the forward-freeze /
reverse-zero masking of ``models/gru.py``. :func:`gru_seq` runs one
layer-direction (the counterpart of ``gru_seq_pallas``); :func:`gru_seq_bidir`
runs both directions of a layer in one launch, into one (T, B, 2H) output.
The input projections stay ``torch.matmul`` outside the kernel, as the JAX
wrapper keeps them outside its kernel.

The kernel runs a thread-block cluster of 8 CTAs per direction (and per 8
batch columns); a card that cannot hold one cluster makes the launch return
an error, which the wrapper raises. On a CUDA tensor a wrapper launches the
kernel or raises. On a CPU tensor it runs the plain version. One launch is
one count.

All three engines run this kernel, ``fp32_strict`` included. The kernel's
arithmetic is fp32 throughout (fp32 FMAs for the recurrent product, fp32
``expf``/``tanhf`` for the gates; the input projections are fp32
``torch.matmul`` with TF32 off), so ``fp32_strict`` gets the same fp32 GRU as
``fp32``. The JAX package keeps a plain scan under ``fp32_strict`` for
"reference-matmul-order fidelity" on the TPU, but on the GPU the reference
runs cuDNN's GRU, whose summation order neither a plain scan nor this kernel
reproduces; no plain version runs on the card.
"""

from __future__ import annotations

import torch

from ..models import gru
from . import _build

MAX_HIDDEN = 256  # the kernel keeps W_hh's slice in registers: H <= 256, H % 32 == 0

launches = 0  # kernel launches since the last reset


def gru_seq_plain(wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor,
                  col_valid: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the recurrence of the JAX ``gru_scan`` over a given ``xproj``."""
    return gru.gru_scan_projected(wh, bh, xproj, col_valid, reverse=reverse)


def gru_seq_bidir_plain(fwd, bwd, xproj_f: torch.Tensor, xproj_b: torch.Tensor,
                        col_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gru_seq_bidir`: both passes and a cat."""
    return torch.cat([gru.gru_scan_projected(fwd["wh"], fwd["bh"], xproj_f, col_valid),
                      gru.gru_scan_projected(bwd["wh"], bwd["bh"], xproj_b, col_valid,
                                             reverse=True)], dim=-1)


def width_error(hidden: int) -> str | None:
    """Why the kernel cannot run a GRU of ``hidden`` units, or None."""
    if hidden % 32 or hidden > MAX_HIDDEN:
        return f"hidden size {hidden} must be a multiple of 32 and at most {MAX_HIDDEN}"
    return None


def _check(xproj: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
           col_valid: torch.Tensor) -> None:
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
    msg = width_error(hidden)
    if msg:
        raise ValueError(f"rgru: {msg}")


def _launch(passes, col_valid: torch.Tensor, out: torch.Tensor, first_reverse: bool) -> None:
    """One launch over ``passes``: one or two (xproj, wh, bh) layer-directions."""
    global launches
    seq_len, batch, hidden = out.shape[0], out.shape[1], passes[0][1].shape[0]
    if seq_len == 0 or batch == 0:
        return
    (xf, whf, bhf), (xb, whb, bhb) = passes[0], passes[-1]
    fn = _build.load("rgru")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(xf.data_ptr(), xb.data_ptr(), whf.data_ptr(), whb.data_ptr(), bhf.data_ptr(),
                 bhb.data_ptr(), col_valid.data_ptr(), out.data_ptr(), seq_len, batch, hidden,
                 len(passes), int(first_reverse), stream)
    with _build.count_lock:
        launches += 1
    if err:
        raise RuntimeError(f"rgru: launch failed with CUDA error {err} "
                           f"({torch.cuda.CudaError(err)}); the kernel needs one cluster of 8 "
                           f"co-resident blocks of {3 * hidden // 2} threads per direction")


def gru_seq(wh: torch.Tensor, bh: torch.Tensor, xproj: torch.Tensor,
            col_valid: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """One layer-direction: (T, B, 3H) fp32 projection, (B,) int32 lengths -> (T, B, H) fp32."""
    if xproj.device.type == "cpu":
        return gru_seq_plain(wh, bh, xproj, col_valid, reverse=reverse)
    _check(xproj, wh, bh, col_valid)
    seq_len, batch, three_h = xproj.shape
    out = torch.empty((seq_len, batch, three_h // 3), dtype=torch.float32, device=xproj.device)
    _launch([(xproj, wh, bh)], col_valid, out, reverse)
    return out


def gru_seq_bidir(fwd, bwd, xproj_f: torch.Tensor, xproj_b: torch.Tensor,
                  col_valid: torch.Tensor) -> torch.Tensor:
    """Both directions of one layer in one launch.

    ``fwd``, ``bwd``: the layer-directions' parameters (``wh``, ``bh``);
    ``xproj_f``, ``xproj_b``: their (T, B, 3H) fp32 projections; (B,) int32
    lengths -> (T, B, 2H) fp32, the forward pass in ``[..., :H]``, the
    reverse pass in ``[..., H:]``.
    """
    if xproj_f.device.type == "cpu":
        return gru_seq_bidir_plain(fwd, bwd, xproj_f, xproj_b, col_valid)
    _check(xproj_f, fwd["wh"], fwd["bh"], col_valid)
    _check(xproj_b, bwd["wh"], bwd["bh"], col_valid)
    if xproj_b.shape != xproj_f.shape or xproj_b.device != xproj_f.device:
        raise ValueError(f"rgru: xproj_f {tuple(xproj_f.shape)} and xproj_b "
                         f"{tuple(xproj_b.shape)} must match")
    seq_len, batch, three_h = xproj_f.shape
    out = torch.empty((seq_len, batch, 2 * (three_h // 3)), dtype=torch.float32,
                      device=xproj_f.device)
    _launch([(xproj_f, fwd["wh"], fwd["bh"]), (xproj_b, bwd["wh"], bwd["bh"])], col_valid, out,
            False)
    return out


def bigru_stack(layers, x: torch.Tensor, valid_len) -> torch.Tensor:
    """Multi-layer biGRU over residues (inference): (T, B, C) -> (T, B, 2H),
    :func:`models.gru.bigru_stack` with one :func:`gru_seq_bidir` per layer.

    ``valid_len``: scalar or (B,) true lengths.
    """
    valid = torch.as_tensor(valid_len, dtype=torch.int32, device=x.device)
    valid = valid.expand(x.shape[1]).contiguous()
    out = x
    for layer in layers:
        fwd, bwd = layer["fwd"], layer["bwd"]
        out = gru_seq_bidir(fwd, bwd, torch.matmul(out, fwd["wi"]) + fwd["bi"],
                            torch.matmul(out, bwd["wi"]) + bwd["bi"], valid)
    return out
