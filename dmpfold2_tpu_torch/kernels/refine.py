"""CA-trace refinement loop: CUDA kernel wrapper and its plain version.

Replaces the TPU kernel ``dmpfold2_tpu/kernels/refine.py:refine_coords_pallas``
with ``csrc/refine.cu``: the whole ``n_steps`` Euler loop of the CA force field
in one launch, the coordinates resident on chip, ``nres`` masking padded
positions out.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor it
runs :func:`refine_coords_plain`.
"""

from __future__ import annotations

import torch

from ..models import geometry
from . import _build

launches = 0  # kernel launches since the last reset


def refine_coords_plain(coords: torch.Tensor, n_steps: int, nres: int) -> torch.Tensor:
    """Plain PyTorch version: ``geometry.refine_coords``, one step at a time."""
    return geometry.refine_coords(coords, n_steps, nres)


def refine_coords(coords: torch.Tensor, n_steps: int, nres: int) -> torch.Tensor:
    """(L, 3) fp32 CA trace -> (L, 3) after ``n_steps`` steps; rows >= nres stay put."""
    global launches
    if coords.device.type == "cpu":
        return refine_coords_plain(coords, n_steps, nres)
    n = coords.shape[0]
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 3 \
            or not coords.is_contiguous():
        raise ValueError("refine: coords must be a contiguous (L, 3) float32 tensor; got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    if not (0 <= nres <= n) or n_steps < 0 or 6 * 4 * n > 227 * 1024:
        raise ValueError(f"refine: need 0 <= nres <= L <= 9685 and n_steps >= 0; "
                         f"got L={n}, nres={nres}, n_steps={n_steps}")
    out = torch.empty_like(coords)
    if n == 0:
        return out
    fn = _build.load("refine")
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = fn(coords.data_ptr(), out.data_ptr(), n, int(n_steps), int(nres), stream)
    launches += 1
    torch.cuda.check_error(err)
    return out
