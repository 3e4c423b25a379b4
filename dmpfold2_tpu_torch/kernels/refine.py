"""CA-trace refinement loop: CUDA kernel wrappers and their plain versions.

Replaces the TPU kernel ``dmpfold2_tpu/kernels/refine.py:refine_coords_pallas``
(and the JAX package's vmap of it over a batch) with ``csrc/refine.cu``: the
whole ``n_steps`` Euler loop of the CA force field in one launch for a batch
of (L, 3) traces, each target with its own ``nres``; the traces stay in
shared memory, one thread-block cluster of 16 CTAs per target.

On a CUDA tensor a wrapper launches the kernel or raises. On a CPU tensor it
runs the plain version.
"""

from __future__ import annotations

import torch

from ..models import geometry
from . import _build

launches = 0  # kernel launches since the last reset

# the kernel's shared memory: two float4 trace buffers (32 B per residue) and
# 1024 float4 each of partial sums and springs, in 227 KB
MAX_L = (232448 // 16 - 2048) // 2  # 6240


def refine_coords_batched_plain(coords: torch.Tensor, n_steps: int,
                                nres: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the batch: ``geometry.refine_coords`` per target."""
    out = coords.clone()
    for b, k in enumerate(nres.tolist()):
        out[b] = geometry.refine_coords(coords[b], n_steps, k)
    return out


def refine_coords_batched(coords: torch.Tensor, n_steps: int,
                          nres: torch.Tensor) -> torch.Tensor:
    """(B, L, 3) fp32 traces, (B,) int32 lengths -> (B, L, 3) after ``n_steps``
    steps; rows at or past a target's ``nres`` stay put (an ``nres`` outside
    [0, L] acts as its nearest end, as the plain version's masks read it)."""
    global launches
    if coords.device.type == "cpu":
        return refine_coords_batched_plain(coords, n_steps, nres)
    if coords.dtype != torch.float32 or coords.dim() != 3 or coords.shape[2] != 3 \
            or not coords.is_contiguous():
        raise ValueError("refine: coords must be a contiguous (B, L, 3) float32 tensor; got "
                         f"{coords.dtype} {tuple(coords.shape)}")
    batch, n, _ = coords.shape
    if nres.dtype != torch.int32 or tuple(nres.shape) != (batch,) \
            or nres.device != coords.device or not nres.is_contiguous():
        raise ValueError(f"refine: nres must be a contiguous ({batch},) int32 tensor on "
                         f"{coords.device}; got {nres.dtype} {tuple(nres.shape)} on "
                         f"{nres.device}")
    if n > MAX_L or batch > 65535 or n_steps < 0:
        raise ValueError(f"refine: need L <= {MAX_L}, B <= 65535 and n_steps >= 0; got "
                         f"L={n}, B={batch}, n_steps={n_steps}")
    out = torch.empty_like(coords)
    if batch == 0 or n == 0:
        return out
    fn = _build.load("refine")
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = fn(coords.data_ptr(), nres.data_ptr(), out.data_ptr(), batch, n, int(n_steps),
                 stream)
    with _build.count_lock:
        launches += 1
    if err:
        raise RuntimeError(f"refine: launch failed with CUDA error {err} "
                           f"({torch.cuda.CudaError(err)}); the kernel needs one cluster of "
                           "16 blocks of 1024 threads to be resident")
    return out
