"""The trunk's maxout convolutions in bf16: CUDA kernel wrappers, their plain
versions, the weight packing they read and the differentiable block conv.

Replaces three TPU kernels of ``dmpfold2_tpu/kernels/conv_block.py``:

  * ``conv5x5_maxout`` (``csrc/conv5x5_maxout.cu``): each residual block's
    same-padded 5x5 conv 128 -> 512 + bias + maxout over 4 slices, in stats
    mode (the bf16 engine, :func:`conv5x5_maxout_stats`) and in argmax mode
    (bf16 training, :func:`conv5x5_maxout_argmax`);
  * ``gemm_maxout`` (``csrc/gemm_maxout.cu``): the input layer, a 1x1 conv
    (a GEMM) 955 -> 384 + bias + maxout over 3 slices, stats mode, with TMA
    loads and wgmma products of a 128-pixel by 192-column tile whose weights
    :func:`pack_gemm_weights` packs K-major and slice-major;
  * ``conv5x5_maxout_diff``, the custom VJP around the argmax mode:
    :class:`Conv5x5MaxoutDiff`.

and adds one the JAX package left to XLA: the bf16 residual block's tail
(``csrc/block_tail.cu``, :func:`block_tail`): sSE, the norm, the cSE gate,
the residual and the mask in one pass over the map.

The kernels take bf16 operands with fp32 accumulation and return the bf16
maxout (channel c = g * pool + p pooled into g; the first maximum wins, which
does not change the value) with, in stats mode, the fp32 masked sum and sum
of squares of the pre-rounding maxout over [0, nres)^2 per target and
channel, or, in argmax mode, the int8 index of the winning slice. Maps are
NHWC, as the JAX package keeps them at this boundary.

Row slabs (residue-axis sharding, ``parallel/sharding.py``): each kernel
also runs on a slab of a larger map. With ``slab=True``, the conv's
:func:`conv5x5_maxout_partials` and :func:`conv5x5_maxout_argmax` take the
owned rows with ``HALO`` rows of each neighbour around them, (B, R + 4, W,
128), and give R rows, "valid" in rows and "same" in columns;
:func:`gemm_maxout_partials` takes R rows as they are. A slab's global row
offset ``r0`` places the stats mask. The ``*_partials`` forms return the
kernel's per-tile stats unreduced: a shard that starts on a multiple of 16
rows (of a map whose width is a multiple of 8) has its tiles where the
square launch has them, so the shards' partials joined in row order and
summed are the square launch's sums, bit for bit. :class:`Conv5x5MaxoutDiff`
takes a slab too; its backward gives dx for the whole slab, halo rows
included.

The conv kernel is a persistent, warp-specialised Hopper kernel: TMA loads
of the halo patch and of the weights, packed K-major (c_out, 3200), and
wgmma products over work items of an 8 x 16-pixel patch by 256 output
columns (``CONV_TILE``, ``CONV_N_TILE``; see the note in
``csrc/conv5x5_maxout.cu``). On a CUDA tensor a wrapper launches its kernel
or raises; it never reaches cuDNN, cuBLAS or the plain version. On a CPU tensor it runs the plain
version, which computes in fp32 on the same bf16 operands. The engine packs
weights once (:func:`pack_conv5x5_weights`, :func:`pack_gemm_weights`), when
it puts the parameters on the device; training packs the live weights on
every forward of :class:`Conv5x5MaxoutDiff`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

KSIZE = 5
CONV_POOL = 4
GEMM_POOL = 3
CONV_C_IN = 128       # the conv kernel's input width
CONV_N_TILE = 256     # conv output columns per work item: 64 whole groups of 4
CONV_TILE = (8, 16)   # conv pixels per work item: an 8 x 16 patch
GEMM_N_TILE = 192     # GEMM output columns per block: 64 whole groups of 3
GEMM_K_ALIGN = 64     # the GEMM's K step; K is padded to a multiple upstream
GEMM_TILE_M = 128     # GEMM pixels per block
HALO = KSIZE // 2     # rows of each neighbour a slab carries on each side

conv_launches = 0  # conv5x5_maxout kernel launches (stats mode) since the last reset
conv_argmax_launches = 0  # conv5x5_maxout kernel launches in argmax mode
gemm_launches = 0  # gemm_maxout kernel launches since the last reset
tail_launches = 0  # block_tail kernel launches since the last reset


def gemm_k_pad(c_in: int) -> int:
    """The input width the GEMM kernel reads: ``c_in`` rounded up to 64."""
    return -(-c_in // GEMM_K_ALIGN) * GEMM_K_ALIGN


def pack_conv5x5_weights(w: torch.Tensor, b: torch.Tensor):
    """OIHW (c_out, c_in, 5, 5) fp32 -> ((c_out, 25 * c_in) bf16, (c_out,) fp32).

    Row c in torch order, column (dy * 5 + dx) * c_in + ci: K contiguous, the
    layout the kernel's TMA loads and wgmma reads (B K-major), and a group's
    pool slices are adjacent rows, so a 256-row tile holds whole groups.
    """
    c_out, c_in = w.shape[:2]
    packed = w.permute(0, 2, 3, 1).reshape(c_out, KSIZE * KSIZE * c_in)
    return packed.to(torch.bfloat16).contiguous(), b.to(torch.float32).contiguous()


def unpack_conv5x5_weights(w_packed: torch.Tensor) -> torch.Tensor:
    """The packed (c_out, 25 * c_in) weights back to OIHW (c_out, c_in, 5, 5),
    in the packed dtype: a view, no copy."""
    c_out = w_packed.shape[0]
    c_in = w_packed.shape[1] // (KSIZE * KSIZE)
    return w_packed.view(c_out, KSIZE, KSIZE, c_in).permute(0, 3, 1, 2)


def gemm_pack_order(c_out: int) -> torch.Tensor:
    """The torch channel of each packed row: within each N tile of
    ``GEMM_N_TILE`` rows (the last may be narrower), the tile's groups slice
    by slice, so packed row ``p * n + g`` of a tile of n groups starting at
    group g0 is channel ``(g0 + g) * 3 + p`` (the JAX kernel's
    ``_perm_indices`` within a tile)."""
    groups, per_tile = c_out // GEMM_POOL, GEMM_N_TILE // GEMM_POOL
    order = []
    for g0 in range(0, groups, per_tile):
        n = min(per_tile, groups - g0)
        order += [(g0 + g) * GEMM_POOL + p for p in range(GEMM_POOL) for g in range(n)]
    return torch.tensor(order, dtype=torch.long)


def pack_gemm_weights(w: torch.Tensor, b: torch.Tensor, k_pad: int):
    """OIHW (c_out, c_in, 1, 1) fp32 -> ((c_out, k_pad) bf16, (c_out,) fp32).

    K-major (a row's K contiguous, columns >= c_in zero), rows and biases in
    :func:`gemm_pack_order`: the layout the kernel's TMA loads and wgmma
    reads, with a group's three pool slices ``GEMM_N_TILE / 3`` rows apart in
    one tile.
    """
    c_out, c_in = w.shape[:2]
    order = gemm_pack_order(c_out).to(w.device)
    packed = torch.zeros((c_out, k_pad), dtype=torch.bfloat16, device=w.device)
    packed[:, :c_in] = w.reshape(c_out, c_in)[order]
    return packed, b.to(torch.float32)[order].contiguous()


def unpack_gemm_weights(w_packed: torch.Tensor, b_packed: torch.Tensor):
    """The packed weights and biases back in torch channel order: ((c_out,
    k_pad), (c_out,)), in the packed dtypes."""
    inverse = torch.argsort(gemm_pack_order(w_packed.shape[0])).to(w_packed.device)
    return w_packed[inverse], b_packed[inverse]


def _masked_sums(y: torch.Tensor, nres: torch.Tensor, r0: int = 0):
    """(B, H, W, C) fp32, rows r0 .. r0 + H - 1 of a map -> sum and sum of
    squares over the pixels whose global row and column lie in [0, nres),
    each (B, C)."""
    nr = nres[:, None].to(y.device)
    rows = ((torch.arange(y.shape[1], device=y.device) + r0)[None, :] < nr).to(y.dtype)
    cols = (torch.arange(y.shape[2], device=y.device)[None, :] < nr).to(y.dtype)
    masked = y * (rows[:, :, None, None] * cols[:, None, :, None])
    return masked.sum(dim=(1, 2)), (masked * masked).sum(dim=(1, 2))


def _one_tile(s: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """Sums (B, C) as partials of one tile, (B, 1, 2, C)."""
    return torch.stack([s, ss], dim=1)[:, None]


def _maxout_nhwc(y: torch.Tensor, pool: int) -> torch.Tensor:
    """(B, c_out, H, W) -> (B, H, W, c_out / pool), max over c = g * pool + p."""
    b, c, h, w = y.shape
    return y.view(b, c // pool, pool, h, w).amax(dim=2).permute(0, 2, 3, 1)


def _conv_plain(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor,
                slab: bool) -> torch.Tensor:
    """``F.conv2d`` in fp32 on the bf16-rounded operands, bias: (B, c_out,
    H_out, W); a slab is "valid" in rows, a square map "same"."""
    w = unpack_conv5x5_weights(w_packed.to(torch.bfloat16).float())
    xf = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    return F.conv2d(xf, w, b_packed.float(), padding=(0 if slab else HALO, HALO))


def conv5x5_maxout_partials_plain(x: torch.Tensor, w_packed: torch.Tensor,
                                  b_packed: torch.Tensor, nres: torch.Tensor, r0: int = 0,
                                  slab: bool = False):
    """Plain version of :func:`conv5x5_maxout_partials`: ``F.conv2d`` in fp32
    on the bf16-rounded operands, bias, maxout, and the masked sums as one
    tile, (B, 1, 2, C)."""
    y = _maxout_nhwc(_conv_plain(x, w_packed, b_packed, slab), CONV_POOL)
    return y.to(torch.bfloat16), _one_tile(*_masked_sums(y, nres, r0))


def conv5x5_maxout_stats_plain(x: torch.Tensor, w_packed: torch.Tensor,
                               b_packed: torch.Tensor, nres: torch.Tensor):
    """Plain version of :func:`conv5x5_maxout_stats`."""
    return _reduce_partials(*conv5x5_maxout_partials_plain(x, w_packed, b_packed, nres))


def _gemm_plain(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor):
    """An fp32 matmul on the bf16-rounded operands, bias, maxout: (B, H, W, C)."""
    batch, rows, cols, k_pad = x.shape
    c_out = w_packed.shape[0]
    w, b = unpack_gemm_weights(w_packed.to(torch.bfloat16), b_packed.float())
    xf = x.to(torch.bfloat16).float().reshape(-1, k_pad)
    y = xf @ w.float().T + b
    return y.view(batch, rows, cols, c_out // GEMM_POOL, GEMM_POOL).amax(dim=4)


def gemm_maxout_partials_plain(x: torch.Tensor, w_packed: torch.Tensor,
                               b_packed: torch.Tensor, nres: torch.Tensor, r0: int = 0):
    """Plain version of :func:`gemm_maxout_partials`: an fp32 matmul on the
    bf16-rounded operands, bias, maxout, and the masked sums as one tile,
    (B, 1, 2, C)."""
    y = _gemm_plain(x, w_packed, b_packed)
    return y.to(torch.bfloat16), _one_tile(*_masked_sums(y, nres, r0))


def gemm_maxout_stats_plain(x: torch.Tensor, w_packed: torch.Tensor,
                            b_packed: torch.Tensor, nres: torch.Tensor):
    """Plain version of :func:`gemm_maxout_stats`."""
    return _reduce_partials(*gemm_maxout_partials_plain(x, w_packed, b_packed, nres))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: need a contiguous, 16-byte aligned {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}" + ("" if t.is_contiguous() else " (not contiguous)"))


def _launch(lib: str, entry: str, x, w_packed, b_packed, nres, out_rows: int, tiles: int,
            pool: int, dims: tuple):
    """Allocate the output (B, out_rows, W, c_out / pool) and the partials
    (B, tiles, 2, c_out / pool), launch with the int arguments ``dims``
    after the batch size; returns both, the partials unreduced."""
    batch, width = x.shape[0], x.shape[2]
    c_out = b_packed.shape[0]
    c_groups = c_out // pool
    out = torch.empty((batch, out_rows, width, c_groups), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((batch, tiles, 2, c_groups), dtype=torch.float32, device=x.device)
    fn = _build.load(lib, entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(), nres.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), batch, *dims, stream)
    torch.cuda.check_error(err)
    return out, partial


def _reduce_partials(out, partial):
    """(out, partials) -> (out, sum, sumsq): the partials summed per target
    in tile order (a fixed order: the same bits on every run)."""
    sums = partial.sum(dim=1)
    return out, sums[:, 0], sums[:, 1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_width_error(c_in: int, c_out: int) -> str | None:
    """Why the conv kernel cannot run a ``c_in`` -> ``c_out`` conv, or None."""
    broken = []
    if c_in != CONV_C_IN:
        broken.append(f"c_in must be {CONV_C_IN} (got {c_in})")
    if c_out <= 0 or c_out % CONV_N_TILE:
        broken.append(f"c_out must be a multiple of {CONV_N_TILE} (got {c_out})")
    return "; ".join(broken) or None


def gemm_width_error(c_out: int) -> str | None:
    """Why the GEMM kernel cannot run ``c_out`` output channels, or None."""
    if c_out <= 0 or c_out % GEMM_N_TILE:
        return f"c_out must be a multiple of {GEMM_N_TILE} (got {c_out})"
    return None


def _check_conv(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor,
                slab: bool = False) -> int:
    """What the conv kernel takes, in either mode; raises otherwise. Returns
    the output's rows."""
    if slab and (x.dim() != 4 or x.shape[1] <= 2 * HALO):
        raise ValueError(f"conv5x5_maxout: a slab must be (B, R + {2 * HALO}, W, {CONV_C_IN}) "
                         f"with R >= 1; got {tuple(x.shape)}")
    if not slab and (x.dim() != 4 or x.shape[1] != x.shape[2]):
        raise ValueError(f"conv5x5_maxout: x must be (B, L, L, {CONV_C_IN}); got "
                         f"{tuple(x.shape)}")
    c_out = w_packed.shape[0] if w_packed.dim() == 2 else 0
    msg = conv_width_error(x.shape[3], c_out)
    if msg:
        raise ValueError(f"conv5x5_maxout: {msg}; x must be (B, L, L, c_in) and w_packed "
                         f"(c_out, 25 c_in), got {tuple(x.shape)} and {tuple(w_packed.shape)}")
    dev = x.device
    _check("conv5x5_maxout: x", x, torch.bfloat16, x.shape, dev)
    _check("conv5x5_maxout: w_packed", w_packed, torch.bfloat16,
           (c_out, KSIZE * KSIZE * CONV_C_IN), dev)
    _check("conv5x5_maxout: b_packed", b_packed, torch.float32, (c_out,), dev)
    return x.shape[1] - 2 * HALO if slab else x.shape[1]


def _conv_stats(x, w_packed, b_packed, nres, r0: int, slab: bool):
    """The stats-mode launch, square or slab: (out, partials)."""
    global conv_launches
    out_rows = _check_conv(x, w_packed, b_packed, slab)
    batch, h_in, width = x.shape[:3]
    _check("conv5x5_maxout: nres", nres, torch.int32, (batch,), x.device)
    tiles = _cdiv(out_rows, CONV_TILE[0]) * _cdiv(width, CONV_TILE[1])
    result = _launch("conv5x5_maxout", "conv5x5_maxout_stats", x, w_packed, b_packed, nres,
                     out_rows, tiles, CONV_POOL,
                     (h_in, out_rows, width, r0, CONV_C_IN, w_packed.shape[0]))
    with _build.count_lock:
        conv_launches += 1
    return result


def conv5x5_maxout_stats(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor,
                         nres: torch.Tensor):
    """Fused 5x5 conv + bias + maxout(4) + masked sums, NHWC.

    x (B, L, L, 128) bf16; w_packed (c_out, 3200) bf16 and b_packed (c_out,)
    fp32 from :func:`pack_conv5x5_weights`; nres (B,) int32 ->
    (out (B, L, L, c_out / 4) bf16, sum (B, c_out / 4), sumsq (B, c_out / 4)).
    """
    return _reduce_partials(*conv5x5_maxout_partials(x, w_packed, b_packed, nres))


def conv5x5_maxout_partials(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor,
                            nres: torch.Tensor, r0: int = 0, slab: bool = False):
    """:func:`conv5x5_maxout_stats` with the stats per tile, unreduced.

    x (B, L, L, 128) bf16, or with ``slab`` a row slab (B, R + 4, W, 128):
    global rows r0 - 2 .. r0 + R + 1 (zeros outside the map) -> (out (B, R,
    W, c_out / 4) bf16, partials (B, tiles, 2, c_out / 4) fp32: per tile of
    the kernel, in row order, the masked sum and sum of squares over the
    pixels of global row and column in [0, nres); one tile on the CPU).
    """
    if x.device.type == "cpu":
        return conv5x5_maxout_partials_plain(x, w_packed, b_packed, nres, r0, slab)
    return _conv_stats(x, w_packed, b_packed, nres, r0, slab)


def conv5x5_maxout_argmax_plain(x: torch.Tensor, w_packed: torch.Tensor,
                                b_packed: torch.Tensor, slab: bool = False):
    """Plain version of :func:`conv5x5_maxout_argmax`: ``F.conv2d`` in fp32 on
    the bf16-rounded operands, bias, maxout with the index of the winning
    slice (``torch.max`` returns the first on a tie)."""
    y = _conv_plain(x, w_packed, b_packed, slab).permute(0, 2, 3, 1)
    y = y.reshape(*y.shape[:3], y.shape[3] // CONV_POOL, CONV_POOL)
    val, idx = y.max(dim=-1)
    return val.to(torch.bfloat16), idx.to(torch.int8)


def conv5x5_maxout_argmax(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor,
                          slab: bool = False):
    """Fused 5x5 conv + bias + maxout(4) with the winning slice, NHWC (the
    kernel's argmax mode).

    x (B, L, L, 128) bf16; w_packed (c_out, 3200) bf16 and b_packed (c_out,)
    fp32 from :func:`pack_conv5x5_weights` -> (out (B, L, L, c_out / 4) bf16,
    index (B, L, L, c_out / 4) int8 in 0..3: ``out[..., g]`` is slice
    ``index[..., g]`` of channels g * 4 .. g * 4 + 3, the first on a tie).
    ``out`` is the same bits as :func:`conv5x5_maxout_stats` gives. With
    ``slab``, x is a row slab (B, R + 4, W, 128) as
    :func:`conv5x5_maxout_partials` takes it, and both results (B, R, W,
    c_out / 4).
    """
    global conv_argmax_launches
    if x.device.type == "cpu":
        return conv5x5_maxout_argmax_plain(x, w_packed, b_packed, slab)
    out_rows = _check_conv(x, w_packed, b_packed, slab)
    batch, h_in, width = x.shape[:3]
    c_out = w_packed.shape[0]
    shape = (batch, out_rows, width, c_out // CONV_POOL)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    index = torch.empty(shape, dtype=torch.int8, device=x.device)
    fn = _build.load("conv5x5_maxout", "conv5x5_maxout_argmax")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(), out.data_ptr(),
                 index.data_ptr(), batch, h_in, out_rows, width, CONV_C_IN, c_out, stream)
    torch.cuda.check_error(err)
    with _build.count_lock:
        conv_argmax_launches += 1
    return out, index


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (M, K) x bf16 (K, N) -> fp32 (M, N), products and sums in fp32.

    On CUDA this is cuBLAS's bf16 GEMM with an fp32 output (``aten::mm.dtype``);
    that operator has no CPU kernel, so on the CPU the same product is taken in
    fp32 on the exactly converted operands."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class Conv5x5MaxoutDiff(torch.autograd.Function):
    """Differentiable conv5x5 + bias + maxout(4) in bf16, the counterpart of
    ``dmpfold2_tpu/kernels/conv_block.py:conv5x5_maxout_diff`` (:646).

    x (B, L, L, 128) NHWC bf16, w (c_out, 128, 5, 5) OIHW fp32, b (c_out,)
    fp32 -> (B, L, L, c_out / 4) bf16; with ``slab`` True, x is a row slab
    (B, R + 4, W, 128) and the output (B, R, W, c_out / 4), and dx covers the
    whole slab, halo rows included, so autograd carries the halo's share back
    to the neighbour's rows. The forward packs the live weights and
    runs the kernel's argmax mode, saving the int8 index; the backward
    (``_diff_bwd``, :682-737) routes the cotangent by it:

      * the cotangent scattered to its winning slice, one 512-wide map G
        (c = g * 4 + p), fp32 for db (the sum of the unrounded cotangent),
        then bf16 for the two products;
      * dx = the transposed conv of G with w: one cuDNN bf16 convolution that
        sums all four slices' terms in fp32 and rounds once to x's dtype;
      * dw = 25 shifted-view GEMMs, x's (128, B L L) view at tap (dy, dx)
        times G, each with an fp32 output.

    The JAX backward takes the four slices one at a time (``gp = g [idx ==
    p]``) to keep the 512-wide cotangent out of TPU memory; here G is 2 bytes
    x 512 per pixel (127 MB at B 1, L 352), and the single dx convolution
    then accumulates in fp32 across the slices without a bf16 partial sum.
    """

    @staticmethod
    def forward(ctx, x, w, b, slab=False):
        w_packed, b_packed = pack_conv5x5_weights(w.detach(), b.detach())
        out, index = conv5x5_maxout_argmax(x.detach().contiguous(), w_packed, b_packed, slab)
        ctx.save_for_backward(x, w, b, index)
        ctx.slab = slab
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b, index = ctx.saved_tensors
        batch, l_rows, l_cols, c_groups = g.shape
        c_out, c_in = w.shape[:2]
        scat = torch.zeros((batch, l_rows, l_cols, c_groups, CONV_POOL), dtype=torch.float32,
                           device=g.device)
        scat.scatter_(-1, index.long().unsqueeze(-1), g.float().unsqueeze(-1))
        db = scat.sum(dim=(0, 1, 2)).reshape(c_out)
        cot = scat.reshape(batch, l_rows, l_cols, c_out).to(torch.bfloat16)
        del scat
        dx = dw = None
        pad_rows = 0 if ctx.slab else HALO  # a slab carries its halo rows
        if ctx.needs_input_grad[0]:
            dx = F.conv_transpose2d(cot.permute(0, 3, 1, 2), w.to(torch.bfloat16),
                                    padding=(pad_rows, HALO))
            dx = dx.permute(0, 2, 3, 1).to(x.dtype).contiguous()
        if ctx.needs_input_grad[1]:
            xp = F.pad(x.to(torch.bfloat16), (0, 0, HALO, HALO, pad_rows, pad_rows))
            cot2 = cot.reshape(-1, c_out)
            taps = [_mm_fp32(xp[:, dy:dy + l_rows, dx_:dx_ + l_cols].reshape(-1, c_in).T, cot2)
                    for dy in range(KSIZE) for dx_ in range(KSIZE)]
            dw = torch.stack(taps).view(KSIZE, KSIZE, c_in, c_out).permute(3, 2, 0, 1)
            dw = dw.to(w.dtype).contiguous()
        return dx, dw, db.to(b.dtype), None


def conv5x5_maxout_diff(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        slab: bool = False) -> torch.Tensor:
    """The trunk block conv of bf16 training: :class:`Conv5x5MaxoutDiff` when a
    gradient is wanted; otherwise (no_grad, an eval step) the same kernel
    launch without keeping the index, so the output is the same bits.
    ``slab``: x is a row slab with its halo rows (:class:`Conv5x5MaxoutDiff`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return Conv5x5MaxoutDiff.apply(x, w, b, slab)
    w_packed, b_packed = pack_conv5x5_weights(w, b)
    return conv5x5_maxout_argmax(x.contiguous(), w_packed, b_packed, slab)[0]


def gemm_maxout_stats(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor,
                      nres: torch.Tensor):
    """Fused 1x1 conv (GEMM) + bias + maxout(3) + masked sums, NHWC.

    x (B, L, L, k_pad) bf16 with k_pad a multiple of 64, channels past the
    layer's inputs zero; w_packed (c_out, k_pad) bf16 and b_packed (c_out,)
    fp32 from :func:`pack_gemm_weights`; nres (B,) int32 ->
    (out (B, L, L, c_out / 3) bf16, sum (B, c_out / 3), sumsq (B, c_out / 3)).
    """
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"gemm_maxout: x must be (B, L, L, k_pad); got {tuple(x.shape)}")
    return _reduce_partials(*gemm_maxout_partials(x, w_packed, b_packed, nres))


def gemm_maxout_partials(x: torch.Tensor, w_packed: torch.Tensor, b_packed: torch.Tensor,
                         nres: torch.Tensor, r0: int = 0):
    """:func:`gemm_maxout_stats` with the stats per tile, unreduced, on the
    map or on a row slab of it: x (B, R, W, k_pad) bf16, global rows r0 ..
    r0 + R - 1 -> (out (B, R, W, c_out / 3) bf16, partials (B, tiles, 2,
    c_out / 3) fp32: per 128-pixel tile, in row order, the masked sum and
    sum of squares over the pixels of global row and column in [0, nres);
    one tile on the CPU)."""
    if x.device.type == "cpu":
        return gemm_maxout_partials_plain(x, w_packed, b_packed, nres, r0)
    return _gemm_stats(x, w_packed, b_packed, nres, r0)


def _gemm_stats(x, w_packed, b_packed, nres, r0: int):
    """The GEMM launch, square or slab: (out, partials)."""
    global gemm_launches
    if x.dim() != 4 or x.shape[3] % GEMM_K_ALIGN:
        raise ValueError(f"gemm_maxout: x must be (B, R, W, k_pad) with k_pad a multiple of "
                         f"{GEMM_K_ALIGN}; got {tuple(x.shape)}")
    batch, rows, width, k_pad = x.shape
    c_out = w_packed.shape[0]
    msg = gemm_width_error(c_out)
    if msg or batch > 65535:
        raise ValueError(f"gemm_maxout: {msg or f'need B <= 65535 (got {batch})'}")
    dev = x.device
    _check("gemm_maxout: x", x, torch.bfloat16, x.shape, dev)
    _check("gemm_maxout: w_packed", w_packed, torch.bfloat16, (c_out, k_pad), dev)
    _check("gemm_maxout: b_packed", b_packed, torch.float32, (c_out,), dev)
    _check("gemm_maxout: nres", nres, torch.int32, (batch,), dev)
    tiles = _cdiv(rows * width, GEMM_TILE_M)
    result = _launch("gemm_maxout", "gemm_maxout_stats", x, w_packed, b_packed, nres, rows,
                     tiles, GEMM_POOL, (rows, width, r0, k_pad, c_out))
    with _build.count_lock:
        gemm_launches += 1
    return result


def normalize(out: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """``((out * scale + shift) * mask)`` in bf16: a maxout map normalized by
    its per-target (B, C) scale and shift, then masked."""
    y = out.float() * scale[:, None, None, :] + shift[:, None, None, :]
    return (y * mask).to(torch.bfloat16)


def block_tail_plain(z: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, sse_w: torch.Tensor, sse_b: torch.Tensor,
                     cse_gate: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`block_tail`: sSE reads the raw maxout with
    scale folded into its weights (rounded to bf16, as JAX does) and shift
    into its bias; then the cSE gate, residual, mask, with fp32
    intermediates."""
    w_eff = (scale * sse_w[None, :]).to(torch.bfloat16)                   # (B, C)
    s_bias = shift @ sse_w + sse_b[0]                                     # (B,)
    zf = z.float()
    s = torch.einsum("bhwc,bc->bhw", zf, w_eff.float()) + s_bias[:, None, None]
    gate = cse_gate + torch.sigmoid(s)[..., None]
    y = zf * scale[:, None, None, :] + shift[:, None, None, :]
    out = (y * gate + x.float()).to(torch.bfloat16)
    return out * mask


def block_tail(z: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, sse_w: torch.Tensor, sse_b: torch.Tensor,
               cse_gate: torch.Tensor) -> torch.Tensor:
    """The bf16 residual block's tail (JAX ``trunk._resnet_block_fused_norm``
    after its conv), NHWC, one kernel launch on the card.

    z (B, R, W, 128) bf16, the conv's maxout; x (B, R, W, 128) bf16, the
    carry; mask (B, R, W, 1) bf16; scale, shift (B, 128) fp32, the norm's;
    sse_w (128,), sse_b (1,), cse_gate (128,) fp32, the packed block's ->
    the next carry, (B, R, W, 128) bf16: ``bf16((z * scale + shift) *
    (cse_gate + sigmoid(z . bf16(scale * sse_w) + shift . sse_w + sse_b)) +
    x) * mask``. Per pixel, so R may be any row slab of the map and gives
    the unsharded rows' bits.
    """
    global tail_launches
    if z.device.type == "cpu":
        return block_tail_plain(z, x, mask, scale, shift, sse_w, sse_b, cse_gate)
    if z.dim() != 4 or z.shape[3] != CONV_C_IN:
        raise ValueError(f"block_tail: z must be (B, R, W, {CONV_C_IN}); got {tuple(z.shape)}")
    batch, rows, width, c = z.shape
    dev = z.device
    _check("block_tail: z", z, torch.bfloat16, z.shape, dev)
    _check("block_tail: x", x, torch.bfloat16, z.shape, dev)
    _check("block_tail: mask", mask, torch.bfloat16, (batch, rows, width, 1), dev)
    for name, t, shape in (("scale", scale, (batch, c)), ("shift", shift, (batch, c)),
                           ("sse_w", sse_w, (c,)), ("sse_b", sse_b, (1,)),
                           ("cse_gate", cse_gate, (c,))):
        _check(f"block_tail: {name}", t, torch.float32, shape, dev)
    if batch > 65535:
        raise ValueError(f"block_tail: need B <= 65535 (got {batch})")
    out = torch.empty_like(z)
    fn = _build.load("block_tail")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(z.data_ptr(), x.data_ptr(), mask.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), sse_w.data_ptr(), sse_b.data_ptr(), cse_gate.data_ptr(),
                 out.data_ptr(), batch, rows, width, c, stream)
    torch.cuda.check_error(err)
    with _build.count_lock:
        tail_launches += 1
    return out
