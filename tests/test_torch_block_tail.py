"""The bf16 residual block's tail, ``kernels/conv_block.block_tail``.

On the CPU the wrapper runs its plain version, held here to the math written
out, bit for bit, with no kernel launch counted. On a card the kernel
(``csrc/block_tail.cu``) is held to the plain version within one bf16 ulp,
|d| <= 2^-7 max(|ref|, 1): the two channel sums (sSE's dot product and its
bias) are taken in another order than the plain version's, so a pixel's gate
may differ in its last fp32 bits and an output land on the other bf16
neighbour. A row slab, a fully masked target and a second launch are held to
exact bits.

The ``gpu`` tests decide inside the test whether a card is present and skip
here.
"""

import pytest
import torch

from dmpfold2_tpu_torch.kernels import conv_block

C = conv_block.CONV_C_IN
BF16_ULP = 2.0 ** -7


def _case(batch: int, l: int, nres, device="cpu", seed: int = 0):
    """Tail inputs over a (batch, l, l) map, as the bf16 engine hands them:
    (z, x, mask, scale, shift, sse_w, sse_b, cse_gate); the maxout z and the
    carry x are nonzero on padded pixels too, which the mask clears."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def uniform(*shape, bound=1.0):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound

    z = (randn(batch, l, l, C) + 0.5).to(torch.bfloat16)
    x = (2 * randn(batch, l, l, C)).to(torch.bfloat16)
    valid = torch.arange(l, device=device)[None, :] < torch.tensor(nres, device=device)[:, None]
    mask = (valid[:, :, None] & valid[:, None, :])[..., None].to(torch.bfloat16)
    scale = 1 + 0.2 * randn(batch, C)
    shift = -0.5 * scale + 0.1 * randn(batch, C)
    sse_w, sse_b = uniform(C, bound=C ** -0.5), uniform(1, bound=C ** -0.5)
    cse_gate = torch.rand(C, generator=g, device=device)
    return z, x, mask, scale, shift, sse_w, sse_b, cse_gate


def _rows(args, r0: int, r1: int):
    """The same inputs for rows r0 .. r1 - 1 of the map (a row slab)."""
    z, x, mask, *rest = args
    return (z[:, r0:r1].contiguous(), x[:, r0:r1].contiguous(), mask[:, r0:r1].contiguous(),
            *rest)


def _written_out(z, x, mask, scale, shift, sse_w, sse_b, cse_gate):
    w_eff = (scale * sse_w[None, :]).to(torch.bfloat16)
    s_bias = shift @ sse_w + sse_b[0]
    zf = z.float()
    s = torch.einsum("bhwc,bc->bhw", zf, w_eff.float()) + s_bias[:, None, None]
    gate = cse_gate + torch.sigmoid(s)[..., None]
    y = zf * scale[:, None, None, :] + shift[:, None, None, :]
    return (y * gate + x.float()).to(torch.bfloat16) * mask


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


@pytest.mark.parametrize("batch,l,nres,rows", [
    (1, 8, [8], None),
    (2, 12, [12, 7], None),    # a target shorter than the map
    (2, 12, [12, 7], (3, 8)),  # a slab of 5 rows, across the second target's edge
])
def test_block_tail_on_cpu_is_the_written_out_math(batch, l, nres, rows):
    args = _case(batch, l, nres, seed=l + batch)
    if rows is not None:
        args = _rows(args, *rows)
    before = conv_block.tail_launches
    got = conv_block.block_tail(*args)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert torch.equal(_bits(got), _bits(_written_out(*args)))
    assert conv_block.tail_launches == before


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _ulp_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    d = (got.float() - ref.float()).abs()
    return (d / (BF16_ULP * ref.float().abs().clamp(min=1.0))).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("batch,l,nres", [
    (8, 256, [256, 241, 250, 253, 244, 256, 247, 249]),  # the batch cell's shape
    (1, 736, [720]),                                      # the long cell's
])
def test_block_tail_on_card_within_one_ulp_of_plain(batch, l, nres):
    _require_cuda()
    args = _case(batch, l, nres, device="cuda", seed=l)
    got = conv_block.block_tail(*args)
    ref = conv_block.block_tail_plain(*args)
    torch.cuda.synchronize()
    assert _ulp_err(got, ref) <= 1.0
    assert torch.equal(got * args[2], got)  # padded pixels are zero


@pytest.mark.gpu
def test_block_tail_slab_on_card_is_the_whole_maps_rows():
    """Rows 0-131 and 132-255 of a 256 map (the seq path's two shards, R
    even and odd-sized slabs alike) give the whole-map launch's bits."""
    _require_cuda()
    args = _case(2, 256, [256, 200], device="cuda", seed=1)
    whole = conv_block.block_tail(*args)
    for r0, r1 in ((0, 132), (132, 256), (7, 140)):
        slab = conv_block.block_tail(*_rows(args, r0, r1))
        assert torch.equal(_bits(slab), _bits(whole[:, r0:r1]))


@pytest.mark.gpu
def test_block_tail_fully_masked_target_on_card_is_zero():
    _require_cuda()
    args = _case(3, 64, [0, 40, 64], device="cuda", seed=2)
    got = conv_block.block_tail(*args)
    ref = conv_block.block_tail_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), torch.zeros_like(_bits(got[0])))
    assert _ulp_err(got, ref) <= 1.0


@pytest.mark.gpu
def test_block_tail_on_card_repeats_its_bits_and_counts_launches():
    _require_cuda()
    args = _case(2, 96, [96, 90], device="cuda", seed=3)
    before = conv_block.tail_launches
    first = conv_block.block_tail(*args)
    assert conv_block.tail_launches == before + 1
    second = conv_block.block_tail(*args)
    assert conv_block.tail_launches == before + 2
    assert torch.equal(_bits(first), _bits(second))


@pytest.mark.gpu
def test_block_tail_rejects_bad_input_on_card():
    _require_cuda()
    z, x, mask, scale, shift, sse_w, sse_b, cse_gate = _case(2, 16, [16, 9], device="cuda")
    rest = (sse_w, sse_b, cse_gate)
    half = (z[..., :64].contiguous(), x[..., :64].contiguous(), mask, scale[:, :64].contiguous(),
            shift[:, :64].contiguous(), sse_w[:64].contiguous(), sse_b,
            cse_gate[:64].contiguous())
    with pytest.raises(ValueError, match="128"):
        conv_block.block_tail(*half)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_block.block_tail(z.float(), x, mask, scale, shift, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        conv_block.block_tail(z, x.transpose(1, 2), mask, scale, shift, *rest)
    with pytest.raises(ValueError, match="scale"):
        conv_block.block_tail(z, x, mask, scale[:1].contiguous(), shift, *rest)
