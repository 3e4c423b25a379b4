"""The PyTorch port's differentiable block conv against the JAX package: the
argmax mode of conv5x5_maxout and Conv5x5MaxoutDiff (the counterpart of
``conv5x5_maxout_diff``, bf16 training's trunk conv).

On the CPU the argmax wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode. Tolerances are the JAX package's own for its
kernel and VJP (tests/test_pallas_kernels.py:142-243): outputs 0.05; indices
equal where the top-2 margin exceeds 0.02 (at least 97% of positions);
gradients dx 0.3, dw 0.5, db 0.05 in units of max(|ref|, 1), dx only where no
near-tie touches the receptive field.

The ``gpu`` tests run the CUDA kernel against the plain versions on a card;
they decide inside the test whether a card is present and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dmpfold2_tpu.kernels.conv_block as jax_cb
from dmpfold2_tpu_torch.kernels import conv_block

B, L, C, CO, POOL = 2, 16, 8, 32, 4
MARGIN = 0.02


def _inputs(seed):
    """x (B, L, L, C) bf16-representable, w HWIO, b, cotangent; as numpy."""
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(size=(B, L, L, C)), jnp.bfloat16), np.float32)
    w = (rng.normal(size=(5, 5, C, CO)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(CO,)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(B, L, L, CO // POOL)).astype(np.float32)
    return x, w, b, cot


def _oihw(hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(hwio).permute(3, 2, 0, 1).contiguous()


def _pre_max(x, w, b):
    """fp32 conv of the bf16-rounded operands + bias, grouped: (B, L, L, CO/4, 4)."""
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32), (1, 1),
        ((2, 2), (2, 2)), dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    return np.asarray(ref).reshape(B, L, L, CO // POOL, POOL)


def _margin_ok(x, w, b):
    top2 = np.sort(_pre_max(x, w, b), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > MARGIN


def test_argmax_plain_matches_pallas():
    x, w, b, _ = _inputs(2)
    ref, ref_idx = jax_cb.conv5x5_maxout(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), POOL,
                                         interpret=True, with_argmax=True)
    wp, bp = conv_block.pack_conv5x5_weights(_oihw(w), torch.from_numpy(b))
    before = conv_block.conv_argmax_launches
    out, idx = conv_block.conv5x5_maxout_argmax(torch.from_numpy(x).to(torch.bfloat16), wp, bp)
    assert conv_block.conv_argmax_launches == before  # a CPU tensor runs the plain version
    assert out.dtype == torch.bfloat16 and idx.dtype == torch.int8
    assert out.shape == idx.shape == (B, L, L, CO // POOL)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=0.05)
    clear = _margin_ok(x, w, b)
    assert clear.mean() > 0.97
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(ref_idx)[clear])


def test_argmax_plain_ties_take_the_first_slice():
    """Equal slices (zero weights, equal biases per group) pick slice 0, as
    the kernel's strict > does; the output equals the stats mode's."""
    x = torch.randn(1, 6, 6, C).to(torch.bfloat16)
    w = torch.zeros(CO, C, 5, 5)
    b = torch.arange(CO // POOL, dtype=torch.float32).repeat_interleave(POOL)
    wp, bp = conv_block.pack_conv5x5_weights(w, b)
    out, idx = conv_block.conv5x5_maxout_argmax(x, wp, bp)
    assert (idx == 0).all()
    stats_out = conv_block.conv5x5_maxout_stats(x, wp, bp, torch.tensor([6], dtype=torch.int32))[0]
    assert torch.equal(out, stats_out)


def test_diff_grads_match_jax_vjp():
    x, w, b, cot = _inputs(4)

    def jax_loss(x_, w_, b_):
        out = jax_cb.conv5x5_maxout_diff(x_, w_, b_, POOL, True)  # interpret mode
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.grad(jax_loss, (0, 1, 2))(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                         jnp.asarray(b))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = _oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = conv_block.conv5x5_maxout_diff(xt, wt, bt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == bt.grad.dtype == torch.float32

    dw_want = np.asarray(want[1]).transpose(3, 2, 0, 1)
    for name, got, ref, tol in (("dw", wt.grad.numpy(), dw_want, 0.5),
                                ("db", bt.grad.numpy(), np.asarray(want[2]), 0.05)):
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(got / scale, ref / scale, atol=tol / scale, err_msg=name)
    # dx where no near-tie touches the 5 x 5 receptive field
    bad = np.pad(~_margin_ok(x, w, b).all(axis=-1), ((0, 0), (2, 2), (2, 2)))
    near = np.zeros((B, L, L), bool)
    for dy in range(5):
        for dx in range(5):
            near |= bad[:, dy:dy + L, dx:dx + L]
    dx_ref = np.asarray(want[0], np.float32)
    scale = max(np.abs(dx_ref).max(), 1.0)
    np.testing.assert_allclose(xt.grad.float().numpy()[~near] / scale, dx_ref[~near] / scale,
                               atol=0.3 / scale)


def test_diff_grads_match_autograd_of_plain():
    """Routed by the same index, the hand-written backward is autograd through
    the plain conv + maxout (a bf16-exact cotangent, so both see the same
    numbers): dx within one bf16 rounding, dw and db fp32 sums in another
    order."""
    x, w, b, cot = _inputs(6)
    clear = torch.from_numpy(_margin_ok(x, w, b))
    g = (torch.from_numpy(cot) * clear).to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt, bt = _oihw(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = torch.autograd.grad(conv_block.Conv5x5MaxoutDiff.apply(xt, wt, bt), (xt, wt, bt), g)
    # w rounded to bf16 before it becomes a leaf: autograd through a cast to
    # bf16 would round the reference's dw to bf16 too
    xr = torch.from_numpy(x).requires_grad_()
    wr = _oihw(w).to(torch.bfloat16).float().requires_grad_()
    br = torch.from_numpy(b).requires_grad_()
    y = F.conv2d(xr.permute(0, 3, 1, 2), wr, br, padding=2)
    y = y.permute(0, 2, 3, 1).reshape(B, L, L, CO // POOL, POOL).amax(dim=-1)
    want = torch.autograd.grad(y, (xr, wr, br), g.float())
    for name, a, r, rtol in zip("xwb", got, want, (2.0 ** -7, 1e-4, 1e-4)):
        err = ((a.float() - r).abs() / r.abs().clamp(min=1.0)).max().item()
        assert err <= rtol, f"d{name}: {err:.3g} > {rtol:.3g}"


def test_diff_primal_identical_with_and_without_grad():
    x, w, b, _ = _inputs(5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt, bt = _oihw(w), torch.from_numpy(b)
    with torch.no_grad():
        plain = conv_block.conv5x5_maxout_diff(xt, wt, bt)
    graded = conv_block.conv5x5_maxout_diff(xt, wt.requires_grad_(), bt.requires_grad_())
    assert graded.requires_grad and not plain.requires_grad
    assert torch.equal(plain, graded.detach())


# ---------------------------------------------------------------- on the card

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _card_case(batch, l, seed):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(512, 128, 5, 5, generator=g) * 0.02
    b = torch.randn(512, generator=g) * 0.1
    x = torch.randn(batch, l, l, 128, generator=g).to(torch.bfloat16)
    return x.to(dev), w.to(dev), b.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [21, 32, 40])
def test_argmax_kernel_on_card(l):
    _require_cuda()
    x, w, b = _card_case(2, l, seed=l)
    wp, bp = conv_block.pack_conv5x5_weights(w, b)
    before = conv_block.conv_argmax_launches
    out, idx = conv_block.conv5x5_maxout_argmax(x, wp, bp)
    out2, idx2 = conv_block.conv5x5_maxout_argmax(x, wp, bp)
    assert conv_block.conv_argmax_launches == before + 2
    stats_out = conv_block.conv5x5_maxout_stats(x, wp, bp, torch.tensor(
        [l, l], dtype=torch.int32, device=x.device))[0]
    ref, _ = conv_block.conv5x5_maxout_argmax_plain(x, wp, bp)
    torch.cuda.synchronize()
    assert torch.equal(out, stats_out) and torch.equal(out, out2) and torch.equal(idx, idx2)
    err = ((out.float() - ref.float()).abs() / (2.0 ** -7 * ref.float().abs().clamp(min=1.0)))
    assert err.max().item() <= 1.0
    # every index names a slice within one bf16 ulp of the plain maximum
    wf = conv_block.unpack_conv5x5_weights(wp.float())
    pre = F.conv2d(x.float().permute(0, 3, 1, 2), wf, bp, padding=2).permute(0, 2, 3, 1)
    pre = pre.reshape(2, l, l, 128, 4)
    top = pre.amax(dim=-1)
    gap = top - pre.gather(-1, idx.long().unsqueeze(-1))[..., 0]
    assert (gap <= 2.0 ** -7 * top.abs().clamp(min=1.0)).all()


@pytest.mark.gpu
def test_diff_backward_on_card():
    _require_cuda()
    x, w, b = _card_case(1, 24, seed=3)
    g = torch.randn(1, 24, 24, 128, device=x.device).to(torch.bfloat16)
    xt, wt, bt = (t.clone().requires_grad_() for t in (x, w, b))
    got = torch.autograd.grad(conv_block.Conv5x5MaxoutDiff.apply(xt, wt, bt), (xt, wt, bt), g)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    assert all(torch.isfinite(t).all() for t in got)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_block.conv5x5_maxout_argmax(x.float(), *conv_block.pack_conv5x5_weights(w, b))
