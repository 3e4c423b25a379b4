"""The PyTorch port's bf16 engine against the JAX package: the two trunk
kernels (conv5x5_maxout, gemm_maxout in stats mode), the fused block and
input layer, the bf16 trunk and the bf16 fold.

On the CPU each wrapper runs its kernel's plain version; the JAX side runs the
Pallas kernels in interpret mode, monkeypatched in as
tests/test_pallas_kernels.py does. Tolerances: kernel outputs 0.05 (the JAX
package's own kernel-vs-XLA bound, tests/test_pallas_kernels.py:158-160),
sums and sums of squares rtol 1e-4 (fp32 sums of the same pre-rounding values
in another order), fused block and input layer 0.1 (tests/
test_pallas_kernels.py:351-353).

The ``gpu`` tests run the CUDA kernels against the plain versions on a card;
they decide inside the test whether a card is present and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmpfold2_tpu.kernels.conv_block as jax_cb
from dmpfold2_tpu.models import trunk as jax_trunk
from dmpfold2_tpu.score import tm_score
from dmpfold2_tpu_torch.engine import fold
from dmpfold2_tpu_torch.kernels import conv_block
from dmpfold2_tpu_torch.models import gruresnet, trunk
from dmpfold2_tpu_torch.parallel.sharding import SeqShards
from dmpfold2_tpu_torch.weights import params_from_jax

from test_quality_gate import NRES, NSEQS, TM_FLOOR, _fold as _jax_fold, overfit_setup  # noqa: F401

OUT_TOL = 0.05
STATS_RTOL = 1e-4
FUSED_TOL = 0.1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _oihw(hwio) -> torch.Tensor:
    return _t(hwio).permute(3, 2, 0, 1).contiguous()


def _square_mask(nres, l):
    idx = np.arange(l)
    rows = idx[None, :] < np.asarray(nres)[:, None]
    return (rows[:, :, None] & rows[:, None, :])[..., None].astype(np.float32)


def _interpret(monkeypatch, name):
    orig = getattr(jax_cb, name)
    monkeypatch.setattr(jax_cb, name, lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


# ---------------------------------------------------------------- kernels (plain) vs Pallas

def test_conv_plain_matches_pallas_stats():
    rng = np.random.default_rng(2)
    batch, l, c_in, c_out = 3, 20, 8, 32
    nres = np.asarray([20, 13, 7], np.int32)
    x = (rng.normal(size=(batch, l, l, c_in)) * _square_mask(nres, l)).astype(np.float32)
    w = (rng.normal(size=(5, 5, c_in, c_out)) * 0.1).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    ref, ref_s, ref_ss = jax_cb.conv5x5_maxout(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4,
                                              jnp.asarray(nres), interpret=True, with_stats=True)
    wp, bp = conv_block.pack_conv5x5_weights(_oihw(w), _t(b))
    before = conv_block.conv_launches
    out, s, ss = conv_block.conv5x5_maxout_stats(_t(x).to(torch.bfloat16), wp, bp,
                                                 torch.from_numpy(nres))
    assert conv_block.conv_launches == before  # a CPU tensor runs the plain version
    assert out.dtype == torch.bfloat16 and out.shape == (batch, l, l, c_out // 4)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=OUT_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=STATS_RTOL)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ref_ss), rtol=STATS_RTOL)


def test_gemm_plain_matches_pallas_stats():
    """c_in 19: a K that is not a multiple of either kernel's tile."""
    rng = np.random.default_rng(3)
    batch, l, c_in, c_out = 3, 20, 19, 96
    nres = np.asarray([20, 13, 7], np.int32)
    x = (rng.normal(size=(batch, l, l, c_in)) * _square_mask(nres, l)).astype(np.float32)
    w = (rng.normal(size=(1, 1, c_in, c_out)) * 0.3).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    ref, ref_s, ref_ss = jax_cb.gemm_maxout(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 3,
                                           jnp.asarray(nres), interpret=True, with_stats=True)
    k_pad = conv_block.gemm_k_pad(c_in)
    assert k_pad == 64
    wp, bp = conv_block.pack_gemm_weights(_oihw(w), _t(b), k_pad)
    xp = torch.zeros((batch, l, l, k_pad), dtype=torch.bfloat16)
    xp[..., :c_in] = _t(x)
    before = conv_block.gemm_launches
    out, s, ss = conv_block.gemm_maxout_stats(xp, wp, bp, torch.from_numpy(nres))
    assert conv_block.gemm_launches == before
    assert out.dtype == torch.bfloat16 and out.shape == (batch, l, l, c_out // 3)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=OUT_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=STATS_RTOL)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ref_ss), rtol=STATS_RTOL)


@pytest.mark.parametrize("c_in,c_out", [(8, 32), (128, 512)])
def test_conv_packing_round_trips(c_in, c_out):
    """The kernel's K-major packing: row c, column (dy * 5 + dx) * c_in + ci;
    unpacking gives back the bf16-rounded OIHW weights leaf by leaf."""
    g = torch.Generator().manual_seed(c_in)
    w, b = torch.randn(c_out, c_in, 5, 5, generator=g), torch.randn(c_out, generator=g)
    wp, bp = conv_block.pack_conv5x5_weights(w, b)
    assert wp.shape == (c_out, 25 * c_in) and wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert torch.equal(bp, b)
    assert torch.equal(conv_block.unpack_conv5x5_weights(wp), w.to(torch.bfloat16))
    c, ci, dy, dx = c_out - 3, c_in - 1, 3, 1
    assert wp[c, (dy * 5 + dx) * c_in + ci] == w[c, ci, dy, dx].to(torch.bfloat16)


@pytest.mark.parametrize("c_in,c_out", [(19, 96), (955, 384)])
def test_gemm_packing_round_trips(c_in, c_out):
    """The GEMM kernel's packing: K-major (c_out, k_pad), zero past c_in, rows
    and biases slice-major within each 192-row tile; unpacking gives back the
    bf16-rounded weights and the biases in torch channel order."""
    g = torch.Generator().manual_seed(c_out)
    w, b = torch.randn(c_out, c_in, 1, 1, generator=g), torch.randn(c_out, generator=g)
    k_pad = conv_block.gemm_k_pad(c_in)
    wp, bp = conv_block.pack_gemm_weights(w, b, k_pad)
    assert wp.shape == (c_out, k_pad) and wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert torch.all(wp[:, c_in:] == 0)
    wu, bu = conv_block.unpack_gemm_weights(wp, bp)
    assert torch.equal(wu[:, :c_in], w.reshape(c_out, c_in).to(torch.bfloat16))
    assert torch.equal(bu, b)
    tile, p, grp = c_out // 192 - 1 if c_out >= 192 else 0, 2, 5
    n = min(64, c_out // 3)  # groups in a tile
    row = tile * 192 + p * n + grp
    assert torch.equal(wp[row, :c_in], w[(tile * 64 + grp) * 3 + p, :, 0, 0].to(torch.bfloat16))
    assert bp[row] == b[(tile * 64 + grp) * 3 + p]


def test_conv_kernel_checks_reject_bad_shapes():
    """What the conv kernel takes: (c_out, 3200) K-major weights with c_out a
    multiple of its 256-column tile; the earlier (3200, c_out) layout and a
    128-wide c_out raise before any launch."""
    x = torch.zeros((1, 12, 12, 128), dtype=torch.bfloat16)
    wp, bp = conv_block.pack_conv5x5_weights(torch.zeros(512, 128, 5, 5), torch.zeros(512))
    conv_block._check_conv(x, wp, bp)
    with pytest.raises(ValueError, match="multiple of 256"):
        conv_block._check_conv(x, wp.T.contiguous(), bp)
    with pytest.raises(ValueError, match="multiple of 256"):
        conv_block._check_conv(x, wp[:128].contiguous(), bp[:128].contiguous())
    with pytest.raises(ValueError, match="float32"):
        conv_block._check_conv(x, wp, bp.double())


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_conv_argmax_takes_the_first_slice_on_every_tie(device):
    """Zero weights leave each output at its bias: the 128 groups' biases run
    through every 4-tuple of {0, 1, 2} (all tie patterns across the kernel's
    two lanes of 2 slices). Argmax mode picks torch.max's first maximum and
    outputs its value, on the CPU (plain version) and on a card (kernel)."""
    if device == "cuda":
        _require_cuda()
    vals = torch.cartesian_prod(*[torch.arange(3.0)] * 4)        # (81, 4)
    vals = torch.cat([vals, vals[:128 - len(vals)]])             # (128, 4)
    wp, bp = conv_block.pack_conv5x5_weights(torch.zeros(512, 128, 5, 5), vals.reshape(-1))
    x = torch.randn(1, 20, 20, 128, generator=torch.Generator().manual_seed(0))
    out, idx = conv_block.conv5x5_maxout_argmax(x.to(torch.bfloat16).to(device), wp.to(device),
                                                bp.to(device))
    ref_v, ref_w = vals.max(dim=1)
    assert torch.equal(idx.cpu().long(), ref_w.expand(1, 20, 20, 128))
    assert torch.equal(out.cpu().float(), ref_v.expand(1, 20, 20, 128))


# ---------------------------------------------------------------- fused layers vs JAX

def _jax_block(seed, width):
    """JAX block parameters with gamma and beta away from their init (1, 0),
    so the norm's affine and the constant cSE gate are exercised."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jax_trunk.block_params(jax.random.PRNGKey(seed), width, 5, 1))
    p["maxout"]["gamma"] = (1.0 + 0.3 * rng.normal(size=width)).astype(np.float32)
    p["maxout"]["beta"] = (0.3 * rng.normal(size=width)).astype(np.float32)
    return p


def _port_block(p):
    mx, se = p["maxout"], p["scse"]
    return trunk.pack_block_bf16({
        "maxout": {"w": _oihw(mx["w"]), "b": _t(mx["b"]), "gamma": _t(mx["gamma"]),
                   "beta": _t(mx["beta"])},
        "scse": {"cse_w1": _t(se["cse_w1"]), "cse_w2": _t(se["cse_w2"]),
                 "sse_w": _oihw(se["sse_w"]), "sse_b": _t(se["sse_b"])}})


def test_resnet_block_fused_norm_matches_jax(monkeypatch):
    _interpret(monkeypatch, "conv5x5_maxout")
    rng = np.random.default_rng(11)
    width, batch, l = 16, 2, 16
    nres = np.asarray([16, 10], np.int32)
    mask = _square_mask(nres, l)
    x = jnp.asarray(rng.normal(size=(batch, l, l, width)) * mask, jnp.bfloat16)
    p = _jax_block(4, width)
    ref = np.asarray(jax_trunk._resnet_block_fused_norm(p, x, jnp.asarray(mask)), np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    (ours,) = trunk.resnet_block_fused_norm(
        [_port_block(p)], [xt], [torch.from_numpy(mask).to(torch.bfloat16)],
        [torch.from_numpy(nres)], SeqShards.split([xt.device], l))
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    np.testing.assert_allclose(ours, ref, atol=FUSED_TOL)
    np.testing.assert_array_equal(ours * (1 - mask), 0.0)  # padding stays exactly 0


def test_input_layer_matches_jax(monkeypatch):
    """The fused input layer against maxout2d(fused_conv="norm"), whose gate
    sends a 128-wide group through gemm_maxout_norm."""
    _interpret(monkeypatch, "gemm_maxout_norm")
    rng = np.random.default_rng(23)
    p = jax.tree.map(np.asarray, jax_trunk.maxout_params(jax.random.PRNGKey(0), 19, 128,
                                                         pool=3, ksize=1))
    p["gamma"] = (1.0 + 0.3 * rng.normal(size=128)).astype(np.float32)
    p["beta"] = (0.3 * rng.normal(size=128)).astype(np.float32)
    nres = np.asarray([14, 9], np.int32)
    l = 16
    mask = _square_mask(nres, l)
    x = (rng.normal(size=(2, l, l, 19)) * mask).astype(np.float32)
    ref = jax_trunk.maxout2d(p, jnp.asarray(x), pool=3, mask=jnp.asarray(mask),
                             compute_dtype=jnp.bfloat16, fused_conv="norm")
    k_pad = conv_block.gemm_k_pad(19)
    w, b = conv_block.pack_gemm_weights(_oihw(p["w"]), _t(p["b"]), k_pad)
    xp = torch.zeros((2, l, l, k_pad), dtype=torch.bfloat16)
    xp[..., :19] = _t(x)
    (ours,) = trunk.input_layer_bf16(
        [{"w": w, "b": b, "gamma": _t(p["gamma"]), "beta": _t(p["beta"])}], [xp],
        [torch.from_numpy(mask)], [torch.from_numpy(nres)], SeqShards.split([xp.device], l))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), atol=FUSED_TOL)


# bf16 trunk vs JAX's bf16 trunk at toy width. JAX on the CPU takes the
# unfused bf16 path (its fused kernels are TPU-only and need 128-wide
# groups): it rounds each conv output to bf16 before the bias and the norm,
# where the port's kernels round once after the maxout. Each of the 3 layers
# then differs by a few bf16 ulps (2^-8 relative) of O(1) activations; the
# fp32 head sums 16 of them. 0.1 is the JAX package's own bound between its
# fused and unfused bf16 paths (tests/test_pallas_kernels.py:351-353).
TRUNK_BF16_TOL = 0.1


def test_trunk_apply_bf16_matches_jax():
    rng = np.random.default_rng(5)
    from dmpfold2_tpu.models import gruresnet as jax_gruresnet

    tree = jax.tree.map(np.asarray, jax_gruresnet.init_params(jax.random.PRNGKey(1), width=32,
                                                              cwidth=16, num_blocks=2))
    mx = tree["trunk"]["blocks"]["maxout"]
    mx["gamma"] = (1.0 + 0.3 * rng.normal(size=mx["gamma"].shape)).astype(np.float32)
    mx["beta"] = (0.3 * rng.normal(size=mx["beta"].shape)).astype(np.float32)
    c_in = 32 + 443
    l, nres = 14, np.asarray([14, 9], np.int32)
    mask = _square_mask(nres, l)
    x = (rng.normal(size=(2, l, l, c_in)) * mask).astype(np.float32)
    # a bool mask, as JAX's forward passes it: a float mask would promote the
    # bf16 block carry to fp32
    ref = np.asarray(jax_trunk.trunk_apply(tree["trunk"], jnp.asarray(x), jnp.asarray(mask > 0),
                                           compute_dtype=jnp.bfloat16), np.float32)
    packed = trunk.pack_bf16(params_from_jax(tree)["trunk"])
    xp = torch.zeros((2, l, l, packed.k_pad), dtype=torch.bfloat16)
    xp[..., :c_in] = _t(x)
    ours = trunk.trunk_apply_bf16([packed], [xp], [torch.from_numpy(mask)],
                                  torch.from_numpy(nres))
    assert ours.dtype == torch.float32 and ours.shape == (2, l, l, 2)
    ours = ours.numpy()
    np.testing.assert_allclose(ours, ref, atol=TRUNK_BF16_TOL)
    np.testing.assert_array_equal(ours * (1 - mask), 0.0)


# ---------------------------------------------------------------- the bf16 fold

def _port_fold(params, aln, precision, nloops=2, steps=20, n_pad=None, l_pad=None):
    """The port's fold of an (n, l) alignment through ``fold.fold_padded`` on
    the CPU, optionally padded to (n_pad, l_pad); coords and confs of the
    valid residues."""
    n, l = aln.shape
    aln_p = np.zeros((n_pad or n, l_pad or l), np.int32)
    aln_p[:n, :l] = aln
    dmap = fold._build_dmap_channel(l_pad or l, l, None)
    with torch.inference_mode():
        coords, confs, _ = fold.fold_padded(
            gruresnet.pack_params(params, precision), torch.from_numpy(aln_p), n, l,
            torch.from_numpy(dmap), nloops, steps, precision=precision)
    return coords[:l].numpy(), confs[:l].numpy()


def test_bf16_fold_quality_gate(overfit_setup):  # noqa: F811
    """The slice as a whole: the toy model overfit in JAX (the fixture of
    tests/test_quality_gate.py, 80 steps), carried across, folded at -n 2
    -m 20. The port's bf16 CA trace must reach TM >= 0.75 against JAX's bf16
    forward (with the subspace MDS, as both bf16 engines run it) and against
    the port's own fp32 fold."""
    jax_params, aln = overfit_setup
    params = params_from_jax(jax.tree.map(np.asarray, jax_params))
    ours, _ = _port_fold(params, aln, "bf16")
    port_fp32, _ = _port_fold(params, aln, "fp32")
    jax_bf16 = _jax_fold(jax_params, aln, compute_dtype=jnp.bfloat16, mds_impl="subspace")
    for name, ref in (("JAX bf16", jax_bf16), ("port fp32", port_fp32)):
        score = tm_score(ours[:, 1], ref[:, 1])
        assert score["tm"] >= TM_FLOOR, (f"port bf16 vs {name}: TM {score['tm']:.3f} < "
                                         f"{TM_FLOOR}; RMSD {score['rmsd']:.2f} A")


def test_bf16_fold_padding_invariant(overfit_setup):  # noqa: F811
    """Padded rows and columns change nothing but rounding: the masks keep
    padding out of every statistic, and zero padding is conv-equivalent to
    the true boundary. The plain convs of two map sizes sum in other orders,
    so a few activations round to the other bf16 neighbour; the bound is the
    bf16 engine's, not the fp32 test's."""
    jax_params, aln = overfit_setup
    params = params_from_jax(jax.tree.map(np.asarray, jax_params))
    base_c, base_f = _port_fold(params, aln, "bf16", nloops=1, steps=5)
    pad_c, pad_f = _port_fold(params, aln, "bf16", nloops=1, steps=5, n_pad=NSEQS + 8,
                              l_pad=NRES + 16)
    np.testing.assert_allclose(pad_f, base_f, atol=1e-2)
    assert tm_score(pad_c[:, 1], base_c[:, 1])["tm"] >= 0.95


def test_folder_packs_bf16_weights_once(monkeypatch):
    calls = []
    orig = conv_block.pack_conv5x5_weights
    monkeypatch.setattr(conv_block, "pack_conv5x5_weights",
                        lambda *a: calls.append(1) or orig(*a))
    params = gruresnet.init_params(seed=0, width=16, cwidth=16, num_blocks=3)
    folder = fold.Folder(params, device="cpu", precision="bf16")
    assert len(calls) == 3
    alnmat = np.random.default_rng(0).integers(0, 21, (6, 12)).astype(np.int32)
    for _ in range(2):
        coords, confs = folder.fold(alnmat, iterations=1, minsteps=0)
        assert np.isfinite(coords).all() and np.isfinite(confs).all()
    assert len(calls) == 3


def test_bf16_needs_packed_trunk():
    params = gruresnet.init_params(seed=0, width=16, cwidth=16, num_blocks=1)
    aln = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="pack_params"):
        gruresnet.forward(params, aln, torch.zeros((8, 8, 443)), 4, 8, 0, 0, precision="bf16")


# ---------------------------------------------------------------- on the card

def _ulp_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (2^-7 * max(|ref|, 1)): at most 1 means within one bf16 ulp."""
    o, r = out.float(), ref.float()
    return ((o - r).abs() / (2.0 ** -7 * r.abs().clamp(min=1.0))).max().item()


def _card_case(kind, batch, l, nres, seed):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    if kind == "conv":
        c_in, c_out = 128, 512
        w, b = conv_block.pack_conv5x5_weights(torch.randn(c_out, c_in, 5, 5, generator=g) * 0.02,
                                               torch.randn(c_out, generator=g) * 0.1)
    else:
        c_in, c_out = 955, 384
        w, b = conv_block.pack_gemm_weights(torch.randn(c_out, c_in, 1, 1, generator=g) * 0.03,
                                            torch.randn(c_out, generator=g) * 0.1,
                                            conv_block.gemm_k_pad(c_in))
    x = torch.zeros((batch, l, l, w.shape[1] if kind == "gemm" else c_in))
    x[..., :c_in] = torch.randn(batch, l, l, c_in, generator=g)
    nr = torch.tensor(nres, dtype=torch.int32)
    return (x.to(torch.bfloat16).to(dev), w.to(dev), b.to(dev), nr.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["conv", "gemm"])
@pytest.mark.parametrize("l,nres", [(21, [21, 9]), (32, [5, 32]), (40, [40, 17]),
                                    (352, [350, 352]), (88, [82]), (88, [88, 61, 5])])
def test_kernel_on_card(kind, l, nres):
    """B = len(nres): the main path's B 1, L 88 and ragged batches."""
    _require_cuda()
    args = _card_case(kind, len(nres), l, nres, seed=l)
    kernel = conv_block.conv5x5_maxout_stats if kind == "conv" else conv_block.gemm_maxout_stats
    plain = (conv_block.conv5x5_maxout_stats_plain if kind == "conv"
             else conv_block.gemm_maxout_stats_plain)
    out, s, ss = kernel(*args)
    out2, s2, ss2 = kernel(*args)
    ref, rs, rss = plain(*args)
    torch.cuda.synchronize()
    assert _ulp_err(out, ref) <= 1.0
    torch.testing.assert_close(s, rs, rtol=STATS_RTOL, atol=0.0)
    torch.testing.assert_close(ss, rss, rtol=STATS_RTOL, atol=0.0)
    assert torch.equal(out, out2) and torch.equal(s, s2) and torch.equal(ss, ss2)


@pytest.mark.gpu
def test_conv_block_wrappers_reject_bad_input_on_card():
    _require_cuda()
    x, w, b, nr = _card_case("conv", 2, 12, [12, 4], seed=0)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_block.conv5x5_maxout_stats(x.float(), w, b, nr)
    with pytest.raises(ValueError, match="contiguous"):
        conv_block.conv5x5_maxout_stats(x.transpose(1, 2), w, b, nr)
    with pytest.raises(ValueError, match="128"):
        conv_block.conv5x5_maxout_stats(x[..., :64].contiguous(), w, b, nr)
    with pytest.raises(ValueError, match="multiple of 256"):
        conv_block.conv5x5_maxout_stats(x, w[:128].contiguous(), b[:128].contiguous(), nr)
    x, w, b, nr = _card_case("gemm", 2, 12, [12, 4], seed=0)
    with pytest.raises(ValueError, match="multiple of 64"):
        conv_block.gemm_maxout_stats(x[..., :955].contiguous(), w, b, nr)
    with pytest.raises(ValueError, match="multiple of 192"):
        conv_block.gemm_maxout_stats(x, w[:192 + 96].contiguous(), b[:288].contiguous(), nr)
    with pytest.raises(ValueError, match="w_packed"):  # the earlier (k_pad, c_out) layout
        conv_block.gemm_maxout_stats(x, w.T.contiguous(), b, nr)
