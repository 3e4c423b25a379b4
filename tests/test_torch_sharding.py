"""Residue-axis (seq) sharding in the PyTorch port (``parallel/sharding.py``
and its users), on the CPU: the counterpart of tests/test_sharding.py.

Toy widths 32/16/2, as tests/test_sharding.py. Shards are ``["cpu"] * n``:
the same code as on cards, with every cross-device copy a no-op. Held:

  (a) the sharding functions, and the kernels' slab plain versions (conv
      stats and argmax, the GEMM, ``Conv5x5MaxoutDiff``'s gradients through
      the halo exchange) against the square plain versions' rows and sums,
      over 2 and 3 shards (one uneven); mutation checks: the halo's
      gradient cut at the exchange, and the slab backward's dw read with the
      halo rows zeroed or with the square map's row padding, must fail;
  (b) the seq-sharded ``Folder`` against JAX's ``Folder.fold`` under a
      ``1 x 4`` mesh with ``pair_sharding("seq")`` (tests/test_sharding.py's
      inputs and bounds: confidences 1e-4, coordinates 5e-3), then against
      the port's unsharded fold (fp32: confidences 1e-5, CA 1e-4 A; bf16:
      phase cpu's bounds, confidence 0.025 and trunk channels 17 x 2^-8 of
      their scale);
  (c) ``train_step`` on a ``1 x 2`` mesh against the unsharded step,
      refinement off: loss 1e-5 relative, each gradient within 2e-5 of the
      largest or, where more, within twice as far as a witness moves it: the
      unsharded step with the head's bias and the first block's conv
      weights moved by one fp32 ulp, or run on another number of CPU threads
      (the same function, other summation orders). Only the input layer's
      weight gradient, the largest, needs the witness: another thread count
      alone moves it by 6.6e-5 of the scale. (With refinement on, one-ulp
      moves of a weight move some gradients by up to 7e-3 of the scale, too
      loose a bound to catch a fault.) Mutation checks: the halo's gradient
      cut at the exchange, and dropout drawn per shard instead of at the
      global shape, must fail. The batch loss against JAX's under a ``4 x
      2`` mesh with ``pair_sharding("seq")`` (tests/test_sharding.py:72-80:
      loss rtol 1e-4, parameters after one Adam step 3e-3) and its
      gradients within 1e-3 of the largest of JAX's unsharded ones
      (tests/test_torch_train.py's bound) or, where more, twice the port's
      unsharded gradient's distance from them (at L 32 that reaches 2.3e-3
      on the input layer). JAX's seq-sharded gradient of the block conv
      weights comes out n_data times its unsharded one (4x on the 4 x 2
      mesh, held by a test), which Adam's first step hides, so the port's
      gradients are held to JAX's unsharded ones. And the training loop
      with ``--mesh 1x2``;
  (d) ``BatchFolder`` over a ``2 x 2`` mesh against the mesh-less batch
      (tests/test_torch_stream.py's tolerances).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dmpfold2_tpu.engine.fold import Folder as JaxFolder
from dmpfold2_tpu.models import gruresnet as jax_gruresnet
from dmpfold2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmpfold2_tpu.parallel.sharding import pair_sharding
from dmpfold2_tpu.train import step as jax_step
from dmpfold2_tpu_torch.engine.fold import Folder
from dmpfold2_tpu_torch.kernels import conv_block
from dmpfold2_tpu_torch.models import gruresnet, trunk
from dmpfold2_tpu_torch.ops import dropout as dropout_mod
from dmpfold2_tpu_torch.parallel import sharding
from dmpfold2_tpu_torch.parallel.mesh import make_mesh
from dmpfold2_tpu_torch.parallel.sharding import (SeqShards, exchange_halo, gather_rows,
                                                  reduce_sum, row_splits, scatter_rows)
from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target
from dmpfold2_tpu_torch.train import step
from dmpfold2_tpu_torch.weights import params_from_jax

CPU = torch.device("cpu")


def _cpu_seq(n: int, l_pad: int) -> SeqShards:
    return SeqShards.split([CPU] * n, l_pad)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jax_gruresnet.init_params(
        jax.random.PRNGKey(0), width=32, cwidth=16, num_blocks=2))


# ---------------------------------------------------------------- (a) the pieces

def test_row_splits():
    assert row_splits(88, 2) == (0, 48, 88)
    assert row_splits(88, 3) == (0, 32, 64, 88)
    assert row_splits(256, 2) == (0, 128, 256)
    assert row_splits(256, 3) == (0, 96, 192, 256)
    assert row_splits(24, 3) == (0, 16, 24)  # too short for a third shard
    assert row_splits(40, 1) == (0, 40)
    for l_pad in range(1, 200, 7):
        for n in (1, 2, 3, 4):
            b = row_splits(l_pad, n)
            assert b[0] == 0 and b[-1] == l_pad and len(b) <= n + 1
            assert all(r % 16 == 0 for r in b[:-1]) and all(x < y for x, y in zip(b, b[1:]))
    seq = SeqShards.split(["cpu"] * 3, 24)
    assert seq.n == 2 and seq.devices == (CPU, CPU) and seq.rows(1) == slice(16, 24)
    with pytest.raises(ValueError):
        row_splits(0, 2)


@pytest.mark.parametrize("sizes", [(32, 8), (16, 16, 8), (16, 1, 7)])
def test_exchange_gather_reduce(sizes):
    """The halo of each shard is the zero-padded map's rows around it, also
    when a neighbour holds fewer rows than the halo; gather undoes scatter;
    reduce_sum is the sum in shard order on every shard."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, sum(sizes), 5, 3)).astype(np.float32))
    bounds = tuple(np.cumsum((0,) + sizes).tolist())
    seq = SeqShards((CPU,) * len(sizes), bounds)
    parts = scatter_rows(seq, x)
    assert [p.shape[1] for p in parts] == list(sizes)
    torch.testing.assert_close(gather_rows(parts), x, rtol=0, atol=0)
    padded = F.pad(x, (0, 0, 0, 0, 2, 2))
    for k, slab in enumerate(exchange_halo(parts, 2)):
        torch.testing.assert_close(slab, padded[:, bounds[k]:bounds[k + 1] + 4], rtol=0, atol=0)
    vals = [torch.full((2, 3), float(k + 1)) for k in range(len(sizes))]
    for total in reduce_sum(vals):
        torch.testing.assert_close(total, sum(vals), rtol=0, atol=0)


def _toy_conv(rng, c_out=32):
    w = torch.from_numpy(rng.normal(size=(c_out, 16, 5, 5)).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.normal(size=(c_out,)).astype(np.float32) * 0.1)
    return w, b


def _bf16_close(got, want, ulps=1):
    """Within ``ulps`` bf16 steps of ``want``'s magnitude (2^-8 relative each)."""
    tol = ulps * 2.0 ** -8 * want.float().abs() + 1e-6
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("n_seq", [2, 3])
def test_slab_plain_versions_match_square(n_seq):
    """conv stats / argmax and the GEMM in slab form, joined over the
    shards: the square plain versions' rows, and (stats) their sums."""
    rng = np.random.default_rng(2)
    l_pad, nres = 40, torch.tensor([37, 29], dtype=torch.int32)
    seq = _cpu_seq(n_seq, l_pad)
    x = torch.from_numpy(rng.normal(size=(2, l_pad, l_pad, 16)).astype(np.float32))
    x = x.to(torch.bfloat16)
    wp, bp = conv_block.pack_conv5x5_weights(*_toy_conv(rng))
    slabs = exchange_halo(scatter_rows(seq, x), conv_block.HALO)

    ref, ref_s, ref_ss = conv_block.conv5x5_maxout_stats_plain(x, wp, bp, nres)
    got = [conv_block.conv5x5_maxout_partials(s, wp, bp, nres, r0, slab=True)
           for s, r0 in zip(slabs, seq.bounds)]
    _bf16_close(gather_rows([o for o, _ in got]), ref)
    sums = torch.cat([p for _, p in got], dim=1).sum(dim=1)
    torch.testing.assert_close(sums[:, 0], ref_s, rtol=1e-4, atol=1e-4 * float(ref_s.abs().max()))
    torch.testing.assert_close(sums[:, 1], ref_ss, rtol=1e-4, atol=0.0)

    ref_v, ref_i = conv_block.conv5x5_maxout_argmax_plain(x, wp, bp)
    got = [conv_block.conv5x5_maxout_argmax(s, wp, bp, slab=True) for s in slabs]
    _bf16_close(gather_rows([v for v, _ in got]), ref_v)
    assert float((gather_rows([i for _, i in got]) == ref_i).float().mean()) > 0.999

    k_pad = 64
    xg = torch.from_numpy(rng.normal(size=(2, l_pad, l_pad, k_pad)).astype(np.float32))
    xg = xg.to(torch.bfloat16)
    wg = torch.from_numpy(rng.normal(size=(192, 50, 1, 1)).astype(np.float32) * 0.1)
    bg = torch.from_numpy(rng.normal(size=(192,)).astype(np.float32) * 0.1)
    wgp, bgp = conv_block.pack_gemm_weights(wg, bg, k_pad)
    xg[..., 50:] = 0
    ref, ref_s, ref_ss = conv_block.gemm_maxout_stats_plain(xg, wgp, bgp, nres)
    got = [conv_block.gemm_maxout_partials(p, wgp, bgp, nres, r0)
           for p, r0 in zip(scatter_rows(seq, xg), seq.bounds)]
    _bf16_close(gather_rows([o for o, _ in got]), ref)
    sums = torch.cat([p for _, p in got], dim=1).sum(dim=1)
    torch.testing.assert_close(sums[:, 0], ref_s, rtol=1e-4, atol=1e-4 * float(ref_s.abs().max()))
    torch.testing.assert_close(sums[:, 1], ref_ss, rtol=1e-4, atol=0.0)


def _conv_diff_grads(n_seq: int, sharded: bool):
    """Conv5x5MaxoutDiff on a seeded L 40 map, whole or as slabs through the
    halo exchange (``sharding.exchange_halo``): (y, dx, dw, db)."""
    rng = np.random.default_rng(3)
    l_pad = 40
    x0 = torch.from_numpy(rng.normal(size=(2, l_pad, l_pad, 16)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, l_pad, l_pad, 8)).astype(np.float32))
    w0, b0 = _toy_conv(rng)
    x = x0.to(torch.bfloat16).requires_grad_()
    w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
    if sharded:
        seq = _cpu_seq(n_seq, l_pad)
        slabs = sharding.exchange_halo(scatter_rows(seq, x), conv_block.HALO)
        y = gather_rows([conv_block.Conv5x5MaxoutDiff.apply(s, w, b, True) for s in slabs])
    else:
        y = conv_block.Conv5x5MaxoutDiff.apply(x, w, b)
    (y.float() * g).sum().backward()
    return y, x.grad, w.grad, b.grad


def _assert_conv_diff_close(got, want):
    _bf16_close(got[0], want[0])
    scale = float(want[1].float().abs().max())
    # a halo row's dx is two bf16 terms (its own slab's, the neighbour's) summed
    torch.testing.assert_close(got[1].float(), want[1].float(), rtol=0, atol=2.0 ** -7 * scale)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("n_seq", [2, 3])
def test_conv_diff_slab_gradients_match_square(n_seq):
    """Conv5x5MaxoutDiff on slabs through the halo exchange: the square
    Function's output, and its dx (the halo's share carried back to the
    neighbour's rows by autograd), dw and db."""
    _assert_conv_diff_close(_conv_diff_grads(n_seq, True), _conv_diff_grads(n_seq, False))


def _halo_detached(parts, halo, axis=1):
    """A faulty exchange: the neighbours' rows cut from autograd, so the
    halo's share of a conv's input gradient never returns to them."""
    slabs = exchange_halo(parts, halo, axis)
    return [torch.cat([s.narrow(axis, 0, halo).detach(), p,
                       s.narrow(axis, s.shape[axis] - halo, halo).detach()], dim=axis)
            for s, p in zip(slabs, parts)]


def _dw_mutant(saved):
    """A faulty slab backward: dw from ``saved(x)`` in place of the slab x,
    with the square map's row padding when ``saved`` is None."""
    real = conv_block.Conv5x5MaxoutDiff.backward

    def backward(ctx, g):
        dx, _, db, none = real(ctx, g)
        x, w, b, index = ctx.saved_tensors
        fake = SimpleNamespace(saved_tensors=(x if saved is None else saved(x), w, b, index),
                               slab=ctx.slab and saved is not None,
                               needs_input_grad=(False, True, False, False))
        return dx, real(fake, g)[1], db, none

    return staticmethod(backward)


def _zero_halo(x):
    x = x.clone()
    x[:, :conv_block.HALO] = 0
    x[:, -conv_block.HALO:] = 0
    return x


@pytest.mark.parametrize("fault", ["halo detached", "dw halo zero", "dw square padding"])
def test_conv_diff_slab_faults_fail(fault, monkeypatch):
    """Mutation checks of the slab backward: each fault must part from the
    square Function's gradients."""
    want = _conv_diff_grads(2, False)
    if fault == "halo detached":
        monkeypatch.setattr(sharding, "exchange_halo", _halo_detached)
    else:
        monkeypatch.setattr(conv_block.Conv5x5MaxoutDiff, "backward",
                            _dw_mutant(_zero_halo if fault == "dw halo zero" else None))
    with pytest.raises(AssertionError):
        _assert_conv_diff_close(_conv_diff_grads(2, True), want)


# ---------------------------------------------------------------- (b) the fold

@pytest.fixture(scope="module")
def fold_inputs(tree):
    """tests/test_sharding.py:90-112: its toy model, alignment rng(0) 10 x
    40, and JAX's seq-sharded fold of it (iterations 0, minsteps 3)."""
    alnmat = np.random.default_rng(0).integers(0, 21, (10, 40)).astype(np.uint8)
    folder = JaxFolder(jax.tree.map(jnp.asarray, tree))
    with jax.set_mesh(jax_make_mesh(1, 4, devices=jax.devices()[:4])), pair_sharding("seq"):
        ref_c, ref_f = folder.fold(alnmat, iterations=0, minsteps=3)
    return alnmat, np.asarray(ref_c), np.asarray(ref_f)


@pytest.mark.parametrize("n_seq", [2, 3])
def test_seq_fold_matches_jax_seq_fold(tree, fold_inputs, n_seq):
    alnmat, ref_c, ref_f = fold_inputs
    params = params_from_jax(tree)
    folder = Folder(params, mesh=make_mesh(1, n_seq, devices=["cpu"] * n_seq))
    assert folder.device == CPU and len(folder.seq_row) == n_seq
    coords, confs = folder.fold(alnmat, iterations=0, minsteps=3)
    np.testing.assert_allclose(confs, ref_f, atol=1e-4)
    np.testing.assert_allclose(coords, ref_c, atol=5e-3)
    base_c, base_f = Folder(params, device="cpu").fold(alnmat, iterations=0, minsteps=3)
    np.testing.assert_allclose(confs, base_f, atol=1e-5)
    np.testing.assert_allclose(coords[:, 1], base_c[:, 1], atol=1e-4)


@pytest.mark.parametrize("n_seq", [2, 3])
def test_seq_bf16_matches_unsharded_bf16(tree, fold_inputs, n_seq):
    """bf16: the sharded trunk's channels within 17 x 2^-8 of their scale of
    the unsharded trunk's on the same input (phase cpu's bound), and the
    fold's confidences within 0.025."""
    alnmat = fold_inputs[0]
    params = params_from_jax(tree)
    mesh = make_mesh(1, n_seq, devices=["cpu"] * n_seq)
    base_c, base_f = Folder(params, device="cpu", precision="bf16").fold(
        alnmat, iterations=1, minsteps=3)
    coords, confs = Folder(params, mesh=mesh, precision="bf16").fold(alnmat, iterations=1,
                                                                    minsteps=3)
    np.testing.assert_allclose(confs, base_f, atol=0.025)
    assert np.isfinite(coords).all() and coords.shape == base_c.shape

    rng = np.random.default_rng(4)
    packed = trunk.pack_bf16(params["trunk"])
    l_pad, nres = 40, torch.tensor([40, 33], dtype=torch.int32)
    c_in = params["trunk"]["input"]["w"].shape[1]
    x = torch.zeros((2, l_pad, l_pad, packed.k_pad), dtype=torch.bfloat16)
    x[..., :c_in] = torch.from_numpy(rng.normal(size=(2, l_pad, l_pad, c_in)).astype(np.float32))
    row = (torch.arange(l_pad)[None] < nres[:, None]).float()
    mask = (row[:, :, None] * row[:, None, :])[..., None]
    x = x * mask.to(torch.bfloat16)
    want = trunk.trunk_apply_bf16([packed], [x], [mask], nres)
    seq = _cpu_seq(n_seq, l_pad)
    got = trunk.trunk_apply_bf16([packed] * seq.n, scatter_rows(seq, x), scatter_rows(seq, mask),
                                 nres, seq)
    for c in range(2):
        scale = float(want[..., c].abs().max())
        torch.testing.assert_close(got[..., c], want[..., c], rtol=0, atol=17 * 2.0 ** -8 * scale)


def test_folder_mesh_errors(tree):
    params = params_from_jax(tree)
    with pytest.raises(ValueError, match="device or a mesh"):
        Folder(params, device="cpu", mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="one row"):
        Folder(params, mesh=make_mesh(2, 2, devices=["cpu"] * 4))


# ---------------------------------------------------------------- (c) training

B, N, L = 2, 6, 24
NLOOPS, REFINE = 1, 0


def _batch(b=B, n=N, l_pad=L, seed=5):
    rng = np.random.default_rng(seed)
    return step.TrainBatch(alnmat=rng.integers(0, 22, (b, n, l_pad)).astype(np.int32),
                           targets=(rng.normal(size=(b, l_pad, 5, 3)) * 4).astype(np.float32),
                           nseqs=np.full((b,), n, np.int32),
                           nres=np.asarray([l_pad, l_pad - 5][:b] + [l_pad] * (b - 2), np.int32))


def _trainable(tree, witness=False):
    """The toy model's trainable parameters; ``witness``: the head's bias
    and the first block's conv weights moved up by one fp32 ulp."""
    params = step.trainable(params_from_jax(tree), "cpu")
    if witness:
        with torch.no_grad():
            for t in (params["trunk"]["out_b"], params["trunk"]["blocks"][0]["maxout"]["w"]):
                t.copy_(torch.nextafter(t, torch.tensor(np.inf)))
    return params


def _other_threads(fn):
    """``fn()`` on another number of CPU threads than the current one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1 if n > 1 else 2)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def _step_grads(tree, mesh=None, witness=False):
    """One train_step (dropout on) from the toy model (``_trainable``):
    (metrics, the gradients handed to Adam)."""
    params = _trainable(tree, witness)
    opt = step.make_optimizer(params, 1e-3)
    seen, real = [], step.Optimizer.update

    def update(self, g):
        seen.append([x.detach().clone() for x in g])
        return real(self, g)

    step.Optimizer.update = update
    try:
        metrics = step.train_step(params, opt, _batch(), seed=3, nloops=NLOOPS,
                                  refine_steps=REFINE, mesh=mesh)
    finally:
        step.Optimizer.update = real
    return metrics, seen[0]


def _assert_same_grads(got, want, witnesses, floor=2e-5):
    """Each gradient within ``floor`` of the largest, or within twice the
    farthest witness's distance from ``want`` where that is more."""
    scale = max(float(g.abs().max()) for g in want)
    for i, (a, b) in enumerate(zip(got, want)):
        moved = max(float((w[i] - b).abs().max()) for w in witnesses)
        torch.testing.assert_close(a, b, rtol=0, atol=max(floor * scale, 2 * moved))


@pytest.fixture(scope="module")
def unsharded_step(tree):
    """The unsharded step and its two witnesses' gradients."""
    return _step_grads(tree), [_step_grads(tree, witness=True)[1],
                               _other_threads(lambda: _step_grads(tree))[1]]


def _assert_same_step(got, unsharded):
    (want_m, want_g), witnesses = unsharded
    np.testing.assert_allclose(got[0]["loss"], want_m["loss"], rtol=1e-5)
    _assert_same_grads(got[1], want_g, witnesses)


def test_seq_train_step_matches_unsharded(tree, unsharded_step):
    _assert_same_step(_step_grads(tree, make_mesh(1, 2, devices=["cpu"] * 2)), unsharded_step)


def test_seq_dropout_drawn_per_shard_fails(tree, unsharded_step, monkeypatch):
    """Mutation check: each shard drawing its dropout at its own shape (not
    its rows of the global draw) must part from the unsharded step."""
    real = dropout_mod.keep_mask

    def per_shard(seed, shape, rate, device, shard=None, batch_axis=0, rows=None):
        return real(seed, shape, rate, device, shard, batch_axis)

    monkeypatch.setattr(dropout_mod, "keep_mask", per_shard)
    with pytest.raises(AssertionError):
        _assert_same_step(_step_grads(tree, make_mesh(1, 2, devices=["cpu"] * 2)),
                          unsharded_step)


def test_seq_halo_gradient_cut_fails(tree, unsharded_step, monkeypatch):
    """Mutation check: a halo exchange that cuts the neighbours' rows from
    autograd must part from the unsharded step."""
    monkeypatch.setattr(trunk, "exchange_halo", _halo_detached)
    with pytest.raises(AssertionError):
        _assert_same_step(_step_grads(tree, make_mesh(1, 2, devices=["cpu"] * 2)),
                          unsharded_step)


@pytest.mark.parametrize("remat", [False, True, "save_conv", "recycle"])
def test_seq_batch_loss_remat_tiers_match_unsharded(tree, remat):
    """The sharded batch loss with dropout, under each remat tier
    (checkpointing a block across every shard), against the unsharded;
    refinement off (module docstring, (c))."""
    batch = _batch()
    draws = [step.draw_prep(s, L) for s in (11, 12)]

    def grads(seq, witness=False):
        params = _trainable(tree, witness)
        loss, _ = step.batch_loss_native(
            params, torch.from_numpy(batch.alnmat), torch.from_numpy(batch.targets),
            batch.nseqs, batch.nres, draws, nloops=NLOOPS, refine_steps=0,
            dropout_seed=9, remat=remat if seq is not None else False, seq=seq)
        return float(loss), torch.autograd.grad(loss, step.leaves(params))

    want, got = grads(None), grads(_cpu_seq(2, L))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    _assert_same_grads(got[1], want[1], [grads(None, witness=True)[1],
                                         _other_threads(lambda: grads(None))[1]])


@pytest.fixture(scope="module")
def jax_seq_step(tree):
    """tests/test_sharding.py's batch construction (4 x 6, rng 0) at L 32,
    dropout off: JAX's batch loss and gradients on its 4 x 2 mesh with
    pair_sharding("seq"), and its unsharded gradients."""
    rng = np.random.default_rng(0)
    b, n, l_pad = 4, 6, 32
    alnmat = rng.integers(0, 22, (b, n, l_pad)).astype(np.int32)
    targets = (rng.normal(size=(b, l_pad, 5, 3)) * 4).astype(np.float32)
    nseqs, nres = np.full((b,), n, np.int32), np.full((b,), l_pad, np.int32)
    rngs = jax.random.split(jax.random.PRNGKey(7), b)

    def jax_fn(p):
        return jax_step.batch_loss_native(
            p, jax_step.TrainBatch(alnmat, targets, nseqs, nres), rngs, nloops=1,
            refine_steps=2, dropout=False, remat=False)[0]

    with jax.set_mesh(jax_make_mesh(4, 2)), pair_sharding("seq"):
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_fn))(tree)
    plain_grads = jax.jit(jax.grad(jax_fn))(tree)
    return SimpleNamespace(alnmat=alnmat, targets=targets, nseqs=nseqs, nres=nres, rngs=rngs,
                           loss=ref_loss, grads=ref_grads, plain_grads=plain_grads)


def test_jax_seq_step_scales_block_conv_grads_by_data_axis(tree, jax_seq_step):
    """Why the port's seq-sharded gradients are held to JAX's unsharded ones:
    JAX's seq-sharded step returns the block conv weights' gradient 4x (the
    4 x 2 mesh's data axis) its unsharded one, and every other nonzero
    gradient 1x (within 1%)."""
    seq_leaves = step.leaves(params_from_jax(jax.tree.map(np.asarray, jax_seq_step.grads)))
    plain = params_from_jax(jax.tree.map(np.asarray, jax_seq_step.plain_grads))
    conv_w = {id(b["maxout"]["w"]) for b in plain["trunk"]["blocks"]}
    for got, want in zip(seq_leaves, step.leaves(plain)):
        total = float(want.abs().sum())
        if total == 0.0:
            continue
        ratio = float(got.abs().sum()) / total
        np.testing.assert_allclose(ratio, 4.0 if id(want) in conv_w else 1.0, rtol=1e-2)


def test_seq_batch_loss_matches_jax_seq(tree, jax_seq_step):
    """JAX's step of ``jax_seq_step`` against the port's on its 1 x 2 CPU
    mesh (at L 32 two shards of 16), JAX's teacher-forcing draws: the loss
    and one Adam step against JAX's seq-sharded step, the gradients against
    JAX's unsharded ones."""
    j = jax_seq_step
    alnmat, targets, nseqs, nres, rngs = j.alnmat, j.targets, j.nseqs, j.nres, j.rngs
    l_pad = alnmat.shape[2]
    ref_loss, ref_grads, plain_grads = j.loss, j.grads, j.plain_grads
    draws = []
    for r in rngs:
        r_tf, r_noise, _ = jax.random.split(r, 3)
        draws.append((bool(jax.random.bernoulli(r_tf, 0.5)),
                      torch.from_numpy(np.array(jax.random.normal(r_noise, (l_pad, 3))))))
    def port(seq):
        params = step.trainable(params_from_jax(tree), "cpu")
        loss, _ = step.batch_loss_native(params, torch.from_numpy(alnmat),
                                         torch.from_numpy(targets), nseqs, nres, draws,
                                         nloops=1, refine_steps=2, remat=False, seq=seq)
        return params, float(loss), torch.autograd.grad(loss, step.leaves(params))

    params, loss, grads = port(_cpu_seq(2, l_pad))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-4)
    ref_leaves = step.leaves(params_from_jax(jax.tree.map(np.asarray, plain_grads)))
    _assert_same_grads(grads, ref_leaves, [port(None)[2]], floor=1e-3)
    # one Adam step each (tests/test_sharding.py's optimizer, lr 1e-3)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(ref_grads, opt.init(tree), tree)
    ref_after = step.leaves(params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(
        tree, updates))))
    step.make_optimizer(params, 1e-3).update([g.clone() for g in grads])
    for got, want in zip(step.leaves(params), ref_after):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=3e-3)


def test_train_step_seq_mesh_checks_the_device(tree):
    params = step.trainable(params_from_jax(tree), "cpu")
    mesh = make_mesh(1, 2, devices=["meta", "cpu"])
    with pytest.raises(ValueError, match="first device"):
        step.train_step(params, step.make_optimizer(params), _batch(), seed=0, nloops=0,
                        refine_steps=0, mesh=mesh)


def test_loop_mesh_1x2_matches_unsharded(tmp_path, monkeypatch, capsys):
    """The training loop's CLI with ``--mesh 1x2 -d cpu`` (one process, the
    trunk split over two CPU shards) against the loop without a mesh: the
    epoch's train and validation losses within 1e-5 relative; the
    parameters after its two Adam steps (learning rate 3e-4) 99% within 1e-5
    and all within 2 x 2 x 3e-4: Adam moves a weight by about the learning
    rate whatever its gradient, so where a gradient is at the rounding floor
    two sum orders can move it apart by twice that a step."""
    from dmpfold2_tpu_torch.train import checkpoint as ckpt
    from dmpfold2_tpu_torch.train import dataset, loop
    from dmpfold2_tpu_torch.weights import load_npz

    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for sub in ("tdb", "aln"):
        (data / sub).mkdir(parents=True)
    letters = "ARNDCQEGHILKMFPSTWYV-"
    for k, length in enumerate((20, 26, 40)):
        with open(data / "tdb" / f"t{k}.tdb", "w") as fh:
            fh.write("# synthetic tdb\n")
            for atoms in rng.normal(size=(length, 5, 3)) * 5:
                fh.write(" " * 5 + "A" + " " * 33 + "".join(f"{v:9.3f}" for v in atoms.ravel())
                         + "\n")
        rows = ["".join(letters[i] for i in rng.integers(0, 21, length)) for _ in range(8)]
        (data / "aln" / f"t{k}.aln").write_text("\n".join(rows) + "\n")
    (data / "clusters.lst").write_text("t0\nt1\nt2\n")
    monkeypatch.setattr(loop, "load_cluster_list",
                        lambda path: dataset.load_cluster_list(path, validation_clusters=1))

    def run(name, *extra):
        work = tmp_path / name
        work.mkdir()
        loop.main(["--data-dir", str(data), "--clusters", "clusters.lst", "--workdir", str(work),
                   "--epochs", "1", "--micro-batch", "1", "--accum-steps", "1",
                   "--refine-steps", "2", "--width", "16", "--cwidth", "8", "--num-blocks", "2",
                   "-d", "cpu", *extra])
        line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("Epoch")][-1]
        losses = [float(line.split(key)[1].split()[0]) for key in ("train ", "val ")]
        return losses, step.leaves(load_npz(str(work / ckpt.LATEST)))

    calls, real = [], gruresnet.trunk_apply
    monkeypatch.setattr(gruresnet, "trunk_apply",
                        lambda params, xs, *a, **kw: calls.append(len(xs)) or real(params, xs, *a,
                                                                                  **kw))
    want_l, want_p = run("plain")
    assert calls and set(calls) == {1}
    calls.clear()
    got_l, got_p = run("mesh", "--mesh", "1x2")
    assert calls and set(calls) == {2}  # every trunk pass over the two shards
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got_p, want_p)])
    assert float(diff.max()) <= 2 * 2 * 3e-4
    assert float((diff <= 1e-5).float().mean()) >= 0.99


# ---------------------------------------------------------------- (d) batches

def test_batch_folder_on_data_and_seq_mesh(tree):
    """BatchFolder on a 2 x 2 mesh of CPU shards against the mesh-less batch
    (tests/test_torch_stream.py: confidences 1e-4, coordinates 1e-2)."""
    tree = dict(tree, coord_fc=tree["coord_fc"] * np.float32(256.0))
    params = params_from_jax(tree)
    rng = np.random.default_rng(0)
    targets = [Target(alnmat=rng.integers(0, 22, s).astype(np.uint8))
               for s in [(8, 20), (12, 25), (6, 20), (10, 40), (20, 22)]]
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    ours = BatchFolder(params, mesh=mesh, batch_size=2)
    assert len(ours.folders) == 1 and len(ours.folder.seq_row) == 2
    got = ours.fold_many(targets, iterations=1, minsteps=3)
    ours.close()
    want = BatchFolder(params, device="cpu", batch_size=2).fold_many(targets, iterations=1,
                                                                      minsteps=3)
    for (gc, gf), (wc, wf) in zip(got, want):
        np.testing.assert_allclose(gf, wf, atol=1e-4)
        np.testing.assert_allclose(gc, wc, atol=1e-2)
