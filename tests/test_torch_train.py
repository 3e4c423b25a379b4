"""The PyTorch port's training stack against the JAX package: losses, the
batched fp32 loss and its gradients, the remat tiers, the optimizer, the
dataset, checkpoints and the loop, all on the CPU at toy width.

The toy is tests/test_train.py's: width 32/16/2, B 2, N 6, L 12, nloops 1,
refine_steps 3, inputs from numpy seeds. Parity against JAX's
``batch_loss_native`` runs with dropout off and the teacher-forcing bits JAX
draws from its rng split, fed to the port's pure ``prep_sample``; weights go
across through ``params_from_jax`` and JAX's gradients through the same map.
Tolerances: loss rtol 1e-4, each gradient within 1e-3 of the tree's largest
|grad| (fp32 on both sides, sums in other orders over recycling and 3
refinement steps); the remat tiers change what is saved, never the math:
rtol 1e-5.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmpfold2_tpu import weights as jax_weights
from dmpfold2_tpu.models import gruresnet as jax_gruresnet
from dmpfold2_tpu.train import checkpoint as jax_ckpt
from dmpfold2_tpu.train import dataset as jax_dataset
from dmpfold2_tpu.train import loss as jax_loss
from dmpfold2_tpu.train import step as jax_step
from dmpfold2_tpu_torch.models import gruresnet, trunk
from dmpfold2_tpu_torch.train import checkpoint as ckpt
from dmpfold2_tpu_torch.train import dataset, loop, loss, step
from dmpfold2_tpu_torch.weights import keypaths, load_npz, params_from_jax

B, N, L = 2, 6, 12
NLOOPS, REFINE = 1, 3


def _jax_tree(seed=0, width=32, cwidth=16, num_blocks=2):
    return jax.tree.map(np.asarray, jax_gruresnet.init_params(
        jax.random.PRNGKey(seed), width=width, cwidth=cwidth, num_blocks=num_blocks))


def _toy_batch(nres=(L, L)):
    rng = np.random.default_rng(5)
    return step.TrainBatch(alnmat=rng.integers(0, 22, (B, N, L)).astype(np.int32),
                           targets=(rng.normal(size=(B, L, 5, 3)) * 4).astype(np.float32),
                           nseqs=np.full((B,), N, np.int32), nres=np.asarray(nres, np.int32))


def _jax_draws(rngs, l_pad):
    """The teacher-forcing bits JAX's _prep_sample draws from each sample's rng."""
    draws = []
    for r in rngs:
        r_tf, r_noise, _ = jax.random.split(r, 3)
        draws.append((bool(jax.random.bernoulli(r_tf, 0.5)),
                      torch.from_numpy(np.array(jax.random.normal(r_noise, (l_pad, 3))))))
    return draws


def _port_loss(params, batch, draws, **kw):
    return step.batch_loss_native(params, torch.from_numpy(batch.alnmat),
                                  torch.from_numpy(batch.targets), batch.nseqs, batch.nres,
                                  draws, **{"nloops": NLOOPS, "refine_steps": REFINE, **kw})


def _grads(params, batch, draws, **kw):
    loss_value, _ = _port_loss(params, batch, draws, **kw)
    return loss_value, torch.autograd.grad(loss_value, step.leaves(params))


@pytest.fixture(scope="module")
def tree():
    return _jax_tree()


@pytest.fixture(scope="module")
def toy(tree):
    return step.trainable(params_from_jax(tree), "cpu"), _toy_batch()


# ---------------------------------------------------------------- losses

def test_loss_functions_match_jax():
    rng = np.random.default_rng(0)
    l_pad, nres = 20, 14
    pred = (rng.normal(size=(l_pad, 5, 3)) * 4).astype(np.float32)
    tgt = (pred + rng.normal(size=(l_pad, 5, 3))).astype(np.float32)
    conf = rng.random(l_pad).astype(np.float32)
    ref, ref_m = jax_loss.fold_loss(jnp.asarray(pred), jnp.asarray(conf), jnp.asarray(tgt), nres)
    ours, ours_m = loss.fold_loss(torch.from_numpy(pred), torch.from_numpy(conf),
                                  torch.from_numpy(tgt), nres)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    for k in ref_m:
        np.testing.assert_allclose(float(ours_m[k]), float(ref_m[k]), rtol=1e-5, atol=1e-6)
    flat = pred.reshape(-1, 3)
    np.testing.assert_allclose(
        loss.tmscore(torch.from_numpy(tgt.reshape(-1, 3)), torch.from_numpy(flat), 5 * nres)
        [:5 * nres].numpy(),
        np.asarray(jax_loss.tmscore(jnp.asarray(tgt.reshape(-1, 3)), jnp.asarray(flat),
                                    5 * nres))[:5 * nres], atol=1e-5)
    # small nres: 1.24 n / 5 - 15 < 0, where d0 takes the real cube root
    np.testing.assert_allclose(
        float(loss.steric_loss(torch.from_numpy(pred[:, 1]), 3)),
        float(jax_loss.steric_loss(jnp.asarray(pred[:, 1]), 3)), rtol=1e-6)
    np.testing.assert_allclose(
        loss.tmscore(torch.from_numpy(tgt[:4].reshape(-1, 3)), torch.from_numpy(
            pred[:4].reshape(-1, 3))).numpy(),
        np.asarray(jax_loss.tmscore(jnp.asarray(tgt[:4].reshape(-1, 3)),
                                    jnp.asarray(pred[:4].reshape(-1, 3)))), atol=1e-5)


# ---------------------------------------------------------------- the batched loss

def test_batch_loss_fp32_matches_jax(tree, toy):
    """The port's fp32 batch_loss_native and its gradients against JAX's."""
    params, batch = toy
    jbatch = jax_step.TrainBatch(*(jnp.asarray(a) for a in batch))
    rngs = jax.random.split(jax.random.PRNGKey(7), B)

    def jax_fn(p):
        return jax_step.batch_loss_native(p, jbatch, rngs, nloops=NLOOPS, refine_steps=REFINE,
                                          dropout=False, remat=False)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_fn))(tree)
    ours_loss, ours_grads = _grads(params, batch, _jax_draws(rngs, L), remat="save_conv")
    np.testing.assert_allclose(float(ours_loss), float(ref_loss), rtol=1e-4)
    ref_leaves = step.leaves(params_from_jax(jax.tree.map(np.asarray, ref_grads)))
    scale = max(float(g.abs().max()) for g in ref_leaves)
    for (path, _), got, want in zip(keypaths(params), ours_grads, ref_leaves):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3 * scale, rtol=0,
                                   err_msg=path)


def test_batch_equals_mean_of_single_samples(toy):
    """Within 1e-4 of the largest |grad|, at nloops 0. With recycling, the
    second toy sample's gradient is ill-conditioned on the random model's
    collapsed trace: the sample and its own duplicate in a batch of two (GEMMs
    of another shape, sums in another order) already differ by 1.4e-3 of the
    scale, so nloops 1 would test the conditioning, not the batching."""
    params, batch = toy
    draws = [step.draw_prep(s, L) for s in (3, 4)]
    loss2, grads2 = _grads(params, batch, draws, nloops=0)
    singles = [_grads(params, step.TrainBatch(*(a[i:i + 1] for a in batch)), draws[i:i + 1],
                      nloops=0) for i in range(B)]
    np.testing.assert_allclose(float(loss2), np.mean([float(l) for l, _ in singles]), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in grads2)
    for (path, _), g, a, b in zip(keypaths(params), grads2, singles[0][1], singles[1][1]):
        np.testing.assert_allclose(g.numpy(), ((a + b) / 2).numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("nres", [10, 7])
def test_grads_finite_with_padding(toy, nres):
    """Padded samples (nres < L) keep every gradient finite: the padded Gram
    block, coincident padded CAs and the Kabsch SVD (tests/test_train.py:
    105-122)."""
    params, _ = toy
    batch = _toy_batch(nres=(nres, nres))
    _, grads = _grads(params, batch, [step.draw_prep(s, L) for s in (1, 2)])
    assert all(torch.isfinite(g).all() for g in grads)
    assert max(float(g.abs().max()) for g in grads) > 0


@pytest.fixture(scope="module")
def no_remat_grads(toy):
    params, batch = toy
    return _grads(params, batch, [step.draw_prep(s, L) for s in (1, 2)], dropout_seed=11,
                  remat=False)[1]


@pytest.mark.parametrize("tier", [True, "save_conv", "recycle", "recycle_save_conv"])
def test_remat_tiers_equal_grads_with_dropout(toy, no_remat_grads, tier):
    """Checkpointing replays regions whose dropout masks come from seeds, so
    every tier gives the gradients of no remat at all, dropout on."""
    params, batch = toy
    _, grads = _grads(params, batch, [step.draw_prep(s, L) for s in (1, 2)], dropout_seed=11,
                      remat=tier)
    for (path, _), got, want in zip(keypaths(params), grads, no_remat_grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()) + 1e-12, err_msg=path)


_FULL = {"trunk": {"blocks": [{"maxout": {"w": np.zeros((512, 128, 5, 5))}}] * 16,
                   "input": {"w": np.zeros((384, 955, 1, 1))}}}
_FULL_JAX = {"trunk": {"blocks": {"maxout": {"w": np.zeros((16, 5, 5, 128, 512))}},
                       "input": {"w": np.zeros((1, 1, 955, 384))}}}


@pytest.mark.parametrize("model,batch_size,l_pad,nloops,fused", [
    ("full", 1, 352, 3, True), ("full", 2, 352, 3, True), ("full", 1, 352, 3, False),
    ("full", 1, 128, 3, False), ("small", 2, 352, 3, True), ("small", 1, 352, 3, False),
    ("full", 4, 352, 3, True), ("full", 8, 352, 3, True), ("full", 4, 352, 0, True),
])
def test_resolve_remat_matches_jax(model, batch_size, l_pad, nloops, fused):
    """The cases of tests/test_train.py:269-308."""
    if model == "full":
        ours_p, jax_p = _FULL, _FULL_JAX
    else:
        ours_p = gruresnet.init_params(seed=0, width=64, cwidth=32, num_blocks=4)
        jax_p = _jax_tree(0, 64, 32, 4)
    assert (step.resolve_remat(ours_p, batch_size, l_pad, nloops, fused)
            == jax_step._resolve_remat(jax_p, batch_size, l_pad, nloops, fused))


# ---------------------------------------------------------------- the step

def _snapshot(params):
    return [p.detach().clone() for p in step.leaves(params)]


def test_train_step_updates_params_and_eval_does_not(tree):
    params = step.trainable(params_from_jax(tree), "cpu")
    opt = step.make_optimizer(params, 1e-3)
    before = _snapshot(params)
    metrics = step.train_step(params, opt, _toy_batch(), seed=2, nloops=NLOOPS, refine_steps=2)
    assert np.isfinite(metrics["loss"]) and metrics["skipped"] == 0.0 and metrics["updated"]
    assert any(not torch.equal(a, p) for a, p in zip(before, step.leaves(params)))
    before = _snapshot(params)
    metrics = step.train_step(params, opt, _toy_batch(), seed=3, nloops=NLOOPS, refine_steps=2,
                              train=False)
    assert np.isfinite(metrics["loss"]) and len(metrics["sample_loss"]) == B
    assert all(torch.equal(a, p) for a, p in zip(before, step.leaves(params)))


def test_train_step_skips_nonfinite_grads(tree):
    """NaN targets: the step is skipped and leaves the parameters, Adam's
    moments and the accumulation buffer as they were."""
    params = step.trainable(params_from_jax(tree), "cpu")
    opt = step.make_optimizer(params, 1e-3, accum_steps=2)
    batch = _toy_batch()
    for seed in range(3):  # one Adam update, then a half-full buffer
        step.train_step(params, opt, batch, seed=seed, nloops=0, refine_steps=1)
    before = _snapshot(params)
    state = opt.state_dict()
    bad = batch._replace(targets=np.full_like(batch.targets, np.nan))
    metrics = step.train_step(params, opt, bad, seed=9, nloops=0, refine_steps=1)
    assert metrics["skipped"] == 1.0 and not metrics["updated"]
    assert all(torch.equal(a, p) for a, p in zip(before, step.leaves(params)))
    after = opt.state_dict()
    assert after["mini_step"] == state["mini_step"] == 1
    assert all(torch.equal(a, b) for a, b in zip(after["acc"], state["acc"]))
    for k, s in state["adam"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(after["adam"]["state"][k][name], s[name])


def test_vmapped_path_is_not_ported(tree):
    """The JAX package's vmapped per-sample path (native_batch=False) exists
    for GSPMD mesh sharding; the port raises: under data parallelism each
    rank runs the native batch path."""
    params = step.trainable(params_from_jax(tree), "cpu")
    with pytest.raises(NotImplementedError, match="is not ported: under data parallelism"):
        step.train_step(params, step.make_optimizer(params), _toy_batch(), seed=0, nloops=0,
                        native_batch=False)


def _random_grads(shapes, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) for s in shapes]


def test_accumulation_is_one_adam_step_on_the_mean():
    shapes = [(3, 4), (5,)]
    params_a = {"a": torch.randn(3, 4), "b": torch.randn(5)}
    params_b = {k: v.clone() for k, v in params_a.items()}
    accum = step.make_optimizer(params_a, 1e-2, accum_steps=3)
    single = step.make_optimizer(params_b, 1e-2)
    grads = [_random_grads(shapes, s) for s in range(3)]
    moved = [accum.update(g) for g in grads]
    assert moved == [False, False, True]
    single.update([sum(gs) / 3 for gs in zip(*grads)])
    for a, b in zip(step.leaves(params_a), step.leaves(params_b)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7)


def test_adam_matches_optax():
    shapes = [(3, 4), (5,)]
    rng = np.random.default_rng(0)
    start = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params = {"a": torch.from_numpy(start[0].copy()), "b": torch.from_numpy(start[1].copy())}
    opt = step.make_optimizer(params, 1e-3)
    ref_opt = optax.adam(1e-3)
    ref = {"a": jnp.asarray(start[0]), "b": jnp.asarray(start[1])}
    state = ref_opt.init(ref)
    for s in range(3):
        grads = _random_grads(shapes, s)
        opt.update(grads)
        updates, state = ref_opt.update({"a": jnp.asarray(grads[0].numpy()),
                                         "b": jnp.asarray(grads[1].numpy())}, state, ref)
        ref = optax.apply_updates(ref, updates)
    for got, want in zip(step.leaves(params), (ref["a"], ref["b"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_bf16_step_trains_and_follows_fp32(toy):
    """The bf16 step (each block conv through Conv5x5MaxoutDiff, here its
    plain version) gives a finite loss and moves the parameters, and its
    gradient follows fp32's where bf16 acts: given the same input and
    cotangent, the bf16 training trunk's gradient has a cosine >= 0.95 to the
    fp32 trunk's (measured 0.992).

    The whole step's gradient is not held so: downstream of the trunk (MDS,
    the coordinate GRUs, refinement) the random model's step is so
    ill-conditioned that bf16 rounding turns its gradient around. JAX's own
    bf16 and fp32 steps on this toy have a gradient cosine of -0.85, the
    port's 0.92."""
    params, batch = toy
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(B, L, L, 32 + 443)).astype(np.float32))
    row = torch.arange(L) < torch.tensor([L, 9])[:, None]
    mask = (row[:, :, None] & row[:, None, :]).float()[..., None]
    cot = torch.from_numpy(rng.normal(size=(B, L, L, 2)).astype(np.float32))
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        out = trunk.trunk_apply([params["trunk"]], [x], [mask], compute_dtype=dtype,
                                remat="save_conv")
        grads[dtype] = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            (out * cot).sum(), step.leaves(params["trunk"]))])
    assert float(torch.nn.functional.cosine_similarity(
        grads[torch.float32], grads[torch.bfloat16], dim=0)) >= 0.95

    moving = step.trainable(params, "cpu")
    before = _snapshot(moving)
    opt = step.make_optimizer(moving, 1e-3)
    metrics = step.train_step(moving, opt, batch, seed=4, nloops=NLOOPS, refine_steps=REFINE,
                              precision="bf16")
    assert np.isfinite(metrics["loss"]) and metrics["updated"] and metrics["skipped"] == 0.0
    assert any(not torch.equal(a, p) for a, p in zip(before, step.leaves(moving)))


def test_overfit_single_sample_loss_decreases(tree):
    """Fifty steps on one sample drive the loss down (tests/test_train.py:
    355-378): the last five average below 0.8 of the first five."""
    params = step.trainable(params_from_jax(tree), "cpu")
    opt = step.make_optimizer(params, 3e-3)
    one = step.TrainBatch(*(a[:1] for a in _toy_batch()))
    losses = []
    for i in range(50):
        metrics = step.train_step(params, opt, one, seed=11 + i, nloops=0, refine_steps=0)
        losses.append(metrics["loss"])
        assert np.isfinite(losses[-1]), f"step {i}"
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < 0.8 * first, f"first5={first:.4f} last5={last:.4f}: {losses}"


# ---------------------------------------------------------------- data

def _write_tdb(path, classes, coords):
    letters = "ARNDCQEGHILKMFPSTWYV"
    with open(path, "w") as fh:
        fh.write("# synthetic tdb\n")
        for cls, atoms in zip(classes, coords):
            line = " " * 5 + letters[cls % 20] + " " * 33
            fh.write(line + "".join(f"{v:9.3f}" for v in atoms.ravel()) + "\n\n")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    os.makedirs(root / "tdb")
    os.makedirs(root / "aln")
    rng = np.random.default_rng(0)
    letters = "ARNDCQEGHILKMFPSTWYV-"
    for k, (length, rows) in enumerate([(20, 8), (26, 8), (40, 30)]):
        _write_tdb(root / "tdb" / f"t{k}.tdb", rng.integers(0, 20, length),
                   rng.normal(size=(length, 5, 3)) * 5)
        aln = ["".join(letters[i] for i in rng.integers(0, 21, length)) for _ in range(rows)]
        (root / "aln" / f"t{k}.aln").write_text("\n".join(aln) + "\n")
    (root / "clusters.lst").write_text("t0\n\nt0 t1\nt2 t1\n")
    return str(root)


def test_dataset_matches_jax(data_dir):
    """parse_tdb, load_cluster_list, DMPDataset (with and without
    augmentation, the same random.Random draws) and pad_to_bucket give JAX's
    arrays."""
    path = os.path.join(data_dir, "tdb", "t2.tdb")
    for a, b in zip(dataset.parse_tdb(path), jax_dataset.parse_tdb(path)):
        np.testing.assert_array_equal(a, b)
    lst = os.path.join(data_dir, "clusters.lst")
    assert dataset.load_cluster_list(lst, 2) == jax_dataset.load_cluster_list(lst, 2)
    members = dataset.load_cluster_list(lst)[1]
    for augment in (True, False):
        ours = dataset.DMPDataset(members, data_dir, augment=augment, crop_len=24)
        ref = jax_dataset.DMPDataset(members, data_dir, augment=augment, crop_len=24)
        for idx in range(len(members)):
            a, b = ours.get(idx, random.Random(idx)), ref.get(idx, random.Random(idx))
            np.testing.assert_array_equal(a.alnmat, b.alnmat)
            np.testing.assert_array_equal(a.targets, b.targets)
        samples = [ours.get(i, random.Random(9)) for i in range(len(members))]
        for a, b in zip(dataset.pad_to_bucket(samples), jax_dataset.pad_to_bucket(samples)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- checkpoints

def test_port_npz_loads_into_jax(tmp_path):
    params = gruresnet.init_params(seed=3, width=32, cwidth=16, num_blocks=3)
    path = str(tmp_path / "port.npz")
    ckpt.save_params(path, params)
    loaded = jax_weights.load_params(path)
    restored, n = jax_ckpt.partial_restore(jax_gruresnet.init_params(
        jax.random.PRNGKey(1), width=32, cwidth=16, num_blocks=3), path)
    assert n == len(jax.tree.leaves(loaded))
    back = params_from_jax(jax.tree.map(np.asarray, loaded))
    for a, b, c in zip(step.leaves(params), step.leaves(back),
                       step.leaves(params_from_jax(jax.tree.map(np.asarray, restored)))):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_jax_npz_loads_into_port(tmp_path, tree):
    path = str(tmp_path / "jax.npz")
    jax_weights.save_params(path, tree)
    want = step.leaves(params_from_jax(tree))
    skeleton = gruresnet.init_params(seed=1, width=32, cwidth=16, num_blocks=2)
    restored, n = ckpt.partial_restore(skeleton, path)
    assert n == len(jax.tree.leaves(tree))
    for a, b, c in zip(want, step.leaves(restored), step.leaves(load_npz(path))):
        assert torch.equal(a, b) and torch.equal(a, c)
    # another width: only the leaves whose shapes match are restored
    wider = gruresnet.init_params(seed=1, width=64, cwidth=16, num_blocks=2)
    _, n_wider = ckpt.partial_restore(wider, path)
    assert 0 < n_wider < n


def test_train_state_roundtrip(tmp_path, tree):
    params = step.trainable(params_from_jax(tree), "cpu")
    opt = step.make_optimizer(params, 1e-3, accum_steps=2)
    shapes = [p.shape for p in step.leaves(params)]
    for s in range(3):
        opt.update(_random_grads(shapes, s))
    ckpt.save_train_state(str(tmp_path), 7, opt.state_dict(), 1.5, 2.5, params=params)
    state = ckpt.load_train_state(str(tmp_path))
    assert (state["epoch"], state["val_err_min"], state["train_err_min"]) == (7, 1.5, 2.5)
    with np.load(tmp_path / ckpt.LATEST) as stamp:
        assert int(stamp["__epoch__"]) == 7
    fresh = step.make_optimizer(step.trainable(params_from_jax(tree), "cpu"), 1e-3,
                                accum_steps=2)
    fresh.load_state_dict(state["opt_state"])
    again = fresh.state_dict()
    assert again["mini_step"] == 1
    for a, b in zip(again["acc"], state["opt_state"]["acc"]):
        assert torch.equal(a, b)
    for k, s in state["opt_state"]["adam"]["state"].items():
        assert torch.equal(again["adam"]["state"][k]["exp_avg"], s["exp_avg"])


def test_train_loop_end_to_end(data_dir, tmp_path):
    """Two runs of the loop on the CPU with a tiny model (the port of
    tests/test_dataset.py:166-189): finite epochs, the checkpoint files, and
    a resume that restores LATEST and advances the epoch; the second through
    the CLI."""
    kwargs = dict(data_dir=data_dir, clusters="clusters.lst", workdir=str(tmp_path),
                  num_epochs=1, micro_batch=1, accum_steps=2, restart=False, refine_steps=2,
                  model_kwargs=dict(width=16, cwidth=8, num_blocks=2), device="cpu")
    params = loop.train(**kwargs)
    assert (tmp_path / ckpt.CHECKPOINT).exists()
    # all clusters are validation (the first 300): no best-train file
    assert not (tmp_path / ckpt.BEST_TRAIN).exists()
    assert (tmp_path / ckpt.BEST_VAL).exists() and (tmp_path / ckpt.LATEST).exists()
    latest = load_npz(str(tmp_path / ckpt.LATEST))
    for a, b in zip(step.leaves(params), step.leaves(latest)):
        assert torch.equal(a.detach(), b)
    state0 = ckpt.load_train_state(str(tmp_path))
    loop.main(["--data-dir", data_dir, "--clusters", "clusters.lst", "--workdir", str(tmp_path),
               "--epochs", "1", "--micro-batch", "1", "--accum-steps", "2", "--refine-steps",
               "2", "--width", "16", "--cwidth", "8", "--num-blocks", "2", "-d", "cpu"])
    assert ckpt.load_train_state(str(tmp_path))["epoch"] == state0["epoch"] + 1
