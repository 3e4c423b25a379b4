"""The PyTorch port's batch engine (``parallel/stream.py``) and its logging
(``utils/obs.py``): against the JAX package's batched fold, against the
port's own single-target fold, and its pipeline and failure tolerance.

Weights: the JAX package's toy model (32/16/2) carried across with
``params_from_jax``, with ``coord_fc`` scaled by 256 as in
tests/test_torch_model.py: unscaled, the random head collapses the CA trace
(steps of a few hundredths of an A), where backbone completion turns
rounding-level differences of the CA trace into 1e-2 A of atoms. The
``gpu`` tests run the batch engine's kernels on a card and skip here.
"""

import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmpfold2_tpu.models.gruresnet import init_params as jax_init_params
from dmpfold2_tpu.parallel import stream as jax_stream
from dmpfold2_tpu_torch.engine import fold
from dmpfold2_tpu_torch.parallel import stream
from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target
from dmpfold2_tpu_torch.utils import obs
from dmpfold2_tpu_torch.weights import params_from_jax

# (nseqs, nres): three buckets at batch 2: (16, 32) x 3, (16, 40), (32, 32)
SHAPES = [(8, 20), (12, 25), (6, 20), (10, 40), (20, 22)]
# the batch against a single fold (tests/test_stream.py:27-37)
CONF_TOL, COORD_TOL = 1e-4, 1e-2


@pytest.fixture(scope="module")
def tree():
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), width=32,
                                                    cwidth=16, num_blocks=2))
    tree["coord_fc"] = tree["coord_fc"] * np.float32(256.0)
    return tree


@pytest.fixture(scope="module")
def params(tree):
    return params_from_jax(tree)


@pytest.fixture(scope="module")
def targets():
    rng = np.random.default_rng(0)
    return [Target(alnmat=rng.integers(0, 22, s).astype(np.uint8)) for s in SHAPES]


@pytest.fixture(scope="module")
def fp32_folders(params):
    return BatchFolder(params, device="cpu", batch_size=2), fold.Folder(params, device="cpu")


@pytest.fixture(scope="module")
def fp32_batch(fp32_folders, targets):
    """fold_many of the five targets at batch 2, -n 1 -m 3."""
    return fp32_folders[0].fold_many(targets, iterations=1, minsteps=3)


# ---------------------------------------------------------------- (a) against JAX

@pytest.mark.parametrize("nloops,steps", [(1, 5), (2, 0)])
def test_batch_matches_jax_fold_batch(tree, params, nloops, steps):
    """Three ragged targets of one bucket (16, 32), one a single sequence
    (zero DCA), through the port's batch body and JAX ``_fold_batch`` (scan
    GRUs, XLA refinement): the bounds of tests/test_torch_model.py:162-164."""
    rng = np.random.default_rng(3)
    batch = [Target(rng.integers(0, 22, s).astype(np.uint8)) for s in ((12, 20), (1, 17),
                                                                         (9, 13))]
    aln_b, dmap_b, nseqs, nres = stream._pad_batch(batch, 16, 32)
    ours_c, ours_f = stream._fold_batch(fold.Folder(params, device="cpu"), aln_b, dmap_b,
                                        nseqs, nres, nloops, steps)
    ref_c, ref_f = jax_stream._fold_batch(
        tree, jnp.asarray(aln_b), jnp.asarray(nseqs, jnp.int32), jnp.asarray(nres, jnp.int32),
        jnp.asarray(dmap_b), jnp.asarray(nloops), jnp.asarray(steps), vgru_impl="scan",
        rgru_impl="scan", refine_impl="xla")
    for b, n in enumerate(nres):
        np.testing.assert_allclose(ours_f[b, :n], np.asarray(ref_f)[b, :n], atol=2e-4)
        np.testing.assert_allclose(ours_c[b, :n], np.asarray(ref_c)[b, :n], atol=5e-3)


# ---------------------------------------------------------------- (b) against single folds

def test_batch_matches_single_fp32(fp32_folders, fp32_batch, targets):
    single = fp32_folders[1]
    for t, (bc, bf) in zip(targets, fp32_batch):
        sc, sf = single.fold(t.alnmat, iterations=1, minsteps=3)
        np.testing.assert_allclose(bf, sf, atol=CONF_TOL)
        np.testing.assert_allclose(bc, sc, atol=COORD_TOL)


# bf16 at -n 0 -m 0, batch against single: batching, like padding, changes
# nothing but the order of the fp32 sums before each bf16 rounding, so a few
# activations land on the other bf16 neighbour (2^-8 relative). The
# confidences get the bf16 engine's bound for that case
# (tests/test_torch_conv_block.py::test_bf16_fold_padding_invariant, 1e-2);
# at -m 0 no refinement amplifies what reaches the coordinate head, so the
# coordinates keep (b)'s fp32 bound.
BF16_CONF_TOL = 1e-2


def test_batch_matches_single_bf16(params, targets):
    batched = BatchFolder(params, device="cpu", batch_size=2, precision="bf16")
    single = fold.Folder(params, device="cpu", precision="bf16")
    results = batched.fold_many(targets, iterations=0, minsteps=0)
    for t, (bc, bf) in zip(targets, results):
        sc, sf = single.fold(t.alnmat, iterations=0, minsteps=0)
        assert bc.shape == sc.shape == (t.alnmat.shape[1], 5, 3)
        np.testing.assert_allclose(bf, sf, atol=BF16_CONF_TOL)
        np.testing.assert_allclose(bc, sc, atol=COORD_TOL)


# ---------------------------------------------------------------- (c) order, padding

def test_results_in_input_order_with_shapes(fp32_batch, targets):
    assert len(fp32_batch) == len(targets)
    for t, (coords, confs) in zip(targets, fp32_batch):
        n = t.alnmat.shape[1]
        assert coords.shape == (n, 5, 3) and confs.shape == (n,)
        assert np.isfinite(coords).all() and ((confs >= 0) & (confs <= 1)).all()


def test_partial_batch_repeat_leaves_others_unchanged(params, targets):
    """Three targets of bucket (16, 32) at batch 4: the batch is padded by
    repeating the third; the same three with another fourth target give the
    same bits for the three."""
    three = [targets[i] for i in (0, 1, 2)]
    rng = np.random.default_rng(9)
    other = Target(rng.integers(0, 22, (5, 31)).astype(np.uint8))
    folder = BatchFolder(params, device="cpu", batch_size=4)
    partial = folder.fold_many(three, iterations=1, minsteps=2)
    full = folder.fold_many(three + [other], iterations=1, minsteps=2)
    for (pc, pf), (fc, ff) in zip(partial, full[:3]):
        np.testing.assert_array_equal(pc, fc)
        np.testing.assert_array_equal(pf, ff)
    assert folder.counters.targets == 7


# ---------------------------------------------------------------- (d) pipeline depth

def test_two_in_flight_equal_one(params, fp32_batch, targets):
    seq = BatchFolder(params, device="cpu", batch_size=2, max_inflight=1)
    want = seq.fold_many(targets, iterations=1, minsteps=3)
    assert seq.counters.targets == len(targets)
    for (wc, wf), (gc, gf) in zip(want, fp32_batch):
        np.testing.assert_array_equal(wc, gc)
        np.testing.assert_array_equal(wf, gf)


def test_fold_many_async_returns_before_results(params, targets):
    """Two fold_many_async calls in flight at once on one folder, waited in
    the other order: each gets its own targets' results."""
    folder = BatchFolder(params, device="cpu", batch_size=2)
    first = folder.fold_many_async(targets[:3], iterations=0, minsteps=0)
    second = folder.fold_many_async(targets[3:], iterations=0, minsteps=0)
    got_second, got_first = second.wait(), first.wait()
    assert first.wait() is got_first
    assert [c.shape[0] for c, _ in got_first + got_second] == [s[1] for s in SHAPES]
    assert folder.counters.targets == len(targets)


# ---------------------------------------------------------------- (e) failure tolerance

@pytest.mark.parametrize("where", ["dispatch", "retire"])
def test_failed_batch_requeues_singly(params, fp32_batch, targets, monkeypatch, capsys, where):
    """The batch of target 2 (bucket (16, 32)'s second, padded with its
    copy) fails when it is padded (dispatch) or in its worker (retire); its
    target is folded alone on the same folder, and every result equals the
    batch's within (b)'s bounds."""
    name = "_pad_batch" if where == "dispatch" else "_fold_batch"
    real, failed = getattr(stream, name), []

    def fails_for_target_2(*args):
        # _pad_batch(targets, n_pad, l_pad); _fold_batch(folder, aln, dmap, nseqs, ...)
        mine = args[0][0] is targets[2] if where == "dispatch" else args[3] == [6, 6]
        if mine:
            failed.append(where)
            raise RuntimeError(f"injected {where} failure")
        return real(*args)

    monkeypatch.setattr(stream, name, fails_for_target_2)
    singles = []
    real_single = BatchFolder._fold_single

    def recording_single(self, target, iterations, minsteps, folder=None):
        singles.append((folder or self.folder, target))
        return real_single(self, target, iterations, minsteps, folder)

    monkeypatch.setattr(BatchFolder, "_fold_single", recording_single)
    folder = BatchFolder(params, device="cpu", batch_size=2)
    results = folder.fold_many(targets, iterations=1, minsteps=3)
    assert failed == [where]
    assert singles == [(folder.folder, targets[2])]
    assert folder.counters.targets == len(targets)
    for (rc, rf), (bc, bf) in zip(results, fp32_batch):
        np.testing.assert_allclose(rf, bf, atol=CONF_TOL)
        np.testing.assert_allclose(rc, bc, atol=COORD_TOL)
    err = capsys.readouterr().err
    assert "batch_error" in err and f"injected {where} failure" in err


def test_single_target_failure_gives_none_and_logs(params, targets, monkeypatch, capsys):
    def failing_batch(*args, **kwargs):
        raise RuntimeError("injected batch failure")

    bad = 2
    real_single = BatchFolder._fold_single

    def selective_single(self, target, iterations, minsteps, folder=None):
        if target is targets[bad]:
            raise ValueError("injected single-target failure")
        return real_single(self, target, iterations, minsteps, folder)

    monkeypatch.setattr(stream, "_fold_batch", failing_batch)
    monkeypatch.setattr(BatchFolder, "_fold_single", selective_single)
    folder = BatchFolder(params, device="cpu", batch_size=2)
    results = folder.fold_many(targets, iterations=0, minsteps=1)
    assert results[bad] is None
    for i, (t, r) in enumerate(zip(targets, results)):
        if i != bad:
            assert r is not None and r[0].shape == (t.alnmat.shape[1], 5, 3)
    assert folder.counters.targets == len(targets) - 1
    err = capsys.readouterr().err
    assert "target_error" in err and "injected single-target failure" in err


def test_out_of_memory_empties_the_cache_before_single_folds(params, targets, monkeypatch):
    events = []

    def oom_batch(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("injected out of memory")

    monkeypatch.setattr(stream, "_fold_batch", oom_batch)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: events.append("empty_cache"))
    real_single = BatchFolder._fold_single
    monkeypatch.setattr(BatchFolder, "_fold_single",
                        lambda self, *a: events.append("single") or real_single(self, *a))
    folder = BatchFolder(params, device="cpu", batch_size=2)
    results = folder.fold_many(targets[:2], iterations=0, minsteps=0)
    assert all(r is not None for r in results)
    assert events == ["empty_cache", "single", "single"]


def test_batch_folder_defaults_to_cuda(monkeypatch, params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchFolder(params)


def test_auto_iterations_refused(fp32_folders, targets):
    with pytest.raises(ValueError, match="single-target"):
        fp32_folders[0].fold_many(targets, iterations="auto")


# ---------------------------------------------------------------- (f) obs

def test_counters_lose_no_count_under_threads():
    counters = obs.Counters()
    per_thread, n_threads = 2000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counters.record(3)
                                                    for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counters.targets == per_thread * n_threads
    assert counters.residues == 3 * per_thread * n_threads


def test_counters_merge_and_summary():
    a, b = obs.Counters(), obs.Counters()
    a.record(10)
    a.record(20)
    b.record(30)
    b.started = a.started - 5.0
    merged = obs.Counters.merge([a, b])
    assert (merged.targets, merged.residues, merged.started) == (3, 60, b.started)
    summary = merged.summary()
    assert summary["targets"] == 3 and summary["residues"] == 60
    assert summary["seconds"] >= 5.0 and 0 < summary["targets_per_s"] <= 3 / 5.0


def test_verbose_logs_to_file(params, targets, tmp_path, monkeypatch):
    logfile = tmp_path / "targets.jsonl"
    monkeypatch.setenv("DMPFOLD2_TPU_LOG", str(logfile))
    folder = BatchFolder(params, device="cpu", batch_size=2, verbose=True)
    folder.fold_many(targets[:3], iterations=0, minsteps=0)
    lines = [json.loads(line) for line in logfile.read_text().splitlines()]
    assert [line["event"] for line in lines] == ["target_folded"] * 3
    assert sorted(line["nres"] for line in lines) == sorted(s[1] for s in SHAPES[:3])
    assert all(line["batch_size"] == 2 for line in lines)


def test_broken_log_sink_falls_back_to_stderr(params, targets, monkeypatch, capsys):
    monkeypatch.setenv("DMPFOLD2_TPU_LOG", "/nonexistent-dir/xyz/targets.jsonl")
    monkeypatch.setattr(obs, "_sink_broken", False)
    folder = BatchFolder(params, device="cpu", batch_size=2, verbose=True)
    results = folder.fold_many(targets[:2], iterations=0, minsteps=1)
    assert all(r is not None for r in results)
    err = capsys.readouterr().err
    assert "log sink failed" in err and "target_folded" in err


def test_profile_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace" / "fold.json"
    with obs.profile(str(path)):
        torch.ones(8, 8).sum()
    assert "traceEvents" in json.loads(path.read_text())


# ---------------------------------------------------------------- on the card

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _card_model(seed=0):
    """The widths the card's kernels run (width 512, cwidth 128), 2 blocks."""
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    return init_params(seed=seed, width=512, cwidth=128, num_blocks=2)


def _card_targets():
    rng = np.random.default_rng(4)
    return [Target(rng.integers(0, 21, s).astype(np.uint8)) for s in ((40, 88), (50, 81),
                                                                       (33, 85))]


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_batch_on_card_launches_once_per_batch(precision):
    """B 3 ragged in bucket (64, 88) (nres 88, 81, 85) on the card: each
    kernel is launched as often per batch as for one fold, and the fp32
    batch equals single folds at -n 0 -m 0 (refinement of the random
    model's collapsed trace and the recycle's choice amplify rounding;
    chip_smoke.py's BATCH_CHECK)."""
    _require_cuda()
    from dmpfold2_tpu_torch.kernels import conv_block, refine, rgru, vgru

    counters = {"vgru": (vgru, "launches"), "rgru": (rgru, "launches"),
                "refine": (refine, "launches"), "conv": (conv_block, "conv_launches"),
                "gemm": (conv_block, "gemm_launches"), "tail": (conv_block, "tail_launches")}

    def counted(fn):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        out = fn()
        return out, {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    params, targets = _card_model(), _card_targets()
    batched = BatchFolder(params, batch_size=3, precision=precision)
    results, batch_counts = counted(lambda: batched.fold_many(targets, iterations=2,
                                                               minsteps=10))
    single = batched.folder
    _, single_counts = counted(lambda: single.fold(targets[0].alnmat, iterations=2,
                                                   minsteps=10))
    assert batch_counts == single_counts
    assert batch_counts["vgru"] == 1 and batch_counts["rgru"] == 2 + 3 * 3
    assert batch_counts["refine"] == 2
    assert batch_counts["conv"] == (6 if precision == "bf16" else 0)
    assert batch_counts["tail"] == batch_counts["conv"]  # one tail a block
    for t, (coords, confs) in zip(targets, results):
        assert coords.shape == (t.alnmat.shape[1], 5, 3) and np.isfinite(coords).all()
    if precision == "fp32":
        results = batched.fold_many(targets, iterations=0, minsteps=0)
        for t, (bc, bf) in zip(targets, results):
            sc, sf = single.fold(t.alnmat, iterations=0, minsteps=0)
            np.testing.assert_allclose(bf, sf, atol=5e-4)
            np.testing.assert_allclose(bc[:, 1], sc[:, 1], atol=1e-2)
    batched.close()


@pytest.mark.gpu
def test_fresh_process_two_workers_on_card(tmp_path):
    """In a process that has made no linalg call yet, two batches in flight
    (two buckets, two workers) fold without a batch error: the batch engine
    loads torch's CUDA linear-algebra library before its workers make their
    first call at once."""
    _require_cuda()
    import os
    import subprocess

    log = tmp_path / "log.jsonl"
    script = (
        "import numpy as np\n"
        "from dmpfold2_tpu_torch.models.gruresnet import init_params\n"
        "from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target\n"
        "rng = np.random.default_rng(4)\n"
        "targets = [Target(rng.integers(0, 21, s).astype(np.uint8)) for s in ((40, 88), (50, 200))]\n"
        "bf = BatchFolder(init_params(seed=0, width=512, cwidth=128, num_blocks=2), batch_size=1,\n"
        "                 precision='bf16', max_inflight=2)\n"
        "out = bf.fold_many(targets, iterations=1, minsteps=10)\n"
        "bf.close()\n"
        "assert all(r is not None for r in out)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, DMPFOLD2_TPU_LOG=str(log)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    events = [json.loads(line).get("event") for line in log.read_text().splitlines()] \
        if log.exists() else []
    assert "batch_error" not in events and "target_error" not in events


@pytest.mark.gpu
def test_two_streams_on_card_equal_one():
    """max_inflight 2 (two batches at once, on two streams) gives the
    results of max_inflight 1, and finishes."""
    _require_cuda()
    params = _card_model()
    targets = _card_targets() * 2
    out = {}
    for depth in (1, 2):
        folder = BatchFolder(params, batch_size=2, precision="bf16", max_inflight=depth)
        done = threading.Event()
        box = []
        worker = threading.Thread(target=lambda: (box.append(folder.fold_many(
            targets, iterations=1, minsteps=10)), done.set()))
        worker.start()
        assert done.wait(timeout=300), f"max_inflight {depth} did not finish"
        worker.join(timeout=10)
        out[depth] = box[0]
        assert folder.counters.targets == len(targets)
        folder.close()
    for (ac, af), (bc, bf) in zip(out[1], out[2]):
        np.testing.assert_array_equal(ac, bc)
        np.testing.assert_array_equal(af, bf)
