"""The PyTorch port over several devices and processes (``parallel/mesh.py``,
``BatchFolder(mesh=...)``, ``serve --mesh``, ``train_step(mesh=...)`` and the
loop's ``--coordinator``), on the CPU: the counterpart of
tests/test_multiprocess.py.

Two OS processes join a gloo group on localhost (this module run as a
script is the worker) at toy widths (32/16/2, as tests/mp_worker.py) and:
fold mp_worker's six targets with ``BatchFolder(mesh=make_mesh(devices=
["cpu"]))`` (batch 4: two slots a process), take one data-parallel
``train_step`` (micro-batch 4 split 2 + 2), then run one epoch of the real
training loop through its CLI entry (``loop.main`` with ``--coordinator ...
--num-processes 2 --process-id k -d cpu``, the validation split cut to 2
clusters as mp_worker cuts it). The parent holds them against one process:
folds against a single-process BatchFolder on a mesh of two CPU replicas (the
same program per shard) within 1e-5 (mp_worker's bound); the step and the
loop (whose epoch accumulates its two micro-batches into one Adam update)
against the single-process step on the whole micro-batch and the
single-process loop: every gradient handed to the optimizer within 2e-5 of
that step's largest |gradient|, and the parameters after the update within
2e-5 (mp_worker's bound). Adam's first update moves a parameter by
lr * g / (|g| + 1e-8), about lr whatever |g| is, so where a gradient is at
the rounding floor (below 1e-6 of the largest) two sum orders can move it
apart by up to 2 lr; those entries are held to that instead.

Also here: the port's mesh batch against JAX's mesh batch on the conftest's
virtual CPU devices (tests/test_torch_stream.py's tolerances), ``make_mesh``'s
errors, and ``serve --mesh`` on CPU replicas. The ``gpu`` cases run a small
form of ``chip_smoke.py`` phase ``multi`` (d) and (e) on a card and skip
here. Workers log to files, not pipes (see tests/test_multiprocess.py), and
every wait has a timeout.
"""

import contextlib
import os
import socket
import subprocess
import sys
import threading
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script (the worker)
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dmpfold2_tpu_torch.config import TrainConfig  # noqa: E402
from dmpfold2_tpu_torch.models.gruresnet import init_params  # noqa: E402
from dmpfold2_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target  # noqa: E402
from dmpfold2_tpu_torch.train import step  # noqa: E402

WORKER_TIMEOUT_S = 300
BATCH, MICRO_BATCH, STEP_SEED, STEP_LR = 4, 4, 3, 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fold_params():
    """The toy model with its coordinate head scaled by 256, as
    tests/test_torch_stream.py scales it (a protein-sized CA trace)."""
    params = init_params(seed=0, width=32, cwidth=16, num_blocks=2)
    params["coord_fc"] = params["coord_fc"] * 256.0
    return params


def _targets():
    """mp_worker.make_targets' six alignments (seed 7), as port Targets."""
    rng = np.random.default_rng(7)
    return [Target(alnmat=rng.integers(0, 21, (4 + i, 12 + (i % 3))).astype(np.int32))
            for i in range(6)]


def _step_batch():
    """mp_worker's training batch: B 4, N 6, L 16, nres 14, helix-like targets."""
    rng = np.random.default_rng(11)
    t = np.arange(16, dtype=np.float32)
    helix = np.stack([2.3 * np.cos(0.6 * t), 2.3 * np.sin(0.6 * t), 1.5 * t], -1)
    gt = helix[None, :, None, :] + rng.normal(size=(MICRO_BATCH, 16, 5, 3)).astype(np.float32) * 0.3
    return step.TrainBatch(rng.integers(0, 21, (MICRO_BATCH, 6, 16)).astype(np.int32),
                           gt.astype(np.float32), np.full((MICRO_BATCH,), 6, np.int32),
                           np.full((MICRO_BATCH,), 14, np.int32))


@contextlib.contextmanager
def _recorded_updates():
    """Record the gradients every ``Optimizer.update`` (each micro-step) is
    handed, after the all-reduce under data parallelism."""
    grads, real = [], step.Optimizer.update

    def update(self, g):
        grads.append([x.detach().cpu().numpy().copy() for x in g])
        return real(self, g)

    step.Optimizer.update = update
    try:
        yield grads
    finally:
        step.Optimizer.update = real


def _step(mesh=None, shard=slice(None)):
    """One train_step from the seed-0 toy model on (this rank's shard of) the
    batch: (metrics, parameters after, the gradient handed to Adam)."""
    params = step.trainable(init_params(seed=0, width=32, cwidth=16, num_blocks=2), "cpu")
    optimizer = step.make_optimizer(params, STEP_LR)
    batch = step.TrainBatch(*(a[shard] for a in _step_batch()))
    with _recorded_updates() as grads:
        metrics = step.train_step(params, optimizer, batch, STEP_SEED, nloops=1, refine_steps=2,
                                  mesh=mesh)
    return metrics, [p.detach().numpy().copy() for p in step.leaves(params)], grads[0]


def _assert_same_training(got_params, got_grads, want_params, want_grads, lr, tag):
    """Gradients of every micro-step within 2e-5 of that step's largest
    |gradient|; parameters within 2e-5 where every step's gradient is above
    the rounding floor (1e-6 of the largest), and within the 2 lr that one
    Adam update can part them by below it (one update in every case here)."""
    floor = None
    for k, (got, want) in enumerate(zip(got_grads, want_grads)):
        scale = max(float(np.abs(g).max()) for g in want if g.size)  # cwidth 8: empty cSE
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 * scale,
                                       err_msg=f"{tag} update {k} gradient {i}")
        # an exact zero in both runs leaves the parameter where it was in both
        small = [(np.abs(b) < 1e-6 * scale) & ((a != 0) | (b != 0)) for a, b in zip(got, want)]
        floor = small if floor is None else [f | m for f, m in zip(floor, small)]
    for i, (a, b, f) in enumerate(zip(got_params, want_params, floor)):
        np.testing.assert_allclose(a[~f], b[~f], rtol=2e-5, atol=2e-5,
                                   err_msg=f"{tag} parameter {i}")
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=2 * lr,
                                   err_msg=f"{tag} parameter {i} at the floor")


# one Adam update an epoch, on the mean of its two micro-batches: a second
# update would start from parameters the first moved by +-lr at the rounding
# floor, and its gradients would part by more than rounding
LOOP_ARGS = ["--clusters", "clusters.lst", "--epochs", "1", "--micro-batch", str(MICRO_BATCH),
             "--accum-steps", "8", "--refine-steps", "2", "--no-restart", "--width", "16",
             "--cwidth", "8", "--num-blocks", "2", "-d", "cpu"]


def _run_loop(data_dir: str, workdir: str, argv=()):
    """One epoch of the loop through its CLI entry, with mp_worker's
    validation split (2 clusters); returns (parameters, dataset reads)."""
    from dmpfold2_tpu_torch.train import dataset, loop

    datasets = []

    class CountingDataset(dataset.DMPDataset):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            datasets.append(self)

    os.makedirs(workdir, exist_ok=True)
    real = loop.DMPDataset, loop.load_cluster_list
    loop.DMPDataset = CountingDataset
    loop.load_cluster_list = lambda p: dataset.load_cluster_list(p, validation_clusters=2)
    try:
        with _recorded_updates() as grads:
            params = loop.main(["--data-dir", data_dir, "--workdir", workdir, *LOOP_ARGS, *argv])
    finally:
        loop.DMPDataset, loop.load_cluster_list = real
    return ([p.detach().numpy().copy() for p in step.leaves(params)], grads,
            sum(d.reads for d in datasets))


def _worker(coord_fold: str, coord_loop: str, nproc: int, pid: int, outdir: str) -> None:
    """One rank: the sharded fold, one DDP step, then the loop's own group."""
    import torch.distributed as dist
    from mp_worker import make_train_dataset

    mesh_mod.initialize_distributed(coord_fold, nproc, pid, device="cpu")
    mesh = mesh_mod.make_mesh(devices=["cpu"])
    assert mesh.shape == {"data": nproc, "seq": 1} and mesh.rank == pid
    folder = BatchFolder(_fold_params(), mesh=mesh, batch_size=BATCH)
    results = folder.fold_many(_targets(), iterations=1, minsteps=2)
    local_targets, global_targets = folder.counters.targets, folder.global_counters().targets
    folder.close()
    per = MICRO_BATCH // nproc
    metrics, stepped, step_grads = _step(mesh, slice(pid * per, (pid + 1) * per))
    dist.destroy_process_group()

    data_dir = os.path.join(outdir, f"data{pid}")
    make_train_dataset(data_dir)
    trained, loop_grads, reads = _run_loop(data_dir, os.path.join(outdir, f"work{pid}"),
                               ["--coordinator", coord_loop, "--num-processes", str(nproc),
                                "--process-id", str(pid)])
    np.savez(os.path.join(outdir, f"proc{pid}.npz"),
             local_targets=local_targets, global_targets=global_targets,
             loss=metrics["loss"], sample_loss=np.asarray(metrics["sample_loss"]),
             skipped=metrics["skipped"], reads=reads,
             **{f"coords{i}": r[0] for i, r in enumerate(results)},
             **{f"confs{i}": r[1] for i, r in enumerate(results)},
             n_leaves=len(stepped), n_updates=len(loop_grads),
             **{f"stepped{i}": p for i, p in enumerate(stepped)},
             **{f"step_grad{i}": g for i, g in enumerate(step_grads)},
             **{f"trained{i}": p for i, p in enumerate(trained)},
             **{f"loop_grad{k}_{i}": g for k, gs in enumerate(loop_grads)
                for i, g in enumerate(gs)})


def _leaves(out, prefix: str) -> list:
    return [out[f"{prefix}{i}"] for i in range(int(out["n_leaves"]))]


def _launch(args_of, outdir, n=2) -> None:
    """Run ``n`` workers (this module as a script), logging to files; fail
    with a worker's log if one fails or outlives WORKER_TIMEOUT_S."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("DMPFOLD2_TPU_LOG", None)
    logs = [open(os.path.join(outdir, f"worker{k}.log"), "w+b") for k in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_of(k)], env=env,
                              cwd=REPO, stdout=logs[k], stderr=subprocess.STDOUT)
             for k in range(n)]
    try:
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs:  # never leave a worker behind
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, fh in zip(procs, logs):
        fh.seek(0)
        text = fh.read().decode(errors="replace")
        fh.close()
        assert p.returncode == 0, f"worker failed:\n{text[-4000:]}"


@pytest.fixture(scope="module")
def mp_outputs(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("torch_mp"))
    fold_port, loop_port = _free_port(), _free_port()
    _launch(lambda k: ["worker", f"127.0.0.1:{fold_port}", f"127.0.0.1:{loop_port}", "2",
                       str(k), outdir], outdir)
    return {k: np.load(os.path.join(outdir, f"proc{k}.npz")) for k in (0, 1)}


# ---------------------------------------------------------------- two processes

def test_two_process_fold_matches_single_process(mp_outputs):
    """Every process holds every result, and each equals a single-process
    BatchFolder's on a mesh of two CPU replicas (the same shard program)."""
    mesh = mesh_mod.make_mesh(2, devices=["cpu", "cpu"])
    folder = BatchFolder(_fold_params(), mesh=mesh, batch_size=BATCH)
    reference = folder.fold_many(_targets(), iterations=1, minsteps=2)
    folder.close()
    for pid in (0, 1):
        out = mp_outputs[pid]
        for i, (coords, confs) in enumerate(reference):
            np.testing.assert_allclose(out[f"coords{i}"], coords, rtol=1e-5, atol=1e-5,
                                       err_msg=f"proc {pid} target {i}")
            np.testing.assert_allclose(out[f"confs{i}"], confs, rtol=1e-5, atol=1e-5,
                                       err_msg=f"proc {pid} target {i}")


def test_two_process_counters_merge(mp_outputs):
    """Each process counts only its own slots; the merged view is global."""
    local = [int(mp_outputs[pid]["local_targets"]) for pid in (0, 1)]
    assert sum(local) == 6 and all(n > 0 for n in local), local
    assert all(int(mp_outputs[pid]["global_targets"]) == 6 for pid in (0, 1))


def test_ddp_step_equals_whole_batch_step(mp_outputs):
    """One data-parallel step: the global loss on both ranks, each rank's
    sample losses the whole batch's, both ranks' parameters the same bits
    after the update, and its gradient and parameters those of the
    single-process step on the whole micro-batch."""
    metrics, want, want_grads = _step()
    losses = [float(mp_outputs[pid]["loss"]) for pid in (0, 1)]
    assert np.isfinite(losses).all() and abs(losses[0] - losses[1]) < 1e-6, losses
    np.testing.assert_allclose(losses[0], metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([mp_outputs[pid]["sample_loss"] for pid in (0, 1)]),
        metrics["sample_loss"], rtol=1e-5)
    assert metrics["skipped"] == 0.0 and all(mp_outputs[pid]["skipped"] == 0.0 for pid in (0, 1))
    for a, b in zip(_leaves(mp_outputs[0], "stepped"), _leaves(mp_outputs[1], "stepped")):
        np.testing.assert_array_equal(a, b)
    for pid in (0, 1):
        out = mp_outputs[pid]
        _assert_same_training(_leaves(out, "stepped"), [_leaves(out, "step_grad")], want,
                              [want_grads], STEP_LR, f"proc {pid} step")


def test_two_process_loop_matches_single_with_half_the_reads(mp_outputs, tmp_path):
    """One epoch of the loop over two processes equals the single-process
    loop, and each process loaded only its half of the training samples
    (plus every validation sample)."""
    from mp_worker import N_TRAIN_CLUSTERS, make_train_dataset

    make_train_dataset(str(tmp_path / "data"))
    want, want_grads, reads = _run_loop(str(tmp_path / "data"), str(tmp_path / "work"))
    n_val = 2
    assert reads == N_TRAIN_CLUSTERS + n_val
    # two micro-batches from the same parameters; Adam steps at the second
    assert len(want_grads) == N_TRAIN_CLUSTERS // MICRO_BATCH
    for pid in (0, 1):
        out = mp_outputs[pid]
        assert int(out["reads"]) == N_TRAIN_CLUSTERS // 2 + n_val
        assert int(out["n_updates"]) == len(want_grads)
        grads = [_leaves(out, f"loop_grad{k}_") for k in range(len(want_grads))]
        _assert_same_training(_leaves(out, "trained"), grads, want, want_grads,
                              TrainConfig.learning_rate_scratch, f"proc {pid} loop")


# ---------------------------------------------------------------- one process

def test_mesh_batch_matches_jax_mesh_batch():
    """The port's BatchFolder over two CPU replicas against JAX's over two
    virtual CPU devices (shard_map), the same toy model and targets, at
    tests/test_torch_stream.py:70-86's bounds."""
    import jax

    from dmpfold2_tpu.models.gruresnet import init_params as jax_init_params
    from dmpfold2_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dmpfold2_tpu.parallel.stream import BatchFolder as JaxBatchFolder
    from dmpfold2_tpu.parallel.stream import Target as JaxTarget
    from dmpfold2_tpu_torch.weights import params_from_jax

    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), width=32, cwidth=16,
                                                    num_blocks=2))
    tree["coord_fc"] = tree["coord_fc"] * np.float32(256.0)
    targets = _targets()
    ours = BatchFolder(params_from_jax(tree), mesh=mesh_mod.make_mesh(2, devices=["cpu"] * 2),
                       batch_size=BATCH)
    got = ours.fold_many(targets, iterations=1, minsteps=5)
    ours.close()
    ref = JaxBatchFolder(tree, mesh=jax_make_mesh(n_data=2), batch_size=BATCH).fold_many(
        [JaxTarget(t.alnmat) for t in targets], iterations=1, minsteps=5)
    assert ours.counters.targets == len(targets)
    for (gc, gf), (rc, rf) in zip(got, ref):
        np.testing.assert_allclose(gf, np.asarray(rf), atol=2e-4)
        np.testing.assert_allclose(gc, np.asarray(rc), atol=5e-3)


def test_make_mesh_errors_and_parse():
    with pytest.raises(ValueError, match="mesh 3x1 needs 3 devices but only 2 are available"):
        mesh_mod.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 1 devices but only 0"):
        mesh_mod.make_mesh(devices=[])
    grid = mesh_mod.make_mesh(2, 2, devices=["cpu"] * 4)
    assert grid.shape == {"data": 2, "seq": 2} and grid.devices == ((torch.device("cpu"),) * 2,) * 2
    row = mesh_mod.parse_mesh("1x2", "cpu")
    assert row.shape == {"data": 1, "seq": 2} and row.local_devices == [torch.device("cpu")]
    mesh = mesh_mod.parse_mesh("3", "cpu")
    assert mesh.shape == {"data": 3, "seq": 1} and mesh.local_devices == [torch.device("cpu")] * 3
    assert mesh_mod.owned_batch_indices(mesh, 6) == set(range(6))
    assert mesh_mod.parse_mesh("auto", "cpu").n_data == 1
    assert mesh_mod.replicate_result([1, 2]) == [1, 2]  # one process: no-op
    with pytest.raises(ValueError, match="device or a mesh"):
        BatchFolder(_fold_params(), device="cpu", mesh=mesh)


def test_serve_mesh_answers_concurrent_requests():
    """serve over a mesh of two CPU replicas: warm-up, then a burst of four
    requests and a lone one, every answer a PDB; every request rides the
    batched path."""
    from dmpfold2_tpu_torch.serve import serve

    server = serve(_fold_params(), host="127.0.0.1", port=0, precision="fp32",
                   batch_window_s=1.0, max_batch=8,
                   mesh=mesh_mod.parse_mesh("2", "cpu"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/fold?iterations=0&minsteps=1"
    bodies, errors = [], []

    def client():
        req = urllib.request.Request(url, data=b">q\nIKLTVGGVDITFEPN\nITLTIAGTDISFEPT\n",
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=WORKER_TIMEOUT_S) as resp:
                bodies.append(resp.read().decode())
        except Exception as exc:  # noqa: BLE001 - surfaced in the assert
            errors.append(exc)

    service = server.fold_service
    try:
        service.warmup(shapes=((2, 16),))
        assert service.ready()
        warm_targets = service.counters.targets
        clients = [threading.Thread(target=client) for _ in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=WORKER_TIMEOUT_S)
        assert not any(c.is_alive() for c in clients)
        client()
    finally:
        server.shutdown()
        service.close()
        server.server_close()
        service.batcher.close()
    assert not errors, errors
    assert len(bodies) == 5 and all(b.startswith("REMARK  CONF:") for b in bodies)
    assert service.batch_stats["requests"] == 5 and service.batch_stats["max_coalesced"] >= 2
    assert service.counters.targets - warm_targets == 5


# ---------------------------------------------------------------- on a card

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _card_step(mesh=None, shard=slice(None)):
    """phase multi's DDP step in small form: fp32 toy widths on cuda:0,
    micro-batch 2, nloops 0, refine 0; returns (metrics, parameters after)."""
    params = step.trainable(init_params(seed=0, width=32, cwidth=16, num_blocks=2),
                            torch.device("cuda", 0))
    optimizer = step.make_optimizer(params, STEP_LR)
    batch = step.TrainBatch(*(a[:2][shard] for a in _step_batch()))
    with _recorded_updates() as grads:
        metrics = step.train_step(params, optimizer, batch, STEP_SEED, nloops=0,
                                  refine_steps=0, mesh=mesh)
    return metrics, [p.detach().cpu().numpy() for p in step.leaves(params)], grads[0]


def _card_worker(coord: str, pid: int, outdir: str) -> None:
    """One of two ranks on cuda:0 over gloo (NCCL refuses two ranks on one GPU)."""
    mesh_mod.initialize_distributed(coord, 2, pid, device="cuda:0", backend="gloo")
    metrics, stepped, grads = _card_step(mesh_mod.make_mesh(), slice(pid, pid + 1))
    np.savez(os.path.join(outdir, f"card{pid}.npz"), loss=metrics["loss"],
             sample_loss=np.asarray(metrics["sample_loss"]), n_leaves=len(stepped),
             **{f"stepped{i}": p for i, p in enumerate(stepped)},
             **{f"step_grad{i}": g for i, g in enumerate(grads)})


@pytest.mark.gpu
def test_two_ranks_on_one_card_over_gloo(tmp_path):
    """Two processes share cuda:0 over gloo: each sample's loss the
    single-process step's within 1e-5 relative, both ranks' parameters the
    same bits after the update, gradient and parameters as the CPU test
    holds them against the single-process step."""
    _require_cuda()
    port = _free_port()
    _launch(lambda k: ["card-worker", f"127.0.0.1:{port}", str(k), str(tmp_path)], str(tmp_path))
    metrics, want, want_grads = _card_step()
    outs = [np.load(tmp_path / f"card{k}.npz") for k in (0, 1)]
    np.testing.assert_allclose(np.concatenate([o["sample_loss"] for o in outs]),
                               metrics["sample_loss"], rtol=1e-5)
    for a, b in zip(_leaves(outs[0], "stepped"), _leaves(outs[1], "stepped")):
        np.testing.assert_array_equal(a, b)
    _assert_same_training(_leaves(outs[0], "stepped"), [_leaves(outs[0], "step_grad")], want,
                          [want_grads], STEP_LR, "card")


@pytest.mark.gpu
def test_nccl_group_of_one_is_the_plain_step(tmp_path):
    """A world-size-1 NCCL group: the step gives the same bits as without a
    group (cuDNN's deterministic algorithms, so that two plain steps agree)."""
    _require_cuda()
    import torch.distributed as dist

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain_metrics, plain, _ = _card_step()
        mesh_mod.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda:0")
        try:
            assert dist.get_backend() == "nccl"
            metrics, grouped, _ = _card_step(mesh_mod.make_mesh())
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert metrics["loss"] == plain_metrics["loss"]
    for a, b in zip(grouped, plain):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    elif sys.argv[1] == "card-worker":
        _card_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
