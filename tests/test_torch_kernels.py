"""The PyTorch port's kernels against the JAX package.

On the CPU each wrapper runs its kernel's plain version; those are held
against two JAX functions: the Pallas kernel in interpret mode (as
tests/test_pallas_kernels.py and tests/test_pallas_refine.py run it) and the
JAX scan or XLA path. Tolerances are those files': 1e-5 for the GRUs, 1e-4
for refinement.

The ``gpu`` tests run the CUDA kernels against the plain versions on a card;
they decide inside the test whether a card is present and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmpfold2_tpu.kernels.refine import refine_coords_pallas
from dmpfold2_tpu.kernels.rgru import bigru_stack_pallas, gru_seq_pallas
from dmpfold2_tpu.kernels.vgru import vgru_final_cols_pallas
from dmpfold2_tpu.models import geometry as jax_geometry
from dmpfold2_tpu.models import gru as jax_gru
from dmpfold2_tpu_torch.kernels import refine, rgru, vgru

GRU_TOL = 1e-5
REFINE_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


@pytest.fixture(scope="module")
def vgru_layers():
    return _np_tree(jax_gru.unigru_stack_params(jax.random.PRNGKey(0), 2, 22, 64))


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


# ---------------------------------------------------------------- vgru

@pytest.mark.parametrize("n_rows,n_cols,seed", [(24, 16, 2), (12, 13, 5), (20, 8, 1)])
def test_vgru_plain_per_column_valid(vgru_layers, n_rows, n_cols, seed):
    """Per-column valid depths, a prime column count (13)."""
    rng = np.random.default_rng(seed)
    aln = rng.integers(0, 22, (n_rows, n_cols)).astype(np.int32)
    valid = rng.integers(1, n_rows + 1, n_cols).astype(np.int32)
    ours = vgru.vgru_final_cols(_torch_tree(vgru_layers), torch.from_numpy(aln),
                                torch.from_numpy(valid)).numpy()
    pallas = np.asarray(vgru_final_cols_pallas(vgru_layers, jnp.asarray(aln),
                                               jnp.asarray(valid), interpret=True))
    x = jnp.asarray(aln[..., None] == np.arange(22), jnp.float32)
    scan = np.asarray(jax_gru.unigru_stack_final(vgru_layers, x, valid_len=jnp.asarray(valid)))
    assert ours.shape == (n_cols, 64)
    np.testing.assert_allclose(ours, pallas, atol=GRU_TOL)
    np.testing.assert_allclose(ours, scan, atol=GRU_TOL)


def test_vgru_plain_single_target_padding(vgru_layers):
    """Padded rows past the true depth leave the state as the unpadded run's."""
    rng = np.random.default_rng(7)
    aln = rng.integers(0, 22, (15, 10)).astype(np.int32)
    padded = np.zeros((24, 10), np.int32)
    padded[:15] = aln
    layers = _torch_tree(vgru_layers)
    depth = torch.full((10,), 15, dtype=torch.int32)  # the target's depth in every column
    base = vgru.vgru_final_cols(layers, torch.from_numpy(aln), depth).numpy()
    ours = vgru.vgru_final_cols(layers, torch.from_numpy(padded), depth).numpy()
    np.testing.assert_array_equal(ours, base)
    from dmpfold2_tpu.kernels.vgru import vgru_final_pallas

    pallas = np.asarray(vgru_final_pallas(vgru_layers, jnp.asarray(padded), 15, interpret=True))
    np.testing.assert_allclose(ours, pallas, atol=GRU_TOL)


@pytest.mark.parametrize("n_rows,n_cols,seed", [(24, 16, 2), (12, 13, 5), (9, 40, 3)])
def test_vgru_plain_depth_zero_and_early_end(vgru_layers, n_rows, n_cols, seed):
    """Edges of the column freeze: a column of depth 0 stays at the zero
    state, tokens of class 22 give all-zero one-hots, and in one case every
    column ends short of the last rows (the kernel's scan then stops at the
    deepest column)."""
    rng = np.random.default_rng(seed)
    aln = rng.integers(0, 23, (n_rows, n_cols)).astype(np.int32)
    valid = rng.integers(0, n_rows + 1, n_cols).astype(np.int32)
    valid[0] = 0
    if seed == 3:
        valid = np.minimum(valid, n_rows - 2)
    ours = vgru.vgru_final_cols(_torch_tree(vgru_layers), torch.from_numpy(aln),
                                torch.from_numpy(valid)).numpy()
    pallas = np.asarray(vgru_final_cols_pallas(vgru_layers, jnp.asarray(aln),
                                               jnp.asarray(valid), interpret=True))
    x = jnp.asarray(aln[..., None] == np.arange(22), jnp.float32)
    scan = np.asarray(jax_gru.unigru_stack_final(vgru_layers, x, valid_len=jnp.asarray(valid)))
    np.testing.assert_allclose(ours, pallas, atol=GRU_TOL)
    np.testing.assert_allclose(ours, scan, atol=GRU_TOL)
    np.testing.assert_array_equal(ours[0], 0.0)


# ---------------------------------------------------------------- rgru

@pytest.mark.parametrize("reverse", [False, True])
def test_rgru_plain_per_column_valid(reverse):
    rng = np.random.default_rng(3)
    t_len, batch, hidden = 23, 5, 32
    p = _np_tree(jax_gru.gru_layer_params(jax.random.PRNGKey(1), 8, hidden))
    pt = _torch_tree(p)
    xproj = rng.normal(size=(t_len, batch, 3 * hidden)).astype(np.float32)
    valid = np.asarray([23, 17, 1, 9, 0], np.int32)
    ours = rgru.gru_seq(pt["wh"], pt["bh"], torch.from_numpy(xproj), torch.from_numpy(valid),
                        reverse=reverse).numpy()
    pallas = np.asarray(gru_seq_pallas(p["wh"], p["bh"], jnp.asarray(xproj), jnp.asarray(valid),
                                       reverse=reverse, interpret=True))
    np.testing.assert_allclose(ours, pallas, atol=GRU_TOL)
    if reverse:  # a reverse pass holds zero past each column's length
        assert np.all(ours[17:, 1] == 0) and np.all(ours[:, 4] == 0)
    else:        # a forward pass freezes there
        np.testing.assert_array_equal(ours[9:, 3], np.broadcast_to(ours[8, 3], ours[9:, 3].shape))


def test_rgru_stack_matches_scan_and_pallas():
    """Three bidirectional layers, per-target lengths (as coord_gru runs)."""
    stack = _np_tree(jax_gru.bigru_stack_params(jax.random.PRNGKey(2), 3, 40, 32))
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (19, 4, 40), jnp.float32))
    valid = np.asarray([19, 11, 1, 14], np.int32)
    ours = rgru.bigru_stack(_torch_tree(stack), torch.from_numpy(x), torch.from_numpy(valid))
    scan = np.asarray(jax_gru.bigru_stack(stack, jnp.asarray(x), jnp.asarray(valid)))
    pallas = np.asarray(bigru_stack_pallas(stack, jnp.asarray(x), jnp.asarray(valid),
                                           interpret=True))
    np.testing.assert_allclose(ours.numpy(), scan, atol=GRU_TOL)
    np.testing.assert_allclose(ours.numpy(), pallas, atol=GRU_TOL)


@pytest.mark.parametrize("hidden", [16, 32])
def test_rgru_bidir_plain_matches_pallas(hidden):
    """Both directions of one layer (gru_seq_bidir, here its plain version)
    against the Pallas stack and the Pallas layer-direction kernel, at a
    ragged batch with a zero length."""
    rng = np.random.default_rng(hidden)
    t_len, c_in = 13, 6
    valid = np.asarray([13, 9, 1, 0, 5], np.int32)
    stack = _np_tree(jax_gru.bigru_stack_params(jax.random.PRNGKey(hidden), 1, c_in, hidden))
    x = rng.normal(size=(t_len, len(valid), c_in)).astype(np.float32)
    fwd, bwd = stack[0]["fwd"], stack[0]["bwd"]
    xf, xb = (x @ p["wi"] + p["bi"] for p in (fwd, bwd))
    before = rgru.launches
    ours = rgru.gru_seq_bidir(_torch_tree(fwd), _torch_tree(bwd), torch.from_numpy(xf),
                              torch.from_numpy(xb), torch.from_numpy(valid)).numpy()
    assert rgru.launches == before and ours.shape == (t_len, len(valid), 2 * hidden)
    pallas_stack = np.asarray(bigru_stack_pallas(stack, jnp.asarray(x), jnp.asarray(valid),
                                                 interpret=True))
    pallas_dirs = np.concatenate(
        [np.asarray(gru_seq_pallas(p["wh"], p["bh"], jnp.asarray(xp), jnp.asarray(valid),
                                   reverse=rev, interpret=True))
         for p, xp, rev in ((fwd, xf, False), (bwd, xb, True))], axis=-1)
    np.testing.assert_allclose(ours, pallas_stack, atol=GRU_TOL)
    np.testing.assert_allclose(ours, pallas_dirs, atol=GRU_TOL)
    assert np.all(ours[:, 3] == 0)  # the zero-length column


def test_rgru_stack_one_launch_per_layer(monkeypatch):
    """The fold's stack makes one gru_seq_bidir call (one launch on a card)
    per layer and no one-direction call, and equals the training stack."""
    from dmpfold2_tpu_torch.models import gru as torch_gru

    stack = _torch_tree(_np_tree(jax_gru.bigru_stack_params(jax.random.PRNGKey(6), 3, 10, 16)))
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(11, 2, 10)).astype(np.float32))
    valid = torch.tensor([11, 4], dtype=torch.int32)
    calls = []
    bidir = rgru.gru_seq_bidir

    def counting(*args):
        calls.append(args[2].shape)
        return bidir(*args)

    def one_direction(*args, **kw):
        raise AssertionError("the stack launched one direction alone")

    monkeypatch.setattr(rgru, "gru_seq_bidir", counting)
    monkeypatch.setattr(rgru, "gru_seq", one_direction)
    ours = rgru.bigru_stack(stack, x, valid)
    assert len(calls) == 3
    np.testing.assert_array_equal(ours.numpy(), torch_gru.bigru_stack(stack, x, valid).numpy())


def test_rgru_scalar_valid_single_target():
    stack = _np_tree(jax_gru.bigru_stack_params(jax.random.PRNGKey(4), 2, 12, 16))
    x = np.array(jax.random.normal(jax.random.PRNGKey(5), (19, 1, 12), jnp.float32))
    ours = rgru.bigru_stack(_torch_tree(stack), torch.from_numpy(x), 13).numpy()
    scan = np.asarray(jax_gru.bigru_stack(stack, jnp.asarray(x), 13))
    np.testing.assert_allclose(ours, scan, atol=GRU_TOL)


# ---------------------------------------------------------------- refine

def _chain(l, seed, scale=4.0):
    return (np.random.default_rng(seed).normal(size=(l, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("l,nres,steps", [(25, 25, 20), (96, 96, 100), (130, 101, 7),
                                          (88, 82, 30)])
def test_refine_plain_matches_pallas_and_xla(l, nres, steps):
    ca = _chain(l, seed=l)
    ours = refine.refine_coords_batched(torch.from_numpy(ca[None]), steps,
                                        torch.tensor([nres], dtype=torch.int32))[0].numpy()
    xla = np.asarray(jax_geometry.refine_coords(jnp.asarray(ca), jnp.asarray(steps), nres))
    pallas = np.asarray(refine_coords_pallas(jnp.asarray(ca), jnp.asarray(steps), nres,
                                             interpret=True))
    np.testing.assert_allclose(ours, xla, atol=REFINE_TOL)
    np.testing.assert_allclose(ours, pallas, atol=REFINE_TOL)
    np.testing.assert_array_equal(ours[nres:], ca[nres:])  # padding stays put


@pytest.mark.parametrize("l,steps,nres,seeds", [
    (40, 20, [40, 23, 1], (3, 4, 5)),  # a full target, a padded one, a single residue
    (50, 15, [44], (6,)),              # B 1, as the single fold launches it
])
def test_refine_batched_plain_matches_vmapped_pallas_and_xla(l, steps, nres, seeds):
    """The batched plain version against the JAX package's vmap of the
    Pallas kernel and its XLA path."""
    nres = np.array(nres, np.int32)
    ca = np.stack([_chain(l, seed=s) for s in seeds])
    ours = refine.refine_coords_batched(torch.from_numpy(ca), steps,
                                        torch.from_numpy(nres)).numpy()
    pallas = np.asarray(jax.vmap(lambda c, n: refine_coords_pallas(
        c, jnp.asarray(steps), n, interpret=True))(jnp.asarray(ca), jnp.asarray(nres)))
    for b, n in enumerate(nres):
        xla = np.asarray(jax_geometry.refine_coords(jnp.asarray(ca[b]), jnp.asarray(steps), n))
        np.testing.assert_allclose(ours[b], xla, atol=REFINE_TOL)
        np.testing.assert_allclose(ours[b], pallas[b], atol=REFINE_TOL)
        np.testing.assert_array_equal(ours[b, n:], ca[b, n:])  # padding stays put


@pytest.mark.parametrize("batched", [False, True])
def test_refine_plain_zero_steps_identity(batched):
    """Zero steps leave the traces as they are: one target (B 1, the single
    fold's launch) or a batch of two."""
    ca = _chain(33, seed=2)
    cas, nres = (np.stack([ca, ca]), [33, 20]) if batched else (ca[None], [33])
    out = refine.refine_coords_batched(torch.from_numpy(cas), 0,
                                       torch.tensor(nres, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), cas)


def test_refine_limit_covers_every_bucket():
    """The kernel's shared memory holds a trace of the largest bucket; a
    longer one is refused with the limit named, before any build or launch
    (meta tensors: the wrapper's checks run on shapes alone)."""
    from dmpfold2_tpu_torch.engine.buckets import RES_BUCKETS

    assert refine.MAX_L >= RES_BUCKETS[-1]
    meta = torch.device("meta")
    nres = torch.empty((1,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match=f"L <= {refine.MAX_L}"):
        refine.refine_coords_batched(torch.empty((1, refine.MAX_L + 1, 3), device=meta), 10,
                                     nres)


def test_refine_plain_padded_matches_unpadded():
    ca = _chain(40, seed=9)
    nres = torch.tensor([40], dtype=torch.int32)
    base = refine.refine_coords_batched(torch.from_numpy(ca[None]), 30, nres)[0].numpy()
    ca_pad = np.zeros((1, 70, 3), np.float32)
    ca_pad[0, :40] = ca
    padded = refine.refine_coords_batched(torch.from_numpy(ca_pad), 30, nres)[0].numpy()
    np.testing.assert_allclose(padded[:40], base, atol=1e-5)


def test_cpu_wrappers_do_not_launch(vgru_layers):
    before = (vgru.launches, rgru.launches, refine.launches)
    refine.refine_coords_batched(torch.zeros(2, 4, 3), 2, torch.tensor([4, 3], dtype=torch.int32))
    vgru.vgru_final_cols(_torch_tree(vgru_layers), torch.zeros((5, 3), dtype=torch.int32),
                         torch.full((3,), 5, dtype=torch.int32))
    stack = _torch_tree(_np_tree(jax_gru.bigru_stack_params(jax.random.PRNGKey(0), 1, 4, 16)))
    rgru.bigru_stack(stack, torch.zeros((3, 1, 4)), 3)
    assert (vgru.launches, rgru.launches, refine.launches) == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: a kernel that cannot be built raises."""
    from dmpfold2_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("refine",))


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_wrappers_reject_bad_input_on_card():
    _require_cuda()
    dev = torch.device("cuda")
    layers = [{k: torch.zeros(s, device=dev) for k, s in
               (("wi", (22 if i == 0 else 512, 1536)), ("wh", (512, 1536)), ("bi", (1536,)),
                ("bh", (1536,)))} for i in range(2)]
    aln64 = torch.zeros((4, 8), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="aln_cols"):
        vgru.vgru_final_cols(layers, aln64, torch.zeros(8, dtype=torch.int32, device=dev))
    xproj = torch.zeros((1, 768, 5), device=dev).permute(0, 2, 1)  # (1, 5, 768), strided
    with pytest.raises(ValueError, match="xproj"):
        rgru.gru_seq(layers[1]["wh"][:256, :768].contiguous(), torch.zeros(768, device=dev),
                     xproj, torch.ones(5, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="nres"):
        refine.refine_coords_batched(torch.zeros((1, 4, 3), device=dev), 10,
                                     torch.tensor([5], device=dev))  # int64

@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,n_cols", [(256, 88), (1024, 352)])
def test_vgru_kernel_on_card(n_rows, n_cols):
    _require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    layers = _torch_tree(_np_tree(jax_gru.unigru_stack_params(jax.random.PRNGKey(0), 2, 22, 512)))
    layers = [{k: v.to(dev) for k, v in p.items()} for p in layers]
    aln = torch.from_numpy(rng.integers(0, 22, (n_rows, n_cols)).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.integers(0, n_rows + 1, n_cols).astype(np.int32)).to(dev)
    before = vgru.launches
    out = vgru.vgru_final_cols(layers, aln, valid)
    out2 = vgru.vgru_final_cols(layers, aln, valid)
    ref = vgru.vgru_final_cols_plain(layers, aln, valid)
    torch.cuda.synchronize()
    assert vgru.launches == before + 2
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.equal(out, out2)


@pytest.mark.gpu
def test_vgru_launch_error_raises(monkeypatch):
    """The wrapper turns the library's error code into an exception: here a
    stub returns the code a refused cooperative launch gives. The kernel's
    own co-residency check is not reached (an H100 holds all 128 blocks)."""
    _require_cuda()
    from dmpfold2_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    layers = [{k: torch.zeros(s, device=dev) for k, s in
               (("wi", (22 if i == 0 else 64, 192)), ("wh", (64, 192)), ("bi", (192,)),
                ("bh", (192,)))} for i in range(2)]
    too_large = 720  # cudaErrorCooperativeLaunchTooLarge
    monkeypatch.setattr(_build, "load", lambda name, entry=None: lambda *args: too_large)
    with pytest.raises(RuntimeError):
        vgru.vgru_final_cols(layers, torch.zeros((4, 8), dtype=torch.int32, device=dev),
                             torch.full((8,), 4, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_rgru_kernel_on_card(reverse):
    _require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    p = _torch_tree(_np_tree(jax_gru.gru_layer_params(jax.random.PRNGKey(1), 8, 256)))
    p = {k: v.to(dev) for k, v in p.items()}
    xproj = torch.from_numpy(rng.normal(size=(88, 5, 768)).astype(np.float32)).to(dev)
    valid = torch.tensor([88, 61, 1, 82, 0], dtype=torch.int32, device=dev)
    out = rgru.gru_seq(p["wh"], p["bh"], xproj, valid, reverse=reverse)
    ref = rgru.gru_seq_plain(p["wh"], p["bh"], xproj, valid, reverse=reverse)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("t_len,valid", [(88, [82]), (88, [88, 61, 1, 82, 0]), (352, [350])])
def test_rgru_bidir_kernel_on_card(t_len, valid):
    """One launch for both directions of a layer at the main path's shape
    (H 256), a ragged batch with a zero length and the crop bucket's T."""
    _require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(t_len)
    stack = _torch_tree(_np_tree(jax_gru.bigru_stack_params(jax.random.PRNGKey(1), 1, 8, 256)))
    fwd, bwd = ({k: v.to(dev) for k, v in stack[0][d].items()} for d in ("fwd", "bwd"))
    xf, xb = (torch.from_numpy(rng.normal(size=(t_len, len(valid), 768)).astype(np.float32))
              .to(dev) for _ in range(2))
    v = torch.tensor(valid, dtype=torch.int32, device=dev)
    before = rgru.launches
    out = rgru.gru_seq_bidir(fwd, bwd, xf, xb, v)
    out2 = rgru.gru_seq_bidir(fwd, bwd, xf, xb, v)
    ref = rgru.gru_seq_bidir_plain(fwd, bwd, xf, xb, v)
    torch.cuda.synchronize()
    assert rgru.launches == before + 2
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.equal(out, out2)


def _chains_on_card(l, count, seed, packed=False):
    """Random-walk CA traces with 3.8 A steps, (count, l, 3) on the card; or,
    ``packed``, points uniform in a ball of radius 1.4 A (every pair closer
    than 3 A, as in the random model's collapsed trace)."""
    rng = np.random.default_rng(seed)
    if packed:
        dirs = rng.normal(size=(count, l, 3))
        dirs *= 1.4 * rng.uniform(size=(count, l, 1)) ** (1 / 3) / np.linalg.norm(
            dirs, axis=2, keepdims=True)
        return torch.from_numpy(dirs.astype(np.float32)).cuda()
    steps = rng.normal(size=(count, l, 3))
    steps *= 3.8 / np.linalg.norm(steps, axis=2, keepdims=True)
    return torch.from_numpy(np.cumsum(steps, axis=1).astype(np.float32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("l,nres,packed", [(88, [82], False), (88, [82], True),
                                            (1536, [1536], False),
                                            (352, [352, 300, 82, 1], False)])
def test_refine_kernel_on_card(l, nres, packed):
    """The batched kernel at the fold's shape (a random walk and a packed
    trace), the largest bucket and a ragged batch: within 1e-4 of the plain
    version, the same bits on a second launch, padding untouched. 100 steps
    from a packed trace part two fp32 versions by far more than 1e-4, so
    there each kernel step is held against a plain step from the same state
    along the plain path."""
    _require_cuda()
    ca = _chains_on_card(l, len(nres), seed=l, packed=packed)
    nr = torch.tensor(nres, dtype=torch.int32, device=ca.device)
    before = refine.launches
    out = refine.refine_coords_batched(ca, 100, nr)
    out2 = refine.refine_coords_batched(ca, 100, nr)
    assert refine.launches == before + 2
    if packed:
        x, worst = ca, 0.0
        for _ in range(100):
            nxt = refine.refine_coords_batched_plain(x, 1, nr)
            worst = max(worst, (refine.refine_coords_batched(x, 1, nr) - nxt).abs().max().item())
            x = nxt
        assert worst <= REFINE_TOL
    else:
        ref = refine.refine_coords_batched_plain(ca, 100, nr)
        assert (out - ref).abs().max().item() <= REFINE_TOL
    assert torch.equal(out, out2)
    for b, n in enumerate(nres):
        assert torch.equal(out[b, n:], ca[b, n:])
