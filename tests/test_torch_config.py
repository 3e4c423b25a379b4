"""The widths the card's kernels run: ``gruresnet.check_card_widths`` and its
callers (``Folder``, ``train_step``, the training loop), all on the CPU.

The check is shape arithmetic, so it runs here with ``torch.device("cuda")``;
the callers are shown to reject a width before any upload by making CUDA look
available and failing the upload if it is reached.
"""

import pytest
import torch

from dmpfold2_tpu_torch.engine import fold
from dmpfold2_tpu_torch.models.gruresnet import check_card_widths, init_params
from dmpfold2_tpu_torch.train import loop, step

CUDA = torch.device("cuda")


@pytest.fixture(scope="module")
def models():
    """init_params at (width, cwidth), one trunk block."""
    return {wc: init_params(seed=0, width=wc[0], cwidth=wc[1], num_blocks=1)
            for wc in ((512, 128), (1024, 128), (512, 64), (32, 16))}


@pytest.mark.parametrize("widths,precision,limits", [
    ((1024, 128), "fp32", ["vgru (width): hidden size 1024 must be a multiple of 32, at most 512",
                           "rgru (hgru, width / 2): hidden size 512 must be a multiple of 32 "
                           "and at most 256", "rgru (coord_gru, width / 2)"]),
    ((512, 64), "bf16", ["block conv (cwidth -> 4 x cwidth): c_in must be 128 (got 64)"]),
    ((32, 16), "bf16", ["rgru (hgru, width / 2): hidden size 16 must be a multiple of 32",
                        "c_in must be 128 (got 16); c_out must be a multiple of 256 (got 64)",
                        "input GEMM (3 x cwidth outputs): c_out must be a multiple of 192 "
                        "(got 48)"]),
])
def test_card_widths_reject_with_the_limit_named(models, widths, precision, limits):
    with pytest.raises(ValueError) as err:
        check_card_widths(models[widths], precision, CUDA)
    for limit in limits:
        assert limit in str(err.value)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_card_widths_accept_reference_and_cpu(models, precision):
    check_card_widths(models[(512, 128)], precision, CUDA)
    check_card_widths(models[(512, 128)], precision, CUDA, training=True)
    for params in models.values():
        check_card_widths(params, precision, torch.device("cpu"))
        check_card_widths(params, precision, "cpu", training=True)


def test_card_widths_training_runs_its_grus_plain(models):
    """A training step runs no GRU kernel: width 1024 trains on the card in
    fp32 and bf16, while cwidth 64 still fails the bf16 block conv."""
    for precision in ("fp32", "bf16"):
        check_card_widths(models[(1024, 128)], precision, CUDA, training=True)
    check_card_widths(models[(512, 64)], "fp32", CUDA, training=True)
    with pytest.raises(ValueError, match="c_in must be 128"):
        check_card_widths(models[(512, 64)], "bf16", CUDA, training=True)


def _no_upload(*args, **kwargs):
    raise AssertionError("the parameters were uploaded before the width check")


def test_folder_rejects_before_upload(monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(fold, "params_to", _no_upload)
    with pytest.raises(ValueError, match="vgru .width.: hidden size 1024"):
        fold.Folder(models[(1024, 128)], device="cuda")
    with pytest.raises(ValueError, match="c_in must be 128"):
        fold.Folder(models[(512, 64)], device="cuda", precision="bf16")


def test_train_step_rejects_before_upload(monkeypatch, models):
    class OnCard:
        device = CUDA

    monkeypatch.setattr(step, "leaves", lambda params: [OnCard()])
    monkeypatch.setattr(torch, "from_numpy", _no_upload)
    with pytest.raises(ValueError, match="c_in must be 128"):
        step.train_step(models[(512, 64)], None, None, seed=0, nloops=0, precision="bf16")


def test_train_loop_rejects_before_upload(monkeypatch, tmp_path):
    (tmp_path / "clusters.lst").write_text("")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(loop, "trainable", _no_upload)
    with pytest.raises(ValueError, match="c_in must be 128"):
        loop.main(["--data-dir", str(tmp_path), "--clusters", "clusters.lst", "--workdir",
                   str(tmp_path), "--precision", "bf16", "--width", "32", "--cwidth", "64",
                   "--num-blocks", "1", "--no-restart"])
