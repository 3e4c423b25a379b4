"""Checkpoint and warm restart: the reference's three-file scheme.

Counterpart of ``dmpfold2_tpu/train/checkpoint.py`` (reference
train.py:249-281, 402-418): per epoch the best-validation and best-training
parameters and a rolling checkpoint. Parameters are written as the JAX
package's ``.npz`` (``weights.save_npz``: JAX key paths and layouts), so
either package restores the other's files; the optimizer state is this
package's own (``step.Optimizer.state_dict``), pickled beside them. The
shape-filtered partial restore keeps training restartable across model
edits.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..weights import keypaths, params_from_jax, params_to_jax, save_npz, tree_from_keypaths

BEST_VAL = "fullmap_e2e_model.npz"
BEST_TRAIN = "fullmap_e2e_model_train.npz"
LATEST = "latest_model.npz"
CHECKPOINT = "checkpoint.pkl"


def save_params(path: str, params) -> None:
    save_npz(path, params)


def partial_restore(params, path: str):
    """Parameters from a ``.npz``, keeping only the leaves whose JAX key path
    and shape match ``params`` (train.py:261-262), cast to the skeleton's
    dtype; the others stay as in ``params``. Returns (fp32 parameters on the
    CPU, number of JAX leaves restored)."""
    skeleton = dict(keypaths(params_to_jax(params)))
    merged, n_loaded = {}, 0
    with np.load(path) as data:
        for key, leaf in skeleton.items():
            if key in data.files and data[key].shape == leaf.shape:
                merged[key] = data[key].astype(leaf.dtype)
                n_loaded += 1
            else:
                merged[key] = leaf
    return params_from_jax(tree_from_keypaths(merged)), n_loaded


def save_train_state(workdir: str, epoch: int, opt_state: dict, val_err_min: float,
                     train_err_min: float, params=None) -> None:
    """The rolling checkpoint: ``params`` (when given) as LATEST with the
    epoch stamped in (``__epoch__``), then the optimizer state and minima,
    each written to a temp file and renamed. The optimizer's moments and
    accumulation buffer only mean something with the parameters they were
    computed against, so resume restores both."""
    if params is not None:
        save_npz(os.path.join(workdir, LATEST), params, extra={"__epoch__": np.int64(epoch)})
    state = {"epoch": epoch, "opt_state": opt_state, "val_err_min": val_err_min,
             "train_err_min": train_err_min}
    tmp = os.path.join(workdir, CHECKPOINT + ".tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, os.path.join(workdir, CHECKPOINT))


def load_train_state(workdir: str):
    path = os.path.join(workdir, CHECKPOINT)
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as fh:
        return pickle.load(fh)
