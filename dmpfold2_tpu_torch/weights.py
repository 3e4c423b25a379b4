"""Parameter loading: JAX parameter trees, ``.npz`` files and reference state dicts.

The port's parameters are nested dicts and lists of tensors with the keys of
the JAX package's tree (``dmpfold2_tpu/models/gruresnet.py:init_params``),
in PyTorch layouts where a kernel or ``F.conv2d`` wants them:

  * GRU ``wi`` (in, 3H), ``wh`` (H, 3H), biases (3H,): the JAX layout, which
    the CUDA kernels read coalesced along the gate axis;
  * convolutions OIHW (JAX: HWIO);
  * ``trunk.blocks`` a list of per-block dicts (JAX: stacked on axis 0).

Three sources: :func:`params_from_jax` (a JAX tree as numpy arrays),
:func:`load_npz` (files written by ``dmpfold2_tpu.weights.save_params``) and
:func:`load_state_dict` (the reference's torch state-dict names); one sink,
:func:`save_npz`, which writes the JAX package's file format (training's
checkpoints).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(v, dtype=np.float32))  # a writable copy


def _hwio_to_oihw(v) -> torch.Tensor:
    return _t(v).permute(3, 2, 0, 1).contiguous()


def _gru(p):
    return {k: _t(p[k]) for k in ("wi", "wh", "bi", "bh")}


def _maxout(p):
    return {"w": _hwio_to_oihw(p["w"]), "b": _t(p["b"]),
            "gamma": _t(p["gamma"]), "beta": _t(p["beta"])}


def params_from_jax(tree):
    """JAX parameter tree (nested dicts/lists of arrays) -> port parameters."""
    stacked = tree["trunk"]["blocks"]
    num_blocks = np.asarray(stacked["maxout"]["gamma"]).shape[0]

    def block(i):
        mx, se = stacked["maxout"], stacked["scse"]
        return {
            "maxout": _maxout({k: np.asarray(v)[i] for k, v in mx.items()}),
            "scse": {"cse_w1": _t(np.asarray(se["cse_w1"])[i]),
                     "cse_w2": _t(np.asarray(se["cse_w2"])[i]),
                     "sse_w": _hwio_to_oihw(np.asarray(se["sse_w"])[i]),
                     "sse_b": _t(np.asarray(se["sse_b"])[i])},
        }

    trunk = tree["trunk"]
    return {
        "vgru": [_gru(p) for p in tree["vgru"]],
        "hgru": [{d: _gru(l[d]) for d in ("fwd", "bwd")} for l in tree["hgru"]],
        "trunk": {"input": _maxout(trunk["input"]),
                  "blocks": [block(i) for i in range(num_blocks)],
                  "out_w": _hwio_to_oihw(trunk["out_w"]),
                  "out_b": _t(trunk["out_b"])},
        "coord_gru": [{d: _gru(l[d]) for d in ("fwd", "bwd")} for l in tree["coord_gru"]],
        "coord_fc": _t(tree["coord_fc"]),
    }


_KEY_PART = re.compile(r"\[('([^']*)'|(\d+))\]")


def load_npz(path: str):
    """Read a ``.npz`` written by the JAX package's ``save_params`` (or by
    :func:`save_npz`).

    Keys are JAX key paths such as ``"['trunk']['blocks']['maxout']['w']"``
    or ``"['vgru'][0]['wi']"``; keys that are not paths (metadata such as
    ``__epoch__``) are ignored.
    """
    with np.load(path) as data:
        return params_from_jax(tree_from_keypaths({k: data[k] for k in data.files}))


def tree_from_keypaths(arrays: dict):
    """{JAX key path: array} -> the nested dicts and lists; keys that are not
    paths are skipped."""
    tree: dict = {}
    for key, value in arrays.items():
        parts = [m.group(2) if m.group(2) is not None else int(m.group(3))
                 for m in _KEY_PART.finditer(key)]
        if not parts or "".join(m.group(0) for m in _KEY_PART.finditer(key)) != key:
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _lists(tree)


def keypaths(tree, prefix: str = ""):
    """(JAX key path, leaf) pairs of a nested tree, the key paths as
    ``jax.tree_util.keystr`` writes them (dict keys sorted, as JAX flattens)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keypaths(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from keypaths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _oihw_to_hwio(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(_np(t).transpose(2, 3, 1, 0))


def params_to_jax(params):
    """Port parameters -> the JAX parameter tree as numpy arrays (HWIO convs,
    the residual blocks stacked on axis 0): the inverse of
    :func:`params_from_jax`."""
    def gru(p):
        return {k: _np(p[k]) for k in ("wi", "wh", "bi", "bh")}

    def maxout(p):
        return {"w": _oihw_to_hwio(p["w"]), "b": _np(p["b"]), "gamma": _np(p["gamma"]),
                "beta": _np(p["beta"])}

    trunk = params["trunk"]
    blocks = [{"maxout": maxout(b["maxout"]),
               "scse": {"cse_w1": _np(b["scse"]["cse_w1"]), "cse_w2": _np(b["scse"]["cse_w2"]),
                        "sse_w": _oihw_to_hwio(b["scse"]["sse_w"]),
                        "sse_b": _np(b["scse"]["sse_b"])}} for b in trunk["blocks"]]
    stacked = {part: {k: np.stack([b[part][k] for b in blocks]) for k in blocks[0][part]}
               for part in ("maxout", "scse")}
    return {
        "vgru": [gru(p) for p in params["vgru"]],
        "hgru": [{d: gru(l[d]) for d in ("fwd", "bwd")} for l in params["hgru"]],
        "trunk": {"input": maxout(trunk["input"]), "blocks": stacked,
                  "out_w": _oihw_to_hwio(trunk["out_w"]), "out_b": _np(trunk["out_b"])},
        "coord_gru": [{d: gru(l[d]) for d in ("fwd", "bwd")} for l in params["coord_gru"]],
        "coord_fc": _np(params["coord_fc"]),
    }


def save_npz(path: str, params, extra: dict | None = None) -> None:
    """Write port parameters as the ``.npz`` that the JAX package's
    ``weights.save_params`` writes (JAX key paths, JAX layouts), so that
    ``dmpfold2_tpu.weights.load_params`` reads it. ``extra``: metadata
    arrays under their own ``__``-prefixed keys. Atomic: a temp file, then a
    rename."""
    arrays = dict(keypaths(params_to_jax(params)))
    if extra:
        arrays.update({k: np.asarray(v) for k, v in extra.items()})
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _lists(node):
    """Dicts keyed 0..n-1 (list positions in a key path) back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def _sd_gru(sd, prefix: str, layer: int, suffix: str = ""):
    return {"wi": _t(sd[f"{prefix}.weight_ih_l{layer}{suffix}"]).T.contiguous(),
            "wh": _t(sd[f"{prefix}.weight_hh_l{layer}{suffix}"]).T.contiguous(),
            "bi": _t(sd[f"{prefix}.bias_ih_l{layer}{suffix}"]),
            "bh": _t(sd[f"{prefix}.bias_hh_l{layer}{suffix}"])}


def _sd_bigru(sd, prefix: str, num_layers: int):
    return [{"fwd": _sd_gru(sd, prefix, l), "bwd": _sd_gru(sd, prefix, l, "_reverse")}
            for l in range(num_layers)]


def _sd_maxout(sd, prefix: str):
    return {"w": _t(sd[f"{prefix}.lin.weight"]), "b": _t(sd[f"{prefix}.lin.bias"]),
            "gamma": _t(sd[f"{prefix}.norm.weight"]), "beta": _t(sd[f"{prefix}.norm.bias"])}


def load_state_dict(sd):
    """Reference-named state dict (reference network.py names) -> port parameters.

    Counterpart of ``dmpfold2_tpu/weights.py:convert_state_dict``, with the
    number of residual blocks read from the keys. The frozen one-hot
    ``embed.weight`` is not used.
    """
    num_blocks = sum(1 for k in sd if re.fullmatch(r"resnet\.\d+\.layer1\.lin\.weight", k))
    blocks = []
    for i in range(1, num_blocks + 1):
        p = f"resnet.{i}"
        blocks.append({
            "maxout": _sd_maxout(sd, f"{p}.layer1"),
            "scse": {"cse_w1": _t(sd[f"{p}.scSE.cSE.fc.0.weight"]).T.contiguous(),
                     "cse_w2": _t(sd[f"{p}.scSE.cSE.fc.2.weight"]).T.contiguous(),
                     "sse_w": _t(sd[f"{p}.scSE.sSE.conv.weight"]),
                     "sse_b": _t(sd[f"{p}.scSE.sSE.conv.bias"])},
        })
    return {
        "vgru": [_sd_gru(sd, "vgru", l) for l in range(2)],
        "hgru": _sd_bigru(sd, "hgru", 2),
        "trunk": {"input": _sd_maxout(sd, "resnet.0"),
                  "blocks": blocks,
                  "out_w": _t(sd[f"resnet.{num_blocks + 1}.weight"]),
                  "out_b": _t(sd[f"resnet.{num_blocks + 1}.bias"])},
        "coord_gru": _sd_bigru(sd, "coord_gru", 3),
        "coord_fc": _t(sd["coord_fc.weight"]).T.contiguous(),
    }


def load_pt(paths):
    """Load and merge torch ``.pt`` state-dict shard(s) (later ones override)."""
    sd = {}
    for p in paths:
        sd.update(torch.load(p, map_location="cpu", weights_only=True))
    return load_state_dict(sd)


def params_to(params, device):
    """Every tensor of a parameter tree moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)
