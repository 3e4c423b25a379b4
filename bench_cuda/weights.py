"""The network's weights, made from the seed on the device in one draw.

The layout and the initialisers of DMPfold2's network (the released weights
are not in the repository): GRUs with torch's U(-1/sqrt(H), 1/sqrt(H)), the
trunk's Maxout convs with Xavier-uniform weights of gain 1/sqrt(block) and
U(-1/sqrt(fan_in), ..) biases, InstanceNorm gamma 1 and beta 0, the SE and
head layers U(-1/sqrt(fan_in), ..). One ``torch.rand`` of every weight at
once on the device, then each leaf a scaled view of it; the coordinate head
then times the configuration's ``coord_head_scale``. The same seed gives the
same weights, which the program and the reference each take a copy of.
"""

from __future__ import annotations

import math

import torch

ALIGN = 64  # fp32 elements: 256 bytes


def _gru_layer(in_size: int, hidden: int) -> dict:
    k = 1.0 / math.sqrt(hidden)
    return {"wi": ((in_size, 3 * hidden), k), "wh": ((hidden, 3 * hidden), k),
            "bi": ((3 * hidden,), k), "bh": ((3 * hidden,), k)}


def _bigru(layers: int, in_size: int, hidden: int) -> list:
    return [{d: _gru_layer(in_size if i == 0 else 2 * hidden, hidden) for d in ("fwd", "bwd")}
            for i in range(layers)]


def _maxout(c_in: int, c_out: int, pool: int, ksize: int, block: int) -> dict:
    fan_in, fan_out = c_in * ksize * ksize, c_out * pool * ksize * ksize
    gain = 1.0 / math.sqrt(max(block, 1))
    return {"w": ((c_out * pool, c_in, ksize, ksize), gain * math.sqrt(6.0 / (fan_in + fan_out))),
            "b": ((c_out * pool,), 1.0 / math.sqrt(fan_in)),
            "gamma": ((c_out,), "ones"), "beta": ((c_out,), "zeros")}


def spec(cfg: dict) -> dict:
    """{leaf: (shape, bound or "ones" / "zeros")} in the program's parameter layout."""
    width, cwidth, blocks = cfg["width"], cfg["cwidth"], cfg["num_blocks"]
    red = cwidth // cfg["se_reduction"]
    pair_in = cfg["dca_channels"] + width + 1
    hidden = width // 2
    return {
        "vgru": [_gru_layer(cfg["aa_classes"] if i == 0 else width, width)
                 for i in range(cfg["vgru_layers"])],
        "hgru": _bigru(cfg["hgru_layers"], width, hidden),
        "trunk": {
            "input": _maxout(pair_in, cwidth, 3, 1, 0),
            "blocks": [{"maxout": _maxout(cwidth, cwidth, 4, 5, i + 1),
                        "scse": {"cse_w1": ((cwidth, red), 1.0 / math.sqrt(cwidth)),
                                 "cse_w2": ((red, cwidth), 1.0 / math.sqrt(max(red, 1))),
                                 "sse_w": ((1, cwidth, 1, 1), 1.0 / math.sqrt(cwidth)),
                                 "sse_b": ((1,), 1.0 / math.sqrt(cwidth))}}
                       for i in range(blocks)],
            "out_w": ((2, cwidth, 1, 1), 1.0 / math.sqrt(cwidth)),
            "out_b": ((2,), 1.0 / math.sqrt(cwidth)),
        },
        "coord_gru": _bigru(cfg["coord_gru_layers"], width + 8, hidden),
        "coord_fc": ((width, 3), 1.0 / math.sqrt(width)),
    }


def _leaves(tree, out: list):
    if isinstance(tree, tuple):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    else:
        for v in tree:
            _leaves(v, out)
    return out


def _aligned(n: int) -> int:
    """Elements a leaf takes in the draw: each leaf starts on 256 bytes, as
    the allocator's own tensors do (the kernels read 16-byte aligned data)."""
    return -(-n // ALIGN) * ALIGN


def make(cfg: dict, seed: int, device) -> dict:
    """The parameters for ``cfg`` from ``seed``: one uniform draw on ``device``,
    every leaf a view of it starting on 256 bytes."""
    layout = spec(cfg)
    leaves = _leaves(layout, [])
    total = sum(_aligned(math.prod(shape)) for shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    offset = [0]

    def build(tree):
        if isinstance(tree, tuple):
            shape, bound = tree
            n = math.prod(shape)
            view = flat[offset[0]:offset[0] + n].view(shape)
            offset[0] += _aligned(n)
            if bound == "ones":
                return view.fill_(1.0)
            if bound == "zeros":
                return view.zero_()
            return view.mul_(bound)
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return [build(v) for v in tree]

    params = build(layout)
    params["coord_fc"].mul_(float(cfg.get("coord_head_scale", 1.0)))
    return params
