"""The network's layers in plain PyTorch: GRUs and the residual trunk.

GRU gates as ``torch.nn.GRU`` (order r, z, n; ``h' = (1 - z) n + z h``),
weights as the benchmark makes them: ``wi`` (in, 3H), ``wh`` (H, 3H). The
trunk (network.py): a 1x1 maxout input layer 955 -> 128 (pool 3) with an
affine InstanceNorm, 16 residual blocks (5x5 maxout 128 -> 128, pool 4,
InstanceNorm, concurrent spatial and channel squeeze-excitation, residual)
and a 1x1 head to (distance, confidence). Maps are (P, C, L, L) at the
target's exact size, P passes at once.

``precision`` says how the trunk's products are computed:
  * ``fp32``: fp32 with TF32 off;
  * ``tf32``: the same with TF32 on (the fp32 engine's control);
  * ``bf16``: the bf16 engine's numerics (its JAX original's fused_conv
    "norm" block): bf16 maps between layers, bf16 operands with fp32 sums,
    each layer's epilogue, norm and gates in fp32, the head in fp32;
  * ``fp8``: as ``bf16`` with every conv and input-layer operand rounded to
    float8 e4m3 under a per-tensor scale (the bf16 engine's control).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "bf16", "fp8")
EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for cuBLAS and cuDNN on or off inside the block, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _gates(xp: torch.Tensor, hp: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    n_h = h.shape[-1]
    r = torch.sigmoid(xp[..., :n_h] + hp[..., :n_h])
    z = torch.sigmoid(xp[..., n_h:2 * n_h] + hp[..., n_h:2 * n_h])
    n = torch.tanh(xp[..., 2 * n_h:] + r * hp[..., 2 * n_h:])
    return (1.0 - z) * n + z * h


def vgru_final(layers, x: torch.Tensor) -> torch.Tensor:
    """Stacked GRU over the rows of (T, C, 22) one-hot columns -> the last
    layer's final state (C, H)."""
    hs = [x.new_zeros((x.shape[1], p["wh"].shape[0])) for p in layers]
    for t in range(x.shape[0]):
        inp = x[t]
        for i, p in enumerate(layers):
            hs[i] = _gates(inp @ p["wi"] + p["bi"], hs[i] @ p["wh"] + p["bh"], hs[i])
            inp = hs[i]
    return hs[-1]


def bigru(layers, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Stacked biGRU over (T, B, C) right-padded sequences of ``lengths`` ->
    (T, B, 2H). The forward scan holds its state past a sequence's end; the
    reverse scan starts from zeros at its last valid step."""
    steps, batch = x.shape[:2]
    out = x
    for layer in layers:
        halves = []
        for name, reverse in (("fwd", False), ("bwd", True)):
            p = layer[name]
            xp = out @ p["wi"] + p["bi"]
            h = x.new_zeros((batch, p["wh"].shape[0]))
            seq = [None] * steps
            for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
                new = _gates(xp[t], h @ p["wh"] + p["bh"], h)
                keep = (t < lengths)[:, None]
                h = torch.where(keep, new, torch.zeros_like(new) if reverse else h)
                seq[t] = h
            halves.append(torch.stack(seq))
        out = torch.cat(halves, dim=-1)
    return out


def _quant(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A conv operand as the precision holds it: bf16, or float8 e4m3 under a
    per-tensor scale (carried back in bf16)."""
    t = t.to(torch.bfloat16)
    if precision != "fp8":
        return t
    scale = t.float().abs().amax().clamp(min=1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)


def _maxout(y: torch.Tensor, pool: int) -> torch.Tensor:
    """(P, C * pool, H, W) -> (P, C, H, W), max over channel g * pool + p."""
    p, c, h, w = y.shape
    return y.view(p, c // pool, pool, h, w).amax(dim=2)


def _norm(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Affine InstanceNorm, two passes: the mean, then the biased variance."""
    mean = y.mean(dim=(2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(2, 3), keepdim=True)
    return (y - mean) / torch.sqrt(var + EPS) * gamma[:, None, None] + beta[:, None, None]


def _scale_shift(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """The norm as (P, C) scale and shift from y's sums and sums of squares,
    the variance E[y^2] - E[y]^2 clamped at 0 (the bf16 engine's norm, which
    takes its sums from the conv's fp32 epilogue)."""
    count = y.shape[2] * y.shape[3]
    mean = y.sum(dim=(2, 3)) / count
    var = (y.square().sum(dim=(2, 3)) / count - mean * mean).clamp(min=0.0)
    scale = gamma * torch.rsqrt(var + EPS)
    return scale, beta - mean * scale


def _shifted_gemm_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-padded conv as a sum of k x k shifted GEMMs, NHWC inside: each
    product a TF32 GEMM (exact for bf16 or e4m3 operands, fp32 sums), the
    k x k partial maps added in fp32."""
    p, c, h, wd = x.shape
    k = w.shape[-1]
    pad = k // 2
    xp = F.pad(x, (pad, pad, pad, pad)).permute(0, 2, 3, 1)            # (P, H + 2p, W + 2p, C)
    wt = w.permute(2, 3, 1, 0)                                          # (k, k, C, O)
    out = x.new_zeros((p * h * wd, w.shape[0]))
    with tf32(True):
        for dy in range(k):
            for dx in range(k):
                out.addmm_(xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c), wt[dy, dx])
    return out.view(p, h, wd, -1).permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """A same-padded conv without bias, fp32 out. In bf16 and fp8 the
    operands are rounded first and their products summed in fp32, the
    kernels' arithmetic: TF32 GEMMs hold a bf16 (or e4m3) value exactly."""
    if precision in ("fp32", "tf32"):
        with tf32(precision == "tf32"):
            return F.conv2d(x.float(), w, padding=w.shape[-1] // 2)
    return _shifted_gemm_conv(_quant(x, precision).float(), _quant(w, precision).float())


def input_layer(p: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """(P, 955, L, L) pair input -> (P, 128, L, L): the 1x1 maxout (pool 3)
    and its norm; bf16 values in bf16 and fp8, each map's maxout rounded to
    bf16 after its fp32 epilogue and normalised by a scale and shift from the
    epilogue's sums."""
    with tf32(precision == "tf32"):
        y = _maxout(_conv(x, p["w"], precision) + p["b"][:, None, None], 3)
        if precision in ("fp32", "tf32"):
            return _norm(y, p["gamma"], p["beta"])
    scale, shift = _scale_shift(y, p["gamma"], p["beta"])
    return (y.to(torch.bfloat16).float() * scale[:, :, None, None]
            + shift[:, :, None, None]).to(torch.bfloat16)


def block(p: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    """One residual block, (P, 128, L, L) -> (P, 128, L, L): the 5x5 maxout
    (pool 4), InstanceNorm, concurrent spatial and channel squeeze-excitation
    (the channel gate is a constant of the weights: it pools a norm's output,
    whose mean is beta), the residual. In bf16 and fp8 the maxout is rounded
    to bf16 after its fp32 epilogue, the spatial gate reads it through its
    weights scaled by the norm's scale (rounded to bf16) with the shift
    folded into its bias, and the block's output is rounded to bf16."""
    mx, se = p["maxout"], p["scse"]
    gate = torch.sigmoid(torch.relu(mx["beta"][None, :] @ se["cse_w1"]) @ se["cse_w2"])[0]
    sse_w = se["sse_w"].reshape(-1)
    with tf32(precision == "tf32"):
        y = _maxout(_conv(h, mx["w"], precision) + mx["b"][:, None, None], 4)
        if precision in ("fp32", "tf32"):
            t = _norm(y, mx["gamma"], mx["beta"])
            s = torch.sigmoid(torch.einsum("pchw,c->phw", t, sse_w) + se["sse_b"][0])
            return t * gate[:, None, None] + t * s[:, None] + h
    scale, shift = _scale_shift(y, mx["gamma"], mx["beta"])
    z = y.to(torch.bfloat16).float()
    w_eff = (scale * sse_w).to(torch.bfloat16).float()
    s = torch.einsum("pchw,pc->phw", z, w_eff) + (shift @ sse_w + se["sse_b"][0])[:, None, None]
    norm = z * scale[:, :, None, None] + shift[:, :, None, None]
    out = norm * (gate[:, None, None] + torch.sigmoid(s)[:, None]) + h.float()
    return out.to(torch.bfloat16)


def head(params, h: torch.Tensor, precision: str) -> torch.Tensor:
    """(P, 128, L, L) last block's output -> (P, 2, L, L): the fp32 1x1 head
    (TF32 in the ``tf32`` control)."""
    with tf32(precision == "tf32"):
        return (torch.einsum("pchw,oc->pohw", h.float(), params["out_w"].reshape(2, -1))
                + params["out_b"][:, None, None])
