#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``dmpfold2_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name and ``nvidia-smi`` name/power limit. Without
   CUDA the script exits nonzero here, before any build.
2. build   -- compiles every CUDA kernel from ``dmpfold2_tpu_torch/csrc``
   (one nvcc per source, all started together) and prints ptxas's register,
   shared-memory and spill lines.
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the shapes of the default fold of the bundled PF10963 example (and more),
   with the tolerance stated; times from CUDA events after warm-up.
4. fold    -- ``aln_to_coords`` on PF10963 at full width (512/128/16, random
   weights from seed 0) with the defaults ``-n 10 -m 100`` on ``cuda``, once
   per engine (fp32, then bf16): a warm-up fold, then the timed fold with
   every launch counter set to 0 just before it and read just after, and
   four more timed folds for the spread of the wall time. Checks
   the PDB, finite values, confidences in [0, 1] and the exact launch counts
   (the fp32 fold launches no bf16 trunk kernel).
   One more fold per engine under torch.profiler gives device time by kernel.
5. trunk   -- one bf16 trunk pass on PF10963's features, timed whole and by
   part (input layer, block conv kernel, block tail, head).
6. cpu     -- the same weights through the port on the CPU (plain versions)
   against the card. fp32 at ``-n 1 -m 10`` (and ``-m 0``): the CA trace
   within 1e-2 A, confidences within 5e-4, all atoms within 0.25 A (see
   ``phase_cpu`` for why the atoms get the wider bound). bf16 at ``-n 0
   -m 0``: confidences, and one trunk pass's distance-map and confidence
   channels (see ``phase_cpu_bf16`` for the bounds).

Then the ``kernels`` line (launches from phase 4: the fp32 fold for vgru,
rgru and refine, the bf16 fold for the two trunk kernels), and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
nonzero without the last line. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLE_ALN = os.path.join(REPO, "dmpfold2_tpu", "example", "PF10963.aln")

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the tensor
# cores, bf16 on the tensor cores and HBM3 bandwidth; bound_ms is the larger
# of the operations time and the bytes time
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR = 989e12
PEAK_HBM_BYTES = 3.35e12
REFINE_FLOP_PER_PAIR = 24  # sub 3, square-sum 5, max, sqrt, clip 2, cmp, sub, mul, div 3, mul 3, add 3

# the default fold of PF10963: 252 sequences x 82 residues, bucket (256, 88)
N_PAD, L_PAD, NSEQS, NRES = 256, 88, 252, 82
WIDTH, CWIDTH, BLOCKS = 512, 128, 16
ITERATIONS, MINSTEPS = 10, 100
FOLD_REPEATS = 5  # timed folds per engine; the first is the one counted
EXPECTED_LAUNCHES = {
    "fp32": {"vgru": 1, "rgru": 70, "refine": 2, "conv5x5_maxout": 0, "gemm_maxout": 0},
    # 11 trunk passes: one input layer and 16 block convs each
    "bf16": {"vgru": 1, "rgru": 70, "refine": 2, "conv5x5_maxout": 176, "gemm_maxout": 11},
}
GRU_TOL = 1e-4     # fp32, sums in another order than cuBLAS over 512/256 terms
REFINE_TOL = 1e-4  # the JAX package's own kernel-vs-XLA bound (tests/test_pallas_refine.py)
# the bf16 trunk kernels against their plain versions: both round the same
# fp32 maxout to bf16, whose sums differ only in order, so an output may land
# on the other bf16 neighbour: |d| <= 2^-7 * max(|ref|, 1), one bf16 ulp. The
# sums are fp32 sums of the same values in another order: rtol 1e-4.
BF16_ULP = 2.0 ** -7
STATS_RTOL = 1e-4
# kernel shapes: PF10963's bucket, a batch with mixed nres, an L that is not a
# multiple of either kernel's pixel tile (8 x 16 and 128)
TRUNK_CASES = ((1, L_PAD, [NRES]), (3, L_PAD, [88, 61, 5]), (2, 53, [53, 20]))
GEMM_K_IN = 955  # the input layer's channels: 512 pair + 442 DCA + 1 dmap


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, fragment: str, reps: int) -> float:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``fragment``, from torch.profiler over ``reps`` calls after warm-up. Unlike
    CUDA events around back-to-back calls, this leaves out the host time of a
    wrapper whose kernel is shorter than its Python."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if fragment in evt.key:
            us = getattr(evt, "self_device_time_total", None)
            total += us if us is not None else getattr(evt, "self_cuda_time_total", 0.0)
            count += evt.count
    if count != reps:
        raise AssertionError(f"profiler saw {count} launches of {fragment}, expected {reps}")
    return total / count / 1e3


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_device() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from dmpfold2_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line or "smem" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})


def _chain(n: int, rng) -> np.ndarray:
    """A random-walk CA trace with 3.8 A steps: realistic spacing and clashes."""
    steps = rng.normal(size=(n, 3))
    steps *= 3.8 / np.linalg.norm(steps, axis=1, keepdims=True)
    return np.cumsum(steps, axis=0).astype(np.float32)


def phase_kernels(params) -> dict:
    """Each kernel against its plain version on the card; returns per-kernel rows."""
    from dmpfold2_tpu_torch.engine.fold import use_full_fp32
    from dmpfold2_tpu_torch.kernels import refine, rgru, vgru

    use_full_fp32()  # the library calls too: cuDNN's GRU would otherwise use TF32
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases, rows = [], {}

    # ---- vgru: 256 rows x 88 columns, H = 512
    layers = [{k: v.to(dev) for k, v in p.items()} for p in params["vgru"]]
    aln = torch.from_numpy(rng.integers(0, 22, (N_PAD, L_PAD)).astype(np.int32)).to(dev)
    uniform = torch.full((L_PAD,), NSEQS, dtype=torch.int32, device=dev)
    ragged = torch.from_numpy(rng.integers(1, N_PAD + 1, L_PAD).astype(np.int32)).to(dev)
    err = 0.0
    for label, valid in (("uniform 252", uniform), ("per-column", ragged)):
        out = vgru.vgru_final_cols(layers, aln, valid)
        ref = vgru.vgru_final_cols_plain(layers, aln, valid)
        e = (out - ref).abs().max().item()
        err = max(err, e)
        cases.append({"kernel": "vgru", "case": label, "shape": [N_PAD, L_PAD, WIDTH],
                      "max_abs_err": e})
    ms = time_ms(lambda: vgru.vgru_final_cols(layers, aln, uniform), reps=10)
    plain_ms = time_ms(lambda: vgru.vgru_final_cols_plain(layers, aln, uniform), reps=2, warmup=1)
    gru_lib = torch.nn.GRU(22, WIDTH, num_layers=2).to(dev)
    with torch.no_grad():
        for i, p in enumerate(layers):
            getattr(gru_lib, f"weight_ih_l{i}").copy_(p["wi"].T)
            getattr(gru_lib, f"weight_hh_l{i}").copy_(p["wh"].T)
            getattr(gru_lib, f"bias_ih_l{i}").copy_(p["bi"])
            getattr(gru_lib, f"bias_hh_l{i}").copy_(p["bh"])
        onehot = torch.nn.functional.one_hot(aln[:NSEQS].long(), 22).float()
        lib_out = gru_lib(onehot)[1][-1]
        lib_err = (lib_out - vgru.vgru_final_cols(layers, aln, uniform)).abs().max().item()
        library_ms = time_ms(lambda: gru_lib(onehot), reps=10)
    h = WIDTH
    flops = 2 * 3 * h * 3 * h * float(uniform.sum().item())
    nbytes = 4 * (aln.numel() + L_PAD + 22 * 3 * h + 3 * h * 3 * h + 4 * 3 * h + L_PAD * h)
    b, by = bound_ms(flops, nbytes)
    rows["vgru"] = {"name": "vgru", "route": "cuda", "source": "dmpfold2_tpu_torch/csrc/vgru.cu",
                    "replaces": "dmpfold2_tpu/kernels/vgru.py:113", "max_abs_err": err,
                    "tol": GRU_TOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                    "bound_by": by, "library_ms": library_ms,
                    "library": "torch.nn.GRU(22, 512, num_layers=2) on rows [0, 252)",
                    "library_max_abs_err": lib_err}

    # ---- rgru: T = 88, H = 256, B = 1 (main path) and B = 5, both directions
    hid = WIDTH // 2
    p = {k: v.to(dev) for k, v in params["coord_gru"][0]["fwd"].items()}
    err = 0.0
    for batch, valid_np in ((1, [NRES]), (5, [88, 61, 1, 82, 30])):
        xproj = torch.from_numpy(rng.normal(size=(L_PAD, batch, 3 * hid)).astype(np.float32)).to(dev)
        valid = torch.tensor(valid_np, dtype=torch.int32, device=dev)
        for reverse in (False, True):
            out = rgru.gru_seq(p["wh"], p["bh"], xproj, valid, reverse=reverse)
            ref = rgru.gru_seq_plain(p["wh"], p["bh"], xproj, valid, reverse=reverse)
            e = (out - ref).abs().max().item()
            err = max(err, e)
            cases.append({"kernel": "rgru", "case": f"B={batch} reverse={reverse}",
                          "shape": [L_PAD, batch, hid], "valid": valid_np, "max_abs_err": e})
    xproj = torch.from_numpy(rng.normal(size=(L_PAD, 1, 3 * hid)).astype(np.float32)).to(dev)
    valid = torch.tensor([NRES], dtype=torch.int32, device=dev)
    ms = time_ms(lambda: rgru.gru_seq(p["wh"], p["bh"], xproj, valid), reps=50)
    plain_ms = time_ms(lambda: rgru.gru_seq_plain(p["wh"], p["bh"], xproj, valid), reps=5)
    lib = torch.nn.GRU(3 * hid, hid).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(3 * hid, device=dev))
        lib.bias_ih_l0.zero_()
        lib.weight_hh_l0.copy_(p["wh"].T)
        lib.bias_hh_l0.copy_(p["bh"])
        full = torch.tensor([L_PAD], dtype=torch.int32, device=dev)
        lib_err = (lib(xproj)[0] - rgru.gru_seq(p["wh"], p["bh"], xproj, full)).abs().max().item()
        library_ms = time_ms(lambda: lib(xproj), reps=50)
    flops = 2 * hid * 3 * hid * NRES
    nbytes = 4 * (xproj.numel() + hid * 3 * hid + 3 * hid + 1 + L_PAD * hid)
    b, by = bound_ms(flops, nbytes)
    rows["rgru"] = {"name": "rgru", "route": "cuda", "source": "dmpfold2_tpu_torch/csrc/rgru.cu",
                    "replaces": "dmpfold2_tpu/kernels/rgru.py:75", "max_abs_err": err,
                    "tol": GRU_TOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                    "bound_by": by, "library_ms": library_ms,
                    "library": "torch.nn.GRU(768, 256) with W_ih = I, b_ih = 0, on xproj, "
                               "valid = T", "library_max_abs_err": lib_err}

    # ---- refine: L = 88 with nres = 82 (main path) and L = 1536, 100 steps
    err = 0.0
    for n, nres in ((L_PAD, NRES), (1536, 1536)):
        ca = torch.from_numpy(_chain(n, rng)).to(dev)
        out = refine.refine_coords(ca, MINSTEPS, nres)
        ref = refine.refine_coords_plain(ca, MINSTEPS, nres)
        e = (out - ref).abs().max().item()
        err = max(err, e)
        cases.append({"kernel": "refine", "case": f"L={n} nres={nres} steps={MINSTEPS}",
                      "max_abs_err": e})
    ca = torch.from_numpy(_chain(L_PAD, rng)).to(dev)
    ms = time_ms(lambda: refine.refine_coords(ca, MINSTEPS, NRES), reps=20)
    plain_ms = time_ms(lambda: refine.refine_coords_plain(ca, MINSTEPS, NRES), reps=3)
    flops = MINSTEPS * REFINE_FLOP_PER_PAIR * NRES * NRES
    b, by = bound_ms(flops, 2 * 4 * 3 * L_PAD)
    rows["refine"] = {"name": "refine", "route": "cuda",
                      "source": "dmpfold2_tpu_torch/csrc/refine.cu",
                      "replaces": "dmpfold2_tpu/kernels/refine.py:104", "max_abs_err": err,
                      "tol": REFINE_TOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                      "bound_by": by, "library_ms": None}

    rows.update(_trunk_kernels(params, rng, cases))

    emit({"phase": "kernels", "cases": cases})
    for row in rows.values():
        if "tol" in row and not row["max_abs_err"] <= row["tol"]:
            raise AssertionError(f"{row['name']}: kernel differs from its plain version by "
                                 f"{row['max_abs_err']:.3g} > {row['tol']:.3g}")
    failed = [c for c in cases if not c.get("ok", True)]
    if failed:
        raise AssertionError(f"bf16 trunk kernels differ from their plain versions: {failed}")
    return rows


def _trunk_kernels(params, rng, cases) -> dict:
    """conv5x5_maxout and gemm_maxout against their plain versions, with the
    main path's weights (block 0's conv, the input layer) packed as the bf16
    engine packs them. Each case launches twice: the stats must be the same
    bits."""
    import torch.nn.functional as F

    from dmpfold2_tpu_torch.kernels import conv_block

    dev = torch.device("cuda")
    trunk = params["trunk"]
    conv_w, conv_b = conv_block.pack_conv5x5_weights(trunk["blocks"][0]["maxout"]["w"].to(dev),
                                                     trunk["blocks"][0]["maxout"]["b"].to(dev))
    k_pad = conv_block.gemm_k_pad(GEMM_K_IN)
    gemm_w, gemm_b = conv_block.pack_gemm_weights(trunk["input"]["w"].to(dev),
                                                  trunk["input"]["b"].to(dev), k_pad)
    kinds = {
        "conv5x5_maxout": (conv_block.conv5x5_maxout_stats, conv_block.conv5x5_maxout_stats_plain,
                           conv_w, conv_b, CWIDTH),
        "gemm_maxout": (conv_block.gemm_maxout_stats, conv_block.gemm_maxout_stats_plain,
                        gemm_w, gemm_b, GEMM_K_IN),
    }

    def inputs(kind, batch, l, nres):
        c_in = kinds[kind][4]
        x = torch.zeros((batch, l, l, kinds[kind][2].shape[0] if kind == "gemm_maxout" else c_in))
        valid = (torch.arange(l)[None, :] < torch.tensor(nres)[:, None]).float()
        x[..., :c_in] = (torch.from_numpy(rng.normal(size=(batch, l, l, c_in)).astype(np.float32))
                         * valid[:, :, None, None] * valid[:, None, :, None])
        return (x.to(torch.bfloat16).to(dev), torch.tensor(nres, dtype=torch.int32, device=dev))

    rows = {}
    for kind, (kernel, plain, w, b, c_in) in kinds.items():
        worst_ulp, worst_abs = 0.0, 0.0
        for batch, l, nres in TRUNK_CASES:
            x, nr = inputs(kind, batch, l, nres)
            out, s, ss = kernel(x, w, b, nr)
            out2, s2, ss2 = kernel(x, w, b, nr)
            ref, rs, rss = plain(x, w, b, nr)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            ulp = (d / (BF16_ULP * ref.float().abs().clamp(min=1.0))).max().item()
            stats_rel = max(((s - rs).abs() / rs.abs().clamp(min=1e-30)).max().item(),
                            ((ss - rss).abs() / rss.abs().clamp(min=1e-30)).max().item())
            same = bool(torch.equal(s, s2) and torch.equal(ss, ss2) and torch.equal(out, out2))
            worst_ulp, worst_abs = max(worst_ulp, ulp), max(worst_abs, d.max().item())
            cases.append({"kernel": kind, "case": f"B={batch} L={l} nres={nres}",
                          "max_abs_err": d.max().item(), "max_err_in_bf16_ulps": ulp,
                          "stats_max_rel_err": stats_rel, "stats_rtol": STATS_RTOL,
                          "second_launch_identical": same,
                          "ok": ulp <= 1.0 and stats_rel <= STATS_RTOL and same})
        # timing at the main path's shape: B 1, L 88, nres 82
        x, nr = inputs(kind, *TRUNK_CASES[0])
        ms = device_ms(lambda: kernel(x, w, b, nr), f"{kind}_kernel", reps=50)
        call_ms = time_ms(lambda: kernel(x, w, b, nr), reps=50)
        plain_ms = time_ms(lambda: plain(x, w, b, nr), reps=5)
        npix = L_PAD * L_PAD
        c_out = w.shape[1]
        if kind == "conv5x5_maxout":
            flops = 2.0 * npix * w.shape[0] * c_out
            nbytes = 2 * (x.numel() + w.numel() + npix * c_out // 4) + 4 * (c_out + 1 + 2 * c_out // 4)
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as the kernel reads it
            w_lib = (w.view(5, 5, CWIDTH, c_out).permute(3, 2, 0, 1)
                     .contiguous(memory_format=torch.channels_last))
            library_ms = time_ms(lambda: F.conv2d(x_nchw, w_lib, padding=2), reps=50)
            library = ("F.conv2d on channels-last bf16 (cuDNN): the 5x5 conv to 512 channels "
                       "only, without bias, maxout or statistics; computes less than the kernel")
        else:
            flops = 2.0 * npix * GEMM_K_IN * c_out
            nbytes = 2 * (x.numel() + w.numel() + npix * c_out // 3) + 4 * (c_out + 1 + 2 * c_out // 3)
            x2d = x.view(npix, k_pad)
            library_ms = time_ms(lambda: torch.matmul(x2d, w), reps=50)
            library = ("torch.matmul bf16 (cuBLAS): (7744, 960) x (960, 384) only, without "
                       "bias, maxout or statistics; computes less than the kernel")
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_TENSOR)
        rows[kind] = {"name": kind, "route": "cuda",
                      "source": f"dmpfold2_tpu_torch/csrc/{kind}.cu",
                      "replaces": ("dmpfold2_tpu/kernels/conv_block.py:283"
                                   if kind == "conv5x5_maxout"
                                   else "dmpfold2_tpu/kernels/conv_block.py:531"),
                      "max_abs_err": worst_abs, "max_err_in_bf16_ulps": worst_ulp,
                      "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": library_ms, "library": library,
                      "tflops": flops / (ms * 1e-3) / 1e12}
    return rows


def _counters():
    """kernel name -> (module, name of its launch counter)."""
    from dmpfold2_tpu_torch.kernels import conv_block, refine, rgru, vgru

    return {"vgru": (vgru, "launches"), "rgru": (rgru, "launches"),
            "refine": (refine, "launches"),
            "conv5x5_maxout": (conv_block, "conv_launches"),
            "gemm_maxout": (conv_block, "gemm_launches")}


def phase_fold(params, precision: str) -> tuple[dict, tuple]:
    """The main path: aln_to_coords on the card at the reference defaults."""
    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.config import FoldConfig
    from dmpfold2_tpu_torch.utils.pdb import format_pdb

    kw = dict(device="cuda", params=params, iterations=ITERATIONS, minsteps=MINSTEPS,
              return_alnmat=True, config=FoldConfig(precision=precision))
    aln_to_coords(EXAMPLE_ALN, **kw)  # warm-up: cuDNN and cuSOLVER set-up
    counters = _counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coords, confs, alnmat = aln_to_coords(EXAMPLE_ALN, **kw)
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    expected = EXPECTED_LAUNCHES[precision]
    # the spread: the bf16 fold is bound by the host issuing launches, and
    # the host is shared, so one fold's wall time says little
    walls = [wall]
    for _ in range(FOLD_REPEATS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aln_to_coords(EXAMPLE_ALN, **kw)
        walls.append(time.perf_counter() - t0)

    lines = list(format_pdb(coords, confs, alnmat[0]))
    n_atoms = sum(line.startswith("ATOM") for line in lines)
    checks = {
        "conf_header": lines[0].startswith("REMARK  CONF:"),
        "atoms_406": n_atoms == 406,
        "end": lines[-1] == "END",
        "finite": bool(np.isfinite(coords).all() and np.isfinite(confs).all()),
        "conf_in_0_1": bool(((confs >= 0) & (confs <= 1)).all()),
        "launches": launches == expected,
    }
    emit({"phase": "fold", "precision": precision, "target": "PF10963",
          "shape": list(alnmat.shape), "iterations": ITERATIONS, "minsteps": MINSTEPS,
          "wall_s": wall, "wall_s_median": float(np.median(walls)), "wall_s_all": walls,
          "launches": launches, "expected_launches": expected,
          "mean_conf": float(confs.mean()), "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{precision} fold checks failed: {failed}")
    return launches, (coords, confs)


# kernel-name fragments -> category, first match wins
PROFILE_CATEGORIES = (
    ("vgru", ("vgru_kernel",)), ("rgru", ("rgru_kernel",)), ("refine", ("refine_kernel",)),
    ("conv5x5_maxout", ("conv5x5_maxout_kernel",)), ("gemm_maxout", ("gemm_maxout_kernel",)),
    # cuDNN convolutions ("fprop"); cuBLAS's sm80_xmma_gemm kernels are GEMMs
    ("conv", ("convolution", "fprop", "cudnn", "implicit", "winograd", "fft")),
    ("gemm", ("gemm", "gemv", "dot_kernel", "splitk")),
    ("linalg", ("syev", "potr", "trsm", "trtri", "sytr", "orm", "larf", "stedc", "steqr",
                "lascl", "lansy", "geqr", "cusolver", "syrk", "chol")),
)


def phase_profile(params, precision: str) -> None:
    """Device time of one more default fold by kernel, from torch.profiler
    (profiler overhead included in its wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.config import FoldConfig

    kw = dict(device="cuda", params=params, iterations=ITERATIONS, minsteps=MINSTEPS,
              config=FoldConfig(precision=precision))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        aln_to_coords(EXAMPLE_ALN, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            kernels.append((evt.key, evt.count, us / 1e3))
    by_cat: dict[str, float] = {}
    names: dict[str, list] = {}
    for name, count, ms in sorted(kernels, key=lambda k: -k[2]):
        cat = next((c for c, frags in PROFILE_CATEGORIES
                    if any(f in name.lower() for f in frags)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        names.setdefault(cat, []).append({"name": name[:90], "count": count, "ms": ms})
    busy = sum(ms for *_, ms in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:12]
    emit({"phase": "profile", "precision": precision, "wall_ms": wall_ms,
          "device_busy_ms": busy,
          "idle_share": (1.0 - busy / wall_ms) if wall_ms else None,
          "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
          "kernel_launches": sum(count for _, count, _ in kernels),
          "largest_by_category": {c: v[:3] for c, v in names.items()},
          "top_kernels": [{"name": n[:90], "count": c, "ms": ms} for n, c, ms in top]})


def phase_cpu(params) -> None:
    """The same weights on the CPU (plain versions) against the card.

    Random weights collapse the predicted CA trace (PF10963: all 82 CAs
    within 0.2 A), and backbone completion and refinement are ill-conditioned
    on such a trace: the N/C/O/CB directions come from cross products of
    near-zero, near-collinear CA steps. So the network's output, the CA
    trace, is held to 1e-2 A and confidences to 5e-4 (the cross-implementation
    full-size bounds of tests/test_model_parity.py:147-162); all five atoms
    are held to 0.25 A, the JAX package's own full-size budget across builds
    (tests/test_golden.py). The -m 0 row shows the CA trace and the
    completed backbone side by side, with no refinement.
    """
    from dmpfold2_tpu_torch import aln_to_coords

    rows, failed = [], []
    for iterations, minsteps in ((1, 0), (1, 10)):
        kw = dict(params=params, iterations=iterations, minsteps=minsteps)
        t0 = time.perf_counter()
        c_cpu, f_cpu = aln_to_coords(EXAMPLE_ALN, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        c_gpu, f_gpu = aln_to_coords(EXAMPLE_ALN, device="cuda", **kw)
        row = {"iterations": iterations, "minsteps": minsteps, "cpu_wall_s": cpu_s,
               "max_abs_ca": float(np.abs(c_cpu[:, 1] - c_gpu[:, 1]).max()), "ca_tol": 1e-2,
               "max_abs_atoms": float(np.abs(c_cpu - c_gpu).max()), "atoms_tol": 0.25,
               "max_abs_conf": float(np.abs(f_cpu - f_gpu).max()), "conf_tol": 5e-4,
               "ca_extent": float(np.abs(c_gpu[:, 1]).max()),
               "ca_mean_step": float(np.linalg.norm(np.diff(c_gpu[:, 1], axis=0), axis=1).mean())}
        rows.append(row)
        failed += [f"-n {iterations} -m {minsteps}: {k}" for k in ("ca", "atoms", "conf")
                   if not row[f"max_abs_{k}"] <= row[f"{k}_tol"]]
    emit({"phase": "cpu", "rows": rows})
    if failed:
        raise AssertionError(f"card and CPU folds differ: {failed}")


@contextlib.contextmanager
def _capture_trunk_input(store: list):
    """Record (packed trunk, input, mask) of every bf16 trunk pass the port runs."""
    from dmpfold2_tpu_torch.models import gruresnet

    orig = gruresnet.trunk_apply_bf16

    def recording(packed, x, mask):
        store.append((packed, x.clone(), mask.clone()))
        return orig(packed, x, mask)

    gruresnet.trunk_apply_bf16 = recording
    try:
        yield
    finally:
        gruresnet.trunk_apply_bf16 = orig


def phase_trunk(capture) -> None:
    """One bf16 trunk pass on PF10963's features (B 1, L 88): wall time per
    pass from CUDA events, and device time by part from torch.profiler over 5
    passes. Everything that is not one of the two kernels is plain PyTorch:
    the input layer's norm, the 16 block tails (sSE, gate, residual, mask),
    the stats reductions and the fp32 head."""
    from torch.profiler import ProfilerActivity, profile

    from dmpfold2_tpu_torch.models import trunk

    packed, x, mask = capture
    reps = 5
    pass_ms = time_ms(lambda: trunk.trunk_apply_bf16(packed, x, mask), reps=20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            trunk.trunk_apply_bf16(packed, x, mask)
        torch.cuda.synchronize()
    parts = {"conv5x5_maxout": 0.0, "gemm_maxout": 0.0, "plain": 0.0}
    launches = {"conv5x5_maxout": 0, "gemm_maxout": 0, "plain": 0}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = us if us is not None else getattr(evt, "self_cuda_time_total", 0.0)
        part = next((k for k in ("conv5x5_maxout", "gemm_maxout") if f"{k}_kernel" in evt.key),
                    "plain")
        parts[part] += us / 1e3 / reps
        launches[part] += evt.count // reps
    busy = sum(parts.values())
    emit({"phase": "trunk", "precision": "bf16", "shape": list(x.shape),
          "pass_wall_ms": pass_ms, "pass_device_ms": busy, "device_ms_by_part": parts,
          "launches_per_pass": launches,
          "share_of_device": {k: v / busy for k, v in parts.items()},
          "idle_share": 1.0 - busy / pass_ms})


# bf16 card vs CPU: both run the same bf16 operands, the card through the
# kernels and the CPU through the plain versions, whose fp32 sums differ only
# in order; an activation that lands on the other bf16 neighbour (2^-8
# relative) carries through the later layers. Each output channel is held to
# one such rounding per layer, added up over the 17 layers: 17 * 2^-8 (6.6%)
# of the channel's largest magnitude on the valid region. (With random
# weights the distance-map channel reaches about 34, so an absolute bound
# would say little.) A confidence is the sigmoid of a row mean of the
# confidence channel, slope at most 1/4; at -n 0 the confidences are held to
# 0.025, a quarter of the JAX package's 0.1 bound between its fused and
# unfused bf16 blocks (tests/test_pallas_kernels.py:351-353).
TRUNK_BF16_REL = 17 * 2.0 ** -8
CONF_BF16_TOL = 0.025


def phase_cpu_bf16(params):
    """The bf16 engine on the card against the CPU (plain versions), at
    ``-n 0 -m 0``: confidences, and the one trunk pass's distance-map and
    confidence channels on PF10963's features. Coordinates are not compared:
    with random weights the predicted CA trace collapses, and MDS amplifies
    bf16-scale rounding into coordinate noise (tests/test_quality_gate.py:
    16-21); the CPU tests bound the bf16 fold's structure by TM-score instead.
    Returns the card's (packed trunk, input, mask) of that pass."""
    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.config import FoldConfig
    from dmpfold2_tpu_torch.models import trunk

    kw = dict(params=params, iterations=0, minsteps=0, config=FoldConfig(precision="bf16"))
    t0 = time.perf_counter()
    _, f_cpu = aln_to_coords(EXAMPLE_ALN, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    store = []
    with _capture_trunk_input(store):
        _, f_gpu = aln_to_coords(EXAMPLE_ALN, device="cuda", **kw)
    if len(store) != 1:
        raise AssertionError(f"expected one bf16 trunk pass at -n 0, saw {len(store)}")
    packed, x, mask = store[0]
    out_gpu = trunk.trunk_apply_bf16(packed, x, mask).cpu()
    out_cpu = trunk.trunk_apply_bf16(trunk.pack_bf16(params["trunk"]), x.cpu(), mask.cpu())
    valid = mask.cpu()[..., 0] > 0
    d = (out_gpu - out_cpu).abs()
    row = {"iterations": 0, "minsteps": 0, "cpu_wall_s": cpu_s,
           "max_abs_conf": float(np.abs(f_cpu - f_gpu).max()), "conf_tol": CONF_BF16_TOL,
           "padding_zero": bool((out_gpu[~valid] == 0).all())}
    tols = {"max_abs_conf": CONF_BF16_TOL}
    for ch, label in ((0, "dmap"), (1, "conf")):
        scale = out_cpu[..., ch][valid].abs().max().item()
        row[f"max_abs_{label}_channel"] = d[..., ch][valid].max().item()
        row[f"{label}_channel_scale"] = scale
        row[f"{label}_channel_tol"] = tols[f"max_abs_{label}_channel"] = TRUNK_BF16_REL * scale
    emit({"phase": "cpu", "precision": "bf16", "rows": [row]})
    failed = [k for k, tol in tols.items() if not row[k] <= tol]
    if failed or not row["padding_zero"]:
        raise AssertionError(f"bf16 card and CPU differ: {failed or 'padding'}")
    return store[0]


def main() -> None:
    # fail before printing anything without a card or without the package
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, REPO)
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    info = phase_device()

    phase_build()
    params = init_params(seed=0, width=WIDTH, cwidth=CWIDTH, num_blocks=BLOCKS)
    rows = phase_kernels(params)
    launches = {precision: phase_fold(params, precision)[0] for precision in ("fp32", "bf16")}
    for precision in ("fp32", "bf16"):
        phase_profile(params, precision)
    capture = phase_cpu_bf16(params)
    phase_trunk(capture)
    phase_cpu(params)
    for name, row in rows.items():
        # each kernel's count from the fold of the engine whose path it carries
        engine = "bf16" if name in ("conv5x5_maxout", "gemm_maxout") else "fp32"
        row["launches"] = launches[engine][name]
        row["kernel_ms"] = row["ms"]
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
