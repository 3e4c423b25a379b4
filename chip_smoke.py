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
   the shapes of the default fold of the bundled PF10963 example, with the
   tolerance stated; times from CUDA events after warm-up.
4. fold    -- ``aln_to_coords`` on PF10963 at full width (512/128/16, random
   weights from seed 0) with the defaults ``-n 10 -m 100`` on ``cuda``: a
   warm-up fold, then the timed fold with every launch counter set to 0
   just before it and read just after. Checks the PDB, finite values,
   confidences in [0, 1] and the exact launch counts.
   A second fold under torch.profiler gives device time by kernel.
5. cpu     -- the same weights through the port on the CPU (plain versions)
   at ``-n 1 -m 10`` (and ``-m 0``) against the card: the CA trace within
   1e-2 A, confidences within 5e-4, all atoms within 0.25 A (see
   ``phase_cpu`` for why the atoms get the wider bound).

Then the ``kernels`` line (launches from phase 4), and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
nonzero without the last line. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

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
# cores and HBM3 bandwidth; bound_ms is the larger of the two times
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
REFINE_FLOP_PER_PAIR = 24  # sub 3, square-sum 5, max, sqrt, clip 2, cmp, sub, mul, div 3, mul 3, add 3

# the default fold of PF10963: 252 sequences x 82 residues, bucket (256, 88)
N_PAD, L_PAD, NSEQS, NRES = 256, 88, 252, 82
WIDTH, CWIDTH, BLOCKS = 512, 128, 16
ITERATIONS, MINSTEPS = 10, 100
EXPECTED_LAUNCHES = {"vgru": 1, "rgru": 70, "refine": 2}
GRU_TOL = 1e-4     # fp32, sums in another order than cuBLAS over 512/256 terms
REFINE_TOL = 1e-4  # the JAX package's own kernel-vs-XLA bound (tests/test_pallas_refine.py)


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
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

    emit({"phase": "kernels", "cases": cases})
    for row in rows.values():
        if not row["max_abs_err"] <= row["tol"]:
            raise AssertionError(f"{row['name']}: kernel differs from its plain version by "
                                 f"{row['max_abs_err']:.3g} > {row['tol']:.3g}")
    return rows


def _counters():
    from dmpfold2_tpu_torch.kernels import refine, rgru, vgru

    return {"vgru": vgru, "rgru": rgru, "refine": refine}


def phase_fold(params) -> tuple[dict, tuple]:
    """The main path: aln_to_coords on the card at the reference defaults."""
    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.utils.pdb import format_pdb

    kw = dict(device="cuda", params=params, iterations=ITERATIONS, minsteps=MINSTEPS,
              return_alnmat=True)
    aln_to_coords(EXAMPLE_ALN, **kw)  # warm-up: cuDNN and cuSOLVER set-up
    mods = _counters()
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coords, confs, alnmat = aln_to_coords(EXAMPLE_ALN, **kw)
    wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in mods.items()}

    lines = list(format_pdb(coords, confs, alnmat[0]))
    n_atoms = sum(line.startswith("ATOM") for line in lines)
    checks = {
        "conf_header": lines[0].startswith("REMARK  CONF:"),
        "atoms_406": n_atoms == 406,
        "end": lines[-1] == "END",
        "finite": bool(np.isfinite(coords).all() and np.isfinite(confs).all()),
        "conf_in_0_1": bool(((confs >= 0) & (confs <= 1)).all()),
        "launches": launches == EXPECTED_LAUNCHES,
    }
    emit({"phase": "fold", "target": "PF10963", "shape": list(alnmat.shape),
          "iterations": ITERATIONS, "minsteps": MINSTEPS, "wall_s": wall,
          "launches": launches, "expected_launches": EXPECTED_LAUNCHES,
          "mean_conf": float(confs.mean()), "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fold checks failed: {failed}")
    return launches, (coords, confs)


# kernel-name fragments -> category, first match wins
PROFILE_CATEGORIES = (
    ("vgru", ("vgru_kernel",)), ("rgru", ("rgru_kernel",)), ("refine", ("refine_kernel",)),
    ("conv", ("conv", "xmma", "cudnn", "implicit", "winograd", "fft")),
    ("gemm", ("gemm", "gemv", "dot_kernel", "splitk")),
    ("linalg", ("syev", "potr", "trsm", "trtri", "sytr", "orm", "larf", "stedc", "steqr",
                "lascl", "lansy", "geqr", "cusolver", "syrk", "chol")),
)


def phase_profile(params) -> None:
    """Device time of one more default fold by kernel, from torch.profiler
    (profiler overhead included in its wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from dmpfold2_tpu_torch import aln_to_coords

    kw = dict(device="cuda", params=params, iterations=ITERATIONS, minsteps=MINSTEPS)
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
    for name, _, ms in kernels:
        cat = next((c for c, frags in PROFILE_CATEGORIES
                    if any(f in name.lower() for f in frags)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    busy = sum(ms for *_, ms in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:12]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": (1.0 - busy / wall_ms) if wall_ms else None,
          "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
          "kernel_launches": sum(count for _, count, _ in kernels),
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
    launches, _ = phase_fold(params)
    phase_profile(params)
    phase_cpu(params)
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["kernel_ms"] = row["ms"]
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
