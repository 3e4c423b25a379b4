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
   the shapes of the default fold of the bundled PF10963 example (and more:
   vgru also at 1024 x 352 with ragged depths, rgru's one-launch biGRU layer
   also at B 5 with ragged lengths and at T 352, the conv in both modes up
   to L 352, refine on the fold's own trace and on random walks at L 88, 352
   and 1536 and as a ragged batch of 4), each launched twice for the same
   bits, with the tolerance stated; device times from torch.profiler or CUDA
   events after warm-up.
3b. mds    -- the bf16 engine's MDS, the top-8 eigenpairs by subspace
   iteration (``ops/eigh.py``), on realistic Grams at B 1 L 88, B 1 L 736
   and B 8 L 256 (per-target nres): the card against the port's CPU run
   within 1e-4 of each target's coordinate scale, against ``eigh`` on the
   card within 2e-3, each target of the B 8 call against its map alone
   within 1e-4, padded rows exactly zero; each MDS call's time, device
   launches and host syncs for ``eigh`` and the subspace; PF10963's bf16
   fold on a held ``Folder`` with each MDS in turns, the MDS share of its
   wall time and its host syncs. See ``phase_mds``.
4. fold    -- ``aln_to_coords`` on PF10963 at full width (512/128/16, random
   weights from seed 0) with the defaults ``-n 10 -m 100`` on ``cuda``, once
   per engine (fp32, then bf16, whose MDS is the subspace iteration): a
   warm-up fold, then the timed fold with
   every launch counter set to 0 just before it and read just after, and
   four more timed folds for the spread of the wall time, and five on a
   held ``Folder`` (parameters uploaded once, the serving case). Checks
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
7. batch   -- per engine, the batch engine (``BatchFolder.fold_many``, the
   CLI's ``-o`` mode) on 16 targets, batch size 8, ``-n 10 -m 100``:
   PF10963 and seven seeded alignments in bucket 256 x 88, eight in 256 x
   256. Counters set to 0 around one run: each kernel's launches per batch
   must equal one fold's; no batch may fail (a requeue fails the phase).
   Targets/s, the time ``fold_many_async`` takes to return, each batch
   alone, the device idle share of one 256 x 256 batch; four targets
   against their own single folds (fp32 at ``-n 1 -m 10``, bf16 at ``-n 0
   -m 0`` with phase cpu's bounds) and a partial batch against the full one.
   Phases fold and batch print the model FLOP utilization (utils/flops.py)
   with the peak it is read against.
7b. strict -- the fidelity engine ``fp32_strict`` (LU DCA, raw eigenvector
   signs): phase fold's checks and times in fp32_strict (launches equal to
   the fp32 fold's); LU features card vs CPU within 1e-4 and LU vs Cholesky
   within 1e-5 of max |ref|; confidences at ``-n 0 -m 0`` card vs CPU within
   5e-4; the MDS output the same bits as eigh's own top-8 columns, and the
   columns whose raw sign differs between card and CPU recorded; the batch
   engine at B 8 in fp32_strict with each target's raw MDS output the same
   bits as its map alone and its confidences within 5e-4 of its single
   fold; PF10963 at its exact shape (252 x 82) against its bucket in fp32
   and bf16.
8. serve   -- a bf16 ``FoldService`` over HTTP (max batch 8, warmed at 256 x
   88): 16 concurrent clients post PF10963 at the defaults (half as text,
   half as JSON), then 16 post phase batch's targets; every response a
   whole PDB, requests coalesced, every inference kernel launched, req/s
   and latency percentiles; then each inference kernel's device time and
   bound at the batch shapes (B 8, L 256; refine also at B 16).
8a. multi  -- several devices and processes on the one card, bf16: (a) the
   batch engine over ``make_mesh()`` (every visible card) on phase batch's
   eight 256 x 88 targets, B 8, ``-n 1 -m 10``, the same bits as without a
   mesh; (b) a mesh of two replicas on cuda:0 (B 8 split 4 + 4, each shard
   on its own thread and stream): the same bits per target as (a), or else
   confidences at ``-n 0 -m 0`` within phase cpu's bf16 bound, recorded, and
   one set of launches per shard (path "batch bf16 mesh"); (c) the service
   over that mesh, 16 concurrent PF10963 requests, every response a whole
   PDB; (d) two processes on cuda:0 over gloo (NCCL refuses two ranks on one
   GPU; this script run with ``--ddp-rank``), DDP ``train_step``s on two
   PF10963 samples split 1 + 1, nloops 0 and refine 0 in bf16 and fp32 (and
   fp32 with the coordinate head scaled as phase train's "spread"), then
   bf16 at nloops 3, refine 10 (path "train bf16 ddp"), each against the same
   arithmetic in one process (each sample at B 1 at its global slot,
   gradients summed): each sample's loss within 1e-5 relative and the
   gradient cosine >= 0.9999 per top-level group; against the
   single-process step at B 2 the random model's fp32 losses and the spread
   model's gradient cosines, the rest of that comparison recorded (see
   ``DDP_STEPS``); both ranks' parameters the same bits; (e)
   an NCCL group of one process: the step the plain step's bits. About 1 min.
8c. seq    -- residue-axis sharding over ``make_mesh(1, n, devices=["cuda:0"]
   * n)``: the kernels' slab forms against their plain versions and, joined,
   the same bits as the square kernel (B 1 and 8, L 256 split 128 + 128 and
   96 + 96 + 64), and their times; the bf16 fold of PF10963 sharded 48 + 40
   against unsharded (the 16 block outputs the same bits, the trunk output
   within 1e-5, launches of the trunk kernels twice; path "fold bf16 seq"),
   fp32 and fp32_strict at ``-n 0 -m 0``, a seeded L 1024 target in bf16;
   ``train_step`` on the mesh against the unsharded step (path "train bf16
   seq"); ``serve`` over the mesh. See ``phase_seq``.
8d. long   -- the long target of BASELINE.json config 4: a seeded 3000 x 720
   alignment (bucket 3000 x 736, a (21 x 736)^2 = 15456^2 DCA covariance),
   bf16, 30 recycles, 100 minsteps. (a) ``pair_features`` per DCA method
   (cholesky, blocked and schur, one route that runs the blocked inverse
   past 8192; lu): each method's features within 1e-5 of LU's (of max
   |ref|), the three Cholesky-type names the same bits, their peak memory at
   most 2.5 (21 x 736)^2 fp32 matrices, each method's time and peak; the
   inverse alone, blocked against the stock Cholesky inverse; (b) the blocked
   features of a seeded 256 x 416 alignment (n 8736) card vs CPU within
   1e-4; (c) vgru at 3000 x 736 (and ``torch.nn.GRU(22, 512,
   num_layers=2)``, its library call, there) and the fold's other kernels at
   L 736 against their plain versions, then one fold through ``Folder`` after a
   warm-up: launches (path "fold bf16 long"), a whole PDB, the wall time and
   the model FLOP utilization. See ``phase_long``.
8b. evaluate -- ``train/evaluate.py`` on eight seeded validation targets in
   two buckets, batch 8, ``-n 10 -m 100``, in bf16 and fp32_strict: every
   target scored, each record equal to ``score.tm_score`` of its fold;
   targets/s (random weights: TM itself means nothing).
9. train   -- bf16 training at full width through ``DMPDataset``,
   ``pad_to_bucket``, ``make_optimizer`` and ``train_step``, on two samples
   written to a temp dir: four micro-steps (nloops 0-3, accumulation over 2)
   and an eval step on PF10963 with exact launch counts (16 argmax launches
   per trunk pass, no other kernel) and the parameters moving only at the
   accumulation boundary; then a crop-350 step (bucket 768 x 352, nloops 3):
   wall time, a device profile, peak memory. Last, the step on the card
   against the CPU, refinement's backward and the bf16 training trunk's
   backward (see ``phase_train_cpu``).

Phase 3 also holds the conv kernel's argmax mode (bf16 training) against its
stats mode and its plain version, and ``Conv5x5MaxoutDiff``'s gradients
against autograd through the plain version, and times both directions.

Then the ``kernels`` line (launches from phase 4: the fp32 fold for vgru,
rgru and refine, the bf16 fold for the two trunk kernels; from phase 9's
micro-steps for conv5x5_maxout_diff; ``launches_by_path`` gives each path's
own count, phase multi's "batch bf16 mesh" and "train bf16 ddp" (both
ranks) and phase seq's "fold bf16 seq" and "train bf16 seq" among them,
``batch_shape`` the time and bound at the batch shapes, ``slab`` the slab
form's at phase seq's shape, vgru's ``long`` its case at 3000 x 736 in phase
long, whose path "fold bf16 long" is among the paths), and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits nonzero without the last
line. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the tensor
# cores, bf16 on the tensor cores and HBM3 bandwidth; bound_ms is the larger
# of the operations time and the bytes time. Alone, without the package, the
# script stops here with exit code 1 and no result, as it must.
try:
    from dmpfold2_tpu_torch.utils.assets import example_aln_path
    from dmpfold2_tpu_torch.utils.flops import (PEAK_BF16_TENSOR, PEAK_FP32_FLOPS,
                                                PEAK_HBM_BYTES, fold_flops, mfu)
except ModuleNotFoundError as exc:
    sys.exit(f"chip_smoke: the dmpfold2_tpu_torch package is not beside this script ({exc})")

EXAMPLE_ALN = example_aln_path()
# the peak each engine's model FLOP utilization is read against, named beside it
MFU_PEAK = {"fp32": (PEAK_FP32_FLOPS, "fp32 67 TFLOP/s (H100 SXM, TF32 off)"),
            "fp32_strict": (PEAK_FP32_FLOPS, "fp32 67 TFLOP/s (H100 SXM, TF32 off)"),
            "bf16": (PEAK_BF16_TENSOR, "bf16 tensor 989 TFLOP/s (H100 SXM)")}
REFINE_FLOP_PER_PAIR = 24  # sub 3, square-sum 5, max, sqrt, clip 2, cmp, sub, mul, div 3, mul 3, add 3

# the default fold of PF10963: 252 sequences x 82 residues, bucket (256, 88)
N_PAD, L_PAD, NSEQS, NRES = 256, 88, 252, 82
WIDTH, CWIDTH, BLOCKS = 512, 128, 16
ITERATIONS, MINSTEPS = 10, 100
FOLD_REPEATS = 5  # timed folds per engine; the first is the one counted
EXPECTED_LAUNCHES = {
    "fp32": {"vgru": 1, "rgru": 35, "refine": 2, "conv5x5_maxout": 0, "gemm_maxout": 0,
             "conv5x5_maxout_diff": 0, "block_tail": 0},
    # rgru: one launch per biGRU layer (both directions), hgru's 2 layers and
# coord_gru's 3 in each of 11 trunk passes: 2 + 11 * 3. 11 trunk passes: one
# input layer and 16 block convs and tails each
    "bf16": {"vgru": 1, "rgru": 35, "refine": 2, "conv5x5_maxout": 176, "gemm_maxout": 11,
             "conv5x5_maxout_diff": 0, "block_tail": 176},
}
# fp32_strict is the fp32 engine with the LU DCA and raw signs: the same kernels
EXPECTED_LAUNCHES["fp32_strict"] = EXPECTED_LAUNCHES["fp32"]
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
# the conv kernel in both modes: TRUNK_CASES, an odd count of pixel tiles
# (5 x 3, a persistent grid of fewer blocks than SMs) and the training crop's
# bucket
DIFF_CASES = TRUNK_CASES + ((2, 40, [40, 17]), (1, 352, [350]))
# rgru: (T, valid lengths per column): the main path's layer, a ragged batch
# with a zero length, the training crop's bucket
RGRU_CASES = ((L_PAD, [NRES]), (L_PAD, [88, 61, 1, 82, 0]), (352, [350]))
# vgru beyond PF10963: a deep, wide alignment (bucketed long targets) with
# ragged per-column depths, several column chunks per block
VGRU_WIDE = (1024, 352)
GEMM_K_IN = 955  # the input layer's channels: 512 pair + 442 DCA + 1 dmap
# refine, 100 steps: the fold's own first input (the random model's trace,
# collapsed: every pair closer than 3 A, so every pair takes the force path;
# there 100 steps part two fp32 versions by about 2e-3 A, so it is held step
# by step), then random walks as (L, nres per target): the fold's shape, the
# training crop's bucket with a padded target, the largest bucket, a ragged
# batch; the timed ones with their profiler reps
REFINE_FOLD_CASE = f"fold trace L={L_PAD} nres={[NRES]}"
REFINE_CASES = ((L_PAD, [NRES]), (352, [330]), (1536, [1536]), (352, [352, 300, 82, 1]))
REFINE_TIMED = {REFINE_FOLD_CASE: 50, f"L={L_PAD} nres={[NRES]}": 50, "L=1536 nres=[1536]": 10,
                "L=352 nres=[352, 300, 82, 1]": 20}


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


def device_ms(fn, fragment: str, reps: int, per_call: int = 1) -> float:
    """Mean device milliseconds per call of ``fn`` in the kernels whose name
    holds ``fragment``, from torch.profiler over ``reps`` calls after warm-up;
    each call launches ``per_call`` of them. Unlike CUDA events around
    back-to-back calls, this leaves out the host time of a wrapper whose
    kernel is shorter than its Python. The profiler can lose activity records
    (an H100 run once reported 39 of 50 launches, another 9 of 10 three times
    running), so a profile whose count is not ``reps * per_call`` is taken
    again, up to three times; then the mean over the launches the fullest
    one saw is taken. More launches than expected fail."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    counts, fullest = [], (0, 0.0)
    for _ in range(3):
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
        if count == reps * per_call:
            return total / reps / 1e3
        counts.append(count)
        if count < reps * per_call:
            fullest = max(fullest, (count, total))
    if fullest[0] and max(counts) < reps * per_call:
        return fullest[1] / fullest[0] * per_call / 1e3
    raise AssertionError(f"profiler saw {counts} launches of {fragment}, expected "
                         f"{reps * per_call}")


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


def _vgru_library(layers, aln: torch.Tensor):
    """The library call that computes vgru's function at a uniform depth:
    ``torch.nn.GRU(22, 512, num_layers=2)`` (cuDNN) with vgru's weights, and
    the one-hot of ``aln``'s rows, its input."""
    gru_lib = torch.nn.GRU(22, WIDTH, num_layers=2).to(aln.device)
    with torch.no_grad():
        for i, p in enumerate(layers):
            getattr(gru_lib, f"weight_ih_l{i}").copy_(p["wi"].T)
            getattr(gru_lib, f"weight_hh_l{i}").copy_(p["wh"].T)
            getattr(gru_lib, f"bias_ih_l{i}").copy_(p["bi"])
            getattr(gru_lib, f"bias_hh_l{i}").copy_(p["bh"])
    return gru_lib, torch.nn.functional.one_hot(aln.long(), 22).float()


def phase_kernels(params) -> dict:
    """Each kernel against its plain version on the card; returns per-kernel rows."""
    from dmpfold2_tpu_torch.engine.fold import use_full_fp32
    from dmpfold2_tpu_torch.kernels import rgru, vgru

    use_full_fp32()  # the library calls too: cuDNN's GRU would otherwise use TF32
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases, rows = [], {}

    # ---- vgru: 256 rows x 88 columns (uniform and per-column depths) and
    # 1024 x 352 ragged, H = 512; each launched twice: the same bits
    layers = [{k: v.to(dev) for k, v in p.items()} for p in params["vgru"]]
    aln = torch.from_numpy(rng.integers(0, 22, (N_PAD, L_PAD)).astype(np.int32)).to(dev)
    uniform = torch.full((L_PAD,), NSEQS, dtype=torch.int32, device=dev)
    ragged = torch.from_numpy(rng.integers(1, N_PAD + 1, L_PAD).astype(np.int32)).to(dev)
    n_wide, c_wide = VGRU_WIDE
    aln_wide = torch.from_numpy(rng.integers(0, 22, VGRU_WIDE).astype(np.int32)).to(dev)
    ragged_wide = torch.from_numpy(rng.integers(1, n_wide + 1, c_wide).astype(np.int32)).to(dev)
    err = 0.0
    for label, a, valid in (("uniform 252", aln, uniform), ("per-column", aln, ragged),
                            ("wide, per-column", aln_wide, ragged_wide)):
        out = vgru.vgru_final_cols(layers, a, valid)
        out2 = vgru.vgru_final_cols(layers, a, valid)
        ref = vgru.vgru_final_cols_plain(layers, a, valid)
        e = (out - ref).abs().max().item()
        err = max(err, e)
        same = bool(torch.equal(out, out2))
        cases.append({"kernel": "vgru", "case": label, "shape": [*a.shape, WIDTH],
                      "max_abs_err": e, "tol": GRU_TOL, "second_launch_identical": same,
                      "ok": e <= GRU_TOL and same})
    ms = device_ms(lambda: vgru.vgru_final_cols(layers, aln, uniform), "vgru_kernel", reps=10)
    call_ms = time_ms(lambda: vgru.vgru_final_cols(layers, aln, uniform), reps=10)
    plain_ms = time_ms(lambda: vgru.vgru_final_cols_plain(layers, aln, uniform), reps=2, warmup=1)
    gru_lib, onehot = _vgru_library(layers, aln[:NSEQS])
    with torch.no_grad():
        lib_out = gru_lib(onehot)[1][-1]
        lib_err = (lib_out - vgru.vgru_final_cols(layers, aln, uniform)).abs().max().item()
        library_ms = time_ms(lambda: gru_lib(onehot), reps=10)
    b, by = _vgru_bound(aln, uniform)
    rows["vgru"] = {"name": "vgru", "route": "cuda", "source": "dmpfold2_tpu_torch/csrc/vgru.cu",
                    "replaces": "dmpfold2_tpu/kernels/vgru.py:113", "max_abs_err": err,
                    "tol": GRU_TOL, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                    "bound_ms": b, "bound_by": by, "library_ms": library_ms,
                    "library": "torch.nn.GRU(22, 512, num_layers=2) on rows [0, 252)",
                    "library_max_abs_err": lib_err}

    # ---- rgru: T = 88, H = 256, B = 1 (main path), B = 5 ragged with a zero
    # length, T = 352; both directions of a layer in one launch (gru_seq_bidir,
    # the fold's path), each case launched twice for the same bits, and the
    # one-direction gru_seq
    hid = WIDTH // 2
    layer = {d: {k: v.to(dev) for k, v in params["coord_gru"][0][d].items()}
             for d in ("fwd", "bwd")}
    err = 0.0
    for seq_len, valid_np in RGRU_CASES:
        batch = len(valid_np)
        xf, xb = (torch.from_numpy(rng.normal(size=(seq_len, batch, 3 * hid)).astype(np.float32))
                  .to(dev) for _ in range(2))
        valid = torch.tensor(valid_np, dtype=torch.int32, device=dev)
        out = rgru.gru_seq_bidir(layer["fwd"], layer["bwd"], xf, xb, valid)
        out2 = rgru.gru_seq_bidir(layer["fwd"], layer["bwd"], xf, xb, valid)
        ref = rgru.gru_seq_bidir_plain(layer["fwd"], layer["bwd"], xf, xb, valid)
        e = (out - ref).abs().max().item()
        same = bool(torch.equal(out, out2))
        err = max(err, e)
        cases.append({"kernel": "rgru", "case": f"bidir T={seq_len} B={batch}",
                      "shape": [seq_len, batch, 2 * hid], "valid": valid_np, "max_abs_err": e,
                      "tol": GRU_TOL, "second_launch_identical": same,
                      "ok": e <= GRU_TOL and same})
        for d, x, reverse in (("fwd", xf, False), ("bwd", xb, True)):
            one = rgru.gru_seq(layer[d]["wh"], layer[d]["bh"], x, valid, reverse=reverse)
            e = (one - ref[..., hid:] if reverse else one - ref[..., :hid]).abs().max().item()
            err = max(err, e)
            cases.append({"kernel": "rgru", "case": f"gru_seq T={seq_len} B={batch} "
                          f"reverse={reverse}", "valid": valid_np, "max_abs_err": e,
                          "tol": GRU_TOL, "ok": e <= GRU_TOL})
    # timing: one layer of the main path (both directions), 82 valid steps
    xf, xb = (torch.from_numpy(rng.normal(size=(L_PAD, 1, 3 * hid)).astype(np.float32)).to(dev)
              for _ in range(2))
    valid = torch.tensor([NRES], dtype=torch.int32, device=dev)

    def bidir():
        return rgru.gru_seq_bidir(layer["fwd"], layer["bwd"], xf, xb, valid)

    ms = device_ms(bidir, "rgru", reps=50)
    call_ms = time_ms(bidir, reps=50)
    plain_ms = time_ms(lambda: rgru.gru_seq_bidir_plain(layer["fwd"], layer["bwd"], xf, xb,
                                                        valid), reps=3)
    lib = torch.nn.GRU(3 * hid, hid, bidirectional=True).to(dev)
    with torch.no_grad():
        for suffix, d in (("", "fwd"), ("_reverse", "bwd")):
            getattr(lib, f"weight_ih_l0{suffix}").copy_(torch.eye(3 * hid, device=dev))
            getattr(lib, f"bias_ih_l0{suffix}").zero_()
            getattr(lib, f"weight_hh_l0{suffix}").copy_(layer[d]["wh"].T)
            getattr(lib, f"bias_hh_l0{suffix}").copy_(layer[d]["bh"])
        full = torch.tensor([L_PAD], dtype=torch.int32, device=dev)
        lib_err = (lib(xf)[0][..., :hid]
                   - rgru.gru_seq(layer["fwd"]["wh"], layer["fwd"]["bh"], xf, full)).abs().max().item()
        library_ms = time_ms(lambda: lib(xf), reps=50)
    flops = 2 * (2 * hid * 3 * hid * NRES)
    nbytes = 2 * 4 * (xf.numel() + hid * 3 * hid + 3 * hid + L_PAD * hid) + 4
    b, by = bound_ms(flops, nbytes)
    rows["rgru"] = {"name": "rgru", "route": "cuda", "source": "dmpfold2_tpu_torch/csrc/rgru.cu",
                    "replaces": "dmpfold2_tpu/kernels/rgru.py:75", "max_abs_err": err,
                    "tol": GRU_TOL, "ms": ms, "device_ms": ms, "call_ms": call_ms,
                    "us_per_step": ms * 1e3 / NRES, "plain_ms": plain_ms, "bound_ms": b,
                    "bound_by": by, "library_ms": library_ms,
                    "shape": "one biGRU layer, both directions: T 88, B 1, H 256, 82 valid",
                    "library": "torch.nn.GRU(768, 256, bidirectional=True) (cuDNN) with W_ih = "
                               "I, b_ih = 0, on xproj_f (both directions read it), valid = T",
                    "library_max_abs_err": lib_err}

    rows["refine"] = _refine_kernel(params, rng, cases)
    rows.update(_trunk_kernels(params, rng, cases))
    rows["conv5x5_maxout_diff"] = _argmax_kernel(params, rng, cases)

    emit({"phase": "kernels", "cases": cases})
    for row in rows.values():
        if "tol" in row and not row["max_abs_err"] <= row["tol"]:
            raise AssertionError(f"{row['name']}: kernel differs from its plain version by "
                                 f"{row['max_abs_err']:.3g} > {row['tol']:.3g}")
    failed = [c for c in cases if not c.get("ok", True)]
    if failed:
        raise AssertionError(f"kernels differ from their plain versions: {failed}")
    return rows


def _fold_trace(params) -> torch.Tensor:
    """The fp32 fold's first refinement input on PF10963 (``-n 0``), as
    (1, L_PAD, 3) on the card: the trace the main path refines."""
    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.kernels import refine

    seen, orig = [], refine.refine_coords_batched

    def recording(ca, n_steps, nres):
        seen.append(ca.clone())
        return orig(ca, n_steps, nres)

    refine.refine_coords_batched = recording
    try:
        aln_to_coords(EXAMPLE_ALN, device="cuda", params=params, iterations=0,
                      minsteps=MINSTEPS)
    finally:
        refine.refine_coords_batched = orig
    return seen[0]


def _refine_stepwise_err(refine, ca, nres) -> float:
    """Along the plain version's MINSTEPS-step path from ``ca``: the largest
    difference between one kernel step and one plain step from the same
    state. One step's rounding is not amplified by the steps after it."""
    worst = torch.zeros((), device=ca.device)
    for _ in range(MINSTEPS):
        nxt = refine.refine_coords_batched_plain(ca, 1, nres)
        worst = torch.maximum(worst, (refine.refine_coords_batched(ca, 1, nres) - nxt).abs().max())
        ca = nxt
    return worst.item()


def _refine_kernel(params, rng, cases) -> dict:
    """refine against its plain version on the fold's own trace and at every
    REFINE_CASES shape: within REFINE_TOL (the fold's trace step by step, see
    REFINE_FOLD_CASE), the same bits on a second launch, padding untouched.
    Each case records beside the check how far the plain version on the CPU
    lies from the one on the card, and the kernel and both plain versions
    from the plain version in fp64. Timed at the REFINE_TIMED cases; the
    row's ms is the fold trace's."""
    from dmpfold2_tpu_torch.kernels import refine

    dev = torch.device("cuda")
    inputs = [(REFINE_FOLD_CASE, _fold_trace(params), [NRES])]
    inputs += [(f"L={n} nres={nres_l}",
                torch.from_numpy(np.stack([_chain(n, rng) for _ in nres_l])).to(dev), nres_l)
               for n, nres_l in REFINE_CASES]
    err, shapes = 0.0, {}
    for label, ca, nres_l in inputs:
        nres = torch.tensor(nres_l, dtype=torch.int32, device=dev)

        def run(ca=ca, nres=nres):
            return refine.refine_coords_batched(ca, MINSTEPS, nres)
        out, out2 = run(), run()
        ref = refine.refine_coords_batched_plain(ca, MINSTEPS, nres)
        e = (out - ref).abs().max().item()
        same = bool(torch.equal(out, out2))
        kept = all(torch.equal(out[b, k:], ca[b, k:]) for b, k in enumerate(nres_l))
        ref64 = refine.refine_coords_batched_plain(ca.double(), MINSTEPS, nres)
        ref_cpu = refine.refine_coords_batched_plain(ca.cpu(), MINSTEPS, nres.cpu())
        valid = ca[0, :nres_l[0]]
        close = (torch.cdist(valid, valid) < 3.0).float().mean().item()
        case = {"kernel": "refine", "case": label, "steps": MINSTEPS,
                "pairs_closer_than_3A": close, "max_abs_err": e, "tol": REFINE_TOL,
                "second_launch_identical": same, "padding_untouched": kept,
                "plain_cpu_vs_plain": (ref_cpu - ref.cpu()).abs().max().item(),
                "vs_fp64": (out - ref64).abs().max().item(),
                "plain_vs_fp64": (ref - ref64).abs().max().item(),
                "plain_cpu_vs_fp64": (ref_cpu.double() - ref64.cpu()).abs().max().item()}
        if label == REFINE_FOLD_CASE:
            case["stepwise_max_abs_err"] = _refine_stepwise_err(refine, ca, nres)
            err = max(err, case["stepwise_max_abs_err"])
            case["ok"] = case["stepwise_max_abs_err"] <= REFINE_TOL and same and kept
        else:
            err = max(err, e)
            case["ok"] = e <= REFINE_TOL and same and kept
        cases.append(case)
        if label in REFINE_TIMED:
            flops = MINSTEPS * REFINE_FLOP_PER_PAIR * sum(k * k for k in nres_l)
            b, by = bound_ms(flops, 2 * 4 * ca.numel() + 4 * len(nres_l))
            shapes[label] = {
                "ms": device_ms(run, "refine_kernel", reps=REFINE_TIMED[label]),
                "call_ms": time_ms(run, reps=REFINE_TIMED[label]),
                "plain_ms": time_ms(lambda ca=ca, nres=nres: refine.refine_coords_batched_plain(
                    ca, MINSTEPS, nres), reps=2, warmup=1),
                "bound_ms": b, "bound_by": by, "gflop": flops / 1e9,
                "pairs_closer_than_3A": close}
    main = shapes[REFINE_FOLD_CASE]
    return {"name": "refine", "route": "cuda", "source": "dmpfold2_tpu_torch/csrc/refine.cu",
            "replaces": "dmpfold2_tpu/kernels/refine.py:104", "max_abs_err": err,
            "tol": REFINE_TOL, "ms": main["ms"], "call_ms": main["call_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": f"the fold's trace, L {L_PAD}, nres {NRES}, {MINSTEPS} steps; one cluster "
                     "of 16 CTAs per target", "shapes": shapes}


def _packed_trunk_weights(params, dev):
    """The main path's block-0 conv and input-layer weights on ``dev``,
    packed as the bf16 engine packs them: (conv_w, conv_b, gemm_w, gemm_b,
    the GEMM's padded K)."""
    from dmpfold2_tpu_torch.kernels import conv_block

    trunk = params["trunk"]
    conv_w, conv_b = conv_block.pack_conv5x5_weights(trunk["blocks"][0]["maxout"]["w"].to(dev),
                                                     trunk["blocks"][0]["maxout"]["b"].to(dev))
    k_pad = conv_block.gemm_k_pad(GEMM_K_IN)
    gemm_w, gemm_b = conv_block.pack_gemm_weights(trunk["input"]["w"].to(dev),
                                                  trunk["input"]["b"].to(dev), k_pad)
    return conv_w, conv_b, gemm_w, gemm_b, k_pad


def _vgru_bound(aln: torch.Tensor, valid: torch.Tensor) -> tuple[float, str]:
    """vgru's bound for (rows, columns) tokens ``aln`` and per-column depths
    ``valid``: its two layers' products over every valid cell, and each input
    read and output written once."""
    h = WIDTH
    flops = 2 * 3 * h * 3 * h * float(valid.sum().item())
    nbytes = 4 * (aln.numel() + valid.numel() + 22 * 3 * h + 3 * h * 3 * h + 4 * 3 * h
                  + valid.numel() * h)
    return bound_ms(flops, nbytes)


def _trunk_check(kernel, plain, x, w, b, nr) -> dict:
    """A bf16 trunk kernel against its plain version on the same inputs:
    the output within one bf16 ulp, the sums within STATS_RTOL, the same bits
    on a second launch."""
    out, s, ss = kernel(x, w, b, nr)
    out2, s2, ss2 = kernel(x, w, b, nr)
    ref, rs, rss = plain(x, w, b, nr)
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    ulp = (d / (BF16_ULP * ref.float().abs().clamp(min=1.0))).max().item()
    stats_rel = max(((s - rs).abs() / rs.abs().clamp(min=1e-30)).max().item(),
                    ((ss - rss).abs() / rss.abs().clamp(min=1e-30)).max().item())
    same = bool(torch.equal(s, s2) and torch.equal(ss, ss2) and torch.equal(out, out2))
    return {"max_abs_err": d.max().item(), "max_err_in_bf16_ulps": ulp,
            "stats_max_rel_err": stats_rel, "stats_rtol": STATS_RTOL,
            "second_launch_identical": same,
            "ok": ulp <= 1.0 and stats_rel <= STATS_RTOL and same}


def _trunk_kernels(params, rng, cases) -> dict:
    """conv5x5_maxout and gemm_maxout against their plain versions, with the
    main path's weights (block 0's conv, the input layer) packed as the bf16
    engine packs them. Each case launches twice: the stats must be the same
    bits."""
    import torch.nn.functional as F

    from dmpfold2_tpu_torch.kernels import conv_block

    dev = torch.device("cuda")
    conv_w, conv_b, gemm_w, gemm_b, k_pad = _packed_trunk_weights(params, dev)
    kinds = {
        "conv5x5_maxout": (conv_block.conv5x5_maxout_stats, conv_block.conv5x5_maxout_stats_plain,
                           conv_w, conv_b, CWIDTH),
        "gemm_maxout": (conv_block.gemm_maxout_stats, conv_block.gemm_maxout_stats_plain,
                        gemm_w, gemm_b, GEMM_K_IN),
    }

    def inputs(kind, batch, l, nres):
        c_in = kinds[kind][4]
        x = torch.zeros((batch, l, l, kinds[kind][2].shape[1] if kind == "gemm_maxout" else c_in))
        valid = (torch.arange(l)[None, :] < torch.tensor(nres)[:, None]).float()
        x[..., :c_in] = (torch.from_numpy(rng.normal(size=(batch, l, l, c_in)).astype(np.float32))
                         * valid[:, :, None, None] * valid[:, None, :, None])
        return (x.to(torch.bfloat16).to(dev), torch.tensor(nres, dtype=torch.int32, device=dev))

    rows = {}
    for kind, (kernel, plain, w, b, c_in) in kinds.items():
        worst_ulp, worst_abs = 0.0, 0.0
        for batch, l, nres in (DIFF_CASES if kind == "conv5x5_maxout" else TRUNK_CASES):
            x, nr = inputs(kind, batch, l, nres)
            case = _trunk_check(kernel, plain, x, w, b, nr)
            worst_ulp = max(worst_ulp, case["max_err_in_bf16_ulps"])
            worst_abs = max(worst_abs, case["max_abs_err"])
            cases.append({"kernel": kind, "case": f"B={batch} L={l} nres={nres}", **case})
        # timing at the main path's shape: B 1, L 88, nres 82
        x, nr = inputs(kind, *TRUNK_CASES[0])
        ms = device_ms(lambda: kernel(x, w, b, nr), f"{kind}_kernel", reps=50)
        call_ms = time_ms(lambda: kernel(x, w, b, nr), reps=50)
        plain_ms = time_ms(lambda: plain(x, w, b, nr), reps=5)
        npix = L_PAD * L_PAD
        c_out = b.shape[0]
        if kind == "conv5x5_maxout":
            flops = 2.0 * npix * w.numel()
            nbytes = 2 * (x.numel() + w.numel() + npix * c_out // 4) + 4 * (c_out + 1 + 2 * c_out // 4)
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory, as the kernel reads it
            w_lib = conv_block.unpack_conv5x5_weights(w).contiguous(
                memory_format=torch.channels_last)
            library_ms = time_ms(lambda: F.conv2d(x_nchw, w_lib, padding=2), reps=50)
            library = ("F.conv2d on channels-last bf16 (cuDNN): the 5x5 conv to 512 channels "
                       "only, without bias, maxout or statistics; computes less than the kernel")
        else:
            flops = 2.0 * npix * GEMM_K_IN * c_out
            nbytes = 2 * (x.numel() + w.numel() + npix * c_out // 3) + 4 * (c_out + 1 + 2 * c_out // 3)
            x2d = x.view(npix, k_pad)
            w_lib = w.T  # (k_pad, c_out), a transposed view: cuBLAS reads it as it is
            library_ms = time_ms(lambda: torch.matmul(x2d, w_lib), reps=50)
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


# the argmax mode and conv5x5_maxout_diff: the shapes of the kernel check
# (DIFF_CASES) and of the timing (the two training buckets of phase train)
DIFF_TIMING_L = (L_PAD, 352)
DIFF_GRAD_CASES = ((1, L_PAD, [NRES]), (2, 53, [53, 20]), (1, 352, [350]))
# the Function's gradients against autograd through the plain version, with
# the same bf16 cotangent, zero at groups whose plain top-2 margin is below
# 1e-3 of the maximum: there the kernel's fp32 sums (in another order, ~1e-6
# relative) may pick the other slice, and a flip moves db by a whole
# cotangent. Elsewhere dx is the one bf16 rounding of an fp32 sum: one bf16
# ulp of max(|ref|, 1); dw and db are fp32 sums of the same products in
# another order, over up to B L^2 = 123904 terms (~sqrt(n) * 2^-24 ~ 2e-5
# relative): 1e-3 of max(|ref|, 1).
TIE_MARGIN = 1e-3
DW_DB_RTOL = 1e-3


def _argmax_kernel(params, rng, cases) -> dict:
    """The conv kernel's argmax mode and Conv5x5MaxoutDiff on the card, with
    block 0's weights: the argmax output against stats mode (the same bits)
    and the plain version (one bf16 ulp), each index against the plain fp32
    maximum (within one bf16 ulp), a second launch (the same bits); the
    Function's dx, dw and db against autograd through the plain version; then
    times of both directions at the two training buckets. Returns the row of
    conv5x5_maxout_diff."""
    import torch.nn.functional as F

    from dmpfold2_tpu_torch.kernels import conv_block

    dev = torch.device("cuda")
    mx = params["trunk"]["blocks"][0]["maxout"]
    w, b = mx["w"].to(dev), mx["b"].to(dev)
    wp, bp = conv_block.pack_conv5x5_weights(w, b)
    c_out = w.shape[0]

    def inputs(batch, l, nres):
        valid = (torch.arange(l)[None, :] < torch.tensor(nres)[:, None]).float()
        x = (torch.from_numpy(rng.normal(size=(batch, l, l, CWIDTH)).astype(np.float32))
             * valid[:, :, None, None] * valid[:, None, :, None])
        return x.to(torch.bfloat16).to(dev), torch.tensor(nres, dtype=torch.int32, device=dev)

    def plain_pre_max(x):
        """The plain version's fp32 values before the max: (B, L, L, C/4, 4)."""
        wf = conv_block.unpack_conv5x5_weights(wp.float())
        y = F.conv2d(x.float().permute(0, 3, 1, 2), wf, bp, padding=2).permute(0, 2, 3, 1)
        return y.reshape(*y.shape[:3], c_out // 4, 4)

    worst_ulp = worst_abs = worst_idx_ulp = 0.0
    for batch, l, nres in DIFF_CASES:
        x, nr = inputs(batch, l, nres)
        out, idx = conv_block.conv5x5_maxout_argmax(x, wp, bp)
        out2, idx2 = conv_block.conv5x5_maxout_argmax(x, wp, bp)
        stats_out = conv_block.conv5x5_maxout_stats(x, wp, bp, nr)[0]
        ref, ref_idx = conv_block.conv5x5_maxout_argmax_plain(x, wp, bp)
        pre = plain_pre_max(x)
        top = pre.amax(dim=-1)
        chosen = pre.gather(-1, idx.long().unsqueeze(-1))[..., 0]
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        ulp = (d / (BF16_ULP * ref.float().abs().clamp(min=1.0))).max().item()
        idx_ulp = ((top - chosen) / (BF16_ULP * top.abs().clamp(min=1.0))).max().item()
        case = {"kernel": "conv5x5_maxout_argmax", "case": f"B={batch} L={l} nres={nres}",
                "max_abs_err": d.max().item(), "max_err_in_bf16_ulps": ulp,
                "same_bits_as_stats_mode": bool(torch.equal(out, stats_out)),
                "index_gap_to_max_in_bf16_ulps": idx_ulp,
                "index_equal_to_plain_share": (idx == ref_idx).float().mean().item(),
                "second_launch_identical": bool(torch.equal(out, out2) and torch.equal(idx, idx2))}
        case["ok"] = (ulp <= 1.0 and idx_ulp <= 1.0 and case["same_bits_as_stats_mode"]
                      and case["second_launch_identical"])
        cases.append(case)
        worst_ulp, worst_abs = max(worst_ulp, ulp), max(worst_abs, d.max().item())
        worst_idx_ulp = max(worst_idx_ulp, idx_ulp)

    # ---- the Function's gradients against autograd through the plain version
    grad_errs = {}
    for batch, l, nres in DIFF_GRAD_CASES:
        x, _ = inputs(batch, l, nres)
        top2 = plain_pre_max(x).topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > TIE_MARGIN * top2[..., 0].abs().clamp(min=1.0)
        g = torch.from_numpy(rng.normal(size=clear.shape).astype(np.float32)).to(dev)
        g = (g * clear).to(torch.bfloat16)
        xg, wg, bg = (t.detach().clone().requires_grad_() for t in (x, w, b))
        got = torch.autograd.grad(conv_block.Conv5x5MaxoutDiff.apply(xg, wg, bg), (xg, wg, bg), g)
        # w rounded before it becomes a leaf: autograd through a cast to bf16
        # would round the reference's dw to bf16 too
        xr, wr, br = (t.detach().clone().requires_grad_()
                      for t in (x.float(), w.to(torch.bfloat16).float(), b))
        y = F.conv2d(xr.permute(0, 3, 1, 2), wr, br, padding=2)
        y = y.permute(0, 2, 3, 1).reshape(*x.shape[:3], c_out // 4, 4).amax(dim=-1)
        want = torch.autograd.grad(y, (xr, wr, br), g.float())
        for name, a, r, tol in zip(("dx", "dw", "db"), got, want, (BF16_ULP, DW_DB_RTOL, DW_DB_RTOL)):
            e = ((a.float() - r).abs() / r.abs().clamp(min=1.0)).max().item()
            grad_errs[name] = max(grad_errs.get(name, 0.0), e)
        grad_errs["tie_share"] = max(grad_errs.get("tie_share", 0.0),
                                     1.0 - clear.float().mean().item())
    grad_tols = {"dx": BF16_ULP, "dw": DW_DB_RTOL, "db": DW_DB_RTOL}
    grad_ok = all(grad_errs[k] <= tol for k, tol in grad_tols.items())
    cases.append({"kernel": "conv5x5_maxout_diff", "case": "dx, dw, db vs autograd through "
                  "the plain version (B 1 L 88, B 2 L 53, B 1 L 352)", "max_rel_err": grad_errs,
                  "tol": grad_tols, "ok": grad_ok})

    # ---- times of both directions
    timings = []
    for l in DIFF_TIMING_L:
        x, _ = inputs(1, l, [l])
        npix = l * l
        fwd_flops = 2.0 * npix * wp.numel()
        fwd_bytes = 2 * (x.numel() + wp.numel() + npix * c_out // 4) + 4 * c_out + npix * c_out // 4
        # the backward reads x, w, the cotangent and the index and writes dx,
        # dw and db; dx and dw are each one product of the forward's size
        bwd_bytes = (2 * (x.numel() + npix * c_out // 4) + npix * c_out // 4 + 4 * wp.numel()
                     + 2 * x.numel() + 4 * wp.numel() + 4 * c_out)
        row = {"L": l}
        row["fwd_ms"] = device_ms(lambda: conv_block.conv5x5_maxout_argmax(x, wp, bp),
                                  "conv5x5_maxout_argmax_kernel", reps=20)
        row["fwd_plain_ms"] = time_ms(lambda: conv_block.conv5x5_maxout_argmax_plain(x, wp, bp),
                                      reps=3)
        x_nchw = x.permute(0, 3, 1, 2)
        w_lib = conv_block.unpack_conv5x5_weights(wp).contiguous(
            memory_format=torch.channels_last)
        row["fwd_library_ms"] = time_ms(lambda: F.conv2d(x_nchw, w_lib, padding=2), reps=20)
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(fwd_flops, fwd_bytes, PEAK_BF16_TENSOR)
        g = torch.from_numpy(rng.normal(size=(1, l, l, c_out // 4)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        xg, wg, bg = (t.detach().clone().requires_grad_() for t in (x, w, b))
        out = conv_block.Conv5x5MaxoutDiff.apply(xg, wg, bg)
        row["bwd_ms"] = time_ms(lambda: torch.autograd.grad(out, (xg, wg, bg), g,
                                                            retain_graph=True), reps=5)
        xr, wr, br = (t.detach().clone().requires_grad_()
                      for t in (x.float(), w.to(torch.bfloat16).float(), b))
        y = F.conv2d(xr.permute(0, 3, 1, 2), wr, br, padding=2)
        y = y.permute(0, 2, 3, 1).reshape(1, l, l, c_out // 4, 4).amax(dim=-1)
        row["bwd_plain_ms"] = time_ms(lambda: torch.autograd.grad(y, (xr, wr, br), g.float(),
                                                                  retain_graph=True), reps=3)
        xl, wl, bl = (t.detach().clone().requires_grad_() for t in
                      (x_nchw, w_lib, b.to(torch.bfloat16)))
        yl = F.conv2d(xl, wl, bl, padding=2).permute(0, 2, 3, 1)
        yl = yl.reshape(1, l, l, c_out // 4, 4).amax(dim=-1)
        row["bwd_library_ms"] = time_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), g,
                                                                    retain_graph=True), reps=5)
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(2 * fwd_flops, bwd_bytes,
                                                            PEAK_BF16_TENSOR)
        timings.append(row)
        del out, y, yl
    cases.append({"kernel": "conv5x5_maxout_diff", "case": "times, B 1", "timings": timings})
    main = timings[-1]  # L 352, the crop bucket, where training spends its time
    return {"name": "conv5x5_maxout_diff", "route": "cuda",
            "source": "dmpfold2_tpu_torch/csrc/conv5x5_maxout.cu",
            "wrapper": "dmpfold2_tpu_torch/kernels/conv_block.py:Conv5x5MaxoutDiff (the "
                       "kernel's argmax mode forward, cuDNN and cuBLAS backward)",
            "replaces": "dmpfold2_tpu/kernels/conv_block.py:646",
            "max_abs_err": worst_abs, "max_err_in_bf16_ulps": worst_ulp,
            "index_gap_in_bf16_ulps": worst_idx_ulp, "grad_max_rel_err": grad_errs,
            "ms": main["fwd_ms"] + main["bwd_ms"],
            "plain_ms": main["fwd_plain_ms"] + main["bwd_plain_ms"],
            "bound_ms": main["fwd_bound_ms"] + main["bwd_bound_ms"], "bound_by": "operations",
            "library_ms": main["fwd_library_ms"] + main["bwd_library_ms"],
            "library": "forward: F.conv2d channels-last bf16 (cuDNN), the conv only, without "
                       "bias or maxout (computes less); backward: autograd through F.conv2d "
                       "bf16 + bias + amax, which splits a tie's gradient and rounds dw and db "
                       "to bf16 (computes otherwise)",
            "shape": "B 1, L 352, fwd + bwd", "timings": timings}


def _counters():
    """kernel name -> (module, name of its launch counter)."""
    from dmpfold2_tpu_torch.kernels import conv_block, refine, rgru, vgru

    return {"vgru": (vgru, "launches"), "rgru": (rgru, "launches"),
            "refine": (refine, "launches"),
            "conv5x5_maxout": (conv_block, "conv_launches"),
            "gemm_maxout": (conv_block, "gemm_launches"),
            "conv5x5_maxout_diff": (conv_block, "conv_argmax_launches"),
            "block_tail": (conv_block, "tail_launches")}


def _reset_counters() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counters() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def phase_fold(params, precision: str) -> tuple[dict, tuple]:
    """The main path: aln_to_coords on the card at the reference defaults."""
    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.config import FoldConfig
    from dmpfold2_tpu_torch.engine.fold import Folder
    from dmpfold2_tpu_torch.utils.pdb import format_pdb

    kw = dict(device="cuda", params=params, iterations=ITERATIONS, minsteps=MINSTEPS,
              return_alnmat=True, config=FoldConfig(precision=precision))
    aln_to_coords(EXAMPLE_ALN, **kw)  # warm-up: cuDNN and cuSOLVER set-up
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coords, confs, alnmat = aln_to_coords(EXAMPLE_ALN, **kw)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    expected = EXPECTED_LAUNCHES[precision]
    # the spread: the bf16 fold is bound by the host issuing launches, and
    # the host is shared, so one fold's wall time says little
    walls = [wall]
    for _ in range(FOLD_REPEATS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aln_to_coords(EXAMPLE_ALN, **kw)
        walls.append(time.perf_counter() - t0)

    # the same fold on a held Folder (the serving case): the parameters
    # uploaded and, in bf16, packed once, not per fold as aln_to_coords does
    folder = Folder(params, device="cuda", precision=precision)
    folder.fold(alnmat, iterations=ITERATIONS, minsteps=MINSTEPS)
    held = []
    for _ in range(FOLD_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folder.fold(alnmat, iterations=ITERATIONS, minsteps=MINSTEPS)
        held.append(time.perf_counter() - t0)
    del folder

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
    flops = fold_flops(N_PAD, L_PAD, ITERATIONS, MINSTEPS)
    peak, peak_name = MFU_PEAK[precision]
    emit({"phase": "fold", "precision": precision, "target": "PF10963",
          "shape": list(alnmat.shape), "iterations": ITERATIONS, "minsteps": MINSTEPS,
          "wall_s": wall, "wall_s_median": float(np.median(walls)), "wall_s_all": walls,
          "held_folder_wall_s_median": float(np.median(held)), "held_folder_wall_s_all": held,
          "fold_flops": flops, "mfu_peak": peak_name,
          "mfu": mfu(flops, float(np.median(walls)), peak),
          "mfu_held_folder": mfu(flops, float(np.median(held)), peak),
          "launches": launches, "expected_launches": expected,
          "mean_conf": float(confs.mean()), "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{precision} fold checks failed: {failed}")
    return launches, (coords, confs)


# ---------------------------------------------------------------- batch and serve
#
# Phase batch: the batch engine (BatchFolder, the CLI's -o mode) on 16
# targets at full width, -n 10 -m 100, batch size 8: PF10963 and seven
# seeded alignments in bucket 256 x 88, eight in bucket 256 x 256. Phase
# serve: a bf16 FoldService over HTTP on the same card.

BATCH_SIZE = 8
BATCH_BUCKETS = ((N_PAD, L_PAD), (256, 256))
BATCH_TIMED = 2  # timed fold_many runs per engine after the warm-up; the first is counted
# batch against its own targets' single folds on the card, per engine: the
# (model, (iterations, minsteps)) settings run, each with the targets it
# holds ("all", a name, or None: recorded only) and the differences it
# holds. A batch and a single fold differ only in the order of fp32 sums
# (cuBLAS and cuDNN pick their kernels by shape), as the card and the CPU
# do, so they get phase cpu's bounds: fp32 confidence 5e-4, CA 1e-2 A, atoms
# 0.25 A; bf16 at -n 0 -m 0 confidence 0.025 and the trunk channels 17 x
# 2^-8 of their scale. The model "random" is the seed-0 weights, whose CA
# trace is collapsed (every pair closer than 3 A): there backbone
# completion, refinement and the recycle's choice of its best pass turn
# rounding into tenths of an A or whole A (PERF.md, Findings), so it is held
# where the network's output is well conditioned (its CA trace and
# confidences at -n 0 -m 0; PF10963, as phase cpu holds it, at -n 1 -m 10)
# and the rest recorded; _batch_stages holds every target's refinement,
# backbone completion and choice of its best pass on the batch's own
# inputs. The model "spread" is the same weights with the coordinate head
# scaled by HEAD_SCALE, as the CPU tests scale it (tests/test_torch_stream.py),
# recorded only: at full width most of its CA pairs are still closer than
# 3 A, batch and single fold part by up to 1e-3 A of CA at -n 0 -m 0, and
# recycling and refinement amplify that to tenths of an A or more (PERF.md,
# Findings).
BATCH_CHECK = {
    "fp32": (("random", (0, 0), "all", ("max_abs_conf", "max_abs_ca")),
             ("random", (0, MINSTEPS // 10), None, ()),
             ("random", (1, MINSTEPS // 10), "PF10963",
              ("max_abs_conf", "max_abs_ca", "max_abs_atoms")),
             ("spread", (0, 0), None, ()),
             ("spread", (1, MINSTEPS // 10), None, ())),
    "bf16": (("random", (0, 0), "all", ("max_abs_conf", "max_abs_dmap_channel",
                                        "max_abs_conf_channel")),),
}
FP32_FOLD_TOLS = {"max_abs_conf": 5e-4, "max_abs_ca": 1e-2, "max_abs_atoms": 0.25}
AA_TEXT = "ARNDCQEGHILKMFPSTWYVX-"  # class index -> aln letter
SERVE_CLIENTS = 16


def _batch_targets():
    """PF10963, then seeded alignments: 7 more in bucket 256 x 88 (nseqs
    129-252, nres 81-88) and 8 in bucket 256 x 256 (nseqs 129-256, nres
    241-256); (name, alnmat) pairs."""
    from dmpfold2_tpu_torch.utils.aln import parse_aln

    rng = np.random.default_rng(7)
    out = [("PF10963", parse_aln(EXAMPLE_ALN))]
    for i, (seqs, res) in enumerate([((129, 253), (81, 89))] * 7 + [((129, 257), (241, 257))] * 8):
        shape = (int(rng.integers(*seqs)), int(rng.integers(*res)))
        out.append((f"seeded{i + 1}", rng.integers(0, 22, shape).astype(np.uint8)))
    return out


def _n_atoms(alnmat) -> int:
    """ATOM records of a target's PDB: five per residue, no CB for glycine."""
    from dmpfold2_tpu_torch.utils.aln import GLYCINE

    return 5 * alnmat.shape[1] - int((alnmat[0] == GLYCINE).sum())


def _fold_checks(coords, confs, alnmat) -> dict:
    from dmpfold2_tpu_torch.utils.pdb import format_pdb

    lines = list(format_pdb(coords, confs, alnmat[0]))
    n_atoms = sum(line.startswith("ATOM") for line in lines)
    return {"shape": coords.shape == (alnmat.shape[1], 5, 3),
            "atoms": n_atoms == _n_atoms(alnmat),
            "finite": bool(np.isfinite(coords).all() and np.isfinite(confs).all()),
            "conf_in_0_1": bool(((confs >= 0) & (confs <= 1)).all())}


@contextlib.contextmanager
def _logged_events(store: list):
    """Record the event of every log line the batch engine writes."""
    from dmpfold2_tpu_torch.parallel import stream

    orig = stream.log_target

    def recording(*args, **kw):
        store.append(kw.get("event", "target_folded"))
        return orig(*args, **kw)

    stream.log_target = recording
    try:
        yield
    finally:
        stream.log_target = orig


@contextlib.contextmanager
def _trunk_outputs(store: list):
    """Record (input shape, output) of every bf16 trunk pass."""
    from dmpfold2_tpu_torch.models import gruresnet

    orig = gruresnet.trunk_apply_bf16

    def recording(packed, xs, masks, *args):
        out = orig(packed, xs, masks, *args)
        store.append((tuple(xs[0].shape), out.clone(), masks[0].clone()))  # one shard
        return out

    gruresnet.trunk_apply_bf16 = recording
    try:
        yield
    finally:
        gruresnet.trunk_apply_bf16 = orig


def _batch_vs_single(bf, params, targets, precision) -> dict:
    """Four targets (PF10963, the shortest, one more per bucket) through the
    batch at each BATCH_CHECK[precision] setting against their own single
    folds on the same held Folder (``bf``'s for the model "random", one of
    the head-scaled weights for "spread"); and the first five of bucket 256
    x 88 as a partial batch (padded by repeating the fifth) against the full
    batch at the first setting."""
    from dmpfold2_tpu_torch.engine.buckets import bucket_shape
    from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target

    tgts = [Target(a) for _, a in targets]
    by_bucket = [[i for i, (_, a) in enumerate(targets) if bucket_shape(*a.shape) == b]
                 for b in BATCH_BUCKETS]
    shortest = min(range(len(targets)), key=lambda i: targets[i][1].shape[1])
    picked = list(dict.fromkeys([0, shortest] + [next(i for i in idx if i not in (0, shortest))
                                                 for idx in by_bucket]))
    folders = {"random": bf}
    settings, failed, partial_rows = [], [], []
    for model, (iterations, minsteps), held, held_keys in BATCH_CHECK[precision]:
        if model not in folders:
            folders[model] = BatchFolder(dict(params, coord_fc=params["coord_fc"] * HEAD_SCALE),
                                         device="cuda", batch_size=BATCH_SIZE,
                                         precision=precision)
        mbf = folders[model]
        batch_out, single_out = [], []
        with _trunk_outputs(batch_out):
            full = mbf.fold_many(tgts, iterations, minsteps)
        rows = []
        for i in picked:
            name, alnmat = targets[i]
            with _trunk_outputs(single_out):
                c1, f1 = mbf.folder.fold(alnmat, iterations=iterations, minsteps=minsteps)
            cb, fb = full[i]
            row = {"target": name, "shape": list(alnmat.shape),
                   "max_abs_conf": float(np.abs(fb - f1).max()),
                   "max_abs_ca": float(np.abs(cb[:, 1] - c1[:, 1]).max()),
                   "max_abs_atoms": float(np.abs(cb - c1).max()),
                   "ca_pairs_closer_than_3A": float(
                       (np.linalg.norm(c1[:, None, 1] - c1[None, :, 1], axis=-1) < 3.0).mean())}
            if precision == "fp32":
                tols = dict(FP32_FOLD_TOLS)
            else:
                tols = {"max_abs_conf": CONF_BF16_TOL}
                # the target's slice of its batch's trunk pass against its own
                bucket = bucket_shape(*alnmat.shape)
                slot = by_bucket[BATCH_BUCKETS.index(bucket)].index(i)  # one batch per bucket
                _, out_b, _ = next(o for o in batch_out if o[0][1] == bucket[1])
                _, out_s, mask = single_out[-1]
                valid = mask[0, ..., 0] > 0
                for ch, label in ((0, "dmap"), (1, "conf")):
                    ref = out_s[0, ..., ch][valid]
                    scale = ref.abs().max().item()
                    row[f"max_abs_{label}_channel"] = (out_b[slot, ..., ch][valid]
                                                       - ref).abs().max().item()
                    row[f"{label}_channel_scale"] = scale
                    tols[f"max_abs_{label}_channel"] = TRUNK_BF16_REL * scale
            row["tols"] = tols
            row["held"] = list(held_keys) if held in ("all", name) else []
            failed += [f"{model} -n {iterations} -m {minsteps} {name}: {k}"
                       for k in row["held"] if not row[k] <= tols[k]]
            rows.append(row)
        settings.append({"model": model, "iterations": iterations, "minsteps": minsteps,
                         "rows": rows})
        if partial_rows:
            continue
        partial = mbf.fold_many([tgts[i] for i in by_bucket[0][:5]], iterations, minsteps)
        for j, i in enumerate(by_bucket[0][:5]):
            (pc, pf), (fc, ff) = partial[j], full[i]
            row = {"target": targets[i][0],
                   "identical": bool(np.array_equal(pc, fc) and np.array_equal(pf, ff)),
                   "max_abs_conf": float(np.abs(pf - ff).max()),
                   "max_abs_ca": float(np.abs(pc[:, 1] - fc[:, 1]).max())}
            partial_rows.append(row)
            if not (row["max_abs_conf"] <= rows[0]["tols"]["max_abs_conf"]
                    and row["max_abs_ca"] <= FP32_FOLD_TOLS["max_abs_ca"]):
                failed.append(f"partial batch {targets[i][0]}")
    for mbf in folders.values():
        if mbf is not bf:
            mbf.close()
    return {"vs_single": settings, "partial_batch": partial_rows, "failed": failed}


BATCH_STAGES = (1, MINSTEPS // 10)  # (iterations, minsteps) of the stage holds


def _batch_stages(bf, targets) -> dict:
    """One fp32 fold_many at BATCH_STAGES, one batch at a time, recording
    each batch's trunk outputs, refinements and backbone completion; then,
    for every target of every batch, on the batch's own inputs: each
    refinement the same bits as the target's own B 1 launch, backbone
    completion the same bits as the target alone, and the returned
    confidences those of the pass with the target's best mean confidence
    (recomputed from the recorded trunk outputs by the same expression,
    within 1e-6) with the coordinates the completion's."""
    from dmpfold2_tpu_torch.engine.buckets import bucket_shape
    from dmpfold2_tpu_torch.kernels import refine
    from dmpfold2_tpu_torch.models import gruresnet
    from dmpfold2_tpu_torch.parallel.stream import Target

    rec = []
    orig = (gruresnet.trunk_apply, refine.refine_coords_batched, gruresnet.calpha_to_main_chain)

    def trunk(*args, **kw):
        out = orig[0](*args, **kw)
        rec.append(("trunk", out.clone()))
        return out

    def refine_rec(ca, n_steps, nres):
        out = orig[1](ca, n_steps, nres)
        rec.append(("refine", ca.clone(), n_steps, nres.clone(), out.clone()))
        return out

    def complete(ca, nres):
        out = orig[2](ca, nres)
        rec.append(("complete", ca.clone(), nres.clone(), out.clone()))
        return out

    gruresnet.trunk_apply, refine.refine_coords_batched = trunk, refine_rec
    gruresnet.calpha_to_main_chain = complete
    inflight, bf.max_inflight = bf.max_inflight, 1
    try:
        results = bf.fold_many([Target(a) for _, a in targets], *BATCH_STAGES)
    finally:
        gruresnet.trunk_apply, refine.refine_coords_batched = orig[0], orig[1]
        gruresnet.calpha_to_main_chain = orig[2]
        bf.max_inflight = inflight
    # one record block per batch, in the order fold_many runs them: its
    # trunk passes, two refinements and the completion
    per_batch = 1 + BATCH_STAGES[0] + 2 + 1
    groups, order = {}, []
    for i, (_, a) in enumerate(targets):
        groups.setdefault(bucket_shape(*a.shape), []).append(i)
    for idx in groups.values():
        order += [idx[k:k + BATCH_SIZE] for k in range(0, len(idx), BATCH_SIZE)]
    if len(rec) != per_batch * len(order):
        raise AssertionError(f"stages: {len(rec)} records for {len(order)} batches")
    batches, failed = [], []
    for n, chunk in enumerate(order):
        block = rec[n * per_batch:(n + 1) * per_batch]
        outs = [r[1] for r in block if r[0] == "trunk"]
        refs = [r for r in block if r[0] == "refine"]
        (_, ca_c, nres_c, atoms) = next(r for r in block if r[0] == "complete")
        nres_f = nres_c.float()
        row_mask = (torch.arange(ca_c.shape[1], device=ca_c.device)[None, :]
                    < nres_c[:, None]).float()
        confs = [(o[..., 1] * row_mask[:, None, :]).sum(dim=2) / nres_f[:, None] for o in outs]
        means = [(c * row_mask).sum(dim=1) / nres_f for c in confs]
        row = {"targets": [targets[i][0] for i in chunk], "refine_as_at_b1": True,
               "complete_as_alone": True, "best_pass": [], "max_abs_conf_vs_best_pass": 0.0,
               "coords_are_completion": True}
        for b, ti in enumerate(chunk):
            k = int(nres_c[b])
            for _, ca, n_steps, nres, out in refs:
                row["refine_as_at_b1"] &= torch.equal(
                    orig[1](ca[b:b + 1].contiguous(), n_steps, nres[b:b + 1])[0], out[b])
            row["complete_as_alone"] &= torch.equal(
                orig[2](ca_c[b:b + 1], nres_c[b:b + 1])[0], atoms[b])
            best = 0
            for p in range(1, len(means)):
                if means[p][b] > means[best][b]:
                    best = p
            row["best_pass"].append(best)
            want = torch.sigmoid(confs[best][b, :k]).cpu().numpy()
            coords, conf = results[ti]
            row["max_abs_conf_vs_best_pass"] = max(row["max_abs_conf_vs_best_pass"],
                                                   float(np.abs(conf - want).max()))
            row["coords_are_completion"] &= bool(np.array_equal(coords,
                                                                atoms[b, :k].cpu().numpy()))
        row["ok"] = (row["refine_as_at_b1"] and row["complete_as_alone"]
                     and row["coords_are_completion"] and row["max_abs_conf_vs_best_pass"] <= 1e-6)
        batches.append(row)
        if not row["ok"]:
            failed.append(f"stages of batch {n}")
    return {"iterations": BATCH_STAGES[0], "minsteps": BATCH_STAGES[1], "batches": batches,
            "failed": failed}


def _batch_kernel_shapes(params, rng) -> dict:
    """Each inference kernel at the batch engine's shapes (bucket 256 x 256,
    B 8, ragged lengths as phase batch's; refine also at B 16, two waves of
    16-CTA clusters on 132 SMs): against its plain version on the same inputs
    with the kernel phase's limits (the GRUs GRU_TOL; the trunk kernels one
    bf16 ulp and their sums STATS_RTOL; refine REFINE_TOL at 100 steps where
    its two plain versions agree that far, and step by step for every
    target, each target the same bits as its own B 1 launch, padding
    untouched), the same bits on a second launch; and its time (CUDA events
    over back-to-back launches, each at least 0.3 ms, so the wrappers' host
    time hides; the block tail's, 0.15 ms, from the profiler) and bound.
    Raises when a check fails."""
    from dmpfold2_tpu_torch.kernels import conv_block, refine, rgru, vgru

    dev = torch.device("cuda")
    n_rows, l = BATCH_BUCKETS[1]
    nres = [int(v) for v in rng.integers(241, 257, BATCH_SIZE)]
    nseqs = [int(v) for v in rng.integers(129, 257, BATCH_SIZE)]
    nres_t = torch.tensor(nres, dtype=torch.int32, device=dev)
    out = {}

    def held(fn, plain, tol):
        """Two launches of ``fn`` against ``plain``: max |d|, same bits, ok."""
        got, again, ref = fn(), fn(), plain()
        e = (got - ref).abs().max().item()
        same = bool(torch.equal(got, again))
        return got, {"max_abs_err": e, "tol": tol, "second_launch_identical": same,
                     "ok": e <= tol and same}

    # vgru: B * L = 2048 columns, each at its target's depth
    layers = [{k: v.to(dev) for k, v in p.items()} for p in params["vgru"]]
    aln = torch.from_numpy(rng.integers(0, 22, (n_rows, BATCH_SIZE * l)).astype(np.int32)).to(dev)
    depth = torch.tensor(nseqs, dtype=torch.int32, device=dev).repeat_interleave(l)
    _, check = held(lambda: vgru.vgru_final_cols(layers, aln, depth),
                    lambda: vgru.vgru_final_cols_plain(layers, aln, depth), GRU_TOL)
    b, by = _vgru_bound(aln, depth)
    out["vgru"] = {"shape": f"{n_rows} rows x {BATCH_SIZE * l} columns, depths {nseqs}",
                   **check, "ms": time_ms(lambda: vgru.vgru_final_cols(layers, aln, depth), reps=3),
                   "bound_ms": b, "bound_by": by}
    # rgru: one biGRU layer of coord_gru, T 256, B 8, lengths nres
    hid = WIDTH // 2
    layer = {d: {k: v.to(dev) for k, v in params["coord_gru"][0][d].items()}
             for d in ("fwd", "bwd")}
    xf, xb = (torch.from_numpy(rng.normal(size=(l, BATCH_SIZE, 3 * hid)).astype(np.float32))
              .to(dev) for _ in range(2))
    _, check = held(
        lambda: rgru.gru_seq_bidir(layer["fwd"], layer["bwd"], xf, xb, nres_t),
        lambda: rgru.gru_seq_bidir_plain(layer["fwd"], layer["bwd"], xf, xb, nres_t), GRU_TOL)
    flops = 2 * (2 * hid * 3 * hid * sum(nres))
    nbytes = 2 * 4 * (xf.numel() + hid * 3 * hid + 3 * hid + l * BATCH_SIZE * hid) + 4 * BATCH_SIZE
    b, by = bound_ms(flops, nbytes)
    out["rgru"] = {"shape": f"one biGRU layer, T {l}, B {BATCH_SIZE}, H {hid}, lengths {nres}",
                   **check,
                   "ms": time_ms(lambda: rgru.gru_seq_bidir(layer["fwd"], layer["bwd"], xf, xb,
                                                            nres_t), reps=20),
                   "bound_ms": b, "bound_by": by}
    # refine: random walks at B 8 and B 16, L 256
    shapes = {}
    for batch in (BATCH_SIZE, 2 * BATCH_SIZE):
        nr = (nres * 2)[:batch]
        ca = torch.from_numpy(np.stack([_chain(l, rng) for _ in nr])).to(dev)
        nr_t = torch.tensor(nr, dtype=torch.int32, device=dev)

        def run(ca=ca, nr_t=nr_t):
            return refine.refine_coords_batched(ca, MINSTEPS, nr_t)

        got, again = run(), run()
        ref = refine.refine_coords_batched_plain(ca, MINSTEPS, nr_t)
        ref_cpu = refine.refine_coords_batched_plain(ca.cpu(), MINSTEPS, nr_t.cpu())
        err = (got - ref).abs().amax(dim=(1, 2)).tolist()
        plain_cpu = (ref_cpu - ref.cpu()).abs().amax(dim=(1, 2)).tolist()
        # held at 100 steps: each target whose two plain versions (card, CPU)
        # agree within REFINE_TOL; the others are ill-conditioned over 100
        # steps (as the fold's trace of the kernel phase) and are held step
        # by step, as every target is
        at_100 = [e for e, c in zip(err, plain_cpu) if c <= REFINE_TOL]
        check = {"max_abs_err": max(at_100), "tol": REFINE_TOL,
                 "max_abs_err_by_target": err, "plain_cpu_vs_plain_by_target": plain_cpu,
                 "held_at_100_steps": len(at_100),
                 "stepwise_max_abs_err": _refine_stepwise_err(refine, ca, nr_t),
                 "second_launch_identical": bool(torch.equal(got, again)),
                 "each_target_as_at_b1": all(
                     torch.equal(refine.refine_coords_batched(ca[i:i + 1], MINSTEPS,
                                                              nr_t[i:i + 1])[0], got[i])
                     for i in range(batch)),
                 "padding_untouched": all(torch.equal(got[i, k:], ca[i, k:])
                                          for i, k in enumerate(nr))}
        check["ok"] = (check["max_abs_err"] <= REFINE_TOL
                       and check["stepwise_max_abs_err"] <= REFINE_TOL
                       and check["second_launch_identical"] and check["each_target_as_at_b1"]
                       and check["padding_untouched"])
        flops = MINSTEPS * REFINE_FLOP_PER_PAIR * sum(k * k for k in nr)
        b, by = bound_ms(flops, 2 * 4 * ca.numel() + 4 * batch)
        shapes[f"B {batch}"] = {**check, "ms": time_ms(run, reps=20), "bound_ms": b,
                                "bound_by": by}
    out["refine"] = {"shape": f"L {l}, {MINSTEPS} steps, random walks, nres {nres} (B 16: "
                              "twice)", **shapes[f"B {BATCH_SIZE}"],
                     "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
                     "ok": all(v["ok"] for v in shapes.values()), "shapes": shapes}
    # the bf16 trunk kernels at B 8, L 256 with the main path's weights, on
    # inputs that are zero outside each target's nres x nres, as the trunk's
    conv_w, conv_b, gemm_w, gemm_b, k_pad = _packed_trunk_weights(params, dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    valid = (torch.arange(l, device=dev)[None, :] < nres_t[:, None]).to(torch.bfloat16)
    npix = BATCH_SIZE * l * l
    for kind, kernel, plain, w, bias, c_in, width, pool in (
            ("conv5x5_maxout", conv_block.conv5x5_maxout_stats,
             conv_block.conv5x5_maxout_stats_plain, conv_w, conv_b, CWIDTH, CWIDTH, 4),
            ("gemm_maxout", conv_block.gemm_maxout_stats, conv_block.gemm_maxout_stats_plain,
             gemm_w, gemm_b, GEMM_K_IN, k_pad, 3)):
        x = torch.zeros((BATCH_SIZE, l, l, width), dtype=torch.bfloat16, device=dev)
        x[..., :c_in] = (torch.randn((BATCH_SIZE, l, l, c_in), device=dev, generator=gen)
                         .to(torch.bfloat16) * valid[:, :, None, None] * valid[:, None, :, None])
        check = _trunk_check(kernel, plain, x, w, bias, nres_t)
        c_out = bias.shape[0]
        flops = 2.0 * npix * (w.numel() if kind == "conv5x5_maxout" else c_in * c_out)
        nbytes = 2 * (x.numel() + w.numel() + npix * c_out // pool) + 4 * (c_out + BATCH_SIZE
                                                                           * 2 * c_out // pool)
        b, by = bound_ms(flops, nbytes, PEAK_BF16_TENSOR)
        out[kind] = {"shape": f"B {BATCH_SIZE}, L {l}, nres {nres}", **check,
                     "ms": time_ms(lambda x=x, w=w, bias=bias: kernel(x, w, bias, nres_t),
                                   reps=20),
                     "bound_ms": b, "bound_by": by}
        del x
    out["block_tail"] = _block_tail_shape(params, dev, nres_t, l, gen)
    emit({"phase": "batch_kernel_shapes", "rows": out})
    failed = [k for k, row in out.items() if not row["ok"]]
    if failed:
        raise AssertionError(f"kernels differ from their plain versions at the batch shapes: "
                             f"{failed}")
    return out


def _block_tail_shape(params, dev, nres_t, l: int, gen) -> dict:
    """The block tail at the batch shape (B = len(nres_t), L ``l``), block
    0's packed sSE and cSE weights, a maxout map, a carry and a (scale,
    shift) as the trunk's: within one bf16 ulp of its plain version, the same
    bits twice; its device time, its plain version's and its bound (read z,
    x and the mask, write the carry)."""
    from dmpfold2_tpu_torch.kernels import conv_block
    from dmpfold2_tpu_torch.models import trunk

    block = trunk.pack_block_bf16({part: {k: v.to(dev) for k, v in p.items()}
                                   for part, p in params["trunk"]["blocks"][0].items()})
    batch = nres_t.shape[0]
    valid = torch.arange(l, device=dev)[None, :] < nres_t[:, None]
    mask = (valid[:, :, None] & valid[:, None, :])[..., None].to(torch.bfloat16)
    shape = (batch, l, l, CWIDTH)
    z = (torch.randn(shape, device=dev, generator=gen) + 0.5).to(torch.bfloat16)
    x = (2 * torch.randn(shape, device=dev, generator=gen)).to(torch.bfloat16)
    scale = 1 + 0.2 * torch.randn((batch, CWIDTH), device=dev, generator=gen)
    shift = -0.5 * scale + 0.1 * torch.randn((batch, CWIDTH), device=dev, generator=gen)
    args = (z, x, mask, scale, shift, block["sse_w"], block["sse_b"], block["cse_gate"])
    got, again = conv_block.block_tail(*args), conv_block.block_tail(*args)
    ref = conv_block.block_tail_plain(*args)
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs()
    ulp = (d / (BF16_ULP * ref.float().abs().clamp(min=1.0))).max().item()
    same = bool(torch.equal(got.view(torch.int16), again.view(torch.int16)))
    # about 8 fp32 operations an element; bound by the bytes
    b, by = bound_ms(8.0 * z.numel(), 2 * (3 * z.numel() + mask.numel()))
    ms = device_ms(lambda: conv_block.block_tail(*args), "block_tail_kernel", reps=20)
    return {"shape": f"B {batch}, L {l}, nres {nres_t.tolist()}", "max_abs_err": d.max().item(),
            "max_err_in_bf16_ulps": ulp, "second_launch_identical": same,
            "ok": ulp <= 1.0 and same, "ms": ms,
            "plain_ms": time_ms(lambda: conv_block.block_tail_plain(*args), reps=5),
            "bound_ms": b, "bound_by": by, "bound_share": b / ms}


def _sync_sites(fn) -> list:
    """The host synchronisations of ``fn()`` on this thread, from torch's
    sync debug mode: each caller's file:line in the port with its count."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            counts[where] = counts.get(where, 0) + 1
    return [{"where": k, "count": v} for k, v in sorted(counts.items(), key=lambda kv: -kv[1])]


def _host_syncs(bf, batch) -> list:
    """The host synchronisations of one batch's fold (upload, forward,
    fetch): :func:`_sync_sites`."""
    from dmpfold2_tpu_torch.parallel import stream

    aln_b, dmap_b, nseqs, nres = stream._pad_batch(batch, *BATCH_BUCKETS[0])
    return _sync_sites(lambda: stream._fold_batch(bf.folder, aln_b, dmap_b, nseqs, nres,
                                                  ITERATIONS, MINSTEPS))


def phase_batch(params, precision: str) -> dict:
    """The batch engine through BatchFolder.fold_many on the card; returns
    the launch counts of its counted run."""
    from torch.profiler import ProfilerActivity, profile

    from dmpfold2_tpu_torch.engine.buckets import bucket_shape
    from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target

    targets = _batch_targets()
    tgts = [Target(a) for _, a in targets]
    bf = BatchFolder(params, device="cuda", batch_size=BATCH_SIZE, precision=precision)
    # every log line of the phase: a batch that fails (and requeues) fails it
    events: list = []
    log = contextlib.ExitStack()
    log.enter_context(_logged_events(events))
    bf.fold_many(tgts, ITERATIONS, MINSTEPS)  # warm-up: cuDNN, cuSOLVER, allocator
    walls = []
    for k in range(BATCH_TIMED):
        if k == 0:
            _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = bf.fold_many_async(tgts, ITERATIONS, MINSTEPS)
        returned_s = time.perf_counter() - t0
        results = pending.wait()
        walls.append(time.perf_counter() - t0)
        if k == 0:
            launches = _read_counters()
            counted = results
            dispatch_return_s = returned_s
    sizes = [sum(bucket_shape(*a.shape) == b for _, a in targets) for b in BATCH_BUCKETS]
    n_batches = sum(-(-n // BATCH_SIZE) for n in sizes)
    per_batch = {k: v / n_batches for k, v in launches.items()}
    expected = dict(EXPECTED_LAUNCHES[precision])
    checks = {"launches_per_batch": per_batch == expected,
              "all_folded": all(r is not None for r in counted)}
    for (name, alnmat), res in zip(targets, counted):
        if res is None:
            continue
        for k, ok in _fold_checks(res[0], res[1], alnmat).items():
            checks[f"{name} {k}"] = ok
    # one batch at a time (max_inflight 1): each bucket's batch alone, the
    # same bits as with two batches in flight
    bf.max_inflight = 1
    per_bucket, same_bits = {}, True
    for bucket in BATCH_BUCKETS:
        idx = [i for i, (_, a) in enumerate(targets) if bucket_shape(*a.shape) == bucket]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = bf.fold_many([tgts[i] for i in idx], ITERATIONS, MINSTEPS)
        per_bucket[f"{bucket[0]}x{bucket[1]}"] = time.perf_counter() - t0
        same_bits &= all(np.array_equal(a[0], counted[i][0]) and np.array_equal(a[1], counted[i][1])
                         for a, i in zip(alone, idx))
    checks["inflight_1_same_bits"] = same_bits
    # a half batch (B 4) of bucket 256 x 88, alone: what the service's half
    # batches cost against a full one
    bf.batch_size = BATCH_SIZE // 2
    half = [t for t, (_, a) in zip(tgts, targets)
            if bucket_shape(*a.shape) == BATCH_BUCKETS[0]][:BATCH_SIZE // 2]
    for _ in range(2):  # the first at B 4 is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf.fold_many(half, ITERATIONS, MINSTEPS)
        half_batch_s = time.perf_counter() - t0
    bf.batch_size = BATCH_SIZE
    host_syncs = _host_syncs(bf, [tgts[i] for i, (_, a) in enumerate(targets)
                                  if bucket_shape(*a.shape) == BATCH_BUCKETS[0]])
    # the device idle share of one batch: bucket 256 x 256, B 8, alone
    big = [t for t, (_, a) in zip(tgts, targets) if bucket_shape(*a.shape) == BATCH_BUCKETS[1]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bf.fold_many(big, ITERATIONS, MINSTEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat, kernel_launches, busy = {}, {}, 0.0
    for name, count, ms in _device_kernels(prof):
        cat = _category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        kernel_launches[cat] = kernel_launches.get(cat, 0) + count
        busy += ms
    bf.max_inflight = 2
    check = _batch_vs_single(bf, params, targets, precision)
    checks["vs_single_and_partial"] = not check["failed"]
    if precision == "fp32":
        check["stages"] = _batch_stages(bf, targets)
        checks["stages_per_target"] = not check["stages"]["failed"]
    bf.close()
    log.close()
    checks["no_batch_error"] = not any(e in ("batch_error", "target_error") for e in events)
    # model FLOPs of the run: each target at its bucket's shape
    flops = sum(fold_flops(*bucket_shape(*a.shape), ITERATIONS, MINSTEPS) for _, a in targets)
    peak, peak_name = MFU_PEAK[precision]
    emit({"phase": "batch", "precision": precision, "targets": len(targets),
          "batch_size": BATCH_SIZE, "buckets": [list(b) for b in BATCH_BUCKETS],
          "shapes": [list(a.shape) for _, a in targets], "iterations": ITERATIONS,
          "minsteps": MINSTEPS, "wall_s": walls[0], "wall_s_all": walls,
          "fold_flops": flops, "mfu_peak": peak_name, "mfu": mfu(flops, walls[0], peak),
          "targets_per_s": len(targets) / walls[0],
          "targets_per_s_all": [len(targets) / w for w in walls],
          "fold_many_async_return_s": dispatch_return_s,
          "per_batch_wall_s_inflight_1": per_bucket,
          "half_batch_wall_s": {f"{BATCH_BUCKETS[0][0]}x{BATCH_BUCKETS[0][1]}": half_batch_s},
          "inflight_1_wall_s": sum(per_bucket.values()),
          "launches": launches, "launches_per_batch": per_batch, "expected_per_batch": expected,
          "log_events": events, "host_syncs": host_syncs,
          "profile_one_batch": {"bucket": list(BATCH_BUCKETS[1]), "wall_ms": prof_wall_ms,
                                "device_busy_ms": busy,
                                "idle_share": _idle_share(busy, prof_wall_ms),
                                "by_category_ms": dict(sorted(by_cat.items(),
                                                              key=lambda kv: -kv[1])),
                                "launches_by_category": kernel_launches},
          "check": check, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{precision} batch checks failed: {failed}; {check['failed']}")
    return launches


# ---------------------------------------------------------------- strict and evaluate
#
# Phase strict: the fidelity engine fp32_strict (the fp32 engine with the LU
# DCA inverse and the raw eigenvector signs of eigh) at full width: the main
# path's fold through phase_fold, the LU DCA and the raw signs held on the
# card, the batch engine at B 8 in fp32_strict, and exact shapes
# (use_buckets=False) in fp32 and bf16. Phase evaluate: train/evaluate.py on
# eight seeded validation targets in bf16 and in fp32_strict.

DCA_CARD_VS_CPU = 1e-4   # LU features, card vs CPU, of max |ref|
DCA_LU_VS_CHOL = 1e-5    # LU vs Cholesky features on the card, of max |ref|
STRICT_CONF_TOL = FP32_FOLD_TOLS["max_abs_conf"]
STRICT_CA_TOL = FP32_FOLD_TOLS["max_abs_ca"]


@contextlib.contextmanager
def _mds_calls(store: list):
    """Record (dm, nres, canonical_signs, output) of every MDS call the
    inference forward makes."""
    from dmpfold2_tpu_torch.models import gruresnet

    orig = gruresnet.mds_coords

    def recording(dm, nres, n_dims=8, canonical_signs=True, **kw):
        out = orig(dm, nres, n_dims, canonical_signs=canonical_signs, **kw)
        store.append((dm.clone(), nres.clone(), canonical_signs, out.clone()))
        return out

    gruresnet.mds_coords = recording
    try:
        yield
    finally:
        gruresnet.mds_coords = orig


def _strict_dca() -> dict:
    """PF10963's DCA features at its bucket (256 x 88): LU on the card against
    LU on the CPU, and against Cholesky on the card, with the times of both
    inverses on the card (CUDA events)."""
    from dmpfold2_tpu_torch.engine.fold import pad_target
    from dmpfold2_tpu_torch.features import dca, msa
    from dmpfold2_tpu_torch.utils.aln import parse_aln

    aln_p, _ = pad_target(parse_aln(EXAMPLE_ALN), None, N_PAD, L_PAD)
    out = {}
    for dev in ("cpu", "cuda"):
        oh = msa.msa_one_hot(torch.from_numpy(aln_p).to(dev), NSEQS, NRES)
        w = msa.reweight(oh, NRES)
        out[dev] = {m: dca.fast_dca(oh, w, NSEQS, NRES, method=m) for m in ("lu", "cholesky")}
        if dev == "cuda":
            ms = {m: time_ms(lambda m=m: dca.fast_dca(oh, w, NSEQS, NRES, method=m), reps=10)
                  for m in ("lu", "cholesky")}
    ref = out["cpu"]["lu"]
    scale = ref.abs().max().item()
    lu_gpu = out["cuda"]["lu"].cpu()
    row = {"shape": [N_PAD, L_PAD], "n": 21 * L_PAD, "scale": scale,
           "lu_card_vs_cpu": (lu_gpu - ref).abs().max().item() / scale,
           "lu_vs_cholesky_card": (lu_gpu - out["cuda"]["cholesky"].cpu()).abs().max().item()
           / scale,
           "lu_cholesky_cpu": (ref - out["cpu"]["cholesky"]).abs().max().item() / scale,
           "tols": {"lu_card_vs_cpu": DCA_CARD_VS_CPU, "lu_vs_cholesky_card": DCA_LU_VS_CHOL},
           "fast_dca_ms": ms}
    row["failed"] = [k for k, tol in row["tols"].items() if not row[k] <= tol]
    return row


def _raw_sign_checks(params) -> dict:
    """A strict fold at -n 0 -m 0 on the card and on the CPU: confidences
    within STRICT_CONF_TOL (read before MDS, so the signs do not enter); the
    card's MDS output the same bits as eigh's own top-8 columns of the same
    Gram matrix (the raw-sign wiring); the columns whose raw sign differs
    between the card and the CPU on the card's distance map, recorded (cuSOLVER
    and LAPACK may choose either sign)."""
    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.config import FoldConfig
    from dmpfold2_tpu_torch.models.geometry import mds_coords, mds_gram

    kw = dict(params=params, iterations=0, minsteps=0, config=FoldConfig(precision="fp32_strict"))
    calls: list = []
    with _mds_calls(calls):
        c_gpu, f_gpu = aln_to_coords(EXAMPLE_ALN, device="cuda", **kw)
    _, f_cpu = aln_to_coords(EXAMPLE_ALN, device="cpu", **kw)
    dm, nres, canonical, out = calls[0]
    w, v = torch.linalg.eigh(mds_gram(dm, nres))  # the same Gram matrix, eigh alone
    eigh_cols = v[..., -8:] * torch.sqrt(w[..., -8:].clamp(min=1e-8))[..., None, :]
    cpu_out = mds_coords(dm.cpu(), nres.cpu(), canonical_signs=False)
    dots = (out.cpu() * cpu_out).sum(dim=-2)[0]
    row = {"mds_calls": len(calls), "canonical_signs": [c for _, _, c, _ in calls],
           "max_abs_conf": float(np.abs(f_gpu - f_cpu).max()), "conf_tol": STRICT_CONF_TOL,
           "v8_equals_eigh_columns": bool(torch.equal(out, eigh_cols)),
           "card_vs_cpu_flipped_columns": int((dots < 0).sum()),
           "card_vs_cpu_abs_max": (out.cpu().abs() - cpu_out.abs()).abs().max().item(),
           "finite": bool(np.isfinite(c_gpu).all())}
    row["failed"] = [k for k, ok in (("calls", row["canonical_signs"] == [False]),
                                     ("conf", row["max_abs_conf"] <= STRICT_CONF_TOL),
                                     ("v8", row["v8_equals_eigh_columns"]),
                                     ("finite", row["finite"])) if not ok]
    return row


def _strict_batch(params) -> dict:
    """BatchFolder at B 8 in fp32_strict on phase batch's eight 256 x 88
    targets: at -n 10 -m 100, every MDS call's raw output for each target the
    same bits as the same map alone (eigh at B 1), so a target's signs do not
    depend on its batchmates; launches per batch the fp32 fold's; at -n 0 -m
    0 each target's confidences within STRICT_CONF_TOL of its single fold."""
    from dmpfold2_tpu_torch.engine.buckets import bucket_shape
    from dmpfold2_tpu_torch.models.geometry import mds_coords
    from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target

    targets = [(n, a) for n, a in _batch_targets() if bucket_shape(*a.shape) == BATCH_BUCKETS[0]]
    tgts = [Target(a) for _, a in targets]
    bf = BatchFolder(params, device="cuda", batch_size=BATCH_SIZE, precision="fp32_strict")
    events: list = []
    with _logged_events(events):
        bf.fold_many(tgts, ITERATIONS, MINSTEPS)  # warm-up
        calls: list = []
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _mds_calls(calls):
            results = bf.fold_many(tgts, ITERATIONS, MINSTEPS)
        wall = time.perf_counter() - t0
        launches = _read_counters()
        same, checked = True, 0
        for dm, nres, canonical, out in calls:
            for b in range(dm.shape[0]):
                alone = mds_coords(dm[b:b + 1], nres[b:b + 1], canonical_signs=False)[0]
                same &= bool(torch.equal(out[b], alone)) and not canonical
                checked += 1
        quick = bf.fold_many(tgts, 0, 0)
        conf = [float(np.abs(fb - bf.folder.fold(a, iterations=0, minsteps=0)[1]).max())
                for (_, a), (_, fb) in zip(targets, quick)]
    bf.close()
    flops = sum(fold_flops(*BATCH_BUCKETS[0], ITERATIONS, MINSTEPS) for _ in targets)
    row = {"targets": [n for n, _ in targets], "batch_size": BATCH_SIZE,
           "bucket": list(BATCH_BUCKETS[0]), "wall_s": wall, "targets_per_s": len(tgts) / wall,
           "fold_flops": flops, "mfu_peak": MFU_PEAK["fp32_strict"][1],
           "mfu": mfu(flops, wall, PEAK_FP32_FLOPS),
           "launches": launches, "mds_calls": len(calls), "maps_checked": checked,
           "raw_v8_batch_equals_b1": same, "max_abs_conf_vs_single": max(conf),
           "conf_tol": STRICT_CONF_TOL, "log_events": events}
    row["failed"] = [k for k, ok in (
        ("raw v8 B 8 vs B 1", same and checked == len(targets) * (ITERATIONS + 1)),
        ("launches", launches == EXPECTED_LAUNCHES["fp32_strict"]),
        ("all folded", all(r is not None for r in results)),
        ("no batch error", not any(e in ("batch_error", "target_error") for e in events)),
        ("conf vs single", max(conf) <= STRICT_CONF_TOL)) if not ok]
    return row


def _exact_shapes(params) -> list:
    """PF10963 folded at its exact shape (252 x 82, use_buckets=False) and at
    its bucket (256 x 88), -n 0 -m 0, on the card: fp32 confidences within
    5e-4 and the CA trace within 1e-2 A on the valid region; bf16 within
    phase cpu_bf16's bounds (confidences 0.025, the trunk's distance-map
    and confidence channels 17 x 2^-8 of their scale). The kernels run at
    L 82, which is no bucket width; one that could not would raise up front."""
    from dmpfold2_tpu_torch.engine.fold import Folder
    from dmpfold2_tpu_torch.utils.aln import parse_aln

    alnmat = parse_aln(EXAMPLE_ALN)
    rows = []
    for precision in ("fp32", "bf16"):
        out, store = {}, []
        for exact in (True, False):
            folder = Folder(params, device="cuda", precision=precision, use_buckets=not exact)
            _reset_counters()
            with _trunk_outputs(store) if precision == "bf16" else contextlib.nullcontext():
                out[exact] = folder.fold(alnmat, iterations=0, minsteps=0)
            if exact:
                launches = _read_counters()
            del folder
        (ce, fe), (cb, fb) = out[True], out[False]
        row = {"precision": precision, "exact_shape": [NSEQS, NRES], "bucket": [N_PAD, L_PAD],
               "launches_exact": launches,
               "max_abs_conf": float(np.abs(fe - fb).max()),
               "max_abs_ca": float(np.abs(ce[:, 1] - cb[:, 1]).max())}
        if precision == "fp32":
            tols = {"max_abs_conf": STRICT_CONF_TOL, "max_abs_ca": STRICT_CA_TOL}
        else:
            tols = {"max_abs_conf": CONF_BF16_TOL}
            (_, o_exact, _), (_, o_bucket, _) = store
            for ch, label in ((0, "dmap"), (1, "conf")):
                ref = o_bucket[0, :NRES, :NRES, ch]
                scale = ref.abs().max().item()
                row[f"max_abs_{label}_channel"] = (o_exact[0, ..., ch] - ref).abs().max().item()
                row[f"{label}_channel_scale"] = scale
                tols[f"max_abs_{label}_channel"] = TRUNK_BF16_REL * scale
        row["tols"] = tols
        row["failed"] = [k for k, tol in tols.items() if not row[k] <= tol]
        rows.append(row)
    return rows


def phase_strict(params) -> dict:
    """The fidelity engine on the card. Returns the strict fold's launches."""
    launches, _ = phase_fold(params, "fp32_strict")
    dca_row = _strict_dca()
    signs = _raw_sign_checks(params)
    batch = _strict_batch(params)
    exact = _exact_shapes(params)
    failed = ([f"dca {k}" for k in dca_row["failed"]] + [f"signs {k}" for k in signs["failed"]]
              + [f"batch {k}" for k in batch["failed"]]
              + [f"exact {r['precision']} {k}" for r in exact for k in r["failed"]])
    emit({"phase": "strict", "dca": dca_row, "raw_signs": signs, "batch": batch,
          "exact_shapes": exact, "failed": failed})
    if failed:
        raise AssertionError(f"strict checks failed: {failed}")
    return {"fold": launches, "batch": batch["launches"]}


# phase evaluate: eight seeded validation targets in two buckets, (nseqs, nres)
EVAL_SHAPES = ((200, 82), (150, 85), (120, 88), (252, 84),
               (180, 245), (140, 250), (256, 241), (160, 256))


def _write_eval_data(root: str, rng) -> None:
    """tdb/ and aln/ files of EVAL_SHAPES (a random-walk target and a seeded
    alignment each) and ``clusters.lst``, one cluster per target, so all are
    validation clusters."""
    os.makedirs(os.path.join(root, "tdb"))
    os.makedirs(os.path.join(root, "aln"))
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV-"))
    for i, (nseqs, nres) in enumerate(EVAL_SHAPES):
        _write_tdb(os.path.join(root, "tdb", f"val{i}.tdb"), _chain(nres, rng))
        rows = ["".join(r) for r in letters[rng.integers(0, 21, (nseqs, nres))]]
        with open(os.path.join(root, "aln", f"val{i}.aln"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "clusters.lst"), "w") as fh:
        fh.write("".join(f"val{i}\n" for i in range(len(EVAL_SHAPES))))


def phase_evaluate(params, data_dir: str) -> dict:
    """train/evaluate.py on the card, batch 8, -n 10 -m 100, in bf16 and in
    fp32_strict: every target folded and scored, and every record's tm and
    rmsd equal to score.tm_score recomputed on the CA trace the batch engine
    returned (the same numpy code: exact). With random weights TM itself
    means nothing; targets/s is recorded. Returns each engine's launches."""
    from dmpfold2_tpu_torch.parallel import stream
    from dmpfold2_tpu_torch.score import tm_score
    from dmpfold2_tpu_torch.train.dataset import DMPDataset, load_cluster_list
    from dmpfold2_tpu_torch.train.evaluate import evaluate

    _, val_list = load_cluster_list(os.path.join(data_dir, "clusters.lst"))
    natives = DMPDataset(val_list, data_dir, augment=False)
    real = stream.BatchFolder.fold_many
    launches, rows, failed = {}, [], []
    for precision in ("bf16", "fp32_strict"):
        folds: list = []

        def recording(self, targets, *a, **kw):
            results = real(self, targets, *a, **kw)
            folds.extend(results)
            return results

        stream.BatchFolder.fold_many = recording
        try:
            # no warm-up run: phase batch ran these buckets at this batch size
            # in fp32 and bf16 (fp32_strict runs the fp32 engine's kernels)
            _reset_counters()
            summary, records = evaluate(params, val_list, data_dir=data_dir,
                                        iterations=ITERATIONS, minsteps=MINSTEPS,
                                        precision=precision, batch_size=BATCH_SIZE,
                                        verbose=False, device="cuda")
            launches[precision] = _read_counters()
        finally:
            stream.BatchFolder.fold_many = real
        exact = 0
        for rec in records:
            coords = folds[rec["index"]][0]
            sc = tm_score(np.asarray(coords[:, 1], np.float64),
                          np.asarray(natives[rec["index"]].targets[:, 1], np.float64))
            exact += (rec["tm"], rec["rmsd"]) == (sc["tm"], sc["rmsd"])
        row = {"precision": precision, "summary": summary, "records": records,
               "records_equal_tm_score": exact}
        rows.append(row)
        print(json.dumps(summary), flush=True)
        if not (summary["targets"] == len(EVAL_SHAPES) and summary["skipped"] == 0
                and exact == len(EVAL_SHAPES)):
            failed.append(precision)
    emit({"phase": "evaluate", "shapes": [list(s) for s in EVAL_SHAPES],
          "batch_size": BATCH_SIZE, "iterations": ITERATIONS, "minsteps": MINSTEPS,
          "note": "random weights: TM and RMSD are meaningless; held: every target scored, "
                  "every record equal to score.tm_score of its fold",
          "rows": rows, "launches": launches, "failed": failed})
    if failed:
        raise AssertionError(f"evaluate checks failed: {failed}")
    return launches


def _aln_text(alnmat) -> str:
    return "".join("".join(AA_TEXT[c] for c in row) + "\n" for row in alnmat)


def phase_serve(params) -> dict:
    """A bf16 FoldService on the card: 16 concurrent clients post PF10963 at
    the defaults (half as text, half as JSON), then 16 more post phase
    batch's mixed shapes; every response must be a whole PDB, requests must
    coalesce. Returns the launch counts of the two rounds."""
    import threading
    import urllib.request

    from dmpfold2_tpu_torch.serve import serve

    targets = _batch_targets()
    server = serve(params, host="127.0.0.1", port=0, precision="bf16", device="cuda",
                   max_batch=BATCH_SIZE)
    service = server.fold_service
    t0 = time.perf_counter()
    service.warmup(shapes=((N_PAD, L_PAD),))
    warmup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    query = f"iterations={ITERATIONS}&minsteps={MINSTEPS}"

    def post(body: bytes, json_form: bool):
        headers = {"Content-Type": "application/json"} if json_form else {}
        req = urllib.request.Request(f"{url}/fold?{query}", data=body, method="POST",
                                     headers=headers)
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read().decode(), time.perf_counter() - t

    def round_of(bodies):
        out = [None] * len(bodies)

        def client(i):
            try:
                out[i] = post(*bodies[i])
            except Exception as exc:  # noqa: BLE001 - reported in the checks
                out[i] = (None, repr(exc), None)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        del groups[:]
        t = t_round[0] = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t
        lat = sorted(r[2] for r in out if r[2] is not None)
        return out, {"requests": len(bodies), "wall_s": wall, "req_per_s": len(bodies) / wall,
                     "p50_s": float(np.percentile(lat, 50)) if lat else None,
                     "p95_s": float(np.percentile(lat, 95)) if lat else None,
                     "groups": [dict(g) for g in groups]}

    # each group the dispatcher launches: its size, when it was launched and
    # finished (seconds from the start of its round), and how long the
    # launch held the dispatcher thread
    groups, t_round = [], [0.0]
    launch_group = service._launch_group

    def recording(iterations, minsteps, reqs):
        t = time.perf_counter()
        fin = launch_group(iterations, minsteps, reqs)
        row = {"size": len(reqs), "launched_s": t - t_round[0],
               "launch_held_s": time.perf_counter() - t}
        groups.append(row)
        if fin is None:
            return None

        def finish():
            fin()
            row["finished_s"] = time.perf_counter() - t_round[0]

        return finish

    service._launch_group = recording
    pf_text = _aln_text(targets[0][1])
    rounds, checks = {}, {}
    _reset_counters()
    def body(text: str, i: int):
        """Request i: text for even i, the JSON form for odd i."""
        if i % 2:
            return json.dumps({"aln": text}).encode(), True
        return text.encode(), False

    same = [body(pf_text, i) for i in range(SERVE_CLIENTS)]
    out, rounds["PF10963 x 16"] = round_of(same)
    checks["PF10963 all 200"] = all(r[0] == 200 for r in out)
    checks["PF10963 406 ATOM lines"] = all(
        r[0] == 200 and sum(line.startswith("ATOM") for line in r[1].splitlines()) == 406
        for r in out)
    mixed = [body(_aln_text(a), i) for i, (_, a) in enumerate(targets)]
    out, rounds["mixed x 16"] = round_of(mixed)
    launches = _read_counters()
    checks["mixed all 200"] = all(r[0] == 200 for r in out)
    checks["mixed whole PDBs"] = all(
        r[0] == 200 and sum(line.startswith("ATOM") for line in r[1].splitlines()) == _n_atoms(a)
        for r, (_, a) in zip(out, targets))
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
        checks["healthz"] = resp.status == 200
    with urllib.request.urlopen(f"{url}/stats", timeout=60) as resp:
        stats = json.loads(resp.read())
    batching = stats["batching"]
    checks["coalesced"] = batching["max_coalesced"] >= 2
    checks["fewer_dispatches_than_requests"] = batching["dispatches"] < batching["requests"]
    checks["launched_every_inference_kernel"] = all(
        launches[k] > 0 for k in ("vgru", "rgru", "refine", "conv5x5_maxout", "gemm_maxout",
                                  "block_tail"))
    server.shutdown()
    service.close()
    server.server_close()
    thread.join(timeout=60)
    service._thread.join(timeout=60)
    service._finish_thread.join(timeout=60)
    service.batcher.close()
    checks["closed"] = not (thread.is_alive() or service._thread.is_alive()
                            or service._finish_thread.is_alive())
    emit({"phase": "serve", "precision": "bf16", "max_batch": BATCH_SIZE, "warmup_s": warmup_s,
          "rounds": rounds, "stats": stats, "launches": launches,
          "errors": [r[1][:200] for r in out if r[0] != 200], "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")
    return launches


# ---------------------------------------------------------------- multi
#
# Phase multi: several devices and processes on the one card. (a) the batch
# engine over make_mesh() (every visible card) against the mesh-less one,
# the same bits; (b) a mesh of two replicas on cuda:0 (B 8 split 4 + 4, each
# shard on its own thread and stream): the same bits per target as (a), or
# else phase cpu's bf16 bound on the confidences at -n 0 -m 0, recorded;
# (c) the service over that mesh; (d) two processes on cuda:0 over gloo (NCCL
# refuses two ranks on one GPU), DDP train_steps on two "pf"-like samples
# (micro-batch 2 split 1 + 1); (e) an NCCL group of one process, whose step is
# the plain step's bits.
#
# (d)'s references. A rank runs each sample at B 1 and the single-process
# step runs both at B 2; cuBLAS picks its GEMM kernels by the rows (B x L), so
# the two differ in the order of fp32 sums, and the random model's collapsed
# trace amplifies that in the gradient: measured on one H100, gradient
# cosines of 0.9974-0.99993 (fp32) and 0.41-0.65 (bf16) between the B 2 step
# and the same step taken as B 1 + B 1 in one process, losses 3.6e-6 and
# 4.8e-5 apart, and one fp32 ulp in every weight moves the B 2 step's
# gradient as far (scripts/ddp_batch_witness.py). So each step is held
# against that same arithmetic in one process, each sample at B 1 at its
# global slot and the gradients summed as the all-reduce sums them ("shard
# program"); against the B 2 step by the fp32 losses, and by the gradient
# cosine on the "spread" model (the coordinate head scaled by HEAD_SCALE, as
# phase train), whose gradient the rounding floor moves less (0.999993 for
# one ulp); the rest is recorded.
MULTI_ITERATIONS, MULTI_MINSTEPS = 1, MINSTEPS // 10
DDP_SEED = 21
DDP_LOSS_RTOL = 1e-5     # each sample's loss against its reference
DDP_GRAD_COS = 0.9999    # per top-level parameter group, before the update
DDP_TIMEOUT_S = 600
# (precision, nloops, refine_steps, model): the held steps, then the deeper one
DDP_STEPS = (("bf16", 0, 0, "random"), ("fp32", 0, 0, "random"), ("fp32", 0, 0, "spread"),
             ("bf16", 3, 10, "random"))


def _ddp_batch(data_dir: str):
    """The two samples ("pf" and "pf2": PF10963's alignment, two seeded
    82-residue targets) as one micro-batch."""
    from dmpfold2_tpu_torch.train.dataset import DMPDataset, pad_to_bucket
    from dmpfold2_tpu_torch.train.step import TrainBatch

    dataset = DMPDataset([["pf"], ["pf2"]], data_dir, augment=False)
    return TrainBatch(*pad_to_bucket([dataset[0], dataset[1]]))


def _write_ddp_data(root: str, rng) -> None:
    os.makedirs(os.path.join(root, "tdb"))
    os.makedirs(os.path.join(root, "aln"))
    for name in ("pf", "pf2"):
        with open(EXAMPLE_ALN) as src, open(os.path.join(root, "aln", f"{name}.aln"), "w") as dst:
            dst.write(src.read())
        _write_tdb(os.path.join(root, "tdb", f"{name}.tdb"), _chain(NRES, rng))


def _by_group(weights, grads) -> dict:
    """Gradients in ``leaves`` order, flattened per top-level group, on the CPU."""
    from dmpfold2_tpu_torch.train.step import leaves

    out, k = {}, 0
    for name in sorted(weights):  # leaves() walks the top-level groups in this order
        n = len(leaves(weights[name]))
        out[name] = torch.cat([g.detach().float().cpu().reshape(-1) for g in grads[k:k + n]])
        k += n
    return out


def _ddp_steps(params, batch, device, mesh=None, steps=DDP_STEPS) -> list:
    """Each of ``steps`` from fresh weights and optimizer on ``batch`` (this
    rank's shard under a mesh): metrics, the gradient Adam was handed (after
    the all-reduce) per top-level group, a hash of the parameters after the
    update, the launch counts and the wall."""
    import hashlib

    from dmpfold2_tpu_torch.train import step

    out = []
    for precision, nloops, refine_steps, model in steps:
        weights = step.trainable(params, device)
        if model == "spread":
            with torch.no_grad():
                weights["coord_fc"].mul_(HEAD_SCALE)
        optimizer = step.make_optimizer(weights, 1e-4)
        handed, real = [], step.Optimizer.update

        def update(self, g, handed=handed, real=real):
            handed.append(list(g))
            return real(self, g)

        step.Optimizer.update = update
        try:
            _reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step.train_step(weights, optimizer, batch, DDP_SEED, nloops=nloops,
                                      refine_steps=refine_steps, precision=precision, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_counters()
        finally:
            step.Optimizer.update = real
        digest = hashlib.sha256()
        for p in step.leaves(weights):
            digest.update(p.detach().cpu().numpy().tobytes())
        out.append({"precision": precision, "nloops": nloops, "refine_steps": refine_steps,
                    "model": model, "metrics": metrics, "grads": _by_group(weights, handed[0]),
                    "params_sha256": digest.hexdigest(), "launches": launches, "wall_s": wall})
        del weights, optimizer, handed
    return out


def _shard_program(params, batch, device, precision: str, nloops: int, refine_steps: int,
                   model: str):
    """A DDP step's arithmetic in one process: each sample alone (B 1) at its
    global slot of the micro-batch, as its rank runs it (train_step's draws,
    dropout seed and remat tier), the gradients summed as the all-reduce sums
    them -> (sample losses, gradient per top-level group)."""
    from dmpfold2_tpu_torch.ops.dropout import fold_in
    from dmpfold2_tpu_torch.train import step

    weights = step.trainable(params, device)
    if model == "spread":
        with torch.no_grad():
            weights["coord_fc"].mul_(HEAD_SCALE)
    params_l = step.leaves(weights)
    total, l_pad = batch.alnmat.shape[0], batch.alnmat.shape[2]
    losses, grads = [], None
    for i in range(total):
        loss, metrics = step.batch_loss_native(
            weights, torch.from_numpy(batch.alnmat[i:i + 1]).to(device),
            torch.from_numpy(batch.targets[i:i + 1]).to(device), batch.nseqs[i:i + 1],
            batch.nres[i:i + 1], [step.draw_prep(fold_in(DDP_SEED, i), l_pad)], nloops=nloops,
            refine_steps=refine_steps, dropout_seed=fold_in(fold_in(DDP_SEED, 0), 2),
            precision=precision, remat=step.resolve_remat(weights, 1, l_pad, nloops,
                                                          precision == "bf16"),
            slot_offset=i, global_batch=total)
        g = torch.autograd.grad(loss, params_l, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(params_l, g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        losses += metrics["sample_loss"].tolist()
    return losses, _by_group(weights, grads)


def _ddp_worker(rank: int, port: int, data_dir: str, out_dir: str) -> None:
    """One of two ranks on cuda:0 (``chip_smoke.py --ddp-rank K PORT DATA OUT``)."""
    from dmpfold2_tpu_torch.models.gruresnet import init_params
    from dmpfold2_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    device = initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cuda:0",
                                    backend="gloo")
    mesh = make_mesh()
    batch = _ddp_batch(data_dir)
    shard = type(batch)(*(a[rank:rank + 1] for a in batch))
    steps = _ddp_steps(init_params(seed=0, width=WIDTH, cwidth=CWIDTH, num_blocks=BLOCKS),
                       shard, device, mesh)
    if rank == 0:  # both ranks hold the same reduced gradient: one copy
        torch.save([s["grads"] for s in steps], os.path.join(out_dir, "grads.pt"))
    summary = [{k: v for k, v in s.items() if k != "grads"} for s in steps]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"mesh": mesh.shape, "steps": summary}, fh)


def _compare(ddp_loss, ddp_grads, ref_loss, ref_grads) -> dict:
    rel = [abs(a - b) / abs(b) for a, b in zip(ddp_loss, ref_loss)]
    cos = {name: _cosine(ddp_grads[name], g) for name, g in ref_grads.items()}
    return {"sample_loss": ref_loss, "loss_rel_diff": rel, "grad_cosine": cos,
            "losses_held": max(rel) <= DDP_LOSS_RTOL,
            "grads_held": min(cos.values()) >= DDP_GRAD_COS}


def _ddp_two_ranks(params, data_dir: str) -> dict:
    """(d): two processes on cuda:0 over gloo against one process."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.empty_cache()  # room for the two ranks beside this process
    with tempfile.TemporaryDirectory() as out_dir:
        logs = [open(os.path.join(out_dir, f"rank{k}.log"), "w+b") for k in (0, 1)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank", str(k),
                                   str(port), data_dir, out_dir], cwd=REPO, stdout=logs[k],
                                  stderr=subprocess.STDOUT) for k in (0, 1)]
        try:
            for p in procs:
                p.wait(timeout=DDP_TIMEOUT_S)
        finally:
            for p in procs:  # never leave a rank behind
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_wall = time.perf_counter() - t0
        for p, fh in zip(procs, logs):
            fh.seek(0)
            text = fh.read().decode(errors="replace")
            fh.close()
            if p.returncode != 0:
                raise AssertionError(f"DDP rank failed ({p.returncode}):\n{text[-4000:]}")
        ranks = [json.load(open(os.path.join(out_dir, f"rank{k}.json"))) for k in (0, 1)]
        ddp_grads = torch.load(os.path.join(out_dir, "grads.pt"))
    batch = _ddp_batch(data_dir)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    whole = _ddp_steps(params, batch, device)
    single_wall = time.perf_counter() - t0
    rows, checks = [], {}
    for k, (precision, nloops, refine_steps, model) in enumerate(DDP_STEPS):
        tag = f"{model} {precision} nloops {nloops} refine {refine_steps}"
        got = [r["steps"][k] for r in ranks]
        ddp_loss = [x for r in got for x in r["metrics"]["sample_loss"]]
        refs = {"whole batch": _compare(ddp_loss, ddp_grads[k],
                                        whole[k]["metrics"]["sample_loss"], whole[k]["grads"]),
                "shard program": _compare(ddp_loss, ddp_grads[k], *_shard_program(
                    params, batch, device, precision, nloops, refine_steps, model))}
        row = {"precision": precision, "nloops": nloops, "refine_steps": refine_steps,
               "model": model,
               "sample_loss_ddp": ddp_loss, "references": refs,
               "loss_ranks": [r["metrics"]["loss"] for r in got],
               "skipped": [r["metrics"]["skipped"] for r in got],
               "params_same_bits_across_ranks": got[0]["params_sha256"] == got[1]["params_sha256"],
               "launches_by_rank": [r["launches"] for r in got],
               "wall_s_by_rank": [r["wall_s"] for r in got], "whole_batch_wall_s": whole[k]["wall_s"]}
        rows.append(row)
        shard = refs["shard program"]
        checks[f"{tag}: losses and gradients vs the shard program"] = (
            shard["losses_held"] and shard["grads_held"])
        if (precision, nloops, model) == ("fp32", 0, "random"):
            checks[f"{tag}: losses vs the whole batch"] = refs["whole batch"]["losses_held"]
        if (precision, nloops, model) == ("fp32", 0, "spread"):
            checks[f"{tag}: gradients vs the whole batch"] = refs["whole batch"]["grads_held"]
        checks[f"{tag}: params same bits across ranks"] = row["params_same_bits_across_ranks"]
        checks[f"{tag}: not skipped"] = all(s == 0.0 for s in row["skipped"])
    checks["mesh 2 x 1 on each rank"] = all(r["mesh"] == {"data": 2, "seq": 1} for r in ranks)
    return {"rows": rows, "checks": checks, "ranks_wall_s": ranks_wall,
            "whole_batch_wall_s": single_wall,
            "launches": {"conv5x5_maxout_diff": sum(
                r["conv5x5_maxout_diff"] for r in rows[-1]["launches_by_rank"])},
            "loss_rtol": DDP_LOSS_RTOL, "grad_cosine_min": DDP_GRAD_COS}


def _nccl_group_of_one(params, data_dir: str) -> dict:
    """(e): the held DDP step in an NCCL group of one process against the plain
    step; cuDNN's deterministic algorithms, so that two plain steps agree."""
    import socket

    import torch.distributed as dist

    from dmpfold2_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    batch = _ddp_batch(data_dir)
    held = DDP_STEPS[:1]  # the held bf16 step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = _ddp_steps(params, batch, torch.device("cuda"), steps=held)[0]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda:0")
        init_s = time.perf_counter() - t0
        try:
            backend = dist.get_backend()
            grouped = _ddp_steps(params, batch, torch.device("cuda", 0), make_mesh(), held)[0]
        finally:
            dist.destroy_process_group()
        same = (grouped["params_sha256"] == plain["params_sha256"]
                and grouped["metrics"] == plain["metrics"])
        repeat_same = None
        if not same:  # is the plain step itself reproducible?
            repeat_same = _ddp_steps(params, batch, torch.device("cuda"), steps=held)[0][
                "params_sha256"] == plain["params_sha256"]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"backend": backend, "init_s": init_s, "same_bits_as_plain": same,
            "plain_repeat_same_bits": repeat_same, "loss_grouped": grouped["metrics"]["loss"],
            "loss_plain": plain["metrics"]["loss"], "wall_s": grouped["wall_s"],
            "plain_wall_s": plain["wall_s"]}


def phase_multi(params) -> dict:
    """Phase multi (a)-(e); returns the launch counts of its two new paths."""
    import threading
    import urllib.request

    from dmpfold2_tpu_torch.engine.buckets import bucket_shape
    from dmpfold2_tpu_torch.parallel.mesh import make_mesh
    from dmpfold2_tpu_torch.parallel.stream import BatchFolder, Target
    from dmpfold2_tpu_torch.serve import serve

    t_phase = time.perf_counter()
    targets = [(n, a) for n, a in _batch_targets() if bucket_shape(*a.shape) == BATCH_BUCKETS[0]]
    tgts = [Target(a) for _, a in targets]
    checks, walls = {}, {}
    events: list = []
    log = contextlib.ExitStack()
    log.enter_context(_logged_events(events))

    def run(bf, iterations=MULTI_ITERATIONS, minsteps=MULTI_MINSTEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bf.fold_many(tgts, iterations, minsteps)
        return out, time.perf_counter() - t0

    # (a) every visible card against no mesh: the same program on one card
    plain = BatchFolder(params, device="cuda", batch_size=BATCH_SIZE, precision="bf16")
    run(plain)  # warm-up
    want, walls["no_mesh_s"] = run(plain)
    mesh_all = make_mesh()
    every = BatchFolder(params, mesh=mesh_all, batch_size=BATCH_SIZE, precision="bf16")
    run(every)
    got_a, walls["mesh_all_s"] = run(every)
    same = lambda x, y: np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])  # noqa: E731
    checks["(a) make_mesh() same bits as no mesh"] = all(same(g, w) for g, w in zip(got_a, want))
    every.close()

    # (b) two replicas on cuda:0, B 8 split 4 + 4
    mesh2 = make_mesh(2, devices=["cuda:0", "cuda:0"])
    two = BatchFolder(params, mesh=mesh2, batch_size=BATCH_SIZE, precision="bf16")
    run(two)  # warm-up: B 4 shapes
    _reset_counters()
    got_b, walls["two_replicas_s"] = run(two)
    launches_b = _read_counters()
    same_b = [same(g, a) for g, a in zip(got_b, got_a)]
    diff_b = {"max_abs_conf": max(float(np.abs(g[1] - a[1]).max()) for g, a in zip(got_b, got_a)),
              "max_abs_ca": max(float(np.abs(g[0][:, 1] - a[0][:, 1]).max())
                                for g, a in zip(got_b, got_a))}
    held_b = None
    if not all(same_b):  # phase batch's bf16 bound, at -n 0 -m 0
        zero_b, _ = run(two, 0, 0)
        zero_a, _ = run(plain, 0, 0)
        held_b = max(float(np.abs(g[1] - a[1]).max()) for g, a in zip(zero_b, zero_a))
        checks["(b) confidences at -n 0 -m 0 within bf16 bound"] = held_b <= CONF_BF16_TOL
    passes = MULTI_ITERATIONS + 1  # one set of launches per shard (EXPECTED_LAUNCHES' rule)
    expected = {"vgru": 2, "rgru": 2 * (2 + 3 * passes), "refine": 2 * 2,
                "conv5x5_maxout": 2 * BLOCKS * passes, "gemm_maxout": 2 * passes,
                "conv5x5_maxout_diff": 0, "block_tail": 2 * BLOCKS * passes}
    checks["(b) launches: one set per shard"] = launches_b == expected
    for (name, alnmat), res in zip(targets, got_b):
        checks[f"(b) {name} whole"] = all(_fold_checks(res[0], res[1], alnmat).values())
    two.close()
    plain.close()

    # (c) the service over the two-replica mesh
    server = serve(params, host="127.0.0.1", port=0, precision="bf16", max_batch=BATCH_SIZE,
                   mesh=mesh2)
    service = server.fold_service
    t0 = time.perf_counter()
    service.warmup(shapes=((N_PAD, L_PAD),))
    walls["serve_warmup_s"] = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}/fold?iterations={ITERATIONS}"
           f"&minsteps={MINSTEPS}")
    body = _aln_text(targets[0][1]).encode()
    out = [None] * SERVE_CLIENTS

    def client(i):
        try:
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=600) as resp:
                out[i] = (resp.status, resp.read().decode())
        except Exception as exc:  # noqa: BLE001 - reported in the checks
            out[i] = (None, repr(exc))

    clients = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    walls["serve_16_s"] = time.perf_counter() - t0
    checks["(c) all 200"] = all(r is not None and r[0] == 200 for r in out)
    checks["(c) 406 ATOM lines"] = all(
        r is not None and r[0] == 200
        and sum(line.startswith("ATOM") for line in r[1].splitlines()) == 406 for r in out)
    serve_stats = dict(service.batch_stats)
    server.shutdown()
    service.close()
    server.server_close()
    thread.join(timeout=60)
    service.batcher.close()
    log.close()
    checks["no batch_error"] = not any(e in ("batch_error", "target_error") for e in events)

    # (d) and (e)
    with tempfile.TemporaryDirectory() as data_dir:
        _write_ddp_data(data_dir, np.random.default_rng(5))
        t0 = time.perf_counter()
        ddp = _ddp_two_ranks(params, data_dir)
        walls["ddp_s"] = time.perf_counter() - t0
        checks.update({f"(d) {k}": v for k, v in ddp["checks"].items()})
        t0 = time.perf_counter()
        nccl = _nccl_group_of_one(params, data_dir)
        walls["nccl_one_s"] = time.perf_counter() - t0
        checks["(e) NCCL group of one: same bits as the plain step"] = (
            nccl["backend"] == "nccl" and nccl["same_bits_as_plain"])
    walls["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "multi", "precision": "bf16", "targets": len(tgts), "batch_size": BATCH_SIZE,
          "iterations": MULTI_ITERATIONS, "minsteps": MULTI_MINSTEPS,
          "mesh_all": mesh_all.shape, "mesh_two_replicas": mesh2.shape,
          "targets_per_s": {"no_mesh": len(tgts) / walls["no_mesh_s"],
                            "mesh_all": len(tgts) / walls["mesh_all_s"],
                            "two_replicas": len(tgts) / walls["two_replicas_s"]},
          "two_replicas_same_bits": same_b, "two_replicas_diff": diff_b,
          "two_replicas_conf_n0_m0": held_b, "launches_two_replicas": launches_b,
          "serve": {"requests": SERVE_CLIENTS, "req_per_s": SERVE_CLIENTS / walls["serve_16_s"],
                    "batching": serve_stats, "errors": [r[1][:200] for r in out
                                                        if r is None or r[0] != 200]},
          "ddp": {k: v for k, v in ddp.items() if k != "checks"}, "nccl_one": nccl,
          "walls_s": walls, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"multi checks failed: {failed}")
    return {"batch bf16 mesh": launches_b, "train bf16 ddp": ddp["launches"]}


# ---------------------------------------------------------------- seq
#
# Phase seq: residue-axis sharding on the one card, over make_mesh(1, n,
# devices=["cuda:0"] * n): n seq shards on one device run the same code as n
# cards, each cross-device copy a copy on the card. (a) the kernels' slab
# forms (conv stats and argmax, the GEMM) at B 1 and B 8, L 256 split 128 +
# 128 and 96 + 96 + 64: each shard against its plain version (one bf16 ulp,
# stats rtol 1e-4), and the shards joined against the square kernel: the
# same bits in the rows, the index and the partials; then each slab form's
# time at B 1 on the first of two shards (a 132 x 256 slab). (b) the bf16
# fold of PF10963 at -n 10 -m 100 sharded 48 + 40 against unsharded: the 16
# block outputs of the first pass the same bits (the shards' partials are
# summed in the unsharded tile order) and that pass's trunk output within
# 1e-5 of each channel's scale, the fold the same bits or else its
# confidences at -n 0 -m 0 within phase cpu's bf16 bound (recycling and
# refinement amplify the head's rounding-level differences; the -n 10 -m 100
# differences are recorded), wall times of 3 folds each (after a warm-up),
# and launches of the two trunk kernels twice the unsharded fold's (path
# "fold bf16 seq"). (c) fp32 and fp32_strict at -n 0 -m 0: confidences 5e-4,
# CA 1e-2 A. (d) one seeded 64 x 1024 target in bf16 at -n 1 -m 10 as (b),
# timed likewise. (e) train_step on "pf" (nloops 0, refine
# 0) on the 1 x 2 mesh against the unsharded step: the fp32 losses within
# 1e-5 relative and, on the "spread" model, the gradient cosine >= 0.9999 per
# top-level group; bf16 loss within 1e-3 relative, its cosines recorded (path
# "train bf16 seq"). (f) serve over the 1 x 2 mesh: 4 concurrent PF10963
# requests, each a whole PDB.
SEQ_KERNEL_L = 256
SEQ_SPLITS = (2, 3)
SEQ_KERNEL_BATCHES = (1, 8)
SEQ_LONG = (64, 1024)          # (d): one seeded (nseqs, nres) target
SEQ_LONG_RUN = (1, 10)         # its (iterations, minsteps)
SEQ_WALL_REPEATS = 3
SEQ_TRUNK_REL = 1e-5           # (b), (d): the trunk output, its blocks the same bits
SEQ_FP32_TOLS = {"max_abs_conf": 5e-4, "max_abs_ca": 1e-2}
SEQ_SERVE_REQUESTS = 4
SEQ_TRAIN_STEPS = (("fp32", 0, 0, "spread"), ("fp32", 0, 0, "random"), ("bf16", 0, 0, "random"))
SEQ_TRAIN_LOSS_RTOL = {"fp32": 1e-5, "bf16": 1e-3}


def _seq_mesh(n: int):
    from dmpfold2_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(1, n, devices=["cuda:0"] * n)


def _seq_kernels(params, rng) -> tuple[list, dict]:
    """Phase seq (a): the slab forms against their plain versions and the
    square kernel; returns the cases and each slab form's timing row."""
    import torch.nn.functional as F

    from dmpfold2_tpu_torch.kernels import conv_block
    from dmpfold2_tpu_torch.parallel.sharding import SeqShards, exchange_halo, scatter_rows

    dev = torch.device("cuda")
    conv_w, conv_b, gemm_w, gemm_b, k_pad = _packed_trunk_weights(params, dev)
    l_pad = SEQ_KERNEL_L

    def inputs(batch, c_in, width):
        nres = [l_pad - 6] if batch == 1 else [l_pad - 23 * i for i in range(batch)]
        valid = (torch.arange(l_pad)[None, :] < torch.tensor(nres)[:, None]).float()
        x = torch.zeros((batch, l_pad, l_pad, width))
        x[..., :c_in] = (torch.from_numpy(rng.normal(size=(batch, l_pad, l_pad, c_in))
                                          .astype(np.float32))
                         * valid[:, :, None, None] * valid[:, None, :, None])
        return x.to(torch.bfloat16).to(dev), torch.tensor(nres, dtype=torch.int32, device=dev)

    def ulps(got, want):
        d = (got.float() - want.float()).abs()
        return (d / (BF16_ULP * want.float().abs().clamp(min=1.0))).max().item(), d.max().item()

    def stats_rel(partial, plain_partial):
        s, r = partial.sum(dim=1), plain_partial.sum(dim=1)
        return ((s - r).abs() / r.abs().clamp(min=1e-30)).max().item()

    cases = []
    for batch in SEQ_KERNEL_BATCHES:
        xc, nr = inputs(batch, CWIDTH, CWIDTH)
        xg, _ = inputs(batch, GEMM_K_IN, k_pad)
        sq_conv = conv_block.conv5x5_maxout_partials(xc, conv_w, conv_b, nr)
        sq_arg = conv_block.conv5x5_maxout_argmax(xc, conv_w, conv_b)
        sq_gemm = conv_block.gemm_maxout_partials(xg, gemm_w, gemm_b, nr)
        for n in SEQ_SPLITS:
            seq = SeqShards.split([dev] * n, l_pad)
            r0s = seq.bounds[:-1]
            slabs = exchange_halo(scatter_rows(seq, xc), conv_block.HALO)
            rows = [r.contiguous() for r in scatter_rows(seq, xg)]
            tag = f"B={batch} L={l_pad} split {[r1 - r0 for r0, r1 in zip(seq.bounds, seq.bounds[1:])]}"
            for kind in ("conv5x5_maxout", "conv5x5_maxout_argmax", "gemm_maxout"):
                worst_ulp, worst_abs, worst_rel, idx_agree = 0.0, 0.0, 0.0, 1.0
                got = []
                for k, r0 in enumerate(r0s):
                    if kind == "conv5x5_maxout":
                        out = conv_block.conv5x5_maxout_partials(slabs[k], conv_w, conv_b, nr, r0,
                                                                 slab=True)
                        ref = conv_block.conv5x5_maxout_partials_plain(slabs[k], conv_w, conv_b,
                                                                       nr, r0, slab=True)
                        worst_rel = max(worst_rel, stats_rel(out[1], ref[1]))
                    elif kind == "gemm_maxout":
                        out = conv_block.gemm_maxout_partials(rows[k], gemm_w, gemm_b, nr, r0)
                        ref = conv_block.gemm_maxout_partials_plain(rows[k], gemm_w, gemm_b,
                                                                    nr, r0)
                        worst_rel = max(worst_rel, stats_rel(out[1], ref[1]))
                    else:
                        out = conv_block.conv5x5_maxout_argmax(slabs[k], conv_w, conv_b,
                                                               slab=True)
                        ref = conv_block.conv5x5_maxout_argmax_plain(slabs[k], conv_w, conv_b,
                                                                     slab=True)
                        idx_agree = min(idx_agree,
                                        float((out[1] == ref[1]).float().mean().item()))
                    u, a = ulps(out[0], ref[0])
                    worst_ulp, worst_abs = max(worst_ulp, u), max(worst_abs, a)
                    got.append(out)
                joined = [torch.cat([g[i] for g in got], dim=1) for i in range(2)]
                square = {"conv5x5_maxout": sq_conv, "gemm_maxout": sq_gemm,
                          "conv5x5_maxout_argmax": sq_arg}[kind]
                same = bool(torch.equal(joined[0], square[0]) and torch.equal(joined[1], square[1]))
                row = {"kernel": kind, "case": tag, "max_err_in_bf16_ulps": worst_ulp,
                       "max_abs_err": worst_abs, "same_bits_as_square": same,
                       "ok": same and worst_ulp <= 1.0}
                if kind == "conv5x5_maxout_argmax":
                    row["index_agrees_with_plain"] = idx_agree
                else:
                    row.update(stats_max_rel_err=worst_rel, stats_rtol=STATS_RTOL)
                    row["ok"] = row["ok"] and worst_rel <= STATS_RTOL
                cases.append(row)
        del xc, xg, sq_conv, sq_arg, sq_gemm, slabs, rows
    torch.cuda.synchronize()

    # timing: B 1, the first of two shards (rows 0-127 of L 256, a 132 x 256 slab)
    xc, nr = inputs(1, CWIDTH, CWIDTH)
    xg, _ = inputs(1, GEMM_K_IN, k_pad)
    seq = SeqShards.split([dev] * 2, l_pad)
    slab = exchange_halo(scatter_rows(seq, xc), conv_block.HALO)[0].contiguous()
    rows_g = scatter_rows(seq, xg)[0].contiguous()
    n_rows = seq.bounds[1]
    npix = n_rows * l_pad
    timing = {}
    for kind, name, fn, plain, x in (
            ("conv5x5_maxout", "conv5x5_maxout_kernel",
             lambda: conv_block.conv5x5_maxout_partials(slab, conv_w, conv_b, nr, slab=True),
             lambda: conv_block.conv5x5_maxout_partials_plain(slab, conv_w, conv_b, nr,
                                                              slab=True),
             slab),
            ("conv5x5_maxout_diff", "conv5x5_maxout_argmax_kernel",
             lambda: conv_block.conv5x5_maxout_argmax(slab, conv_w, conv_b, slab=True),
             lambda: conv_block.conv5x5_maxout_argmax_plain(slab, conv_w, conv_b, slab=True),
             slab),
            ("gemm_maxout", "gemm_maxout_kernel",
             lambda: conv_block.gemm_maxout_partials(rows_g, gemm_w, gemm_b, nr),
             lambda: conv_block.gemm_maxout_partials_plain(rows_g, gemm_w, gemm_b, nr),
             rows_g)):
        ms = device_ms(fn, name, reps=50)
        plain_ms = time_ms(plain, reps=5)
        if kind == "gemm_maxout":
            c_out = gemm_b.shape[0]
            flops = 2.0 * npix * GEMM_K_IN * c_out
            nbytes = (2 * (x.numel() + gemm_w.numel() + npix * c_out // 3)
                      + 4 * (c_out + 1 + 2 * c_out // 3 * -(-npix // 128)))
            x2d, w_lib = x.view(npix, k_pad), gemm_w.T
            library_ms = time_ms(lambda: torch.matmul(x2d, w_lib), reps=50)
            library = (f"torch.matmul bf16 (cuBLAS): ({npix}, {k_pad}) x ({k_pad}, {c_out}) "
                       "only, without bias, maxout or statistics")
        else:
            c_out = conv_b.shape[0]
            flops = 2.0 * npix * conv_w.numel()
            out_bytes = npix * c_out // 4 * (3 if kind == "conv5x5_maxout_diff" else 2)
            tiles = -(-n_rows // conv_block.CONV_TILE[0]) * -(-l_pad // conv_block.CONV_TILE[1])
            stats = 0 if kind == "conv5x5_maxout_diff" else 4 * 2 * c_out // 4 * tiles
            nbytes = 2 * (x.numel() + conv_w.numel()) + out_bytes + 4 * (c_out + 1) + stats
            x_nchw = x.permute(0, 3, 1, 2)
            w_lib = conv_block.unpack_conv5x5_weights(conv_w).contiguous(
                memory_format=torch.channels_last)
            library_ms = time_ms(lambda: F.conv2d(x_nchw, w_lib, padding=(0, 2)), reps=50)
            library = ("F.conv2d on the channels-last bf16 slab, padding (0, 2) (cuDNN): the "
                       "5x5 conv to 512 channels only, without bias, maxout, statistics or index")
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_TENSOR)
        timing[kind] = {"shape": f"B 1, slab {tuple(x.shape[1:3])} of L {l_pad} (rows 0-"
                                 f"{n_rows - 1} of a 2-way split)",
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                        "library_ms": library_ms, "library": library,
                        "tflops": flops / (ms * 1e-3) / 1e12}
    return cases, timing


@contextlib.contextmanager
def _seq_trunk_record(store: dict, first_blocks: int):
    """Record the bf16 trunk's block outputs (the first ``first_blocks``
    calls of the block tail) and each pass's trunk output, sharded or not."""
    from dmpfold2_tpu_torch.models import gruresnet, trunk

    store.update(blocks=[], outputs=[])
    tail, apply = trunk._fused_tail, gruresnet.trunk_apply_bf16

    def rec_tail(*args):
        out = tail(*args)
        if len(store["blocks"]) < first_blocks:
            store["blocks"].append(out)
        return out

    def rec_apply(*args, **kw):
        out = apply(*args, **kw)
        store["outputs"].append(out)
        return out

    trunk._fused_tail, gruresnet.trunk_apply_bf16 = rec_tail, rec_apply
    try:
        yield
    finally:
        trunk._fused_tail, gruresnet.trunk_apply_bf16 = tail, apply


def _seq_fold_compare(params, alnmat, iterations: int, minsteps: int, repeats: int) -> dict:
    """Phase seq (b) / (d): the bf16 fold of ``alnmat`` on a 1 x 2 mesh
    against the unsharded one; returns the row, its checks and the sharded
    fold's launch counts."""
    from dmpfold2_tpu_torch.engine.buckets import bucket_shape
    from dmpfold2_tpu_torch.engine.fold import Folder
    from dmpfold2_tpu_torch.parallel.sharding import row_splits

    plain = Folder(params, device="cuda", precision="bf16")
    sharded = Folder(params, mesh=_seq_mesh(2), precision="bf16")
    split = row_splits(bucket_shape(*alnmat.shape)[1], 2)
    walls = {"unsharded": [], "seq": []}
    rec = {}
    for name, folder in (("unsharded", plain), ("seq", sharded)):
        folder.fold(alnmat, iterations=iterations, minsteps=minsteps)  # warm-up
        store: dict = {}
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _seq_trunk_record(store, BLOCKS * (2 if name == "seq" else 1)):
            coords, confs = folder.fold(alnmat, iterations=iterations, minsteps=minsteps)
        walls[name].append(time.perf_counter() - t0)
        rec[name] = dict(store, coords=coords, confs=confs, launches=_read_counters())
        for _ in range(repeats - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            folder.fold(alnmat, iterations=iterations, minsteps=minsteps)
            walls[name].append(time.perf_counter() - t0)
    u, s = rec["unsharded"], rec["seq"]
    blocks_differ = []  # (block, max abs difference) where the joined shards part
    for i in range(BLOCKS):
        joined = torch.cat([s["blocks"][2 * i], s["blocks"][2 * i + 1]], dim=1)
        if not torch.equal(joined, u["blocks"][i]):
            blocks_differ.append(
                [i, float((joined.float() - u["blocks"][i].float()).abs().max())])
    out_u, out_s = u["outputs"][0], s["outputs"][0]
    valid = out_u[..., 0] != 0
    trunk_rel = {label: float((out_s[..., ch] - out_u[..., ch]).abs()[valid].max()
                              / out_u[..., ch].abs()[valid].max())
                 for ch, label in ((0, "dmap"), (1, "conf"))}
    want = {k: (2 * v if k in ("conv5x5_maxout", "gemm_maxout", "block_tail") else v)
            for k, v in u["launches"].items()}
    # recycling and refinement amplify the head's rounding-level differences
    # (its GEMM's rows differ): unless the folds are the same bits, the
    # confidences are held at -n 0 -m 0, as phase multi (b) holds them
    same_fold = bool(np.array_equal(s["coords"], u["coords"])
                     and np.array_equal(s["confs"], u["confs"]))
    conf_n0 = None
    if not same_fold:
        conf_n0 = float(np.abs(sharded.fold(alnmat, iterations=0, minsteps=0)[1]
                               - plain.fold(alnmat, iterations=0, minsteps=0)[1]).max())
    checks = {"blocks same bits": not blocks_differ,
              "trunk output within 1e-5 of scale": all(v <= SEQ_TRUNK_REL
                                                       for v in trunk_rel.values()),
              "fold same bits" if same_fold else "conf at -n 0 -m 0 within bf16 bound":
              same_fold or conf_n0 <= CONF_BF16_TOL,
              "launches: trunk kernels twice": s["launches"] == want,
              **{f"whole: {k}": v for k, v in _fold_checks(s["coords"], s["confs"],
                                                           alnmat).items()}}
    row = {"shape": list(alnmat.shape), "split": list(split), "iterations": iterations,
           "minsteps": minsteps, "blocks_same_bits": not blocks_differ,
           "blocks_differ": blocks_differ, "trunk_rel_diff": trunk_rel,
           "trunk_rel_tol": SEQ_TRUNK_REL, "fold_same_bits": same_fold,
           "max_abs_conf_n0_m0": conf_n0, "conf_n0_m0_tol": CONF_BF16_TOL,
           "max_abs_conf": float(np.abs(s["confs"] - u["confs"]).max()),
           "max_abs_ca": float(np.abs(s["coords"][:, 1] - u["coords"][:, 1]).max()),
           "wall_s": walls, "wall_s_median": {k: float(np.median(v)) for k, v in walls.items()},
           "wall_s_range": {k: [float(min(v)), float(max(v))] for k, v in walls.items()},
           "launches_unsharded": u["launches"], "launches_seq": s["launches"], "checks": checks}
    del plain, sharded, rec
    torch.cuda.empty_cache()
    return row


def phase_seq(params) -> dict:
    """Phase seq (a)-(f); returns the kernels' slab timing rows and the
    launch counts of its two paths."""
    import threading
    import urllib.request

    from dmpfold2_tpu_torch.engine.fold import Folder
    from dmpfold2_tpu_torch.serve import serve
    from dmpfold2_tpu_torch.utils.aln import parse_aln

    t_phase = time.perf_counter()
    walls, checks = {}, {}
    t0 = time.perf_counter()
    cases, timing = _seq_kernels(params, np.random.default_rng(13))
    walls["kernels_s"] = time.perf_counter() - t0
    checks.update({f"(a) {c['kernel']} {c['case']}": c["ok"] for c in cases})

    alnmat = parse_aln(EXAMPLE_ALN)
    t0 = time.perf_counter()
    fold_b = _seq_fold_compare(params, alnmat, ITERATIONS, MINSTEPS, SEQ_WALL_REPEATS)
    walls["fold_bf16_s"] = time.perf_counter() - t0
    checks.update({f"(b) {k}": v for k, v in fold_b["checks"].items()})

    fp32 = {}
    for precision in ("fp32", "fp32_strict"):
        plain = Folder(params, device="cuda", precision=precision)
        sharded = Folder(params, mesh=_seq_mesh(2), precision=precision)
        cp, fp = plain.fold(alnmat, iterations=0, minsteps=0)
        cs, fs = sharded.fold(alnmat, iterations=0, minsteps=0)
        fp32[precision] = {"max_abs_conf": float(np.abs(fs - fp).max()),
                           "max_abs_ca": float(np.abs(cs[:, 1] - cp[:, 1]).max())}
        for k, tol in SEQ_FP32_TOLS.items():
            checks[f"(c) {precision} {k}"] = fp32[precision][k] <= tol
        del plain, sharded

    rng = np.random.default_rng(17)
    long_aln = rng.integers(0, 21, SEQ_LONG).astype(np.uint8)
    t0 = time.perf_counter()
    fold_d = _seq_fold_compare(params, long_aln, *SEQ_LONG_RUN, repeats=SEQ_WALL_REPEATS)
    walls["fold_long_s"] = time.perf_counter() - t0
    checks.update({f"(d) {k}": v for k, v in fold_d["checks"].items()})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_dir:
        _write_train_data(data_dir, np.random.default_rng(1))
        batch = _load_batch(data_dir, "pf")
    want = _ddp_steps(params, batch, "cuda", None, SEQ_TRAIN_STEPS)
    got = _ddp_steps(params, batch, "cuda", _seq_mesh(2), SEQ_TRAIN_STEPS)
    train_rows, train_launches = [], None
    for g, w in zip(got, want):
        tag = f"{g['model']} {g['precision']}"
        rel = abs(g["metrics"]["loss"] - w["metrics"]["loss"]) / abs(w["metrics"]["loss"])
        cos = {k: _cosine(g["grads"][k], w["grads"][k]) for k in w["grads"]}
        train_rows.append({"case": tag, "loss_seq": g["metrics"]["loss"],
                           "loss_unsharded": w["metrics"]["loss"], "loss_rel_diff": rel,
                           "grad_cosine": cos, "wall_s": {"seq": g["wall_s"],
                                                          "unsharded": w["wall_s"]},
                           "launches_seq": g["launches"], "launches_unsharded": w["launches"]})
        checks[f"(e) {tag} loss"] = rel <= SEQ_TRAIN_LOSS_RTOL[g["precision"]]
        if (g["model"], g["precision"]) == ("spread", "fp32"):
            checks.update({f"(e) {tag} cosine {k}": c >= DDP_GRAD_COS for k, c in cos.items()})
        if g["precision"] == "bf16":
            train_launches = g["launches"]
            checks["(e) bf16 argmax launches twice"] = (
                g["launches"]["conv5x5_maxout_diff"] == 2 * w["launches"]["conv5x5_maxout_diff"] > 0)
    walls["train_s"] = time.perf_counter() - t0

    server = serve(params, host="127.0.0.1", port=0, precision="bf16", max_batch=BATCH_SIZE,
                   mesh=_seq_mesh(2))
    service = server.fold_service
    service.warmup(shapes=((N_PAD, L_PAD),))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}/fold?iterations={ITERATIONS}"
           f"&minsteps={MINSTEPS}")
    body = _aln_text(alnmat).encode()
    out = [None] * SEQ_SERVE_REQUESTS

    def client(i):
        try:
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=600) as resp:
                out[i] = (resp.status, resp.read().decode())
        except Exception as exc:  # noqa: BLE001 - reported in the checks
            out[i] = (None, repr(exc))

    clients = [threading.Thread(target=client, args=(i,)) for i in range(SEQ_SERVE_REQUESTS)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    walls["serve_s"] = time.perf_counter() - t0
    checks["(f) all 200, 406 ATOM lines"] = all(
        r is not None and r[0] == 200
        and sum(line.startswith("ATOM") for line in r[1].splitlines()) == 406 for r in out)
    server.shutdown()
    service.close()
    server.server_close()
    thread.join(timeout=60)
    service.batcher.close()
    walls["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "seq", "mesh": "1 x n on cuda:0", "kernel_cases": cases,
          "slab_timing": timing, "fold_bf16": {k: v for k, v in fold_b.items() if k != "checks"},
          "fold_fp32_n0_m0": fp32, "fold_long_bf16": {k: v for k, v in fold_d.items()
                                                      if k != "checks"},
          "train": train_rows, "serve": {"requests": SEQ_SERVE_REQUESTS,
                                         "errors": [r[1][:200] for r in out
                                                    if r is None or r[0] != 200]},
          "walls_s": walls, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"seq checks failed: {failed}")
    return {"slab": timing, "paths": {"fold bf16 seq": fold_b["launches_seq"],
                                      "train bf16 seq": train_launches}}


# ---------------------------------------------------------------- mds
#
# Phase mds: the bf16 engine's MDS, the top-8 eigenpairs by subspace
# iteration (ops/eigh.py), on realistic Grams: distance maps of points in 8
# dimensions at scales geomspace(8, 1), as tests/test_subspace_eigh.py builds
# them, at the fold's bucket (B 1, L 88), the long fold's (B 1, L 736) and
# the batch engine's (B 8, L 256, nres 241-256). Bounds, each of a target's
# coordinate scale (the largest |coordinate| of its eigh MDS): the card
# against the port's CPU run (the same start basis) MDS_CPU_TOL; against
# eigh on the card MDS_EIGH_TOL, JAX's own bound
# (tests/test_subspace_eigh.py:83); each target of the batch against its map
# alone MDS_ALONE_TOL; padded rows exactly zero. Recorded: each call's time
# (CUDA events), device launches (torch.profiler) and host syncs (torch's
# sync debug mode) for eigh and the subspace; then the bf16 fold of PF10963
# on a held Folder with each MDS in turns (subspace, eigh, eigh, subspace):
# its wall time, the MDS calls' share of it (CUDA events around each call)
# and its host syncs.
MDS_CASES = ((L_PAD, (NRES,)), (736, (720,)), (256, (256, 253, 250, 247, 245, 244, 242, 241)))
MDS_CPU_TOL, MDS_EIGH_TOL, MDS_ALONE_TOL = 1e-4, 2e-3, 1e-4
MDS_TIMED = 20


def _mds_maps(l_pad: int, nres, rng) -> torch.Tensor:
    dm = np.zeros((len(nres), l_pad, l_pad), np.float32)
    for b, n in enumerate(nres):
        pts = rng.normal(size=(n, 8)) * np.geomspace(8.0, 1.0, 8)
        dm[b, :n, :n] = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    return torch.from_numpy(dm)


def _rel_err(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest over targets of max |got - ref| over that target's scale."""
    return ((got - ref).abs().amax(dim=(-2, -1)) / scale).max().item()


@contextlib.contextmanager
def _mds_timing(store: list):
    """CUDA events around every MDS call of the inference forward; after a
    synchronise, ``store`` holds each call's milliseconds on the stream."""
    from dmpfold2_tpu_torch.models import gruresnet

    orig, events = gruresnet.mds_coords, []

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    gruresnet.mds_coords = timed
    try:
        yield
    finally:
        gruresnet.mds_coords = orig
        torch.cuda.synchronize()
        store.extend(s.elapsed_time(e) for s, e in events)


def _mds_fold_turns(params) -> dict:
    """PF10963's bf16 fold at the defaults on a held Folder with the subspace
    MDS and with eigh (the engine's choice patched), in turns."""
    from dmpfold2_tpu_torch.engine import fold
    from dmpfold2_tpu_torch.utils.aln import parse_aln

    alnmat = parse_aln(EXAMPLE_ALN)
    folder = fold.Folder(params, device="cuda", precision="bf16")
    orig = fold.resolve_mds_impl
    turns = []
    try:
        for impl in ("subspace", "eigh", "eigh", "subspace"):
            fold.resolve_mds_impl = lambda precision, impl=impl: impl
            run = lambda: folder.fold(alnmat, iterations=ITERATIONS, minsteps=MINSTEPS)  # noqa: E731
            run()  # warm-up
            walls, mds_ms = [], []
            for _ in range(FOLD_REPEATS):
                calls: list = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _mds_timing(calls):
                    run()
                walls.append(time.perf_counter() - t0)
                mds_ms.append(sum(calls))
            turns.append({"mds": impl, "wall_s_median": float(np.median(walls)),
                          "wall_s_all": walls, "mds_calls": len(calls),
                          "mds_ms_median": float(np.median(mds_ms)),
                          "mds_share": float(np.median(mds_ms)) / 1e3 / float(np.median(walls)),
                          "host_syncs": _sync_sites(run)})
    finally:
        fold.resolve_mds_impl = orig
    return {"turns": turns}


def phase_mds(params) -> None:
    from dmpfold2_tpu_torch.engine.fold import use_full_fp32
    from dmpfold2_tpu_torch.models.geometry import mds_coords

    use_full_fp32()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    rows, failed = [], []
    for l_pad, nres in MDS_CASES:
        dm_cpu, nr_cpu = _mds_maps(l_pad, nres, rng), torch.tensor(nres, dtype=torch.int32)
        dm, nr = dm_cpu.cuda(), nr_cpu.cuda()
        sub = mds_coords(dm, nr, impl="subspace")
        eig = mds_coords(dm, nr, impl="eigh")
        cpu = mds_coords(dm_cpu, nr_cpu, impl="subspace").cuda()
        scale = eig.abs().amax(dim=(-2, -1))
        row = {"batch": len(nres), "l_pad": l_pad, "nres": list(nres),
               "coord_scale": scale.tolist(),
               "card_vs_cpu": _rel_err(sub, cpu, scale), "card_vs_cpu_tol": MDS_CPU_TOL,
               "subspace_vs_eigh": _rel_err(sub, eig, scale), "subspace_vs_eigh_tol": MDS_EIGH_TOL,
               "padding_zero": all(bool((sub[b, n:] == 0).all()) for b, n in enumerate(nres)),
               "finite": bool(torch.isfinite(sub).all())}
        # recorded: which of the card's two MDS is nearer the CPU's
        cpu_eig = mds_coords(dm_cpu, nr_cpu, impl="eigh").cuda()
        row["eigh_card_vs_cpu"] = _rel_err(eig, cpu_eig, scale)
        row["subspace_vs_eigh_cpu"] = _rel_err(cpu, cpu_eig, scale)
        checks = {"card_vs_cpu": row["card_vs_cpu"] <= MDS_CPU_TOL,
                  "subspace_vs_eigh": row["subspace_vs_eigh"] <= MDS_EIGH_TOL,
                  "padding_zero": row["padding_zero"], "finite": row["finite"]}
        if len(nres) > 1:
            alone = torch.cat([mds_coords(dm[b:b + 1], nr[b:b + 1], impl="subspace")
                               for b in range(len(nres))])
            row["batch_vs_alone"] = _rel_err(sub, alone, scale)
            row["batch_vs_alone_tol"] = MDS_ALONE_TOL
            row["batch_vs_alone_same_bits"] = bool(torch.equal(sub, alone))
            checks["batch_vs_alone"] = row["batch_vs_alone"] <= MDS_ALONE_TOL
        for impl in ("eigh", "subspace"):
            call = lambda impl=impl: mds_coords(dm, nr, impl=impl)  # noqa: E731
            row[f"{impl}_ms"] = time_ms(call, reps=MDS_TIMED)
            prof = _profiled(call)
            row[f"{impl}_device_ms"] = prof["device_busy_ms"]
            row[f"{impl}_launches"] = prof["kernel_launches"]
            row[f"{impl}_top_kernels"] = prof["top_kernels"][:6]
            row[f"{impl}_host_syncs"] = _sync_sites(call)
        row["checks"] = checks
        failed += [f"B {len(nres)} L {l_pad}: {k}" for k, ok in checks.items() if not ok]
        rows.append(row)
    fold_turns = _mds_fold_turns(params)
    emit({"phase": "mds", "cases": rows, "fold_bf16": fold_turns,
          "phase_s": time.perf_counter() - t_phase, "failed": failed})
    if failed:
        raise AssertionError(f"mds checks failed: {failed}")


# ---------------------------------------------------------------- long
#
# Phase long: the long target of BASELINE.json config 4 ("nres >= 700, deep
# MSA, 30 iterations"), in the JAX bench's form (bench.py:202-215): a seeded
# 3000 x 720 alignment, bucket 3000 x 736, bf16, 30 recycles, 100 minsteps.
# Its DCA covariance is (21 x 736)^2 = 15456^2, past BLOCKED_THRESHOLD, so
# "cholesky" runs the blocked inverse in place (ops/chol.py).

LONG_SHAPE = (3000, 720)
LONG_ITERATIONS, LONG_MINSTEPS = 30, 100
LONG_METHODS = ("cholesky", "blocked", "schur", "lu")
# the Cholesky-type names, one route by size (features/dca.py)
LONG_CHOLESKY = LONG_METHODS[:3]
# pair_features's peak in (21 l_pad)^2 fp32 matrices, with the blocked
# inverse: its (L, L, 443) output and the covariance are two; the one-hot and
# its centred copy (0.19 each at depth 3000) and a panel come on top
LONG_PEAK_MAX = 2.5
# card against CPU at the first bucket past the threshold (n 8736): a seeded
# 256-row alignment, the blocked features within phase strict's card-vs-CPU
# bound
LONG_CPU_SHAPE = (256, 416)
LONG_REPS = 3  # timed features steps per method, after one warm-up


def _long_features(alnmat, dmap, nseqs: int, nres: int) -> dict:
    """pair_features on the card per DCA method: each method's features
    against LU's within DCA_LU_VS_CHOL, the Cholesky-type names the same bits
    (one route: the blocked inverse past the threshold), each method's peak
    memory in (21 l_pad)^2 fp32 matrices and its time (CUDA events)."""
    from dmpfold2_tpu_torch.engine.fold import pair_features
    from dmpfold2_tpu_torch.features.dca import NUM_DCA_CHANNELS

    unit = (21 * alnmat.shape[2]) ** 2 * 4
    feats, rows = {}, {}
    for method in LONG_METHODS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        x2 = pair_features(alnmat, [nseqs], [nres], dmap, method)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / unit
        feats[method] = x2[0, ..., :NUM_DCA_CHANNELS]
        del x2
        ms = time_ms(lambda m=method: pair_features(alnmat, [nseqs], [nres], dmap, m),
                     reps=LONG_REPS, warmup=1)
        rows[method] = {"peak_units": peak, "ms": ms}
    ref = feats["lu"]
    scale = ref.abs().max().item()
    for method in LONG_METHODS:
        rows[method]["vs_lu"] = (feats[method] - ref).abs().max().item() / scale
    same = all(torch.equal(feats[m], feats["cholesky"]) for m in LONG_CHOLESKY)
    del feats, ref
    inverses = _long_inverses(alnmat[0], nseqs, nres)
    failed = ([f"{m} vs lu" for m in LONG_METHODS if not rows[m]["vs_lu"] <= DCA_LU_VS_CHOL]
              + [f"{m} peak" for m in LONG_CHOLESKY
                 if not rows[m]["peak_units"] <= LONG_PEAK_MAX])
    if not same:
        failed.append("the Cholesky-type names are not one route")
    if not inverses["blocked_vs_stock"] <= DCA_LU_VS_CHOL:
        failed.append("blocked inverse vs stock")
    return {"shape": list(alnmat.shape[1:]), "n": 21 * alnmat.shape[2], "unit_bytes": unit,
            "scale": scale, "methods": rows, "inverse_alone": inverses,
            "cholesky_names_same_bits": same,
            "tols": {"vs_lu": DCA_LU_VS_CHOL, "peak_units": LONG_PEAK_MAX}, "failed": failed}


def _long_inverses(aln, nseqs: int, nres: int, penalty: float = 4.5) -> dict:
    """The inverse alone on this target's regularized covariance (built here
    as ``fast_dca`` builds it; CUDA events, a fresh copy each call, the
    copy's time subtracted): the blocked route, the stock Cholesky inverse it
    replaces past the threshold (``cholesky_ex`` + ``cholesky_inverse``) and
    LU; the blocked inverse against the stock one in max |ref|."""
    from dmpfold2_tpu_torch.features import msa
    from dmpfold2_tpu_torch.ops import chol

    oh = msa.msa_one_hot(aln, nseqs, nres)
    w = msa.reweight(oh, nres)
    x = oh.reshape(oh.shape[0], -1)
    wsum = w.sum()
    num_points = wsum - torch.sqrt(wsum / nseqs)
    xc = (x - (x * w[:, None]).sum(dim=0, keepdim=True) / num_points) * torch.sqrt(w[:, None])
    del oh, x
    cov = xc.T @ xc
    del xc
    cov /= num_points
    cov.diagonal().add_(penalty / torch.sqrt(wsum))

    def stock(a):
        return torch.cholesky_inverse(torch.linalg.cholesky_ex(a).L)

    inverses = {"blocked": chol.blocked_spd_inverse_, "stock_cholesky": stock,
                "lu": lambda a: torch.linalg.inv_ex(a).inverse}
    copy_ms = time_ms(lambda: cov.clone(), reps=LONG_REPS, warmup=1)
    out = {f"{name}_ms": time_ms(lambda f=f: f(cov.clone()), reps=LONG_REPS, warmup=1) - copy_ms
           for name, f in inverses.items()}
    ref = stock(cov.clone())
    blocked = chol.blocked_spd_inverse_(cov)
    out["blocked_vs_stock"] = (blocked - ref).abs().max().item() / ref.abs().max().item()
    out["n"] = cov.shape[0]
    return out


def _long_card_vs_cpu() -> dict:
    """The blocked features ("cholesky" past the threshold) of a seeded
    256 x 416 alignment on the card against the CPU."""
    from dmpfold2_tpu_torch.features import dca, msa

    nseqs, nres = LONG_CPU_SHAPE
    aln = np.random.default_rng(37).integers(0, 22, LONG_CPU_SHAPE).astype(np.int32)
    out, secs = {}, {}
    for dev in ("cpu", "cuda"):
        oh = msa.msa_one_hot(torch.from_numpy(aln).to(dev), nseqs, nres)
        w = msa.reweight(oh, nres)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dev] = dca.fast_dca(oh, w, nseqs, nres).cpu()
        secs[dev] = time.perf_counter() - t0
    scale = out["cpu"].abs().max().item()
    err = (out["cuda"] - out["cpu"]).abs().max().item() / scale
    return {"shape": list(LONG_CPU_SHAPE), "n": 21 * nres, "method": "cholesky (blocked)",
            "card_vs_cpu": err, "tol": DCA_CARD_VS_CPU, "seconds": secs,
            "failed": [] if err <= DCA_CARD_VS_CPU else ["card vs cpu"]}


def _long_vgru(params, alnmat) -> dict:
    """vgru at the fold's shape (3000 rows x 736 columns, every column at
    depth 3000) against its plain version, with its time and bound."""
    from dmpfold2_tpu_torch.kernels import vgru

    layers = [{k: v.to("cuda") for k, v in p.items()} for p in params["vgru"]]
    cols = alnmat[0].contiguous()
    valid = torch.full((cols.shape[1],), cols.shape[0], dtype=torch.int32, device="cuda")
    out = vgru.vgru_final_cols(layers, cols, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = vgru.vgru_final_cols_plain(layers, cols, valid)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out - ref).abs().max().item()
    # CUDA events: a launch takes about 0.4 s, so the wrapper's host time is
    # nothing beside it (the profiler once saw none of these launches after
    # the earlier phases, and device_ms raised)
    ms = time_ms(lambda: vgru.vgru_final_cols(layers, cols, valid), reps=3, warmup=1)
    gru_lib, onehot = _vgru_library(layers, cols)
    with torch.no_grad():
        lib_err = (gru_lib(onehot)[1][-1] - out).abs().max().item()
        library_ms = time_ms(lambda: gru_lib(onehot), reps=3, warmup=1)
    del gru_lib, onehot
    b, by = _vgru_bound(cols, valid)
    return {"shape": [*cols.shape, WIDTH], "max_abs_err": err, "tol": GRU_TOL, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": library_ms,
            "library": f"torch.nn.GRU(22, 512, num_layers=2) on {cols.shape[0]} rows x "
                       f"{cols.shape[1]} columns", "library_max_abs_err": lib_err,
            "ok": err <= GRU_TOL}


def _long_kernels(params, l_pad: int, nres: int) -> dict:
    """The fold's other kernels at its shapes (B 1, L 736, nres 720), each
    against its plain version with the kernel phase's limits: one biGRU layer
    of coord_gru (T 736), refine step by step along the plain path from a
    random walk (MINSTEPS steps), the two bf16 trunk kernels with the main
    path's weights on inputs zero outside nres x nres."""
    from dmpfold2_tpu_torch.kernels import conv_block, refine, rgru

    dev = torch.device("cuda")
    rng = np.random.default_rng(43)
    nr = torch.tensor([nres], dtype=torch.int32, device=dev)
    out = {}
    hid = WIDTH // 2
    layer = {d: {k: v.to(dev) for k, v in params["coord_gru"][0][d].items()}
             for d in ("fwd", "bwd")}
    xf, xb = (torch.from_numpy(rng.normal(size=(l_pad, 1, 3 * hid)).astype(np.float32)).to(dev)
              for _ in range(2))
    e = (rgru.gru_seq_bidir(layer["fwd"], layer["bwd"], xf, xb, nr)
         - rgru.gru_seq_bidir_plain(layer["fwd"], layer["bwd"], xf, xb, nr)).abs().max().item()
    out["rgru"] = {"shape": f"T {l_pad}, B 1, valid {nres}", "max_abs_err": e, "tol": GRU_TOL,
                   "ok": e <= GRU_TOL}
    ca = torch.from_numpy(_chain(l_pad, rng))[None].to(dev)
    e = _refine_stepwise_err(refine, ca, nr)
    out["refine"] = {"shape": f"L {l_pad}, nres {nres}, random walk",
                     "stepwise_max_abs_err": e, "tol": REFINE_TOL, "ok": e <= REFINE_TOL}
    conv_w, conv_b, gemm_w, gemm_b, k_pad = _packed_trunk_weights(params, dev)
    gen = torch.Generator(device=dev).manual_seed(43)
    valid = (torch.arange(l_pad, device=dev) < nres).to(torch.bfloat16)
    for kind, kernel, plain, w, bias, c_in, width in (
            ("conv5x5_maxout", conv_block.conv5x5_maxout_stats,
             conv_block.conv5x5_maxout_stats_plain, conv_w, conv_b, CWIDTH, CWIDTH),
            ("gemm_maxout", conv_block.gemm_maxout_stats, conv_block.gemm_maxout_stats_plain,
             gemm_w, gemm_b, GEMM_K_IN, k_pad)):
        x = torch.zeros((1, l_pad, l_pad, width), dtype=torch.bfloat16, device=dev)
        x[..., :c_in] = (torch.randn((1, l_pad, l_pad, c_in), device=dev, generator=gen)
                         .to(torch.bfloat16) * valid[:, None, None] * valid[None, :, None])
        out[kind] = {"shape": f"B 1, L {l_pad}, nres {nres}",
                     **_trunk_check(kernel, plain, x, w, bias, nr)}
        del x
    return out


def phase_long(params) -> dict:
    """Phase long: (a) the DCA step at bucket 3000 x 736 per method; (b) the
    blocked features card vs CPU at 256 x 416; (c) the config 4 fold through
    ``Folder(precision="bf16").fold`` after a warm-up: launches, vgru against
    plain at its shape, whole PDB, wall time and model FLOP utilization.
    Returns the fold's launches and vgru's row."""
    from dmpfold2_tpu_torch.engine.buckets import bucket_shape
    from dmpfold2_tpu_torch.engine.fold import Folder, pad_target, use_full_fp32

    use_full_fp32()
    t_phase = time.perf_counter()
    nseqs, nres = LONG_SHAPE
    aln = np.random.default_rng(41).integers(0, 22, LONG_SHAPE).astype(np.uint8)
    n_pad, l_pad = bucket_shape(nseqs, nres)
    aln_p, dmap = pad_target(aln, None, n_pad, l_pad)
    alnmat = torch.from_numpy(aln_p).cuda()[None]
    dmap_t = torch.from_numpy(dmap).cuda()[None]
    features = _long_features(alnmat, dmap_t, nseqs, nres)
    card_cpu = _long_card_vs_cpu()
    vgru_row = _long_vgru(params, alnmat)
    kernels = _long_kernels(params, l_pad, nres)
    del dmap_t
    torch.cuda.empty_cache()

    folder = Folder(params, device="cuda", precision="bf16")
    folder.fold(aln, iterations=1, minsteps=LONG_MINSTEPS // 10)  # warm-up: the same shapes
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coords, confs = folder.fold(aln, iterations=LONG_ITERATIONS, minsteps=LONG_MINSTEPS)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    # recorded, not held: with no device time traced its idle share is null
    profile_row = _profiled(lambda: folder.fold(aln, iterations=LONG_ITERATIONS,
                                                minsteps=LONG_MINSTEPS))
    del folder
    passes = LONG_ITERATIONS + 1  # EXPECTED_LAUNCHES' rule
    expected = {"vgru": 1, "rgru": 2 + 3 * passes, "refine": 2, "conv5x5_maxout": 16 * passes,
                "gemm_maxout": passes, "conv5x5_maxout_diff": 0, "block_tail": 16 * passes}
    checks = {**_fold_checks(coords, confs, aln), "launches": launches == expected,
              "vgru": vgru_row["ok"], **{k: row["ok"] for k, row in kernels.items()}}
    flops = fold_flops(n_pad, l_pad, LONG_ITERATIONS, LONG_MINSTEPS)
    peak, peak_name = MFU_PEAK["bf16"]
    failed = ([f"features {k}" for k in features["failed"]]
              + [f"card vs cpu {k}" for k in card_cpu["failed"]]
              + [k for k, ok in checks.items() if not ok])
    emit({"phase": "long", "config": "BASELINE.json config 4", "shape": list(LONG_SHAPE),
          "bucket": [n_pad, l_pad], "precision": "bf16", "iterations": LONG_ITERATIONS,
          "minsteps": LONG_MINSTEPS, "features": features, "card_vs_cpu": card_cpu,
          "vgru": vgru_row, "kernels": kernels, "wall_s": wall, "fold_flops": flops,
          "mfu_peak": peak_name, "mfu": mfu(flops, wall, peak), "profile": profile_row,
          "launches": launches, "expected_launches": expected,
          "mean_conf": float(confs.mean()), "checks": checks,
          "phase_s": time.perf_counter() - t_phase, "failed": failed})
    if failed:
        raise AssertionError(f"long checks failed: {failed}")
    return {"launches": launches, "vgru": vgru_row}


# kernel-name fragments -> category, first match wins
PROFILE_CATEGORIES = (
    ("vgru", ("vgru_kernel",)), ("rgru", ("rgru",)), ("refine", ("refine_kernel",)),
    ("conv5x5_maxout", ("conv5x5_maxout_kernel",)), ("gemm_maxout", ("gemm_maxout_kernel",)),
    # cuDNN convolutions ("fprop"); cuBLAS's sm80_xmma_gemm kernels are GEMMs
    ("conv", ("convolution", "fprop", "cudnn", "implicit", "winograd", "fft")),
    ("gemm", ("gemm", "gemv", "dot_kernel", "splitk")),
    ("linalg", ("syev", "potr", "trsm", "trtri", "sytr", "orm", "larf", "stedc", "steqr",
                "lascl", "lansy", "geqr", "cusolver", "syrk", "chol")),
)


def _device_kernels(prof) -> list:
    """(name, launches, device ms) of each CUDA kernel in a torch.profiler
    run, the longest first."""
    kernels = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            kernels.append((evt.key, evt.count, us / 1e3))
    return sorted(kernels, key=lambda k: -k[2])


def _category(name: str) -> str:
    return next((c for c, frags in PROFILE_CATEGORIES if any(f in name.lower() for f in frags)),
                "other")


def _idle_share(busy_ms: float, wall_ms: float):
    """1 - busy / wall, or None when the profiler traced no device time (a
    share it did not measure)."""
    return 1.0 - busy_ms / wall_ms if busy_ms > 0 and wall_ms > 0 else None


def _profiled(fn) -> dict:
    """Device time of ``fn()`` by kernel and category from torch.profiler
    (profiler overhead included in its wall time), its idle share and launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    by_cat: dict[str, float] = {}
    names: dict[str, list] = {}
    for name, count, ms in kernels:
        cat = _category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        names.setdefault(cat, []).append({"name": name[:90], "count": count, "ms": ms})
    busy = sum(ms for *_, ms in kernels)
    top = kernels[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "traced": busy > 0,
            "idle_share": _idle_share(busy, wall_ms),
            "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "kernel_launches": sum(count for _, count, _ in kernels),
            "largest_by_category": {c: v[:3] for c, v in names.items()},
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms} for n, c, ms in top]}


def phase_profile(params, precision: str) -> None:
    """Device time of one more default fold by kernel, from torch.profiler."""
    from dmpfold2_tpu_torch import aln_to_coords
    from dmpfold2_tpu_torch.config import FoldConfig

    kw = dict(device="cuda", params=params, iterations=ITERATIONS, minsteps=MINSTEPS,
              config=FoldConfig(precision=precision))
    emit({"phase": "profile", "precision": precision,
          **_profiled(lambda: aln_to_coords(EXAMPLE_ALN, **kw))})


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
    """Record the arguments (packed trunks, input rows, mask rows, nres) of
    every bf16 trunk pass the port runs on one shard."""
    from dmpfold2_tpu_torch.models import gruresnet

    orig = gruresnet.trunk_apply_bf16

    def recording(packed, xs, masks, nres, *args):
        store.append((packed, [x.clone() for x in xs], [m.clone() for m in masks], nres.clone()))
        return orig(packed, xs, masks, nres, *args)

    gruresnet.trunk_apply_bf16 = recording
    try:
        yield
    finally:
        gruresnet.trunk_apply_bf16 = orig


def phase_trunk(capture) -> None:
    """One bf16 trunk pass on PF10963's features (B 1, L 88): wall time per
    pass from CUDA events, and device time by part from torch.profiler over 5
    passes. Everything that is not one of the three kernels is plain PyTorch:
    the input layer's norm, the stats reductions and the fp32 head."""
    from torch.profiler import ProfilerActivity, profile

    from dmpfold2_tpu_torch.models import trunk

    reps = 5
    pass_ms = time_ms(lambda: trunk.trunk_apply_bf16(*capture), reps=20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            trunk.trunk_apply_bf16(*capture)
        torch.cuda.synchronize()
    kernels = ("conv5x5_maxout", "gemm_maxout", "block_tail")
    parts = {**{k: 0.0 for k in kernels}, "plain": 0.0}
    launches = {**{k: 0 for k in kernels}, "plain": 0}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = us if us is not None else getattr(evt, "self_cuda_time_total", 0.0)
        part = next((k for k in kernels if f"{k}_kernel" in evt.key), "plain")
        parts[part] += us / 1e3 / reps
        launches[part] += evt.count // reps
    busy = sum(parts.values())
    emit({"phase": "trunk", "precision": "bf16", "shape": list(capture[1][0].shape),
          "pass_wall_ms": pass_ms, "pass_device_ms": busy, "device_ms_by_part": parts,
          "launches_per_pass": launches,
          "share_of_device": {k: v / busy for k, v in parts.items()} if busy else None,
          "idle_share": _idle_share(busy, pass_ms)})


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
    Returns the card's trunk arguments of that pass (one shard)."""
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
    _, (x,), (mask,), nres = store[0]
    out_gpu = trunk.trunk_apply_bf16(*store[0]).cpu()
    out_cpu = trunk.trunk_apply_bf16([trunk.pack_bf16(params["trunk"])], [x.cpu()], [mask.cpu()],
                                     nres.cpu())
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


# ---------------------------------------------------------------- training
#
# Phase train: bf16 training at full width through the port's entry points
# (DMPDataset, pad_to_bucket, make_optimizer, train_step). Two samples are
# written as tdb/ + aln/ files: "pf", PF10963's alignment (252 x 82) with a
# seeded 82-residue target, and "crop", a seeded 600 x 400 alignment with a
# 400-residue target that validation-mode loading crops to 350 (bucket 768 x
# 352, the crop the JAX package's training step was sized for).
TRAIN_NLOOPS = (0, 1, 2, 3)  # one micro-step each, accumulation over 2
CROP_ROWS, CROP_LEN, CROP_NLOOPS, CROP_TIMED = 600, 400, 3, 3
# card vs CPU, one step on "pf" at nloops 0 without dropout or teacher
# forcing (phase_train_cpu): the loss within TRAIN_LOSS_RTOL relative, the
# gradients of TRAIN_HELD_CASE to a cosine of TRAIN_GRAD_COS per top-level
# parameter group. Two models: "random", the seed-0 weights, whose CA trace is
# collapsed, and "spread", the same with the coordinate head scaled by
# HEAD_SCALE (as the toy model of tests/test_torch_model.py is scaled), whose
# trace is protein-sized. Refinement's backward is held on its own at
# TRAIN_CPU_REFINE steps.
TRAIN_LOSS_RTOL = {"bf16": 1e-3, "fp32": 1e-4}
TRAIN_GRAD_COS = 0.99
HEAD_SCALE = 256.0
TRAIN_CPU_REFINE = 10
TRAIN_HELD_CASE = ("random", "fp32", 0)
TRAIN_CPU_CASES = (TRAIN_HELD_CASE, ("random", "fp32", TRAIN_CPU_REFINE), ("random", "bf16", 0),
                   ("spread", "fp32", TRAIN_CPU_REFINE))
# the atoms besides CA at fixed offsets from it (Angstrom): N, C, O, CB
ATOM_OFFSETS = np.array([[-1.2, 0.6, 0.3], [1.3, 0.5, -0.2], [1.9, 1.4, 0.4],
                         [-0.4, -1.3, 0.9]], np.float32)


def _write_tdb(path: str, ca: np.ndarray) -> None:
    """A tdb file the reference's reader takes: the residue letter at column
    5, then N, CA, C, O, CB as 9-character floats from column 39."""
    atoms = np.concatenate([ca[:, None] + ATOM_OFFSETS[None, :1], ca[:, None],
                            ca[:, None] + ATOM_OFFSETS[None, 1:]], axis=1)
    with open(path, "w") as fh:
        fh.write("# seeded target\n")
        for res in atoms:
            fh.write(" " * 5 + "A" + " " * 33 + "".join(f"{v:9.3f}" for v in res.ravel()) + "\n")


def _write_train_data(root: str, rng) -> None:
    os.makedirs(os.path.join(root, "tdb"))
    os.makedirs(os.path.join(root, "aln"))
    with open(EXAMPLE_ALN) as src, open(os.path.join(root, "aln", "pf.aln"), "w") as dst:
        dst.write(src.read())
    _write_tdb(os.path.join(root, "tdb", "pf.tdb"), _chain(NRES, rng))
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV-"))
    rows = ["".join(r) for r in letters[rng.integers(0, 21, (CROP_ROWS, CROP_LEN))]]
    with open(os.path.join(root, "aln", "crop.aln"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    _write_tdb(os.path.join(root, "tdb", "crop.tdb"), _chain(CROP_LEN, rng))


def _load_batch(data_dir: str, target: str):
    from dmpfold2_tpu_torch.train.dataset import DMPDataset, pad_to_bucket
    from dmpfold2_tpu_torch.train.step import TrainBatch

    dataset = DMPDataset([[target]], data_dir, augment=False)
    return TrainBatch(*pad_to_bucket([dataset[0]]))


def phase_train(params, data_dir: str) -> int:
    """bf16 training on the card: four accumulating micro-steps and an eval
    step on "pf" (exact launch counts, parameters moving only at the
    accumulation boundary), then the crop-350 step's time, profile and
    memory. Returns the argmax kernel's launches in the micro-steps."""
    from dmpfold2_tpu_torch.train.step import leaves, make_optimizer, train_step, trainable

    dev = torch.device("cuda")
    weights = trainable(params, dev)
    optimizer = make_optimizer(weights, 1e-4, accum_steps=2)
    batch = _load_batch(data_dir, "pf")
    steps, failed, argmax_total = [], [], 0
    for k, nloops in enumerate(TRAIN_NLOOPS):
        before = [p.detach().clone() for p in leaves(weights)]
        _reset_counters()
        t0 = time.perf_counter()
        metrics = train_step(weights, optimizer, batch, seed=k, nloops=nloops, precision="bf16")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters()
        argmax_total += launches["conv5x5_maxout_diff"]
        moved = any(not torch.equal(a, p) for a, p in zip(before, leaves(weights)))
        expected = {**{name: 0 for name in launches},
                    "conv5x5_maxout_diff": BLOCKS * (nloops + 1)}
        checks = {"finite": bool(np.isfinite(metrics["loss"])),
                  "not_skipped": metrics["skipped"] == 0.0,
                  "tier_save_conv": metrics["remat"] == "save_conv",
                  "launches": launches == expected,
                  "moved_at_boundary_only": moved == (k % 2 == 1) == metrics["updated"]}
        steps.append({"micro_step": k + 1, "nloops": nloops, "loss": metrics["loss"],
                      "wall_s": wall, "launches": launches, "moved": moved, "checks": checks})
        failed += [f"micro-step {k + 1}: {c}" for c, ok in checks.items() if not ok]

    before = [p.detach().clone() for p in leaves(weights)]
    _reset_counters()
    metrics = train_step(weights, optimizer, batch, seed=9, nloops=2, train=False,
                         precision="bf16")
    launches = _read_counters()
    unchanged = all(torch.equal(a, p) for a, p in zip(before, leaves(weights)))
    eval_checks = {"finite": bool(np.isfinite(metrics["loss"])), "params_unchanged": unchanged,
                   "launches": launches == {**{n: 0 for n in launches},
                                            "conv5x5_maxout_diff": 3 * BLOCKS}}
    failed += [f"eval: {c}" for c, ok in eval_checks.items() if not ok]
    emit({"phase": "train", "part": "micro-steps", "target": "pf", "bucket": list(
        batch.alnmat.shape[1:]), "accum_steps": 2, "steps": steps,
        "eval": {"nloops": 2, "loss": metrics["loss"], "launches": launches,
                 "checks": eval_checks}})
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    del optimizer
    _train_crop(weights, data_dir)
    return argmax_total


# device-kernel name fragments of a training step -> category, first match wins
TRAIN_CATEGORIES = (
    ("argmax kernel", ("conv5x5_maxout_argmax_kernel",)),
    ("cuDNN convolutions (the block convs' dx)", ("convolution", "dgrad", "wgrad", "fprop",
                                                   "cudnn", "implicit", "xmma_conv")),
    ("GEMMs (dw taps, GRUs, input layer, head)", ("gemm", "gemv", "dot_kernel", "splitk",
                                                   "cublas", "cutlass")),
)


def _train_crop(weights, data_dir: str) -> None:
    """One warm-up step and CROP_TIMED timed steps on "crop" at nloops 3, one
    more under torch.profiler; peak memory and the remat tier."""
    from torch.profiler import ProfilerActivity, profile

    from dmpfold2_tpu_torch.train.step import make_optimizer, train_step

    optimizer = make_optimizer(weights, 1e-4)
    batch = _load_batch(data_dir, "crop")
    kw = dict(nloops=CROP_NLOOPS, precision="bf16")
    metrics = train_step(weights, optimizer, batch, seed=100, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for k in range(CROP_TIMED):
        t0 = time.perf_counter()
        metrics = train_step(weights, optimizer, batch, seed=101 + k, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    # device activity only: the step issues about 0.7 million launches, and
    # host-side events as well take minutes to aggregate
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(weights, optimizer, batch, seed=200, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat, launches, top = {}, 0, []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        ms = (us if us is not None else getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
        cat = next((c for c, frags in TRAIN_CATEGORIES
                    if any(f in evt.key.lower() for f in frags)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        launches += evt.count
        top.append({"name": evt.key[:90], "count": evt.count, "ms": ms})
    busy = sum(by_cat.values())
    emit({"phase": "train", "part": "crop", "bucket": list(batch.alnmat.shape[1:]),
          "nres": int(batch.nres[0]), "nloops": CROP_NLOOPS, "remat": metrics["remat"],
          "loss": metrics["loss"], "step_wall_s": walls,
          "step_wall_s_median": float(np.median(walls)), "peak_memory_gb": peak / 1e9,
          "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": _idle_share(busy, wall_ms), "kernel_launches": launches,
          "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
          "top_kernels": sorted(top, key=lambda t: -t["ms"])[:10]})
    if not np.isfinite(metrics["loss"]) or metrics["skipped"]:
        raise AssertionError(f"crop step: loss {metrics['loss']}, skipped {metrics['skipped']}")


@contextlib.contextmanager
def _conditioning_probe(store: dict):
    """Record, along one step's path from the trunk to the loss, each stage's
    output and the loss's gradient with respect to it: the trunk's distance
    map (MDS's input), the MDS coordinates, the coordinate head's CA trace
    (refinement's first input), the refined trace (backbone completion's
    input) and the predicted atoms; and the loss's Kabsch superposition (the
    same formula in fp64): the (3, 3) covariance's singular values and the
    rotation."""
    from dmpfold2_tpu_torch.models import gruresnet
    from dmpfold2_tpu_torch.train import loss

    originals = (loss.tmscore, gruresnet.mds_coords, gruresnet.refine_coords)

    def keep(name, t, n):
        """t and the gradient with respect to it, on the first n rows (and
        columns of the distance map), the valid ones."""
        def valid(v):
            v = v.detach().double().cpu()[:n]
            return (v[:, :n] if name == "dm" else v).reshape(-1)

        store[name] = valid(t)
        if t.requires_grad:
            t.register_hook(lambda g: store.__setitem__("grad_" + name, valid(g)))

    def mds(dm, nres, *args):
        keep("dm", dm, nres)
        out = originals[1](dm, nres, *args)
        keep("mds", out, nres)
        return out

    def refine(ca, n_steps, nres):
        # at nloops 0 the step refines twice: the first pass, then the best one
        if "raw_ca" not in store:
            keep("raw_ca", ca, nres)
            store["raw_ca_full"] = ca.detach().cpu()
        out = originals[2](ca, n_steps, nres)
        keep("refined_ca", out, nres)
        return out

    def tmscore(target_atoms, pred_atoms, n_atoms=None):
        n = target_atoms.shape[0] if n_atoms is None else n_atoms
        keep("pred_atoms", pred_atoms, n)
        p, q = (t[:n].detach().double().cpu() for t in (target_atoms, pred_atoms))
        p, q = p - p.mean(dim=0), q - q.mean(dim=0)
        u, sv, vt = torch.linalg.svd(p.T @ q)
        det = torch.linalg.det(vt.T @ u.T)
        rot = vt.T @ torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det])) @ u.T
        store.update(singular_values=sv.tolist(), rot=rot, radius=float(q.norm(dim=1).max()))
        return originals[0](target_atoms, pred_atoms, n_atoms)

    loss.tmscore, gruresnet.mds_coords, gruresnet.refine_coords = tmscore, mds, refine
    try:
        yield
    finally:
        loss.tmscore, gruresnet.mds_coords, gruresnet.refine_coords = originals


def _geometry_vjp(ca: torch.Tensor, cot: torch.Tensor, refine_steps: int, nres: int,
                  device: str, dtype) -> torch.Tensor:
    """The gradient, with respect to the coordinate head's CA trace, of the
    step's geometric tail at nloops 0 (two refinements, then backbone
    completion) for the cotangent ``cot`` on its (L, 5, 3) atoms."""
    from dmpfold2_tpu_torch.models.geometry import calpha_to_main_chain, refine_coords

    x = ca.to(device, dtype).requires_grad_()
    out = calpha_to_main_chain(refine_coords(refine_coords(x, refine_steps, nres),
                                             refine_steps, nres), nres)
    (g,) = torch.autograd.grad(out, x, cot.to(device, dtype))
    return g.detach().double().cpu().reshape(-1)


def _geometry_witness(ca: torch.Tensor, cot: torch.Tensor, refine_steps: int, nres: int) -> dict:
    """The geometric tail's gradient on the card (fp32) and on the CPU (fp32
    and fp64) for one trace and cotangent, with the cosines between them;
    ``amplification`` is |gradient| / |cotangent| in fp64."""
    card, cpu32, cpu64 = (_geometry_vjp(ca, cot, refine_steps, nres, dev, dt) for dev, dt in (
        ("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)))
    return {"card_vs_cpu": _cosine(card, cpu32), "cpu_fp32_vs_cpu_fp64": _cosine(cpu32, cpu64),
            "amplification": float(cpu64.norm() / cot.double().norm())}


def _step_grads(params, batch, device: str, precision: str, refine_steps: int,
                head_scale: float = 1.0):
    """One step's loss and gradients on ``device`` (nloops 0, no dropout, no
    teacher forcing), the gradients flattened per top-level parameter group,
    on the CPU, and what :func:`_conditioning_probe` records."""
    from dmpfold2_tpu_torch.train.step import batch_loss_native, leaves, resolve_remat, trainable

    weights = trainable(params, device)
    with torch.no_grad():
        weights["coord_fc"].mul_(head_scale)
    alnmat = torch.from_numpy(batch.alnmat).to(device)
    targets = torch.from_numpy(batch.targets).to(device)
    draws = [(False, torch.zeros(alnmat.shape[2], 3))]
    remat = resolve_remat(weights, 1, alnmat.shape[2], 0, precision == "bf16")
    probe = {}
    with _conditioning_probe(probe):
        loss, _ = batch_loss_native(weights, alnmat, targets, batch.nseqs, batch.nres, draws,
                                    nloops=0, refine_steps=refine_steps, precision=precision,
                                    remat=remat)
        names = sorted(weights)  # leaves() walks the top-level groups in this order
        grads = torch.autograd.grad(loss, [p for n in names for p in leaves(weights[n])])
    flat, k = {}, 0
    for name in names:
        n = len(leaves(weights[name]))
        flat[name] = torch.cat([g.detach().float().cpu().reshape(-1) for g in grads[k:k + n]])
        k += n
    return float(loss.detach()), flat, probe


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """In fp64: fp32 sums over millions of entries may leave [-1, 1]."""
    return float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=0))


def _trunk_grads(params, device: str, dtype):
    """The training trunk's gradient (its parameters and its input) for a
    fixed seeded input and cotangent at pf's bucket, flattened, on the CPU."""
    from dmpfold2_tpu_torch.models.trunk import trunk_apply
    from dmpfold2_tpu_torch.train.step import leaves, trainable

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, L_PAD, L_PAD, GEMM_K_IN, generator=gen).to(device).requires_grad_()
    cot = torch.randn(1, L_PAD, L_PAD, 2, generator=gen).to(device)
    row = (torch.arange(L_PAD) < NRES).float()
    mask = (row[:, None] * row[None, :])[None, :, :, None].to(device)
    weights = trainable(params["trunk"], device)
    out = trunk_apply([weights], [x], [mask], compute_dtype=dtype, remat="save_conv")
    grads = torch.autograd.grad((out * cot).sum(), [x] + leaves(weights))
    return torch.cat([g.detach().float().cpu().reshape(-1) for g in grads])


def _rotation_angle_deg(r1: torch.Tensor, r2: torch.Tensor) -> float:
    """The angle of the rotation r1 r2^T, in degrees."""
    c = ((torch.trace(r1 @ r2.T) - 1.0) / 2.0).clamp(-1.0, 1.0)
    return float(torch.rad2deg(torch.arccos(c)))


PROBE_STAGES = ("dm", "mds", "raw_ca", "refined_ca", "pred_atoms")


def phase_train_cpu(params, data_dir: str) -> None:
    """The training step on the card against the CPU (plain versions), from
    the same weights, on "pf" at nloops 0, without dropout or teacher
    forcing, for each case of TRAIN_CPU_CASES; then refinement's backward and
    the bf16 training trunk's backward alone.

    The loss is held in every case, the whole step's gradients per top-level
    parameter group (TRAIN_GRAD_COS) in the random model's fp32 step without
    refinement. The other cases are recorded with where their gradients part
    (_conditioning_probe: each stage's card-vs-CPU output difference and
    gradient cosine) and the geometric tail's gradient (refinement and
    backbone completion) on the card's CA trace, card vs CPU and CPU fp32 vs
    CPU fp64 (_geometry_witness). Refinement's backward is held on a
    protein-like trace (the "pf" target's CA, a 3.8 A walk) with a seeded
    cotangent, card vs CPU, to TRAIN_GRAD_COS. The bf16 training trunk's
    backward for a fixed input and cotangent: the card's gradient at least as
    close to the CPU's as the CPU's bf16 gradient is to its fp32 one.
    """
    batch = _load_batch(data_dir, "pf")
    rows, failed = [], []
    for model, precision, refine_steps in TRAIN_CPU_CASES:
        scale = HEAD_SCALE if model == "spread" else 1.0
        t0 = time.perf_counter()
        l_gpu, g_gpu, s_gpu = _step_grads(params, batch, "cuda", precision, refine_steps, scale)
        t1 = time.perf_counter()
        l_cpu, g_cpu, s_cpu = _step_grads(params, batch, "cpu", precision, refine_steps, scale)
        cos = {k: _cosine(g_gpu[k], g_cpu[k]) for k in g_gpu}
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        stages = {k: {"rel_diff": float((s_gpu[k] - s_cpu[k]).abs().max() / s_cpu[k].abs().max()),
                      "grad_cosine": _cosine(s_gpu["grad_" + k], s_cpu["grad_" + k])}
                  for k in PROBE_STAGES}
        # the CPU's cotangent on the valid atoms, zero on the padding
        nres, l_pad = int(batch.nres[0]), batch.alnmat.shape[2]
        cot = torch.zeros(l_pad, 5, 3, dtype=torch.float64)
        cot[:nres] = s_cpu["grad_pred_atoms"].reshape(nres, 5, 3)
        row = {"model": model, "precision": precision, "refine_steps": refine_steps,
               "head_scale": scale, "loss_cuda": l_gpu, "loss_cpu": l_cpu,
               "loss_rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL[precision],
               "grad_cosine": cos, "stages": stages,
               "superposition": {"singular_values_cuda": s_gpu["singular_values"],
                                 "singular_values_cpu": s_cpu["singular_values"],
                                 "pred_radius_cuda": s_gpu["radius"],
                                 "rotation_angle_deg": _rotation_angle_deg(s_gpu["rot"],
                                                                           s_cpu["rot"])},
               "geometry_on_card_trace": _geometry_witness(s_gpu["raw_ca_full"], cot,
                                                           refine_steps, nres),
               "cuda_s": t1 - t0, "cpu_s": time.perf_counter() - t1}
        tag = f"{model} {precision} refine {refine_steps}"
        failed += [] if rel <= TRAIN_LOSS_RTOL[precision] else [f"{tag} loss"]
        if (model, precision, refine_steps) == TRAIN_HELD_CASE:
            row["grad_cosine_min"] = TRAIN_GRAD_COS
            failed += [f"{tag} {k}" for k, c in cos.items() if not c >= TRAIN_GRAD_COS]
        rows.append(row)
    gen = torch.Generator().manual_seed(4)
    ca = torch.from_numpy(batch.targets[0, :, 1]).double()
    cot = torch.randn(ca.shape[0], 5, 3, generator=gen, dtype=torch.float64)
    cot[int(batch.nres[0]):] = 0.0
    refine_row = {"refine_steps": TRAIN_CPU_REFINE, "trace": "pf target CA",
                  **_geometry_witness(ca, cot, TRAIN_CPU_REFINE, int(batch.nres[0])),
                  "min": TRAIN_GRAD_COS}
    if not refine_row["card_vs_cpu"] >= TRAIN_GRAD_COS:
        failed.append("refinement backward on a protein-like trace")
    t0 = time.perf_counter()
    card16 = _trunk_grads(params, "cuda", torch.bfloat16)
    cpu16 = _trunk_grads(params, "cpu", torch.bfloat16)
    cpu32 = _trunk_grads(params, "cpu", torch.float32)
    trunk_row = {"card_bf16_vs_cpu_bf16": _cosine(card16, cpu16),
                 "cpu_bf16_vs_cpu_fp32": _cosine(cpu16, cpu32),
                 "seconds": time.perf_counter() - t0}
    if not trunk_row["card_bf16_vs_cpu_bf16"] >= trunk_row["cpu_bf16_vs_cpu_fp32"]:
        failed.append("bf16 trunk gradient")
    emit({"phase": "train", "part": "cpu", "target": "pf", "nloops": 0, "cases": rows,
          "refine_grad_cosine": refine_row, "trunk_grad_cosine": trunk_row})
    if failed:
        raise AssertionError(f"training step, card vs CPU: {failed}")


def main() -> None:
    # fail before printing anything without a card or without the package
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--ddp-rank"]:  # a rank of phase multi's (d)
        rank, port, data_dir, out_dir = sys.argv[2:6]
        _ddp_worker(int(rank), int(port), data_dir, out_dir)
        return
    from dmpfold2_tpu_torch.models.gruresnet import init_params

    info = phase_device()

    phase_build()
    params = init_params(seed=0, width=WIDTH, cwidth=CWIDTH, num_blocks=BLOCKS)
    rows = phase_kernels(params)
    phase_mds(params)
    launches = {precision: phase_fold(params, precision)[0] for precision in ("fp32", "bf16")}
    for precision in ("fp32", "bf16"):
        phase_profile(params, precision)
    capture = phase_cpu_bf16(params)
    phase_trunk(capture)
    phase_cpu(params)
    paths = {f"fold {p}": launches[p] for p in ("fp32", "bf16")}
    for precision in ("fp32", "bf16"):
        paths[f"batch {precision}"] = phase_batch(params, precision)
    strict = phase_strict(params)
    paths["fold fp32_strict"], paths["batch fp32_strict"] = strict["fold"], strict["batch"]
    paths["serve bf16"] = phase_serve(params)
    paths.update(phase_multi(params))
    seq = phase_seq(params)
    paths.update(seq["paths"])
    long = phase_long(params)
    paths["fold bf16 long"] = long["launches"]
    with tempfile.TemporaryDirectory() as eval_dir:
        _write_eval_data(eval_dir, np.random.default_rng(3))
        for precision, counts in phase_evaluate(params, eval_dir).items():
            paths[f"evaluate {precision}"] = counts
    batch_shapes = _batch_kernel_shapes(params, np.random.default_rng(11))
    with tempfile.TemporaryDirectory() as data_dir:
        _write_train_data(data_dir, np.random.default_rng(1))
        launches["train"] = {"conv5x5_maxout_diff": phase_train(params, data_dir)}
        paths["train bf16"] = launches["train"]
        phase_train_cpu(params, data_dir)
    # the block tail is measured at the batch shapes only
    rows["block_tail"] = {"name": "block_tail", "route": "cuda",
                          "source": "dmpfold2_tpu_torch/csrc/block_tail.cu",
                          **batch_shapes.pop("block_tail")}
    for name, row in rows.items():
        # each kernel's count from the run whose path it carries: the fp32
        # fold (vgru, rgru, refine), the bf16 fold (the two trunk kernels),
        # the training micro-steps (the argmax mode and its backward); and
        # its count in every path that launches it, each counted from 0
        engine = {"conv5x5_maxout": "bf16", "gemm_maxout": "bf16", "block_tail": "bf16",
                  "conv5x5_maxout_diff": "train"}.get(name, "fp32")
        row["launches"] = launches[engine][name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items() if c.get(name)}
        row["kernel_ms"] = row["ms"]
        if name in batch_shapes:
            row["batch_shape"] = batch_shapes[name]
        if name in seq["slab"]:
            row["slab"] = seq["slab"][name]
    rows["vgru"]["long"] = long["vgru"]
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
