"""The harness finds every configuration, traffic mix, limit file and metric
by name, and a new one added as files and entries alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_cuda import harness, runner
from bench_cuda.tests import toy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    man = harness.manifest(toy.ROOT)
    for w in man["workloads"]:
        cfg = harness.config(man, toy.ROOT, w["config"])
        assert cfg["precision"] in ("bf16", "fp32")
        params = harness.traffic(w["traffic"])
        assert hasattr(params["module"], "make")
        lims = harness.limits(w["name"])
        assert set(lims) >= {"trunk", "refine", "passes"}
        for kind in ("end_to_end", "per_layer"):
            entries = harness.metrics_of(man, w["name"], kind)
            assert entries, (w["name"], kind)
            for m in entries:
                assert callable(harness.reader(m["name"]))
        assert "setup_s" in {m["name"] for m in harness.metrics_of(man, w["name"], "end_to_end")}


def test_manifest_keeps_the_contract():
    man = harness.manifest(toy.ROOT)
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in man[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in man["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = next(e for e in man["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_a_cell_config_and_metric_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a metric by new files and new entries; no existing file changes, and
    the toy run reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(toy.ROOT / "bench_cuda", root / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(toy.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    base = root / "bench_cuda"
    cfg = json.loads((base / "configs" / "dmpfold2-bf16.json").read_text())
    (base / "configs" / "dmpfold2-fp32-small.json").write_text(
        json.dumps({**cfg, "precision": "fp32", "num_blocks": 4}))
    mix = json.loads((base / "traffic" / "pfam256-b8.json").read_text())
    (base / "traffic" / "pfam64-b4.json").write_text(json.dumps({**mix, "nres": [57, 64],
                                                                 "batch_size": 4}))
    (base / "limits" / "fp32-pfam64-b4.json").write_text(
        (base / "limits" / "bf16-pfam256-b8.json").read_text())
    (base / "metrics" / "targets_seen.batch.py").write_text(
        "def read(ctx):\n    return float(ctx['attempted'])\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dmpfold2-fp32-small", "source": "https://example.org",
                           "file": "bench_cuda/configs/dmpfold2-fp32-small.json",
                           "reduced": ["num_blocks"], "why": "test"})
    man["workloads"].append({"name": "fp32-pfam64-b4", "config": "dmpfold2-fp32-small",
                             "traffic": "pfam64-b4", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "targets_seen.batch", "unit": "targets", "better": "higher",
                             "source": "host_clock", "layer": "batch engine",
                             "moves": "targets_per_s", "workloads": ["fp32-pfam64-b4"]})
    next(m for m in man["end_to_end"] if m["name"] == "targets_per_s")["workloads"].append(
        "fp32-pfam64-b4")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert all(p.read_bytes() == b for p, b in before.items())

    spec = toy.spec("fp32-pfam64-b4", root=root)
    assert spec.cfg["num_blocks"] == toy.TOY_WIDTHS["num_blocks"]
    out = runner.run(spec)
    ctx = runner.context(spec, out)
    man = harness.manifest(root)
    entries = harness.metrics_of(man, "fp32-pfam64-b4", "per_layer")
    assert "targets_seen.batch" in {m["name"] for m in entries}
    value = harness.reader("targets_seen.batch", base)(ctx)
    assert value == out.attempted > 0
    assert out.correct, out.checks


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_listed_for_a_cell_are_the_manifests(kind):
    man = harness.manifest(toy.ROOT)
    got = {m["name"] for m in harness.metrics_of(man, "bf16-pfam256-b8", kind)}
    if kind == "end_to_end":
        assert got == {"targets_per_s", "setup_s"}
    else:
        assert "conv5x5_roofline.batch" in got and "vgru_roofline.long" not in got
