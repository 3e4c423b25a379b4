"""No JAX, no JAX package: the run's check of ``sys.modules``, the sources'
imports, and the watchdog that ends a run that overruns."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

from bench_cuda import harness
from bench_cuda.tests import toy

BENCH = toy.ROOT / "bench_cuda"


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmpfold2_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dmpfold2_tpu.engine", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["dmpfold2_tpu"]


def test_reference_imports_nothing_of_jax_or_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "dmpfold2_tpu",
                                     "dmpfold2_tpu_torch"}, path


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"jax", "jaxlib", "flax", "dmpfold2_tpu"}, path


def test_a_toy_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_cuda import harness, runner\n"
            "from bench_cuda.tests import toy\n"
            "out = runner.run(toy.spec('bf16-pfam256-b8'))\n"
            "assert out.correct\n"
            "print(harness.forbidden_modules())\n") % str(toy.ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_watchdog_ends_an_overrun_without_a_result():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from bench_cuda import run\n"
            "run._watchdog(0.5)\n"
            "time.sleep(30)\n"
            "print('{\"correct\": true}')\n") % str(toy.ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "overran" in res.stderr
