"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.run import ROOT

from .conftest import SEED

BENCH = ROOT / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "epitpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in list((BENCH / "reference").rglob("*.py")) + [BENCH / "dataset.py",
                                                              BENCH / "ess.py",
                                                              BENCH / "roofline.py"]:
        tops = {_top(n) for n in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "math", "typing", "torch", "numpy"}, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A tiny cell in a fresh process: the top-level name of every loaded
    module, compared whole ("epitpu_torch" is not "epitpu")."""
    code = (
        "import sys\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "from benchmark.tests.conftest import TINY\n"
        "run_cell('sir_abc.batch65536', %d, 0.1, False, 'cpu',\n"
        "         traffic_overrides=TINY['sir_abc.batch65536'])\n"
        "assert 'epitpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n" % SEED
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """On this machine torch sees no CUDA device: the command exits non-zero
    and prints nothing on standard output."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would print its result")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "sir_abc.batch65536", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
