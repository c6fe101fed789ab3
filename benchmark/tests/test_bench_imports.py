"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (``reductive_tpu_torch`` is not ``reductive_tpu``)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import run

JAX = {"jax", "jaxlib", "flax", "reductive_tpu"}
PROGRAM = {"reductive_tpu_torch"}
FILES = sorted(p for p in run.BENCH.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((run.BENCH / "reference").glob("*.py"))
ROOT = run.ROOT


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(run.BENCH)))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | PROGRAM)
    assert top_level_imports(path) <= {"__future__", "contextlib", "torch"}


def _loaded_after(code: str, cwd=None) -> set:
    """Top-level names loaded once ``code`` has run in a fresh process from
    ``cwd`` (the repository's root: there the program is found too)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd or ROOT, env=env, capture_output=True, text=True, check=True,
                         timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def check_no_jax(cwd=None):
    """A traced run of every cell that carries its CPU cut, in the
    benchmark at ``cwd``, loads the program and no JAX."""
    code = ("from benchmark.tests import cells\n"
            "from benchmark import run\n"
            "for cell in cells.ready(run.load_json(run.ROOT / 'BENCHMARK.json')):\n"
            "    cells.run_tiny(cell, trace=True)\n"
            "assert not run.forbidden_modules()\n")
    loaded = _loaded_after(code, cwd)
    assert "reductive_tpu_torch" in loaded
    assert not loaded & JAX


def test_a_run_of_every_cell_loads_no_jax():
    check_no_jax()


def test_the_reference_loads_nothing_of_the_program():
    code = "".join(f"import benchmark.reference.{p.stem}\n" for p in REFERENCE)
    assert not _loaded_after(code) & (JAX | PROGRAM)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reductive_tpu_torch_extra", sys)
    assert "reductive_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
