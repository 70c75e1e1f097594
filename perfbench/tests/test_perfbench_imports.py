"""What the benchmark loads: nothing of JAX or the JAX package, compared by
whole top-level name (``ray_marching_tpu_torch`` is not
``ray_marching_tpu``), and a reference that imports nothing of the
program."""

import ast
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ray_marching_tpu"}
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
                 if "tests" not in p.parts)


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_sources_import_no_jax(path):
    assert not imported_roots(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((spec.BENCH_DIR / "reference").glob("*.py")):
        roots = imported_roots(path)
        assert "ray_marching_tpu_torch" not in roots, path
        assert roots <= {"__future__", "ast", "math", "numpy", "torch",
                         "perfbench"}, path
    code = ("import sys; import perfbench.reference.render, "
            "perfbench.reference.fit, perfbench.reference.adam; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ray_marching_tpu_torch', 'ray_marching_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    """A whole small run on the CPU, then the run's own check."""
    code = (
        "import sys, torch; sys.path.insert(0, 'perfbench/tests'); "
        "from conftest import small_cell; from perfbench import run; "
        "cell = small_cell('siren_w256_serve_512', 32, 32); "
        "res = run.run_cell(cell, 7, 0.2, True, 'cpu', 0.0); "
        "print(run.loaded_forbidden(), res.attempted > 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result (on a machine without one)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "siren_w256_serve_512", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    program is missing: a run fails and prints no result line."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_out"))
    code = (
        "import sys, json; sys.path.insert(0, 'perfbench/tests'); "
        "from conftest import small_cell; from perfbench import run; "
        "cell = small_cell('siren_w256_serve_512', 32, 32); "
        "print(json.dumps({'correct': True})) if run.run_cell("
        "cell, 7, 0.2, False, 'cpu', 0.0) else None")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "ray_marching_tpu_torch" in out.stderr
