"""No run loads JAX or the JAX package, and the reference imports nothing of
the program.  Module names are compared by their whole top-level name: the
port's, ``aa_rmvsnet_tpu_torch``, begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import run as runner
from benchmark.manifest import HERE, ROOT


def _top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "aa_rmvsnet_tpu_torch_probe.x", None)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "aa_rmvsnet_tpu.models", None)
    monkeypatch.setitem(sys.modules, "jaxlib", None)
    assert runner.forbidden_modules() == ["aa_rmvsnet_tpu", "jaxlib"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert _top_level_imports(path) <= {"__future__", "math", "torch"}, path


def test_no_benchmark_file_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not _top_level_imports(path) & set(runner.FORBIDDEN), path


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "from benchmark.tests.toy import work\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "for cell in ('dtu_eval.evidential', 'dtu_train.evidential'):\n"
        "    run_cell(cell, 5, 0.0, False, 'cpu', work=work(cell))\n"
        "print('loaded', forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded []"


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    """Where only BENCHMARK.json and the benchmark's files are, a run fails
    and prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = "from benchmark.run import run_cell; print(run_cell('dtu_eval.defaults', 1, 0.0, False, 'cpu'))"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "aa_rmvsnet_tpu_torch" in out.stderr
