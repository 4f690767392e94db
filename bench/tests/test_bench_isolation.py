"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is the program, not ``repro``), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys

from bench_common import BENCH, ROOT, SEED

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in {"__future__", "dataclasses",
                                          "typing", "numpy", "torch"}, (
                path, name)


def test_sys_modules_after_a_run_hold_no_forbidden_name():
    code = (
        "import sys, importlib.util\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import bench.reference.replay, bench.reference.sim\n"
        "spec = importlib.util.spec_from_file_location('r', "
        f"{str(BENCH / 'run.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "m.execute('merge-study-b262k', " + str(SEED) + ", 0.1, False, 'cpu',"
        " instances=4)\n"
        "from bench import harness\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    leaked, tops = proc.stdout.strip().splitlines()[-2:]
    assert leaked == "[]"
    assert "repro_torch" in tops  # the program ran
    for name in FORBIDDEN:
        assert f"'{name}'" not in tops
