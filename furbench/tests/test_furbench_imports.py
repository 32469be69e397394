"""No module a benchmark run imports is JAX or the JAX package, and the
reference imports nothing of the port."""

import ast
import subprocess
import sys

from furbench import harness

from conftest import CHECKOUT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in (harness.ROOT / "furref").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"ba_pathtracing_fur_torch", *harness.FORBIDDEN}, path


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in harness.ROOT.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "ba_pathtracing_fur_tpu_x", sys)
    assert "jax" not in harness.forbidden_modules()
    assert "ba_pathtracing_fur_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_a_tiny_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from furbench import harness\n"
            "from furbench.tests.conftest import tiny\n"
            "res, _ = harness.run('hairball.progressive', 7, 0.2, False, time.perf_counter(),"
            " device='cpu', overrides=tiny('hairball.progressive'))\n"
            "assert res['correct'], res\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "ba_pathtracing_fur_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_run_exits_without_a_result_where_no_card_is():
    out = subprocess.run([sys.executable, "furbench/run.py", "--workload",
                          "hairball.progressive", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=CHECKOUT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
