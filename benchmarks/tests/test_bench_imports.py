"""What a run loads: never JAX nor the JAX package, and the reference
nothing of the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
import types

from benchmarks import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "cudacam_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").rglob("*.py"):
        assert set(_imports(path)) <= {"__future__", "typing", "torch", "numpy"}, path


def test_a_run_loads_no_forbidden_module():
    """A whole CPU run in a fresh process, then the process's modules."""
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]);"
        "from benchmarks import harness; from benchmarks.tests.helpers import small_run;"
        "r = small_run(harness.Suite.load(), 'mega8k.tiles_calm', seconds=0.1);"
        "print(json.dumps([r['correct'], harness.forbidden_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules})]))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)], capture_output=True,
                         text=True, timeout=300, check=True, env=env).stdout
    correct, found, tops = json.loads(out.strip().splitlines()[-1])
    assert correct and found == [] and not set(tops) & FORBIDDEN
    assert "cudacam_tpu_torch" in tops


def test_the_look_for_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cudacam_tpu_torch_x", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cudacam_tpu.ops", types.ModuleType("cudacam_tpu.ops"))
    assert harness.forbidden_modules() == ["cudacam_tpu"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "cam1080p.x8_calm",
                        "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""
    # A checkout holding only BENCHMARK.json and the benchmark's files.
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "cam1080p.x8_calm",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""
