"""The import guard: nothing under slam_bench/ loads JAX or the JAX
package (top-level names compared whole), and the reference loads nothing
of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from slam_bench import harness

BENCH = Path(harness.BENCH_DIR)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_whole_name_comparison():
    mods = ["droid_slam_tpu_torch", "droid_slam_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy", "droid_slam_tpu.ops", "flax"]) == [
        "droid_slam_tpu.ops", "flax", "jax.numpy"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN_MODULES + ("droid_slam_tpu_torch",), (path, mod)


def test_a_run_process_holds_no_forbidden_module():
    # a fresh interpreter, as a run is: the harness, the program, the
    # reference and every metric reader loaded
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from slam_bench import harness, run, check, control\n"
        "import slam_bench.reference.runtime.droid, slam_bench.reference.models.weights\n"
        "run.import_port()\n"
        "spec = harness.benchmark_spec()\n"
        "[harness.load_module('metrics', m['name']) for m in spec['per_layer']]\n"
        "[harness.load_module('drivers', w) for w in ('track_sessions',)]\n"
        "found = harness.forbidden_modules()\n"
        "assert not found, found\n"
        "assert 'droid_slam_tpu_torch' in sys.modules\n"
    )
    root = str(BENCH.parent)
    subprocess.run([sys.executable, "-c", code, root], check=True, timeout=300, cwd=root)


def test_the_reference_alone_loads_no_program_module():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import slam_bench.reference.runtime.droid, slam_bench.reference.models.weights\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('droid_slam_tpu_torch', 'droid_slam_tpu', 'jax')]\n"
        "assert not bad, bad\n"
    )
    root = str(BENCH.parent)
    subprocess.run([sys.executable, "-c", code, root], check=True, timeout=300, cwd=root)
