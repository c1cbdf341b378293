"""Nothing that portbench/run.py runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (speedy_tpu_torch begins with speedy_tpu)."""

import ast
import json
import subprocess
import sys

from portbench.tests.small import ROOT

JAX = {"jax", "jaxlib", "flax", "speedy_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not top_level_imports(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert not top_level_imports(path) & (JAX | {"speedy_tpu_torch", "portbench"}), path


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.reference.plain
ref_only = sorted({{m.split('.')[0] for m in sys.modules}} & {{'speedy_tpu_torch', 'speedy_tpu', 'jax'}})
from portbench import run
from portbench.tests.small import run_small
for w in ("corpus16k.b128", "file16k.nonlinear"):
    run_small(w, trace=True)
print(json.dumps({{"ref": ref_only, "run": run.forbidden_modules(),
                  "port": "speedy_tpu_torch" in sys.modules}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen == {"ref": [], "run": [], "port": True}
