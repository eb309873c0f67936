"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the reference loads nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

HERE = os.path.join(ROOT, "portbench")


def imported(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "checks.py", "design.py", "signals.py",
                 "control.py"):
        got = imported(os.path.join(HERE, name))
        assert not got & {"llzlab_tpu_torch", "llzlab_tpu", "jax"}, name


def test_no_source_reads_the_jax_benchmark():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        if "tests" in path:
            continue
        text = open(path).read()
        assert not imported(path) & {"jax", "jaxlib", "flax", "llzlab_tpu",
                                     "bench"}, path
        assert "BENCH_" not in text and "bench.py" not in text, path


def test_a_run_loads_no_jax_module():
    code = f"""
import sys
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {HERE + '/tests'!r})
from conftest import cpu_run
line = cpu_run("chan1024.1x4.rdma")
from portbench import control, core
control.run_control("fir1ch.stream", 5, 300, None)
top = {{m.split(".")[0] for m in sys.modules}}
assert "llzlab_tpu_torch" in top, "the run did not load the port"
print(sorted(top & {{"jax", "jaxlib", "flax", "llzlab_tpu"}}),
      core.forbidden_modules(), line["correct"])
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[] [] True"
