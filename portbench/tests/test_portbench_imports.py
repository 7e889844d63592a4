"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, and the reference loads nothing of the program either. Top-level
module names are compared whole: the port's name begins with the JAX
package's. A family's modules are named only by its own two files."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "paa_tpu"}

PROBE = """
import sys, torch
sys.path.insert(0, {root!r})
from portbench import calibrate, check, counts, faults, inputs, repeat, run, system, trace
from portbench.tests import tiny
r = run.Run(tiny.cell("wav2vec2-large-lv60", "eval"), 9, torch.device("cpu"))
r.window(0.0)
r.free()
r.numbers()
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _modules(path) -> set:
    """Every module ``path`` imports, ``from a import b`` as ``a.b``."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def _imports(path) -> set:
    return {m.split(".")[0] for m in _modules(path)}


def test_a_cpu_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "paa_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_sources_import_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"paa_tpu_torch"}), path


def test_only_a_familys_own_files_name_its_modules():
    """No module of the harness but ``families/<family>.py`` and
    ``reference/<family>.py`` imports a module named after a family: the
    program's model of it, its reference, or its family file. The rest
    finds them through ``portbench.family`` by the configuration's name."""
    families = {p.stem for p in (ROOT / "portbench" / "families").glob("*.py")}
    assert "wav2vec2" in families
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.parent.name in ("families", "reference") and path.stem in families:
            continue
        for module in _modules(path):
            assert not set(module.split(".")) & families, (path, module)
