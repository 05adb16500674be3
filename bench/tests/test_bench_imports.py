"""The import rule: nothing under bench/ imports JAX or the JAX package, the
yardstick's files (every architecture's plain file among them) import
nothing of the program, and of the harness only ``system.py`` and the
bridges (``bridges/*.py``) import it."""
import ast

import pytest

from _tiny import ROOT

BENCH = ROOT / "bench"
FILES = sorted(p for p in BENCH.rglob("*.py"))
#: the files that may not import the program: the reference and what it and
#: the comparison read
PLAIN = ("reference.py", "inputs.py", "counts.py", "check.py", "spec.py",
         "traffic/sessions.py") + tuple(sorted(
             str(p.relative_to(BENCH)) for p in (BENCH / "arch").glob("*.py")))
#: the harness's files that drive the program
PROGRAM = ("system.py",) + tuple(sorted(
    str(p.relative_to(BENCH)) for p in (BENCH / "bridges").glob("*.py")))


def top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_names(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name", PLAIN)
def test_reference_side_imports_no_program(name):
    assert "repro_torch" not in top_names(BENCH / name)


def test_only_system_and_the_bridges_import_the_program():
    assert "arch/llama.py" in PLAIN and "bridges/llama.py" in PROGRAM
    harness = [p for p in FILES if "tests" not in p.relative_to(BENCH).parts]
    importing = {str(p.relative_to(BENCH)) for p in harness
                 if "repro_torch" in top_names(p)}
    assert importing == set(PROGRAM)
