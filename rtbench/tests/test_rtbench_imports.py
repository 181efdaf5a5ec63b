"""The import guard: nothing under rtbench imports jax, jaxlib, flax or
rtk_tpu (whole top-level names: rtk_tpu_torch is the program), and the
yardstick's files (the reference, the work count, the generators, the
trace reduction, the metric readers) import nothing of the program at
all.  The run itself checks sys.modules the same way before it prints."""
import ast
import sys
from pathlib import Path

import pytest

from rtbench import harness

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
# Files that drive the program (and the tests, which compare with it):
# the harness, the calibration, the command and the query kinds (the
# timed call; their checks read the program's records only to judge
# them).
DRIVERS = {"harness.py", "calibrate.py", "run.py"}


def drives(p):
    rel = p.relative_to(BENCH).parts
    return p.name in DRIVERS or rel[0] in ("queries", "tests")


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in FILES if not drives(p)],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "rtk_tpu_torch" not in top_level_imports(path)
    # Nor by a name in a string (importlib).
    assert not any(isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and n.value.startswith("rtk_tpu")
                   for n in ast.walk(ast.parse(path.read_text())))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rtk_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "rtk_tpu.ops", object())
    assert set(harness.forbidden_modules()) >= {"jax", "rtk_tpu"}


def test_the_whole_harness_loads_none():
    import subprocess

    code = ("import sys; sys.path[0] = %r; from rtbench import harness, "
            "calibrate; import rtk_tpu_torch; "
            "print(harness.forbidden_modules())" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
