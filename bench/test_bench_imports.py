"""Nothing under bench/ imports JAX, jaxlib, flax or the JAX package
``repro`` (top-level names compared whole: the port ``repro_torch`` is
another name), and the plain reference imports nothing of the program or
of the rest of the benchmark."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere_in_the_benchmark(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "repro_torch" not in names and "bench" not in names
    assert names <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_the_walk_sees_what_it_must(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import fs\nimport repro_torch\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n"
                 "from . import sibling\n")
    assert imported(p) == {"jax", "repro", "repro_torch", "importlib", "flax"}
    assert len(SOURCES) > 10


def test_the_run_names_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    from bench import harness

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("repro_torch_probe"))
    assert harness.check_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.check_modules() == ["jax", "repro"]
