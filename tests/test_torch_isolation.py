"""The port imports neither jax nor anything of the JAX package.

``repro_torch`` keeps its own copies of the ``repro`` modules it needs; a
subprocess imports every one of its modules and finds no ``jax`` and no
``repro``/``repro.*`` in ``sys.modules``, and an AST walk over its sources
finds no such import, lazy ones included. The port's evaluation,
``benchmarks_torch`` and ``examples_torch``, is held the same way, and
neither it nor the package imports the reference's ``benchmarks`` or
``examples``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PKG = SRC / "repro_torch"
# the port's evaluation: top-level trees beside the reference's
EVAL = [ROOT / "benchmarks_torch", ROOT / "examples_torch"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "ml_dtypes", "benchmarks", "examples")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path
    for tree in EVAL:
        for path in sorted(tree.glob("*.py")):
            yield f"{tree.name}.{path.stem}", path


def test_importing_every_module_loads_no_jax_and_no_repro():
    names = [m for m, _ in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(names) >= 25
    assert sum(m.startswith(("benchmarks_torch.", "examples_torch.")) for m in names) == 24


def test_sources_import_no_jax_and_no_repro():
    found = []
    for mod, path in _modules():
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                targets = [node.module]
            else:
                continue
            for t in targets:
                if t.split(".")[0] in FORBIDDEN:
                    found.append(f"{mod}:{node.lineno} imports {t}")
    assert not found, found
