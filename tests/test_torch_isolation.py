"""The port imports neither jax nor anything of the JAX package.

``repro_torch`` keeps its own copies of the ``repro`` modules it needs; a
subprocess imports every one of its modules and finds no ``jax`` and no
``repro``/``repro.*`` in ``sys.modules``, and an AST walk over its sources
finds no such import, lazy ones included.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def test_importing_every_module_loads_no_jax_and_no_repro():
    names = [m for m, _ in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(names) >= 25


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
                root = t.split(".")[0]
                if root in ("jax", "jaxlib", "repro", "flax", "ml_dtypes"):
                    found.append(f"{mod}:{node.lineno} imports {t}")
    assert not found, found
