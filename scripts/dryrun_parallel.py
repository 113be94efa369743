#!/usr/bin/env python3
"""The whole dry run with its cells in parallel processes.

    PYTHONPATH=src python3 scripts/dryrun_parallel.py [--jobs 8] [--arch A ...]

Runs ``python -m repro_torch.launch.dryrun --arch A --cell C --single-pod``
(or ``--multi-pod``) once per (mesh, arch, cell), ``--jobs`` at a time,
each in a process of its own (each sets up its own ``fake`` process group),
and prints the rows in the order of ``dryrun --both`` (meshes, then archs,
then cells), then ``done; failures=N``. A cell that exits without a row
counts as a failure and prints a FAIL row naming its exit code and last
error line. Each cell's trace is the same program as in the serial run, in
a fresh process. No cell has a time limit of its own: bound the whole run
from outside.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def run_one(arch: str, cell: str, multi_pod: bool) -> dict:
    mesh = "2x16x16" if multi_pod else "16x16"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                               if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell", cell,
           "--multi-pod" if multi_pod else "--single-pod"]
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True)
    for line in p.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    return {"arch": arch, "cell": cell, "mesh": mesh, "status": "FAIL",
            "error": f"exit {p.returncode}: {(p.stderr.strip().splitlines() or [''])[-1]}"}


def main(argv=None) -> int:
    from repro_torch.launch.specs import ALL_ARCHS
    from repro_torch.models.config import SHAPE_CELLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--arch", action="append", help="an arch (repeatable; default all)")
    a = ap.parse_args(argv)
    jobs = [(arch, cell, mp) for mp in (False, True) for arch in (a.arch or ALL_ARCHS)
            for cell in SHAPE_CELLS]
    with ThreadPoolExecutor(a.jobs) as pool:
        rows = list(pool.map(lambda j: run_one(*j), jobs))
    for r in rows:
        print(json.dumps(r), flush=True)
    failures = sum(r["status"] == "FAIL" for r in rows)
    print(f"done; failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
