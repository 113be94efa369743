#!/usr/bin/env python3
"""The rows of two dry runs that differ: each run's JSON lines (from
``python -m repro_torch.launch.dryrun --out`` or ``scripts/dryrun_parallel.py``),
matched by (arch, cell, mesh).

    python3 scripts/dryrun_diff.py A.jsonl B.jsonl [--tol 0.005]

Prints one line per row whose status differs, or whose collective wire
bytes per device or peak bytes differ by more than ``--tol`` (relative),
with both runs' values and torch releases; then ``rows=N differ=M``. Lines of either file that are not JSON objects are
skipped.
"""
from __future__ import annotations

import argparse
import json


def load(path):
    rows = {}
    for line in open(path, encoding="utf-8"):
        if line.startswith("{"):
            d = json.loads(line)
            rows[(d["arch"], d["cell"], d["mesh"])] = d
    return rows


def off(a, b, tol) -> bool:
    return abs(a - b) > tol * max(abs(a), abs(b), 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--tol", type=float, default=0.005)
    args = ap.parse_args(argv)
    a, b = load(args.a), load(args.b)
    differ = 0
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key, {}), b.get(key, {})
        what = []
        if ra.get("status") != rb.get("status"):
            what.append(f"status {ra.get('status')} / {rb.get('status')}")
        elif ra.get("status") == "OK":
            for k in ("coll_bytes_per_dev", "peak_bytes"):
                if off(ra[k], rb[k], args.tol):
                    what.append(f"{k} {ra[k] / 1e9:.4f} / {rb[k] / 1e9:.4f} GB")
        if what:
            differ += 1
            print(f"{'/'.join(key)} (torch {ra.get('torch')} / {rb.get('torch')}): "
                  + "; ".join(what))
    print(f"rows={len(set(a) | set(b))} differ={differ}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
