# Port of benchmarks/roofline_report.py: it reads the port's dry-run rows from a file of its own.
"""§Roofline report: render the port's dry-run sweep as the
per-(arch × cell × mesh) three-term roofline table. The rows come from

    PYTHONPATH=src python -m repro_torch.launch.dryrun --both --out results/dryrun_torch.jsonl

(or ``scripts/dryrun_parallel.py``'s JSON lines, written to that file);
each row names the torch release that traced it."""
from __future__ import annotations

import json
import os

from benchmarks_torch.common import emit

RESULTS = ["results/dryrun_torch.jsonl"]


def load_rows():
    rows = {}
    for path in RESULTS[::-1]:  # later files override
        if not os.path.exists(path):
            continue
        for line in open(path):
            d = json.loads(line)
            rows[(d["arch"], d["cell"], d["mesh"])] = d
    return rows


def main():
    rows = load_rows()
    if not rows:
        emit("roofline/status", "NO_RESULTS",
             f"run repro_torch.launch.dryrun --both --out {RESULTS[0]} first")
        return
    ok = skip = 0
    for (arch, cell, mesh), d in sorted(rows.items()):
        if d["status"] == "SKIP":
            emit(f"roofline/{arch}/{cell}/{mesh}", "SKIP", d["reason"][:60])
            skip += 1
            continue
        if d["status"] != "OK":
            emit(f"roofline/{arch}/{cell}/{mesh}", "FAIL", d.get("error", "")[:80])
            continue
        ok += 1
        emit(
            f"roofline/{arch}/{cell}/{mesh}",
            f"{max(d['t_compute_ms'], d['t_memory_ms'], d['t_collective_ms']):.2f}",
            f"bottleneck={d['bottleneck']} tc={d['t_compute_ms']:.2f}ms "
            f"tm={d['t_memory_ms']:.2f}ms tx={d['t_collective_ms']:.2f}ms "
            f"mem={d['mem_per_dev_GiB']}GiB useful={d['useful_ratio']:.2f} "
            f"coll_GB={d['coll_bytes_per_dev'] / 1e9:.4f} torch={d.get('torch', '?')}",
        )
    emit("roofline/cells_ok", ok, f"skipped={skip}")


if __name__ == "__main__":
    main()
