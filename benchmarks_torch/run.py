# Port of benchmarks/run.py: the same modules and flags, on repro_torch, with --device.
"""Benchmark harness: one module per paper figure (+ the roofline report).
Prints ``name,value,derived`` CSV rows; claim checks appear as
``claim/<name>,PASS|FAIL``. Usage::

    PYTHONPATH=src python -m benchmarks_torch.run [--smoke] [--out bench.csv] [--device cpu]

``--smoke`` runs the fast subset only (the CI job). ``--out`` mirrors every
CSV row to a file (uploaded as a CI artifact). The exit code is the number
of failed claims plus crashed modules — CI gates on it directly instead of
grepping the output (shell ``! grep`` masks pipeline errors under
``pipefail``). ``--device`` names the torch device of every figure's
OffloadDB, OffloadPrep, KV store and model (default ``cuda``; without a
card that raises before any figure runs).

Every module, the paper figure it reproduces, how to run it standalone,
and its pass thresholds are documented in ``docs/BENCHMARKS.md``.
"""
import importlib
import sys
import time

from benchmarks_torch import common

MODULES = [
    "benchmarks_torch.fig2_fs_overhead",
    "benchmarks_torch.fig7a_offload_levels",
    "benchmarks_torch.fig7b_prep_ratio",
    "benchmarks_torch.fig8_db_scalability",
    "benchmarks_torch.fig9_prep_scalability",
    "benchmarks_torch.fig10_designs",
    "benchmarks_torch.fig11_latency_throughput",
    "benchmarks_torch.fig12_cache_timeline",
    "benchmarks_torch.fig13_cache_pollution",
    "benchmarks_torch.fig14_sharded_plane",
    "benchmarks_torch.fig15_async_wal",
    "benchmarks_torch.fig16_striped_extents",
    "benchmarks_torch.fig17_rebalance",
    "benchmarks_torch.fig18_prep_pipeline",
    "benchmarks_torch.fig19_router_failover",
    "benchmarks_torch.fig20_kv_serving",
    "benchmarks_torch.fig21_pushdown",
    "benchmarks_torch.fig22_memtier",
    "benchmarks_torch.roofline_report",
]

SMOKE_MODULES = [
    "benchmarks_torch.fig2_fs_overhead",
    "benchmarks_torch.fig14_sharded_plane",
    "benchmarks_torch.fig15_async_wal",
    "benchmarks_torch.fig16_striped_extents",
    "benchmarks_torch.fig17_rebalance",
    "benchmarks_torch.fig18_prep_pipeline",
    "benchmarks_torch.fig19_router_failover",
    "benchmarks_torch.fig20_kv_serving",
    "benchmarks_torch.fig21_pushdown",
    "benchmarks_torch.fig22_memtier",
    "benchmarks_torch.roofline_report",
]

USAGE = """\
usage: PYTHONPATH=src python -m benchmarks_torch.run [--smoke] [--out FILE] [--device DEV]

  --smoke   fast subset only (the CI bench-smoke job)
  --out F   mirror every CSV row to F (uploaded as a CI artifact)
  --device D  torch device of the figures (default cuda; cpu on a host
            without a card)

Exit code = failed claims + crashed modules. Per-figure documentation
(paper figure, how to run standalone, pass thresholds): docs/BENCHMARKS.md
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--help" in argv or "-h" in argv:
        print(USAGE)
        return 0
    modules = SMOKE_MODULES if "--smoke" in argv else MODULES
    for flag in ("--out", "--device"):
        i = argv.index(flag) if flag in argv else None
        if i is not None and (i + 1 >= len(argv) or argv[i + 1].startswith("-")):
            print(USAGE, file=sys.stderr)
            return 2
    if "--device" in argv:
        common.DEVICE = argv[argv.index("--device") + 1]
    print(f"# device {common.device()}", flush=True)  # raises without the card it names
    if "--out" in argv:
        common.OUT = open(argv[argv.index("--out") + 1], "w")
    t0 = time.time()
    crashes = 0
    for mod in modules:
        print(f"# === {mod} ===", flush=True)
        t = time.time()
        try:
            importlib.import_module(mod).main()
        except Exception as e:  # noqa: BLE001
            common.emit(f"claim/{mod}/crashed", "FAIL",
                        f"{type(e).__name__}: {e}")
            crashes += 1
        print(f"# {mod} took {time.time()-t:.1f}s", flush=True)
    print(f"# total {time.time()-t0:.1f}s "
          f"({common.FAILURES} failed claims, {crashes} crashes)")
    if common.OUT is not None:
        common.OUT.close()
    return min(crashes + common.FAILURES, 125)


if __name__ == "__main__":
    sys.exit(main())
