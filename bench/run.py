#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload glm4-9b.long_prompt --seed 7 --seconds 10 --trace 0

Sets up (imports, weights from the seed on the card, one prefill of every
shape the cell's traffic can send), measures for ``--seconds``, checks
what the window produced against the plain reference, and prints the
numbers compared beside their limits as the last lines of standard error
and one JSON object as the last line of standard output. ``--trace 1``
records the window's first requests with ``torch.profiler`` (device
activity only, then a few with the host's operations for the breakdown of
idle gaps) and reports the per-layer metrics instead of the end-to-end
ones. Exits non-zero,
printing no result, without enough CUDA devices for the cell, or when the
process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_DIRS.items():  # build caches at fixed paths in the checkout
        os.environ[var] = str(ROOT / "build" / "bench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                         t_start=T_START)
    forbidden = harness.check_modules()  # the window has closed
    if forbidden:
        print(f"modules loaded that the benchmark forbids: {forbidden}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_name()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
