# Copied from benchmarks/common.py; the benchmarks. imports are rewritten, and the
# torch device that the figures run on is added at the end.
"""Shared helpers: CSV emission + claim checks printed as derived rows.

``benchmarks_torch.run`` points ``OUT`` at a file to mirror every row (the CI
artifact) and reads ``FAILURES`` to turn failed claims into a nonzero exit
code — pipeline-safe, unlike shell ``! grep`` post-processing.
"""
from __future__ import annotations

from typing import Optional, TextIO

OUT: Optional[TextIO] = None  # mirror target for every emitted row
FAILURES = 0  # claim checks that failed since process start


def emit(name: str, value, derived: str = ""):
    line = f"{name},{value},{derived}"
    print(line)
    if OUT is not None:
        OUT.write(line + "\n")
        OUT.flush()


def check(name: str, cond: bool, detail: str = ""):
    global FAILURES
    if not cond:
        FAILURES += 1
    emit(f"claim/{name}", "PASS" if cond else "FAIL", detail)
    return cond


# The torch device that every figure's OffloadDB, OffloadPrep, KvCacheStore,
# model, params and prompts live on: the card unless the caller says
# otherwise. ``benchmarks_torch.run --device`` sets it; a figure run alone
# reads ``--device`` from its own command line.
DEVICE = "cuda"


def device() -> str:
    """The figures' torch device: ``--device NAME`` on the command line,
    else ``DEVICE``. A CUDA device without a card raises: nothing carries
    on on the CPU in its place."""
    import sys

    import torch

    argv = sys.argv
    name = argv[argv.index("--device") + 1] if "--device" in argv[:-1] else DEVICE
    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} needs a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    return name


def sync(dev: str) -> None:
    """Wait for the work queued on ``dev``, so that a wall-clock time ends
    when the device is done."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


# The claims that time the host's wall clock. They keep the reference's
# thresholds and are reported as measured; on another host (a card's, a
# loaded CI runner) they may fail where every functional claim holds.
WALL_CLOCK = (
    "fig15/async_2x_at_4_shards",
    "fig18/ingest_speedup",
    "fig19/recovered_throughput",
    "fig20/attach_beats_recompute_2x",
    "fig20/full_width/attach_beats_recompute_2x",
    "fig22/tier_beats_nvme_1p3x",
)
