"""Helpers of the ``benchmarks_torch`` tests: run a figure module and
capture its rows, and hold the port's figure to the JAX package's."""
import importlib
import io
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # the benchmark trees are top-level packages
    sys.path.insert(0, str(ROOT))

from benchmarks_torch import common as TC  # noqa: E402

# rows whose value reads the wall clock, or the order in which threads ran
# (the rebalancer's telemetry in fig17, the producer's lead at fig18's
# checkpoint): they differ between two runs of the same module
RACY = {
    "fig15_async_wal": r"fig15/put_us/.*|claim/fig15/async_2x_at_4_shards",
    "fig17_rebalance": (r"fig17/busiest_fifo_share|claim/fig17/skew_reduced|"
                        r"fig17/migration_replay|claim/fig17/migration_charged|"
                        r"fig17/lease_journal"),
    "fig18_prep_pipeline": (r"fig18/attempt\d+|fig18/ingest_throughput|"
                            r"claim/fig18/ingest_speedup|fig18/resume"),
    "fig19_router_failover": r"fig19/throughput|claim/fig19/recovered_throughput",
    "fig20_kv_serving": r"fig20/ttft_ms|claim/fig20/attach_beats_recompute_2x",
    "fig22_memtier": r"fig22/read_throughput_mbps|claim/fig22/tier_beats_nvme_1p3x",
}
# rows whose value holds but whose text reads thread timing (the staging
# queue's occupancy when the consumer arrives), or names the package (the
# roofline report's hint names the dry run to run): name and value compared
VALUE_ONLY = {
    "fig18_prep_pipeline": r"claim/fig18/queue_bounded",
    "roofline_report": r"roofline/status",
}


def rows(common, module, argv, monkeypatch):
    """Run ``module.main()`` with ``argv`` as its command line; returns its
    CSV rows as (name, value, derived)."""
    buf = io.StringIO()
    monkeypatch.setattr(common, "OUT", buf)
    monkeypatch.setattr(sys, "argv", argv)
    module.main()
    return [tuple(line.split(",", 2)) for line in buf.getvalue().splitlines()]


def compare_with_reference(name, monkeypatch):
    """Two runs of the JAX figure and one of the port's on the CPU; returns
    the port's rows after holding them to the reference's."""
    pytest.importorskip("jax")
    from benchmarks import common as JC

    jax_mod = importlib.import_module(f"benchmarks.{name}")
    port_mod = importlib.import_module(f"benchmarks_torch.{name}")
    monkeypatch.setattr(TC, "DEVICE", "cpu")
    argv = [name, "--smoke"]
    ref1 = rows(JC, jax_mod, argv, monkeypatch)
    ref2 = rows(JC, jax_mod, argv, monkeypatch)
    port = rows(TC, port_mod, argv, monkeypatch)
    wall = {f"claim/{c}" for c in TC.WALL_CLOCK}
    for run in (ref1, ref2, port):
        failed = [r for r in run if r[0].startswith("claim/") and r[1] != "PASS"
                  and r[0] not in wall]
        assert not failed, failed
    racy = re.compile(RACY.get(name, r"$^"))
    value_only = re.compile(VALUE_ONLY.get(name, r"$^"))

    def stable(run):  # fig18 prints one row per calibration attempt it made
        return [r[:2] if value_only.fullmatch(r[0]) else r
                for r in run if not racy.fullmatch(r[0])]

    assert stable(ref1), name
    assert stable(ref1) == stable(ref2), ("the reference's second run differs",
                                          _first_diff(stable(ref1), stable(ref2)))
    assert stable(port) == stable(ref1), ("the port differs from the reference",
                                          _first_diff(stable(port), stable(ref1)))

    def racy_names(run):
        return {re.sub(r"attempt\d+$", "attempt", r[0]) for r in run if racy.fullmatch(r[0])}

    assert racy_names(port) == racy_names(ref1) == racy_names(ref2), (
        racy_names(port), racy_names(ref1), racy_names(ref2))
    return port


def _first_diff(a, b):
    return next(((x, y) for x, y in zip(a, b) if x != y), (len(a), len(b)))
