# Copied from benchmarks/fig21_pushdown.py; imports rewritten, history notes cut.
# Each OffloadDB takes the figures' torch device, common.device().
"""Fig. 21 — programmable pushdown scans: ship predicates, not blocks
(this repo's extension).

An OffloadDB range scan used to ship raw SSTable blocks to the initiator
(NVMe-oF block shipping); the pushdown operator plane ships a small
verified filter/project/aggregate *program* instead and gets back only
matching rows plus key-only suppression markers (see
``repro_torch.core.pushdown``).  Two measurements:

  A. Bytes-on-wire (functional, real fabric accounting): a striped
     corpus on a 4-target plane, one filter per selectivity tier
     (~1% / ~10% / ~50%).  Block shipping = the block-aligned bytes of
     every SSTable overlapping the range (exactly what NVMe-oF would
     move); pushdown = the measured ``RpcFabric`` request+reply bytes of
     the same scan.  Rows must be identical between the two paths (the
     differential invariant), and aggregates must match through the
     target-side fast path.  The per-target row streams merge on the
     figures' torch device (``OffloadDB(device=)``: the merge kernel on
     the card).  Claims: **pushdown ships ≥3× fewer bytes
     than block shipping at ~10% selectivity on 4 targets**, rows
     identical at every tier, aggregate identical.

  B. Scan latency (DES): the calibrated testbed sweeps 1/2/4/8 targets
     across the same selectivities, 1 GB of tables split over the
     stripes.  Pushdown reads NVMe SPDK-direct (no PoseidonOS reactor
     crossing), filters on storage cores, and ships only the selected
     bytes; block shipping drags everything through posvol + both link
     FIFOs and filters on the initiator.  Claim: **pushdown ≥1.5×
     faster at ~10% selectivity on 4 targets**, and adding stripes
     never hurts pushdown latency.

Run ``--smoke`` for the CI-sized subset (smaller corpus, claims
unchanged).
"""
from __future__ import annotations

import random
import sys

from benchmarks_torch.common import check, device, emit
from repro_torch.core import pushdown as P
from repro_torch.core.admission import AcceptAll
from repro_torch.core.blockdev import BLOCK_SIZE, BlockDevice
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.fs import OffloadFS
from repro_torch.core.lsm import compaction as C
from repro_torch.core.lsm.db import DBConfig, OffloadDB
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.core.rpc import RpcFabric
from repro_torch.sim.cluster import TESTBED, Cluster
from repro_torch.sim.des import Sim

N_TARGETS = 4
# value tags drawn so single-prefix filters hit the selectivity tiers
TIERS = {"sel01": (b"A",), "sel10": (b"A", b"B"), "sel50": (b"A", b"B", b"C")}
TAG_P = ((b"A", 0.01), (b"B", 0.09), (b"C", 0.40), (b"D", 1.00))


def build_plane(n_targets: int):
    dev = BlockDevice(num_blocks=1 << 16)
    fs = OffloadFS(dev, node="init0", shards=n_targets)
    fabric = RpcFabric()
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}")
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        P.register_pushdown_stub(eng)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="placement_affinity")
    # materialized L0 tables on rotating stripes (no L0→L1 compaction):
    # an unpinned instance's L1 gravitates to one stripe per round (see
    # ROADMAP), so the multi-target fan-out is demonstrated on L0
    db = OffloadDB(fs, off, DBConfig(memtable_bytes=32 * 1024,
                                     log_recycling=False, l0_cache=False,
                                     l0_trigger=999), device=device())
    return fs, fabric, engines, db


def load_corpus(db: OffloadDB, n_keys: int, *, value_bytes: int = 240,
                seed: int = 21) -> None:
    rng = random.Random(seed)
    pad = bytes(value_bytes)
    for i in rng.sample(range(n_keys), n_keys):
        r = rng.random()
        tag = next(t for t, p in TAG_P if r < p)
        db.put(f"user{i:08d}".encode(), tag + pad)
    db.flush_all()


def tier_filter(tier: str):
    ors = [P.prefix(P.value(), t) for t in TIERS[tier]]
    return ors[0] if len(ors) == 1 else P.or_(*ors)


def blockship_bytes(db: OffloadDB, lo: bytes, hi) -> int:
    """What NVMe-oF block shipping moves for this range: every block of
    every overlapping SSTable (derived from the real extent map)."""
    _, tables = db._ranked_sources(lo, hi)
    total = 0
    for _, tid in tables:
        ino = db.fs.stat(db.tables[tid].path)
        total += sum(e.nblocks for e in ino.extents) * BLOCK_SIZE
    return total


def bytes_on_wire(smoke: bool) -> None:
    n_keys = 2000 if smoke else 8000
    fs, fabric, engines, db = build_plane(N_TARGETS)
    load_corpus(db, n_keys)
    lo, hi = b"user", b"userz"
    ship = blockship_bytes(db, lo, hi)
    emit("fig21/bytes_blockship", ship,
         f"block-aligned SSTable bytes for the full range, {n_keys} keys")
    ratios = {}
    for tier in TIERS:
        prog = P.build_scan(lo, hi, where=tier_filter(tier))
        rows_local = db.scan(program=prog, pushdown=False)
        fabric.drain()
        b0 = fabric.total_bytes()
        rows_push = db.scan(program=prog, pushdown=True)
        fabric.drain()
        wire = fabric.total_bytes() - b0
        ratios[tier] = ship / wire if wire else 0.0
        emit(f"fig21/bytes_pushdown/{tier}", wire,
             f"{len(rows_push)} rows, {ratios[tier]:.2f}x fewer bytes")
        check(f"fig21/rows_identical_{tier}",
              rows_local == rows_push,
              f"{len(rows_local)} rows local vs {len(rows_push)} pushdown")
    check("fig21/bytes_3x_sel10", ratios["sel10"] >= 3.0,
          f"{ratios['sel10']:.2f}x fewer bytes at ~10% selectivity on "
          f"{N_TARGETS} targets (floor 3x)")
    agg = P.build_scan(lo, hi, where=tier_filter("sel10"),
                       aggregate="count")
    check("fig21/aggregate_identical",
          db.scan(program=agg, pushdown=False)
          == db.scan(program=agg, pushdown=True),
          "count aggregate, local vs pushdown")
    check("fig21/engine_scans_all_targets",
          sum(e.pushdown_scans for e in engines) >= len(TIERS) * N_TARGETS,
          f"{[e.pushdown_scans for e in engines]} per-target sub-scans")


def des_latency(smoke: bool) -> None:
    """Scan-heavy load: N_SCANS concurrent range scans drain through the
    fleet.  Block shipping funnels every SSTable byte through the
    PoseidonOS reactors + the initiator's link and cores (the paper's
    NoOffload bottleneck); pushdown spends slower storage cores instead
    and ships only the selected bytes."""
    total = 256e6 if smoke else 1e9
    n_scans = 32
    fleet = (4,) if smoke else (1, 2, 4, 8)
    sels = {"sel01": 0.01, "sel10": 0.10, "sel50": 0.50}
    lat: dict = {}
    for n in fleet:
        for name, sel in sels.items():
            for push in (True, False):
                sim = Sim()
                cl = Cluster(sim, TESTBED, n_initiators=1, n_storage=n)
                for _ in range(n_scans):
                    for t in range(n):
                        sim.spawn(cl.pushdown_scan(0, total / n, sel,
                                                   target=t, pushdown=push))
                lat[(n, name, push)] = sim.run()
        emit(f"fig21/des/latency_n{n}",
             ";".join(f"{name}={lat[(n, name, True)] * 1e3:.1f}ms"
                      f"/ship={lat[(n, name, False)] * 1e3:.1f}ms"
                      for name in sels),
             f"time to drain {n_scans} concurrent scans, "
             f"pushdown vs block-ship")
    n_ref = 4 if 4 in fleet else fleet[0]
    speed = lat[(n_ref, "sel10", False)] / lat[(n_ref, "sel10", True)]
    check("fig21/des_latency_sel10_4t", speed >= 1.5,
          f"{speed:.2f}x faster pushdown at ~10% selectivity, "
          f"{n_ref} targets (floor 1.5x)")
    if len(fleet) > 1:
        mono = all(lat[(fleet[i + 1], "sel10", True)]
                   <= lat[(fleet[i], "sel10", True)] * 1.05
                   for i in range(len(fleet) - 1))
        check("fig21/des_pushdown_scales", mono,
              "adding stripes never hurts pushdown scan latency")


def main():
    smoke = "--smoke" in sys.argv
    bytes_on_wire(smoke)
    des_latency(smoke)


if __name__ == "__main__":
    from benchmarks_torch import common

    main()
    sys.exit(min(common.FAILURES, 125))
