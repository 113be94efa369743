# Copied from benchmarks/fig15_async_wal.py; the imports are rewritten.
# Each OffloadDB takes the figures' torch device, common.device().
"""Fig. 15 — async WAL shipping + crash-recoverable lease journal (this
repo's durability-plane extension).

Three measurements:

  A. Foreground put latency (functional, wall clock): the same OffloadDB
     ingest runs with the synchronous WAL (``sync_wal=True`` — flush every
     record on the initiator, the SpanDB-comparison mode) and with the
     async durability plane (``async_wal=True`` — appends touch only the
     in-memory tail; sealed segments ship to shard targets via
     ``call_async`` with a bounded in-flight ring). Claim: async foreground
     put latency ≥ 2x better than sync at 4 shards, with the durability
     watermark (``durable_lsn``) covering every appended byte after drain.

  B. DES replay (deterministic): the kvmodel workload with sync vs async
     WAL — async removes the per-record fabric round trip + the foreground
     segment write from the op path.

  C. Crash/re-mount: a killed initiator (no clean shutdown) re-mounts the
     volume; the lease journal replays to fence orphaned write leases
     without scanning, and WAL replay recovers exactly the durable prefix.
"""
from __future__ import annotations

import random
import time

from benchmarks_torch.common import check, device, emit
from repro_torch.core import AcceptAll, BlockDevice, OffloadFS, RpcFabric
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.sim.cluster import TESTBED, Cluster
from repro_torch.sim.des import Sim
from repro_torch.sim.kvmodel import KVParams, run_kv

SHARD_COUNTS = (1, 2, 4, 8)
N_OPS = 2500
VALUE = b"v" * 120


def build_plane(n_targets: int):
    dev = BlockDevice(num_blocks=1 << 17)
    fs = OffloadFS(dev, node="init0")
    fabric = RpcFabric()
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}", cache_blocks=1024)
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="least_outstanding")
    return dev, fs, fabric, engines, off


def ingest_latency(db, n_ops: int = N_OPS) -> float:
    """Mean foreground put latency (seconds/op), WAL path isolated: the
    memtable is sized so the ingest never triggers a flush."""
    t0 = time.perf_counter()
    for i in range(n_ops):
        db.put(f"key{i:08d}".encode(), VALUE)
    return (time.perf_counter() - t0) / n_ops


def make_cfg(mode: str) -> DBConfig:
    return DBConfig(
        memtable_bytes=8 * 1024 * 1024,  # no flush during the timed ingest
        sync_wal=(mode == "sync"),
        async_wal=(mode == "async"),
    )


def part_a():
    ratios = {}
    for n in SHARD_COUNTS:
        _, _, fabric_s, _, off_s = build_plane(n)
        db_s = OffloadDB(off_s.fs, off_s, make_cfg("sync"), device=device())
        lat_s = ingest_latency(db_s)
        _, _, fabric_a, engines_a, off_a = build_plane(n)
        db_a = OffloadDB(off_a.fs, off_a, make_cfg("async"), device=device())
        lat_a = ingest_latency(db_a)
        # drain: watermark must cover every appended byte
        wm = db_a.wal.wait_durable()
        fabric_a.drain()
        ratios[n] = lat_s / max(lat_a, 1e-12)
        segs = ";".join(f"{e.node}={e.wal_segments}" for e in engines_a)
        emit(f"fig15/put_us/sync/{n}", f"{lat_s * 1e6:.2f}")
        emit(f"fig15/put_us/async/{n}", f"{lat_a * 1e6:.2f}",
             f"speedup={ratios[n]:.1f}x segments={segs}")
        if n == 4:
            check("fig15/async_2x_at_4_shards", ratios[4] >= 2.0,
                  f"{ratios[4]:.1f}x faster foreground puts")
            check("fig15/watermark_covers_tail", wm == db_a.wal.size,
                  f"durable_lsn={wm} size={db_a.wal.size}")
            # durability is real: the shipped prefix replays fully
            n_recs = sum(1 for _ in db_a.wal.replay())
            check("fig15/replay_complete", n_recs == N_OPS,
                  f"{n_recs}/{N_OPS} records intact on device")


def part_b():
    base = dict(n_ops=60_000, value_bytes=1024, client_procs=8,
                offload_levels=99, offload_flush=True, log_recycling=True,
                l0_cache=True, offload_cache=True)
    r_sync = run_kv(KVParams(sync_wal=True, **base))
    r_async = run_kv(KVParams(async_wal=True, **base))
    emit("fig15/des/sync/p50_us", f"{r_sync.p50 * 1e6:.1f}",
         f"tput={r_sync.throughput:.0f}")
    emit("fig15/des/async/p50_us", f"{r_async.p50 * 1e6:.1f}",
         f"tput={r_async.throughput:.0f}")
    check("fig15/des_latency_win", r_async.p50 * 1.5 <= r_sync.p50,
          f"{r_sync.p50 / max(r_async.p50, 1e-12):.1f}x p50 improvement")
    check("fig15/des_throughput_no_worse",
          r_async.throughput >= 0.95 * r_sync.throughput,
          f"{r_async.throughput / max(r_sync.throughput, 1):.2f}x throughput")
    # re-mount cost is metadata-only and flat in journal size (no scanning)
    sim = Sim()
    cl = Cluster(sim, TESTBED)
    sim.spawn(cl.crash_remount(0, journal_records=256))
    t_remount = sim.run()
    emit("fig15/des/remount_ms", f"{t_remount * 1e3:.3f}", "256 journaled leases")
    check("fig15/des_remount_cheap", t_remount < 0.01,
          f"{t_remount * 1e3:.3f} ms ≪ a WAL scan")


def part_c():
    dev, fs, fabric, engines, off = build_plane(2)
    cfg = DBConfig(memtable_bytes=32 * 1024, sstable_target_bytes=64 * 1024,
                   l0_trigger=4, async_wal=True)
    db = OffloadDB(fs, off, cfg, device=device())
    rng = random.Random(15)
    expected = {}
    for i in range(3000):
        k = f"key{rng.randrange(700):06d}".encode()
        v = f"val{i:08d}".encode() * 4
        db.put(k, v)
        expected[k] = v
    # the initiator dies here: no flush_all, no clean shutdown. What IS
    # known durable: the watermark after drain + the last metadata commit.
    db.wal.wait_durable()
    fs.flush_metadata()
    # a submit_many-style write lease still outstanding at crash time
    fs.create("/orphaned-output")
    fs.fallocate("/orphaned-output", 64 * 1024)
    # reprolint: allow[lease-raw] deliberate orphan: crash-recovery bench needs a never-released grant
    fs.grant_lease((), fs.stat("/orphaned-output").extents)
    fabric.drain()

    fs2 = OffloadFS.mount(dev, node="init0")
    orphans_found = len(fs2.orphan_leases())
    fabric2 = RpcFabric()
    engines2 = []
    for t in range(2):
        eng = OffloadEngine(fs2, node=f"storage{t}", cache_blocks=1024)
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        serve_engine(eng, fabric2, AcceptAll())
        engines2.append(eng)
    off2 = TaskOffloader(fs2, fabric2, node="init0",
                         targets=[e.node for e in engines2])
    db2 = OffloadDB.recover(fs2, off2, cfg, device=device())
    reclaimed = len(db2.orphans_reclaimed)
    emit("fig15/recovery/orphans", orphans_found, f"reclaimed={reclaimed}")
    check("fig15/orphans_reclaimed_100pct",
          orphans_found >= 1 and reclaimed == orphans_found,
          f"{reclaimed}/{orphans_found} journaled orphan leases fenced")
    lost = sum(1 for k, v in expected.items() if db2.get(k) != v)
    check("fig15/durable_prefix_recovered", lost == 0,
          f"{len(expected) - lost}/{len(expected)} keys after re-mount")


def main():
    part_a()
    part_b()
    part_c()


if __name__ == "__main__":
    main()
