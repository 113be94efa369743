# Copied from benchmarks/fig17_rebalance.py; imports rewritten, history notes cut.
# Each OffloadDB takes the figures' torch device, common.device().
"""Fig. 17 — dynamic stripe rebalancing under a zipf-skewed workload
(this repo's extension).

Striped placement (Fig. 16) is static: a zipf-skewed multi-tenant workload
drives ~70% of the device traffic through one NVMe FIFO while the other
stripes idle. The ``StripeRebalancer`` migrates hot files between stripes
online (copy → lease-journaled swap → free) and realigns placement with
load. Three measurements:

  A. Steady-state throughput recovery (functional + DES replay): four
     tenant OffloadDB instances pinned to the stripes of one
     ``OffloadFS(shards=4)`` volume receive zipf-distributed op shares
     (tenant 0 ≈ 70%). After a skewed ingest warmup the *dynamic*
     scenario unpins the hot tenant, spreads its existing files across
     stripes (``StripeRebalancer.spread``) and leaves the rebalancer
     attached — output steering plus the between-rounds cold-table drain
     keep placement aligned; the *static* scenario keeps the fixed
     placement. A mixed read/ingest steady-state phase is then traced and
     its per-stripe traffic replayed through per-shard NVMe FIFOs, with
     the rebalancer's migration copies charged through
     ``Cluster.rebalance`` on the same FIFOs (rate-limited and
     unthrottled variants — migrations are no longer free in the replay).
     Claims: every tenant's reads stay correct, every migrated file is
     byte-identical, the busiest FIFO's share drops, and steady-state
     throughput recovers ≥1.5× vs static placement.

  B. Crash mid-migration (functional): a failpoint kills the initiator
     between the block copy and the metadata swap (and again right after
     the swap). Claims: re-mount is consistent — the file is
     byte-identical, placement is entirely old or entirely new, the
     journaled orphan lease is reclaimed, and free-space accounting is
     exact.

  C. Fleet-level recovery (DES): ``KVParams(shard_skew=2.5)`` concentrates
     8 initiators' placement on one storage target;
     ``rebalance_at=0.25`` migrates them back to uniform placement
     mid-run (background copy I/O via ``Cluster.rebalance``). Claims:
     whole-run throughput recovers ≥1.2× vs static skew, and the
     migration-rate limiter (``rebalance_rate``) beats the unthrottled
     copy burst — paced copies can't starve foreground I/O.

Run ``--smoke`` for the CI-sized subset (fewer ops, claims unchanged).
"""
from __future__ import annotations

import random
import sys

from benchmarks_torch.common import check, device, emit
from repro_torch.core import (
    AcceptAll,
    BlockDevice,
    OffloadFS,
    RpcFabric,
    StripeRebalancer,
)
from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.fs import SB_BLOCKS, MigrationCrash
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.sim.cluster import TESTBED, Cluster
from repro_torch.sim.des import Sim
from repro_torch.sim.kvmodel import KVParams, run_kv

N_TENANTS = 4
N_SHARDS = 4
ZIPF_S = 2.0  # tenant op shares ~ (k+1)^-s: ≈ 70/18/8/4 %


def zipf_pick(rng: random.Random) -> int:
    w = [(k + 1) ** -ZIPF_S for k in range(N_TENANTS)]
    x = rng.random() * sum(w)
    for k in range(N_TENANTS):
        x -= w[k]
        if x <= 0:
            return k
    return N_TENANTS - 1


def build():
    dev = BlockDevice(num_blocks=1 << 18)
    fs = OffloadFS(dev, node="init0", shards=N_SHARDS)
    fabric = RpcFabric()
    engines = []
    for t in range(N_SHARDS):
        eng = OffloadEngine(fs, node=f"storage{t}", cache_blocks=1024)
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="placement_affinity")
    dbs = []
    for inst in range(N_TENANTS):
        cfg = DBConfig(
            memtable_bytes=8 * 1024, sstable_target_bytes=32 * 1024,
            base_level_bytes=64 * 1024, l0_trigger=6,
            # a memory-constrained table cache: steady-state point reads
            # actually hit the device (the Fig. 12/13 regime), so read
            # traffic lands on whichever stripes hold the tables
            table_cache_bytes=64 * 1024,
            namespace=f"/t{inst}", placement_shard=inst,
        )
        dbs.append(OffloadDB(fs, off, cfg, device=device()))
    traffic = {k: [0, 0] for k in range(N_SHARDS)}

    def tracer(ev):
        if ev.block >= SB_BLOCKS:  # superblock/journal area owns no stripe
            traffic[fs.extmgr.shard_of(ev.block)][0 if ev.op == "read" else 1] \
                += ev.nblocks
    dev.tracer = tracer
    return dev, fs, fabric, engines, off, dbs, traffic


def workload(dbs, models, rng, n_ops, *, read_ratio=0.0):
    for i in range(n_ops):
        inst = zipf_pick(rng)
        k = f"key{rng.randrange(500):06d}".encode()
        if rng.random() < read_ratio:
            got = dbs[inst].get(k)
            assert got == models[inst].get(k)
        else:
            v = f"val{i:08d}".encode() * 6
            dbs[inst].put(k, v)
            models[inst][k] = v


def run_scenario(*, rebalance: bool, n_ops: int):
    """Warmup phase (skewed), optional rebalancing, then the measured
    steady-state phase. Returns (traffic, fs, dbs, models, rb,
    steady_moves) — steady_moves is only the migrations the drain hook
    performed DURING the measured phase (the setup spread() happens
    before the traffic counters reset and must not be charged into the
    steady-state replay)."""
    dev, fs, fabric, engines, off, dbs, traffic = build()
    models = [dict() for _ in range(N_TENANTS)]
    rng = random.Random(17)
    workload(dbs, models, rng, n_ops)  # warmup: pure skewed ingest
    fabric.drain()
    rb = None
    if rebalance:
        rb = StripeRebalancer(fs, off)
        # unpin tenants whose stripe's FIFO pressure skews: their new WAL
        # generations then rotate and their flush/compaction outputs are
        # steered by the rebalancer; the drain hook fires between rounds
        pressure = rb.shard_pressure()
        mean = sum(pressure.values()) / N_SHARDS
        rehomed = []
        for db in dbs:
            pin = db.cfg.placement_shard
            if pin is not None and pressure[pin] > rb.skew_threshold * mean:
                db.cfg.placement_shard = None
                rehomed.extend(fs.listdir(db.cfg.namespace + "/"))
            db.attach_rebalancer(rb)
        # spread the rehomed tenants' existing files across stripes, then
        # verify every migrated byte (the copy-swap-free cycle is lossless)
        snapshot = {p: fs.read(p) for p in fs.listdir()}
        moved = rb.spread(rehomed)
        bad = sum(1 for p, blob in snapshot.items() if fs.read(p) != blob)
        check("fig17/migration_byte_identical",
              bool(moved) and bad == 0,
              f"{len(moved)} files migrated, {bad} with changed bytes")
        emit("fig17/migrations", len(moved),
             f"blocks_moved={rb.stats.blocks_moved} "
             f"skipped_leased={rb.stats.skipped_leased}")
    # measured steady-state phase: mixed point reads + ingest — the reads
    # land on whichever stripes hold the tables, which is exactly what the
    # rebalancer changed
    for k in traffic:
        traffic[k] = [0, 0]
    moves_start = len(rb.stats.moves) if rb else 0
    workload(dbs, models, rng, n_ops, read_ratio=0.7)
    for db in dbs:
        db.flush_all()
    fabric.drain()
    dev.tracer = None  # measurement over: the correctness sweep's gets
    steady_moves = rb.stats.moves[moves_start:] if rb else []
    return traffic, fs, dbs, models, rb, steady_moves  # ^ no pollution


MIGRATION_RATE = 1.0e9  # limiter: migration copy paced to 1 GB/s


def replay_fifos(traffic: dict, moves=(), *, rate=None) -> float:
    """DES replay of the measured per-stripe I/O: each stripe's bytes
    drain through its own NVMe read/write FIFO pair, stripes concurrent —
    the makespan is set by the busiest FIFO (what skew costs). Returns the
    FOREGROUND completion time.

    ``moves`` charges the rebalancer's migration copies (``(src, dst,
    blocks)`` from ``RebalanceStats.moves``) through ``Cluster.rebalance``
    — the same FIFOs the foreground drains use, spawned concurrently (the
    drain hook migrates between compaction rounds, i.e. during the
    measured steady state). ``rate`` is the migration-rate limiter: None
    replays each copy as one FIFO-saturating burst; a bytes/s value paces
    it in chunks so foreground I/O interleaves."""
    sim = Sim()
    cl = Cluster(sim, TESTBED, n_initiators=1, n_storage=N_SHARDS)
    fg_done = {}

    def drain(t, read_blocks, write_blocks):
        yield ("use", cl.nvme_r_t[t], read_blocks * BLOCK_SIZE)
        yield ("use", cl.nvme_w_t[t], write_blocks * BLOCK_SIZE)
        fg_done[t] = sim.now

    for src, dst, blocks in moves:
        if blocks > 0:
            sim.spawn(cl.rebalance(0, blocks * BLOCK_SIZE,
                                   src=src, dst=dst, rate=rate))
    for t, (rb_, wb_) in traffic.items():
        sim.spawn(drain(t, rb_, wb_))
    sim.run()
    return max(fg_done.values(), default=0.0)


def busiest_share(traffic: dict) -> float:
    blocks = {k: rb_ + wb_ for k, (rb_, wb_) in traffic.items()}
    return max(blocks.values()) / max(1, sum(blocks.values()))


def crash_mid_migration() -> None:
    """Part B: the failpoint kills the 'initiator' between copy and swap,
    then right after the swap; re-mount must be consistent either way."""
    dev = BlockDevice(num_blocks=1 << 14)
    fs = OffloadFS(dev, node="init0", shards=N_SHARDS)
    data = b"\xa5" * (BLOCK_SIZE * 24)
    fs.create("/victim", shard=0)
    fs.write("/victim", data, 0)
    fs.flush_metadata()
    free_before = fs.extmgr.free_blocks
    ok = True
    detail = []
    for stage, want_shard in (("post_copy", 0), ("post_swap", 1)):
        def boom(s, stage=stage):
            if s == stage:
                raise MigrationCrash(s)
        fs._migration_failpoint = boom
        try:
            fs.migrate_file("/victim", 1)
            ok = False
            detail.append(f"{stage}: failpoint did not fire")
        except MigrationCrash:
            pass
        fs = OffloadFS.mount(dev, node="init0")  # the re-mounted initiator
        orphans = len(fs.orphan_leases())
        reclaimed = len(fs.reclaim_orphans())
        shard = fs.file_shard("/victim")
        intact = fs.read("/victim") == data
        exact = fs.extmgr.free_blocks == free_before
        detail.append(f"{stage}: orphans={orphans} shard={shard} "
                      f"intact={intact} accounting_exact={exact}")
        ok = ok and orphans == 1 and reclaimed == 1 and intact and exact \
            and shard == want_shard
    check("fig17/crash_remount_consistent", ok, "; ".join(detail))


def main():
    smoke = "--smoke" in sys.argv
    n_ops = 3000 if smoke else 6000

    # ------------------------- A: steady-state throughput recovery
    static_traffic, _, s_dbs, s_models, _, _ = run_scenario(
        rebalance=False, n_ops=n_ops)
    dyn_traffic, dyn_fs, d_dbs, d_models, rb, steady_moves = run_scenario(
        rebalance=True, n_ops=n_ops)
    for name, dbs, models in (("static", s_dbs, s_models),
                              ("dynamic", d_dbs, d_models)):
        bad = sum(1 for m, db in zip(models, dbs)
                  for k, v in m.items() if db.get(k) != v)
        check(f"fig17/correctness_{name}", bad == 0, f"{bad} wrong gets")
    share_s, share_d = busiest_share(static_traffic), busiest_share(dyn_traffic)
    emit("fig17/busiest_fifo_share", f"{share_s:.2f}->{share_d:.2f}",
         "static -> rebalanced (0.25 = perfect 4-way spread)")
    check("fig17/skew_reduced", share_s >= 0.5 and share_d <= share_s - 0.15,
          f"busiest FIFO {share_s*100:.0f}% static vs {share_d*100:.0f}% "
          "rebalanced")
    # the dynamic replay CHARGES the rebalancer's migration copies that
    # happened during the measured steady state (the drain hook's moves;
    # the setup spread() predates the traffic reset) — once with the rate
    # limiter, once unthrottled, so the limiter's effect on foreground
    # completion is its own datapoint
    moves = steady_moves
    t_s = replay_fifos(static_traffic)
    t_d = replay_fifos(dyn_traffic, moves, rate=MIGRATION_RATE)
    t_d_unl = replay_fifos(dyn_traffic, moves)
    thr_s, thr_d = n_ops / t_s if t_s else 0.0, n_ops / t_d if t_d else 0.0
    recovery = thr_d / thr_s if thr_s else 0.0
    emit("fig17/steady_state_throughput",
         f"static={thr_s:.0f};rebalanced={thr_d:.0f}",
         f"ops/s through the replayed FIFOs (migration I/O charged, "
         f"limited to {MIGRATION_RATE / 1e9:.1f} GB/s), "
         f"recovery={recovery:.2f}x")
    check("fig17/throughput_recovery", recovery >= 1.5,
          f"{recovery:.2f}x steady-state throughput vs static placement "
          "with migration copies charged")
    mig_blocks = sum(b for _, _, b in moves)
    emit("fig17/migration_replay",
         f"limited={t_d:.6f};unlimited={t_d_unl:.6f}",
         f"foreground completion (s), {mig_blocks} migrated blocks charged "
         "(tenant files are tiny here; the fleet-scale limiter effect is "
         "part C's with/without datapoint)")
    check("fig17/migration_charged", mig_blocks > 0 and t_d_unl >= t_d,
          f"replay charges {mig_blocks} blocks of copy traffic; "
          "unthrottled is never faster for the foreground")
    emit("fig17/lease_journal",
         f"appends={dyn_fs.lease_journal.appends}",
         f"migrations={dyn_fs.migrations} blocks={dyn_fs.migrated_blocks}")
    check("fig17/migrations_lease_journaled",
          dyn_fs.migrations > 0
          and dyn_fs.lease_journal.appends >= 2 * dyn_fs.migrations,
          "every migration grants + releases one journaled write lease")

    # ------------------------- B: crash mid-migration
    crash_mid_migration()

    # ------------------------- C: fleet-level recovery (DES)
    # the DES is cheap (<1s), so smoke keeps the full op count: below
    # ~15k ops the skewed target never saturates and the claim is vacuous
    des_ops = 40_000
    base = dict(n_ops=des_ops, write_ratio=1.0, offload_levels=4,
                offload_flush=True, log_recycling=True, offload_cache=True,
                l0_cache=True, n_storage=4)
    skew = run_kv(KVParams(**base, shard_skew=2.5), instances=8)
    reb = run_kv(KVParams(**base, shard_skew=2.5, rebalance_at=0.25),
                 instances=8)
    des_rec = reb.throughput / skew.throughput if skew.throughput else 0.0
    emit("fig17/des_throughput",
         f"skewed={skew.throughput:.0f};rebalanced={reb.throughput:.0f}",
         f"recovery={des_rec:.2f}x (8 initiators, zipf placement)")
    check("fig17/des_recovery", des_rec >= 1.2,
          f"{des_rec:.2f}x whole-run DES throughput vs static skew")
    # with/without migration-rate limiter: 8 initiators' 32 MB copies land
    # at once when unthrottled and queue ahead of foreground I/O on the
    # shared FIFOs; pacing them (Cluster.rebalance rate=1 GB/s) lets the
    # foreground interleave between chunks
    lim = run_kv(KVParams(**base, shard_skew=2.5, rebalance_at=0.25,
                          rebalance_rate=MIGRATION_RATE), instances=8)
    gain = lim.throughput / reb.throughput if reb.throughput else 0.0
    emit("fig17/des_migration_limiter",
         f"unlimited={reb.throughput:.0f};limited={lim.throughput:.0f}",
         f"whole-run ops/s, limiter gain {gain:.3f}x")
    check("fig17/des_limiter_no_starvation", lim.throughput > reb.throughput,
          f"rate-limited migration recovers {gain:.3f}x the unthrottled "
          "fleet throughput (copy bursts can't starve foreground I/O)")


if __name__ == "__main__":
    main()
