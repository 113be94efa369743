"""The port's dynamic stripe rebalancer (``repro_torch.core.rebalance``)
under the scenarios of ``tests/test_rebalance.py``: migrate_file lifecycle,
crash failpoints, telemetry, greedy rebalancing, the OffloadDB cold-table
drain hook (the port's DB merging on the CPU). One differential case runs
the same skewed file set through the JAX package's rebalancer and the
port's: the same migrations, stats, lease journal and per-file stripes."""
import pytest

from repro_torch.core import BLOCK_SIZE, BlockDevice, OffloadFS, RpcFabric, StripeRebalancer
from repro_torch.core.admission import AcceptAll, EwmaGauge
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.fs import LeaseViolation, MigrationCrash
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine


def make_fs(blocks=1 << 14, shards=4):
    dev = BlockDevice(num_blocks=blocks)
    return dev, OffloadFS(dev, node="init0", shards=shards)


def fill(fs, path, shard, nblocks, byte):
    fs.create(path, shard=shard)
    data = bytes([byte]) * (BLOCK_SIZE * nblocks)
    fs.write(path, data, 0)
    return data


# ------------------------------------------------------------ migrate_file
def test_migrate_moves_blocks_and_preserves_content():
    dev, fs = make_fs()
    data = fill(fs, "/a", 0, 8, 0x11)
    free0 = fs.extmgr.free_blocks
    res = fs.migrate_file("/a", 2)
    assert res == {"blocks": 8, "src": 0, "dst": 2}
    assert fs.read("/a") == data
    assert fs.file_shard("/a") == 2
    for e in fs.stat("/a").extents:
        assert fs.extmgr.shard_of(e.block) == 2 == e.shard
    # copy-swap-free is allocation-neutral and leaves no lease behind
    assert fs.extmgr.free_blocks == free0
    assert fs.orphan_leases() == []
    assert fs.migrations == 1 and fs.migrated_blocks == 8


def test_migrate_same_shard_is_noop_repin():
    dev, fs = make_fs()
    fill(fs, "/a", 1, 4, 0x22)
    before = [e.block for e in fs.stat("/a").extents]
    assert fs.migrate_file("/a", 1)["blocks"] == 0
    assert [e.block for e in fs.stat("/a").extents] == before
    assert fs.migrations == 0


def test_migrate_refuses_leased_source():
    dev, fs = make_fs()
    fill(fs, "/a", 0, 4, 0x33)
    # reprolint: allow[lease-raw] held lease is the fixture: migrate/rebalance must refuse it
    lease = fs.grant_lease([], fs.stat("/a").extents)
    with pytest.raises(LeaseViolation):
        fs.migrate_file("/a", 1)
    fs.release_lease(lease)
    # a READ lease must refuse too: migration would free + trim the blocks
    # the offloaded reader is still authorized to read
    # reprolint: allow[lease-raw] held lease is the fixture: migrate/rebalance must refuse it
    rlease = fs.grant_lease(fs.stat("/a").extents, [])
    with pytest.raises(LeaseViolation):
        fs.migrate_file("/a", 1)
    fs.release_lease(rlease)
    assert fs.migrate_file("/a", 1)["blocks"] == 4


def test_migrate_failure_after_commit_keeps_new_placement():
    """An exception AFTER the superblock flush must not roll back: the swap
    is durable, so in-memory state finishes the cycle instead (source
    freed, lease released) and the error propagates."""
    dev, fs = make_fs()
    data = fill(fs, "/a", 0, 6, 0x45)
    fs.flush_metadata()
    free0 = fs.extmgr.free_blocks

    def boom(stage):
        if stage == "post_swap":
            raise RuntimeError("observer glitch after commit")
    fs._migration_failpoint = boom
    with pytest.raises(RuntimeError):
        fs.migrate_file("/a", 2)
    fs._migration_failpoint = None
    assert fs.read("/a") == data
    assert fs.file_shard("/a") == 2  # durable swap wins
    assert fs.extmgr.free_blocks == free0
    assert fs.orphan_leases() == []
    # and the in-memory state matches what a remount reads back
    fs2 = OffloadFS.mount(dev, node="init0")
    assert fs2.read("/a") == data
    assert fs2.file_shard("/a") == 2


def test_migrate_rollback_on_failure():
    """A plain exception mid-migration (not a crash) rolls back: old
    placement intact, destination blocks freed, lease released."""
    dev, fs = make_fs()
    data = fill(fs, "/a", 0, 6, 0x44)
    fs.flush_metadata()
    free0 = fs.extmgr.free_blocks

    def boom(stage):
        if stage == "post_copy":
            raise RuntimeError("disk glitch")
    fs._migration_failpoint = boom
    with pytest.raises(RuntimeError):
        fs.migrate_file("/a", 3)
    fs._migration_failpoint = None
    assert fs.read("/a") == data
    assert fs.file_shard("/a") == 0
    assert fs.extmgr.free_blocks == free0
    assert fs.orphan_leases() == []
    fs.write("/a", b"\x55" * BLOCK_SIZE, 0)  # no stale lease quiesce


@pytest.mark.parametrize("stage,want_shard", [("pre_copy", 0),
                                              ("post_copy", 0),
                                              ("post_swap", 1)])
def test_crash_mid_migration_remounts_consistent(stage, want_shard):
    """Kill between copy and metadata swap (and around it): the re-mounted
    initiator sees entirely old or entirely new placement, the journaled
    orphan lease is reclaimed, content and accounting are exact."""
    dev, fs = make_fs()
    data = fill(fs, "/a", 0, 10, 0x66)
    fs.flush_metadata()
    free0 = fs.extmgr.free_blocks

    def boom(s):
        if s == stage:
            raise MigrationCrash(s)
    fs._migration_failpoint = boom
    with pytest.raises(MigrationCrash):
        fs.migrate_file("/a", 1)
    fs2 = OffloadFS.mount(dev, node="init0")
    orphans = fs2.orphan_leases()
    assert len(orphans) == 1  # the journaled destination write lease
    # before fencing, the quiesce discipline still guards the orphan blocks
    assert fs2.reclaim_orphans() == [orphans[0].task_id]
    assert fs2.read("/a") == data
    assert fs2.file_shard("/a") == want_shard
    assert fs2.extmgr.free_blocks == free0
    # the reclaimed volume is fully usable again
    fs2.create("/b")
    fs2.write("/b", b"\x77" * BLOCK_SIZE * 8, 0)
    assert fs2.read("/a") == data


# ------------------------------------------------------------- telemetry
def test_ewma_gauge_smoothing():
    g = EwmaGauge(alpha=0.5)
    assert g.update(10) == 5.0
    assert g.update(10) == 7.5
    assert g.samples == 2
    with pytest.raises(ValueError):
        EwmaGauge(alpha=0.0)


def test_offloader_queue_depth_telemetry():
    dev, fs = make_fs()
    fabric = RpcFabric()
    engines = []
    for t in range(4):
        eng = OffloadEngine(fs, node=f"storage{t}")
        eng.register_stub("peek", lambda io, blk: io.offload_read(blk, 1)[:1])
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="placement_affinity")
    data = fill(fs, "/hot", 1, 12, 0x88)
    ex = fs.stat("/hot").extents
    for _ in range(5):
        res, where = off.submit("peek", ex[0].block, read_extents=ex)
        assert res == data[:1] and where == "storage1"
    depth = off.queue_depth_ewma()
    qblocks = off.queue_blocks_ewma()
    assert set(depth) == {e.node for e in engines}
    # only the owning target saw traffic, and the block-depth EWMA reflects
    # the leased block volume (the rebalancer's FIFO-pressure signal)
    assert qblocks["storage1"] > 0 and depth["storage1"] > 0
    assert all(qblocks[f"storage{t}"] == 0 for t in (0, 2, 3))
    util = off.shard_utilization()
    assert set(util) == {0, 1, 2, 3}
    assert max(util, key=util.get) == 1


# ------------------------------------------------------------ rebalancer
def test_rebalance_spreads_skewed_placement_byte_identical():
    dev, fs = make_fs()
    data = {}
    for i in range(8):
        data[f"/f{i}"] = fill(fs, f"/f{i}", 0, 4 + i, 0x10 + i)
    rb = StripeRebalancer(fs)  # no offloader: load-based pressure
    assert rb.skewed()
    moved = rb.rebalance(max_files=16)
    assert moved
    load = rb.placement_load()
    assert max(load.values()) < sum(load.values())  # no longer all on 0
    assert max(load.values()) <= rb.skew_threshold * (
        sum(load.values()) / fs.shards
    ) + max(n for _, (_, n) in rb._file_placement().items())
    for p, d in data.items():
        assert fs.read(p) == d
    assert rb.stats.migrations == len(moved)
    assert rb.stats.blocks_moved == sum(m.blocks for m in moved)


def test_rebalance_noop_when_balanced():
    dev, fs = make_fs()
    for k in range(4):
        fill(fs, f"/f{k}", k, 6, 0x20 + k)
    rb = StripeRebalancer(fs)
    assert not rb.skewed()
    assert rb.rebalance() == []
    assert rb.stats.rounds == 0


def test_rebalance_skips_leased_files():
    dev, fs = make_fs()
    fill(fs, "/big", 0, 10, 0x31)
    fill(fs, "/small", 0, 4, 0x32)
    # reprolint: allow[lease-raw] held lease is the fixture: migrate/rebalance must refuse it
    lease = fs.grant_lease([], fs.stat("/big").extents)
    rb = StripeRebalancer(fs)
    moved = rb.rebalance(max_files=4)
    assert all(m.path != "/big" for m in moved)
    assert rb.stats.skipped_leased >= 1
    fs.release_lease(lease)


def test_spread_rehomes_explicit_set():
    dev, fs = make_fs()
    data = {f"/t0/{i}": fill(fs, f"/t0/{i}", 0, 5, 0x40 + i) for i in range(4)}
    rb = StripeRebalancer(fs)
    moved = rb.spread(fs.listdir("/t0/"))
    assert len(moved) >= 3  # least-loaded-first lands them on 1, 2, 3, ...
    dsts = {m.dst for m in moved}
    assert dsts.issubset({1, 2, 3}) and len(dsts) == 3
    for p, d in data.items():
        assert fs.read(p) == d


def test_migration_budget_limits_copy_traffic_per_round():
    """The migration-rate limiter: a round never copies more blocks than
    its budget; deferred candidates are counted and picked up by later
    rounds, and every move is logged for the DES replay to charge."""
    dev, fs = make_fs()
    for i in range(6):
        fill(fs, f"/f{i}", 0, 6, 0x60 + i)
    rb = StripeRebalancer(fs, migration_budget_blocks=8)
    moved = rb.rebalance(max_files=16)
    assert moved and sum(m.blocks for m in moved) <= 8
    assert rb.stats.deferred_budget > 0
    total_rounds = 1
    while rb.skewed() and total_rounds < 10:
        if not rb.rebalance(max_files=16, force=True):
            break
        total_rounds += 1
    assert total_rounds > 1  # the backlog drained across several rounds
    assert rb.stats.moves[:len(moved)] == [(m.src, m.dst, m.blocks)
                                           for m in moved]
    assert all(b > 0 for _, _, b in rb.stats.moves)
    assert sum(b for _, _, b in rb.stats.moves) == rb.stats.blocks_moved


def test_deferred_budget_counts_each_candidate_once_per_round():
    """Regression: every _one_move call re-scans the candidates, so an
    over-budget file must not be re-counted per completed migration."""
    dev, fs = make_fs()
    for i in range(4):
        fill(fs, f"/s{i}", 0, 6, 0x80 + i)
    for i in range(2):
        fill(fs, f"/b{i}", 0, 10, 0x90 + i)
    rb = StripeRebalancer(fs, migration_budget_blocks=8)
    moved = rb.rebalance(max_files=16)
    assert len(moved) == 1 and moved[0].blocks == 6
    # exactly the 5 not-moved candidates deferred — once each
    assert rb.stats.deferred_budget == 5


def test_spread_respects_migration_budget():
    dev, fs = make_fs()
    for i in range(4):
        fill(fs, f"/t0/{i}", 0, 5, 0x70 + i)
    rb = StripeRebalancer(fs, migration_budget_blocks=10)
    moved = rb.spread(fs.listdir("/t0/"))
    assert sum(m.blocks for m in moved) <= 10
    assert rb.stats.deferred_budget > 0


def test_steer_routes_outputs_off_overloaded_stripe():
    dev, fs = make_fs()
    rb = StripeRebalancer(fs)
    fill(fs, "/hot", 0, 20, 0x50)
    assert rb.steer(0) != 0  # stripe 0 overloaded: steered to coldest
    assert rb.steer(1) == 1  # cold stripes keep their placement
    assert rb.stats.steered == 1


# ------------------------------------------------------- OffloadDB drain
def build_db_plane(shards=4):
    dev = BlockDevice(num_blocks=1 << 16)
    fs = OffloadFS(dev, node="init0", shards=shards)
    fabric = RpcFabric()
    engines = []
    for t in range(shards):
        eng = OffloadEngine(fs, node=f"storage{t}", cache_blocks=256)
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="placement_affinity")
    return dev, fs, fabric, off


def test_db_drain_cold_tables_moves_l1_off_hot_stripe():
    dev, fs, fabric, off = build_db_plane()
    cfg = DBConfig(memtable_bytes=4 * 1024, sstable_target_bytes=16 * 1024,
                   base_level_bytes=48 * 1024, l0_trigger=3,
                   namespace="/db", placement_shard=0)
    db = OffloadDB(fs, off, cfg, device="cpu")
    model = {}
    for i in range(1200):
        k = f"k{i % 400:04d}".encode()
        v = f"v{i}".encode() * 20
        db.put(k, v)
        model[k] = v
    db.flush_all()
    fabric.drain()
    assert db.levels[1], "needs L1 tables for the drain to act on"
    # everything sits on the pinned stripe; unpin and drain
    db.cfg.placement_shard = None
    rb = StripeRebalancer(fs, off)
    db.attach_rebalancer(rb)
    moved = db.drain_cold_tables(max_tables=8)
    assert moved, "cold L1 tables should migrate off the hot stripe"
    assert all(m.path.startswith("/db/sst/") for m in moved)
    cold_paths = {db.tables[t].path for t in db.levels[1]}
    assert {m.path for m in moved} <= cold_paths  # L0/WAL untouched
    for k, v in model.items():
        assert db.get(k) == v, k
    # continued service (hook fires between compaction rounds) stays correct
    for i in range(400):
        k = f"k{i % 400:04d}".encode()
        v = f"w{i}".encode() * 20
        db.put(k, v)
        model[k] = v
    db.flush_all()
    fabric.drain()
    for k, v in model.items():
        assert db.get(k) == v, k


def test_db_recover_after_migrations():
    """Migrated tables must survive a crash/recover cycle: the superblock
    swap at migration time is durable metadata."""
    dev, fs, fabric, off = build_db_plane()
    cfg = DBConfig(memtable_bytes=4 * 1024, sstable_target_bytes=16 * 1024,
                   base_level_bytes=48 * 1024, l0_trigger=3,
                   namespace="/db", placement_shard=0)
    db = OffloadDB(fs, off, cfg, device="cpu")
    model = {}
    for i in range(1200):
        k = f"k{i % 400:04d}".encode()
        v = f"v{i}".encode() * 20
        db.put(k, v)
        model[k] = v
    db.flush_all()
    fabric.drain()
    rb = StripeRebalancer(fs, off)
    db.attach_rebalancer(rb)
    db.cfg.placement_shard = None
    assert db.drain_cold_tables(max_tables=8)
    db.wal.flush()
    fs.flush_metadata()
    fs2 = OffloadFS.mount(dev, node="init0")
    db2 = OffloadDB.recover(fs2, None, cfg, device="cpu")
    for k, v in model.items():
        assert db2.get(k) == v, k


# --------------------------------------------------- against the JAX package
def _rebalance_scenario(pkg):
    """A skewed file set in package ``pkg`` (``repro`` or ``repro_torch``),
    one file held under a lease, then budgeted rebalance rounds, a spread
    and a steer."""
    import dataclasses
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    dev = core.BlockDevice(num_blocks=1 << 14)
    fs = core.OffloadFS(dev, node="init0", shards=4)
    sizes = [3, 9, 4, 12, 5, 7, 2, 10]
    for i, n in enumerate(sizes):
        fs.create(f"/f{i}", shard=0 if i < 6 else 1)
        fs.write(f"/f{i}", bytes([0x20 + i]) * (core.BLOCK_SIZE * n), 0)
    for i in range(3):
        fs.create(f"/t/{i}", shard=1)
        fs.write(f"/t/{i}", bytes([0x50 + i]) * (core.BLOCK_SIZE * 4), 0)
    # reprolint: allow[lease-raw] held lease is the fixture: rebalance must skip it
    lease = fs.grant_lease([], fs.stat("/f3").extents)
    rb = core.StripeRebalancer(fs, migration_budget_blocks=12)
    rounds = [rb.rebalance(max_files=16)]
    fs.release_lease(lease)
    while rb.skewed() and len(rounds) < 8:
        moved = rb.rebalance(max_files=16, force=True)
        if not moved:
            break
        rounds.append(moved)
    spread = rb.spread(fs.listdir("/t/"))
    steer = [rb.steer(s) for s in range(4)]
    paths = sorted(fs.listdir("/"))
    return {
        "rounds": [[(m.path, m.src, m.dst, m.blocks) for m in r] for r in rounds],
        "spread": [(m.path, m.src, m.dst, m.blocks) for m in spread],
        "steer": steer,
        "stats": dataclasses.asdict(rb.stats),
        "load": rb.placement_load(),
        "journal": bytes(fs.lease_journal._buf),
        "fs": (fs.migrations, fs.migrated_blocks, fs.extmgr.free_blocks),
        "files": {p: (fs.file_shard(p), [(e.block, e.nblocks, e.shard)
                                         for e in fs.stat(p).extents], fs.read(p))
                  for p in paths},
    }


def test_rebalance_same_files_same_migrations_and_stripes_as_jax():
    pytest.importorskip("jax")  # the JAX package is the reference
    want, got = _rebalance_scenario("repro"), _rebalance_scenario("repro_torch")
    assert len(got["rounds"]) > 1 and got["stats"]["skipped_leased"] >= 1
    assert got == want
