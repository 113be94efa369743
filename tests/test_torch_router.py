"""The port's cluster front door (``repro_torch.core.router``) under the
scenarios of ``tests/test_router.py``, driven through the port's
``FaultyFabric`` under fixed seeds:

  * membership: join / leave / drain, endpoint-less targets skipped
  * target death mid-``submit_many``: no lost task, no leaked lease
  * health: probe-failure quarantine, stale-telemetry quarantine (aging),
    rejoin on recovery, health-channel-only partitions, the heartbeat
  * priority: background queued behind foreground under overload, shedding
  * cancellation: queued and in-flight, lease revoked through the journal
  * failover: standby re-mounts the dead initiator's volume (warm and
    COLD-PROCESS via a real killed subprocess that imports only
    ``repro_torch``), 100% orphan fencing
  * the pushdown plane through target deaths, on the port's OffloadDB
  * one differential case: the same seed and file set through the JAX
    package's router and the port's give the same lease journal, router
    stats and placements.

Run this file directly (``python tests/test_torch_router.py --child <dir>``)
to execute the cold-process child: it builds a volume, dies mid-flush with
write leases outstanding, and leaves the device image for the parent.
"""
import json
import os
import subprocess
import sys
import time

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (  # noqa: E402
    BlockDevice,
    ClusterRouter,
    FaultyFabric,
    OffloadFS,
    OverloadShed,
    RequestCancelled,
    TaskOffloader,
    standby_takeover,
)
from repro_torch.core import pushdown as P  # noqa: E402
from repro_torch.core.admission import AcceptAll, EwmaGauge  # noqa: E402
from repro_torch.core.blockdev import BLOCK_SIZE  # noqa: E402
from repro_torch.core.engine import OffloadEngine  # noqa: E402
from repro_torch.core.fs import LeaseViolation  # noqa: E402
from repro_torch.core.offloader import serve_engine  # noqa: E402
from repro_torch.core.router import DRAINING, LIVE, QUARANTINED  # noqa: E402


# ------------------------------------------------------------- harness
class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def stub_sum(io, block, nblocks):
    return sum(io.offload_read(block, nblocks)) % 65536


def stub_fill(io, block, nblocks, byte):
    io.offload_write(block, bytes([byte]) * (nblocks * BLOCK_SIZE))
    return nblocks


def wait_no_leases(fs, timeout=5.0):
    """submit_async releases the lease right AFTER resolving its future
    (same worker thread) — give that release the instant it needs."""
    deadline = time.time() + timeout
    while fs._leases and time.time() < deadline:
        time.sleep(0.002)
    assert not fs._leases


def make_file(fs, path, nblocks=2, byte=0xAB):
    fs.create(path)
    fs.write(path, bytes([byte]) * (nblocks * BLOCK_SIZE), 0)
    return fs.stat(path).extents


def build_cluster(n_targets=3, *, seed=0, policies=None, clock=None,
                  **router_kw):
    dev = BlockDevice(num_blocks=1 << 16)
    fs = OffloadFS(dev, node="init0")
    fabric = FaultyFabric(seed=seed)
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}", enable_cache=False)
        eng.register_stub("sum", stub_sum)
        eng.register_stub("fill", stub_fill)
        serve_engine(eng, fabric, policies[t] if policies else AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="least_outstanding")
    off.register_local_stub("sum", stub_sum)
    off.register_local_stub("fill", stub_fill)
    router = ClusterRouter(off, clock=clock, **router_kw)
    return dev, fs, fabric, engines, off, router


# ---------------------------------------------------------- membership
def test_join_leave_drain_lifecycle():
    dev, fs, fabric, engines, off, router = build_cluster(2)
    assert sorted(router.live_members()) == ["storage0", "storage1"]
    # join a third target whose engine comes up with it
    eng = OffloadEngine(fs, node="storage2", enable_cache=False)
    eng.register_stub("sum", stub_sum)
    serve_engine(eng, fabric, AcceptAll())
    router.join("storage2")
    assert "storage2" in off.targets and "storage2" in router.live_members()
    # leave removes it from routing for good
    assert router.leave("storage2", unregister=True)
    assert "storage2" not in off.targets
    assert not fabric.has_endpoint("storage2")
    # drain: no NEW work, member not live, existing target quiescent
    assert router.drain("storage1")
    assert router.members["storage1"].state == DRAINING
    assert "storage1" not in off.targets
    assert router.drained("storage1")
    ext = make_file(fs, "/a")
    req = router.submit("sum", ext[0].block, 1, read_extents=ext)
    result, where = req.result(timeout=30)
    assert where == "storage0"  # only live member left


def test_pick_skips_target_whose_engine_never_came_up():
    """Satellite regression: a registered name with zero engine stubs used
    to raise KeyError out of the load balancer; now it is skipped."""
    dev, fs, fabric, engines, off, router = build_cluster(2)
    router.join("ghost")  # no serve_engine: no endpoint
    ext = make_file(fs, "/a")
    for _ in range(6):
        req = router.submit("sum", ext[0].block, 1, read_extents=ext)
        _, where = req.result(timeout=30)
        assert where in ("storage0", "storage1")  # never the ghost
    assert off.least_loaded_other("storage0") == "storage1"
    assert off.least_loaded_other("ghost") in ("storage0", "storage1")
    wait_no_leases(fs)


def test_router_runs_local_when_no_targets_left():
    dev, fs, fabric, engines, off, router = build_cluster(1)
    router.leave("storage0")
    ext = make_file(fs, "/a")
    req = router.submit("sum", ext[0].block, 1, read_extents=ext)
    result, where = req.result(timeout=30)
    assert where == "init0"
    assert result == sum(bytes([0xAB]) * BLOCK_SIZE) % 65536
    assert off.stats.ran_local == 1
    assert not fs._leases


# ------------------------------------------------ death mid-submit_many
def test_target_death_mid_submit_many_loses_no_task_leaks_no_lease():
    """Acceptance: kill one of four targets with its wire batch already
    committed — every share still lands (reroute or local), the device
    bytes are exactly what a healthy run produces, and zero leases leak."""
    dev, fs, fabric, engines, off, router = build_cluster(4, seed=42)
    exts = [make_file(fs, f"/f{i}", 1, byte=0x00) for i in range(8)]
    fabric.kill_after("storage1", 1)  # one sub-call runs, then mid-batch death
    specs = [{"task": "fill", "args": (e[0].block, 1, 0x5A),
              "write_extents": e, "target": f"storage{i % 4}",
              "reroute": True}
             for i, e in enumerate(exts)]
    futs = off.submit(specs, stream=True)
    wheres = [f.result(timeout=30)[1] for f in futs]
    assert fabric.injected["dead"] > 0
    assert wheres[1] != "storage1" and wheres[5] != "storage1"  # rerouted
    for i in range(8):
        assert fs.read(f"/f{i}") == bytes([0x5A]) * BLOCK_SIZE  # no lost task
    assert not fs._leases  # no leaked lease
    assert fs.lease_journal.replay() == {}  # journal fully settled


# -------------------------------------------------------------- health
def test_probe_failures_quarantine_dead_target():
    clock = ManualClock()
    dev, fs, fabric, engines, off, router = build_cluster(
        3, clock=clock, max_probe_failures=2)
    assert all(router.probe().values())  # healthy fleet
    fabric.kill("storage2")
    clock.advance(0.5)
    out = router.probe()
    assert out["storage2"] is False
    assert router.members["storage2"].state == LIVE  # 1 failure < threshold
    clock.advance(0.5)
    router.probe()
    assert router.members["storage2"].state == QUARANTINED
    assert "storage2" not in off.targets
    assert router.stats.quarantined == 1
    # work keeps flowing around the quarantined member
    ext = make_file(fs, "/a")
    _, where = router.submit("sum", ext[0].block, 1,
                             read_extents=ext).result(timeout=30)
    assert where in ("storage0", "storage1")


def test_quarantined_target_rejoins_on_successful_probe():
    clock = ManualClock()
    dev, fs, fabric, engines, off, router = build_cluster(
        2, clock=clock, max_probe_failures=1)
    fabric.kill("storage1")
    clock.advance(0.1)
    router.probe()
    assert router.members["storage1"].state == QUARANTINED
    fabric.revive("storage1")
    clock.advance(0.1)
    router.probe()
    assert router.members["storage1"].state == LIVE
    assert "storage1" in off.targets
    assert router.stats.rejoined == 1


def test_stale_telemetry_quarantined_within_aging_window():
    """The aging tentpole: a target that stops reporting decays toward
    'unknown' and is quarantined — NOT kept at its last flattering
    reading, NOT preferred for being silent."""
    clock = ManualClock()
    dev, fs, fabric, engines, off, router = build_cluster(
        2, clock=clock, stale_after=3.0, telemetry_half_life=1.0)
    router.probe()  # stamps both gauges at t=0
    g = off._depth_ewma["storage1"]
    assert g.updated_at is not None
    # silence: inside the window nothing happens
    clock.advance(2.0)
    assert router.sweep_stale() == []
    assert router.telemetry_age("storage1") == pytest.approx(2.0)
    # past the window: quarantined by age alone, no probe needed
    clock.advance(1.5)
    hit = router.sweep_stale()
    assert set(hit) == {"storage0", "storage1"}  # both went silent
    assert router.members["storage1"].state == QUARANTINED
    assert "storage1" not in off.targets


def test_aged_ewma_decays_toward_unknown():
    g = EwmaGauge(alpha=1.0)
    g.update(8.0, now=10.0)
    assert g.aged_value(10.0, half_life=2.0) == pytest.approx(8.0)
    assert g.aged_value(12.0, half_life=2.0) == pytest.approx(4.0)
    assert g.aged_value(16.0, half_life=2.0) == pytest.approx(1.0)
    assert g.age(16.0) == pytest.approx(6.0)
    fresh = EwmaGauge()
    assert fresh.age(99.0) == float("inf")
    assert fresh.aged_value(99.0, half_life=2.0) == 0.0


def test_fleet_pressure_uses_aged_not_frozen_readings():
    clock = ManualClock()
    dev, fs, fabric, engines, off, router = build_cluster(
        1, clock=clock, telemetry_half_life=1.0, stale_after=100.0)
    with off._lock:
        off._depth_ewma["storage0"] = EwmaGauge(alpha=1.0)
        off._depth_ewma["storage0"].update(8.0, now=clock())
    hot = router.fleet_pressure()
    assert hot == pytest.approx(8.0)
    clock.advance(2.0)  # two half-lives of silence
    assert router.fleet_pressure() == pytest.approx(2.0)


def test_health_channel_partition_quarantines_but_tasks_still_flow():
    """Only the ping method is dropped: the target serves tasks fine but
    never reports health — the router must still quarantine it (silence
    is indistinguishable from death) while already-routed work lands."""
    clock = ManualClock()
    dev, fs, fabric, engines, off, router = build_cluster(
        2, clock=clock, max_probe_failures=2)
    fabric.drop("storage1", 1.0, methods={"ping"})
    ext = make_file(fs, "/a")
    for _ in range(2):
        clock.advance(0.1)
        router.probe()
    assert router.members["storage1"].state == QUARANTINED
    assert fabric.injected["dropped"] >= 2
    # the data plane was never touched: a direct submit still works there
    _, where = off.submit("sum", ext[0].block, 1, read_extents=ext,
                          target="storage1")
    assert where == "storage1"


def test_isolate_heal_partition_distinct_from_death():
    dev, fs, fabric, engines, off, router = build_cluster(2, seed=9)
    fabric.isolate("storage1")
    ext = make_file(fs, "/a")
    with pytest.raises(Exception):
        off.submit("sum", ext[0].block, 1, read_extents=ext,
                   target="storage1")
    assert fabric.injected["partitioned"] >= 1
    assert fabric.injected["dead"] == 0
    fabric.heal("storage1")
    _, where = off.submit("sum", ext[0].block, 1, read_extents=ext,
                          target="storage1")
    assert where == "storage1"
    assert not fs._leases


# ------------------------------------------------------------ priority
def test_background_queues_behind_foreground_under_overload():
    pressure = [10.0]
    dev, fs, fabric, engines, off, router = build_cluster(
        2, overload_threshold=4.0, pressure_fn=lambda: pressure[0])
    bg_ext = make_file(fs, "/bg", 1)
    fg_ext = make_file(fs, "/fg", 1)
    bg = router.submit("fill", bg_ext[0].block, 1, 0x11,
                       write_extents=bg_ext, priority="background")
    assert not bg.done()
    assert router.stats.queued == 1
    assert not fs._leases  # queued work holds NO lease (nothing quiesced)
    # foreground cuts ahead while the fleet is overloaded
    fg = router.submit("fill", fg_ext[0].block, 1, 0x22,
                       write_extents=fg_ext, priority="foreground")
    fg.result(timeout=30)
    assert not bg.done()  # still held
    pressure[0] = 0.0
    assert router.pump() == 1
    bg.result(timeout=30)
    assert fs.read("/bg") == bytes([0x11]) * BLOCK_SIZE
    assert fs.read("/fg") == bytes([0x22]) * BLOCK_SIZE


def test_background_shed_on_request_or_full_queue():
    pressure = [10.0]
    dev, fs, fabric, engines, off, router = build_cluster(
        1, overload_threshold=1.0, pressure_fn=lambda: pressure[0],
        max_queued=1)
    ext = make_file(fs, "/a")
    shed = router.submit("sum", ext[0].block, 1, read_extents=ext,
                         priority="background", shed=True)
    with pytest.raises(OverloadShed):
        shed.result(timeout=5)
    q1 = router.submit("sum", ext[0].block, 1, read_extents=ext,
                       priority="background")
    assert not q1.done()
    overflow = router.submit("sum", ext[0].block, 1, read_extents=ext,
                             priority="background")
    with pytest.raises(OverloadShed):  # queue full → shed
        overflow.result(timeout=5)
    assert router.stats.shed == 2
    pressure[0] = 0.0
    router.pump()
    q1.result(timeout=30)


# -------------------------------------------------------- cancellation
def test_cancel_queued_request_never_runs_never_leases():
    pressure = [10.0]
    dev, fs, fabric, engines, off, router = build_cluster(
        1, overload_threshold=1.0, pressure_fn=lambda: pressure[0])
    ext = make_file(fs, "/a", 1)
    req = router.submit("fill", ext[0].block, 1, 0x77, write_extents=ext,
                        priority="background")
    ran_before = engines[0].tasks_run
    assert req.cancel()
    with pytest.raises(RequestCancelled):
        req.result(timeout=5)
    pressure[0] = 0.0
    assert router.pump() == 0  # nothing left to release
    assert engines[0].tasks_run == ran_before
    assert fs.read("/a") == bytes([0xAB]) * BLOCK_SIZE  # untouched
    assert not fs._leases
    assert router.stats.cancelled_queued == 1
    assert not req.cancel()  # idempotent: already resolved


def test_cancel_inflight_releases_lease_through_journal_and_fences():
    """The cancellation tentpole: revoking an in-flight request releases
    its write lease NOW (journaled), the blocks stop being quiesced, and
    the target's late write dies on the lease fence — the device never
    sees the cancelled task's bytes."""
    dev, fs, fabric, engines, off, router = build_cluster(1, seed=5)
    fabric.delay("storage0", 0.4, methods={"submit_task"})
    ext = make_file(fs, "/a")
    req = router.submit("fill", ext[0].block, 2, 0xEE, write_extents=ext)
    deadline = time.time() + 5
    while req._inner is None and time.time() < deadline:
        time.sleep(0.005)
    tid = req._inner.lease.task_id
    assert fs._leases  # lease granted, blocks quiesced
    assert req.cancel()
    with pytest.raises(RequestCancelled):
        req.result(timeout=5)
    assert not fs._leases  # revoked immediately, before the target ran
    assert tid not in fs.lease_journal.replay()  # release JOURNALED
    fabric.drain()  # let the delayed task hit the fence
    assert fs.read("/a") == bytes([0xAB]) * (2 * BLOCK_SIZE)  # fenced bytes
    assert router.stats.cancelled_inflight == 1
    # the volume is immediately reusable: the write set is un-quiesced
    fs.write("/a", bytes([0xCD]) * BLOCK_SIZE, 0)
    assert fs.read("/a")[:BLOCK_SIZE] == bytes([0xCD]) * BLOCK_SIZE


# ------------------------------------------------------------ failover
def test_standby_takeover_fences_every_orphan_and_reads_identical():
    """Warm-path failover: initiator 'dies' with write leases outstanding;
    the standby re-mounts, replays the journal, fences 100% of the
    orphans, and reads byte-identical data."""
    dev = BlockDevice(num_blocks=1 << 16)
    fs = OffloadFS(dev, node="init0")
    payload = {f"/f{i}": bytes([0x30 + i]) * (2 * BLOCK_SIZE)
               for i in range(3)}
    for p, data in payload.items():
        fs.create(p)
        fs.write(p, data, 0)
    fs.flush_metadata()
    # reprolint: allow[lease-raw] deliberate orphans: standby takeover must fence them
    leases = [fs.grant_lease((), fs.stat(p).extents) for p in payload]
    orphan_tids = {ls.task_id for ls in leases}
    # ...the initiator process is now "dead"; nothing was released.
    fs2, fenced = standby_takeover(dev, node="standby0")
    assert set(fenced) == orphan_tids  # 100% orphan fencing
    assert not fs2.orphan_leases() and not fs2._leases
    assert fs2.lease_journal.replay() == {}  # journal compacted
    for p, data in payload.items():
        assert fs2.read(p) == data  # byte-identical
    # a straggler write from the dead incarnation's target is fenced
    with pytest.raises(LeaseViolation):
        fs2.authorized_write(leases[0], min(leases[0].write_blocks),
                             b"late", node="storage0")
    # the standby owns the namespace: previously-quiesced blocks writable
    fs2.write("/f0", bytes([0x99]) * BLOCK_SIZE, 0)
    assert fs2.read("/f0")[:BLOCK_SIZE] == bytes([0x99]) * BLOCK_SIZE


def _run_failover_child(tmpdir: str) -> None:
    """Cold-process child: build a volume, write data, grant write leases
    'mid-flush', persist the device image, die WITHOUT releasing."""
    dev = BlockDevice(num_blocks=1 << 16)
    fs = OffloadFS(dev, node="init0")
    payload = {f"/f{i}": bytes([0x40 + i]) * (2 * BLOCK_SIZE)
               for i in range(4)}
    for p, data in payload.items():
        fs.create(p)
        fs.write(p, data, 0)
    fs.flush_metadata()
    # reprolint: allow[lease-raw] deliberate orphans: standby takeover must fence them
    leases = [fs.grant_lease((), fs.stat(p).extents)
              for p in list(payload)[:2]]  # 2 in-flight "flushes"
    dev.save(os.path.join(tmpdir, "volume.bin"))
    with open(os.path.join(tmpdir, "expect.json"), "w") as f:
        json.dump({
            "orphans": sorted(ls.task_id for ls in leases),
            "files": {p: len(d) for p, d in payload.items()},
            "bytes0": payload["/f0"][0],
            "foreign": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "repro")),
        }, f)
    os._exit(1)  # crash mid-flush: no release, no cleanup, no atexit


def test_cold_process_standby_failover(tmp_path):
    """The CI ``failover-smoke`` scenario: the initiator PROCESS is killed
    mid-flush (os._exit in a real subprocess), a standby process (this
    one) loads the volume, re-mounts, fences orphans, reads clean."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr  # died the way we told it to
    with open(tmp_path / "expect.json") as f:
        expect = json.load(f)
    assert expect["foreign"] == []  # the child ran on the port alone
    dev = BlockDevice.load(str(tmp_path / "volume.bin"))
    fs, fenced = standby_takeover(dev, node="standby0")
    assert sorted(fenced) == expect["orphans"]  # journal replay → fence
    assert not fs.orphan_leases() and not fs._leases
    assert fs.lease_journal.replay() == {}
    for p, size in expect["files"].items():
        data = fs.read(p)
        assert len(data) == size
        assert set(data) == {expect["bytes0"] + int(p[2:])}  # byte-identical
    fs.write("/f0", b"\xA5" * BLOCK_SIZE, 0)  # namespace fully owned
    assert fs.read("/f0")[:BLOCK_SIZE] == b"\xA5" * BLOCK_SIZE


# -------------------------------------------------------- determinism
def test_faultyfabric_seed_determinism():
    def run(seed):
        fab = FaultyFabric(seed=seed)
        fab.register("n", "m", lambda: "ok")
        fab.drop("n", 0.5)
        out = []
        for _ in range(32):
            try:
                fab.call("c", "n", "m")
                out.append(1)
            except Exception:
                out.append(0)
        return out

    a, b, c = run(7), run(7), run(8)
    assert a == b  # same seed → identical fault schedule
    assert a != c  # different seed → different schedule
    assert 0 < sum(a) < 32  # p=0.5 really drops some and passes some


def test_faultyfabric_duplicate_and_delay():
    fab = FaultyFabric(seed=1)
    hits = []
    fab.register("n", "m", lambda: hits.append(1) or len(hits))
    fab.duplicate("n", 1.0)
    fab.call("c", "n", "m")
    assert len(hits) == 2  # at-least-once delivery
    assert fab.injected["duplicated"] == 1
    fab.clear_faults("n")
    fab.delay("n", 0.05)
    t0 = time.time()
    fab.call("c", "n", "m")
    assert time.time() - t0 >= 0.05
    assert fab.injected["delayed"] == 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _run_failover_child(sys.argv[2])
    else:  # pragma: no cover - convenience direct run
        sys.exit(pytest.main([__file__, "-q"]))


def test_heartbeat_thread_quarantines_dead_target():
    """start_heartbeat runs probe() on a daemon thread: a killed target is
    quarantined with NO manual probe calls."""
    dev, fs, fabric, engines, off, router = build_cluster(
        3, max_probe_failures=2)
    with pytest.raises(ValueError):
        router.start_heartbeat(0.0)
    router.start_heartbeat(0.01)
    try:
        with pytest.raises(RuntimeError):
            router.start_heartbeat(0.01)  # double start refused
        fabric.kill("storage2")
        deadline = time.time() + 5.0
        while (router.members["storage2"].state != QUARANTINED
               and time.time() < deadline):
            time.sleep(0.005)
        assert router.members["storage2"].state == QUARANTINED
        assert "storage2" not in off.targets
        assert router.stats.heartbeats >= 2  # the thread actually beat
    finally:
        router.stop_heartbeat()
    beats = router.stats.heartbeats
    router.stop_heartbeat()  # idempotent
    time.sleep(0.05)
    assert router.stats.heartbeats == beats  # thread really stopped
    # the plane still serves around the quarantined corpse
    ext = make_file(fs, "/hb")
    _, where = router.submit("sum", ext[0].block, 1,
                             read_extents=ext).result(timeout=30)
    assert where in ("storage0", "storage1")
    wait_no_leases(fs)


# ------------------------------------------------------ pushdown plane
def _pushdown_plane(n_targets, fabric):
    """``tests/pushdown_util.py``'s ``build_plane`` built from the port's
    modules, its DB merging on the CPU (the merge's plain version)."""
    from repro_torch.core.lsm import compaction as C
    from repro_torch.core.lsm import DBConfig, OffloadDB

    dev = BlockDevice(num_blocks=1 << 14)
    fs = OffloadFS(dev, node="init0", shards=n_targets)
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}")
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        P.register_pushdown_stub(eng)
        serve_engine(eng, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[f"storage{t}" for t in range(n_targets)],
                        lb_policy="placement_affinity")
    db = OffloadDB(fs, off, DBConfig(memtable_bytes=4 * 1024, log_recycling=False,
                                     l0_cache=False, l0_trigger=999), device="cpu")
    return fs, db


def test_pushdown_scan_survives_target_death_mid_scan():
    """A target dies while its pushdown sub-scan is in flight: the share
    reroutes (other target, then local) under the ORIGINAL read lease and
    the scan returns byte-identical rows — zero leaked leases."""
    fabric = FaultyFabric(seed=7)
    fs, db = _pushdown_plane(3, fabric)
    for i in range(90):
        tag = b"A" if i % 4 == 0 else b"B"
        db.put(f"k{i:04d}".encode(), tag + bytes(20 + i % 7))
        if i % 30 == 29:
            db.flush_all()  # three tables, rotating stripes
    prog = P.build_scan(where=P.prefix(P.value(), b"A"))
    expect = db.scan(program=prog, pushdown=False)
    assert len(expect) == 23
    fabric.kill_after("storage1", 0)  # dies at delivery of its sub-scan
    assert db.scan(program=prog, pushdown=True) == expect
    wait_no_leases(fs)
    fabric.kill("storage0")  # a second target fully dead: retries refused
    assert db.scan(program=prog, pushdown=True) == expect
    wait_no_leases(fs)
    # and the degenerate fleet: every target dead → every share local
    fabric.kill("storage2")
    assert db.scan(program=prog, pushdown=True) == expect
    wait_no_leases(fs)
    # an aggregate through the same wreckage
    agg = P.build_scan(where=P.prefix(P.value(), b"A"), aggregate="count")
    assert db.scan(program=agg, pushdown=True) == 23
    wait_no_leases(fs)


def test_pushdown_priority_queues_under_overload_drains_before_background():
    """The third I/O class: pushdown queues under overload (it is not
    foreground), but pump() drains it strictly before background."""
    order = []

    def stub_mark(io, tag):
        order.append(tag)
        return tag

    dev = BlockDevice(num_blocks=1 << 12)
    fs = OffloadFS(dev, node="init0")
    # ONE rpc worker: execution order == dispatch order, so the drain
    # order is observable through the stub
    fabric = FaultyFabric(seed=0, workers=1)
    eng = OffloadEngine(fs, node="storage0", enable_cache=False)
    eng.register_stub("mark", stub_mark)
    serve_engine(eng, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="init0", targets=["storage0"])
    off.register_local_stub("mark", stub_mark)
    pressure = [10.0]
    router = ClusterRouter(off, overload_threshold=1.0,
                           pressure_fn=lambda: pressure[0])
    with pytest.raises(ValueError):
        router.submit("mark", "x", priority="bulk")
    bg = router.submit("mark", "bg", priority="background")
    pd = router.submit("mark", "pd", priority="pushdown")
    assert not bg.done() and not pd.done()  # both classes held back
    assert router.stats.queued == 2
    assert not fs._leases  # queued work quiesces nothing
    fg = router.submit("mark", "fg", priority="foreground")
    fg.result(timeout=30)
    assert not pd.done()  # pushdown is latency-tolerant: still queued
    pressure[0] = 0.0
    assert router.pump() == 2
    pd.result(timeout=30)
    bg.result(timeout=30)
    assert order == ["fg", "pd", "bg"]  # class ladder, FIFO within class
    wait_no_leases(fs)


def test_pushdown_shed_under_pressure_when_requested():
    """A pushdown share with shed=True prefers failure to waiting, same
    as background — the scan planner can then degrade to block shipping."""
    pressure = [10.0]
    dev, fs, fabric, engines, off, router = build_cluster(
        1, overload_threshold=1.0, pressure_fn=lambda: pressure[0])
    ext = make_file(fs, "/p")
    req = router.submit("sum", ext[0].block, 1, read_extents=ext,
                        priority="pushdown", shed=True)
    with pytest.raises(OverloadShed, match="pushdown shed"):
        req.result(timeout=5)
    assert router.stats.shed == 1
    assert not fs._leases


# --------------------------------------------------- against the JAX package
def _router_scenario(pkg):
    """One seeded run of the router in package ``pkg`` (``repro`` or
    ``repro_torch``): probes through a lossy health channel, a kill and its
    quarantine, reads and writes routed around it, a cancelled in-flight
    write. Every request is awaited, and its lease released, before the
    next, so the run is a function of the seed alone."""
    import dataclasses
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    off_mod = importlib.import_module(f"{pkg}.core.offloader")
    adm = importlib.import_module(f"{pkg}.core.admission")
    clock = ManualClock()
    dev = core.BlockDevice(num_blocks=1 << 14)
    fs = core.OffloadFS(dev, node="init0", shards=3)
    fabric = core.FaultyFabric(seed=11)
    for t in range(3):
        eng = core.OffloadEngine(fs, node=f"storage{t}", enable_cache=False)
        eng.register_stub("sum", stub_sum)
        eng.register_stub("fill", stub_fill)
        off_mod.serve_engine(eng, fabric, adm.AcceptAll())
    off = core.TaskOffloader(fs, fabric, node="init0",
                             targets=[f"storage{t}" for t in range(3)],
                             lb_policy="least_outstanding")
    router = core.ClusterRouter(off, clock=clock, max_probe_failures=2)
    exts = [make_file(fs, f"/f{i}", 1 + i % 3, byte=0x10 + i) for i in range(6)]
    log = []

    def settle(req):
        try:
            log.append(("ok", req.result(timeout=30)))
        except Exception as e:  # noqa: BLE001 - the class is the record
            log.append(("raised", type(e).__name__))
        wait_no_leases(fs)

    fabric.drop("storage1", 0.5, methods={"ping"})
    for _ in range(3):
        clock.advance(0.5)
        log.append(sorted(router.probe().items()))
    for i, ext in enumerate(exts):
        settle(router.submit("sum", ext[0].block, len(ext), read_extents=ext))
        settle(router.submit("fill", ext[0].block, 1, 0x60 + i, write_extents=ext))
    fabric.kill("storage2")
    for ext in exts[:3]:  # least-outstanding still feeds the dead target one
        settle(router.submit("sum", ext[0].block, 1, read_extents=ext))
    for _ in range(3):
        clock.advance(0.5)
        log.append(sorted(router.probe().items()))
    for ext in exts:
        settle(router.submit("sum", ext[0].block, 1, read_extents=ext))
    fabric.delay("storage0", 0.2, methods={"submit_task"})
    req = router.submit("fill", exts[1][0].block, 1, 0xEE, write_extents=exts[1])
    while req._inner is None:
        time.sleep(0.002)
    log.append(req.cancel())
    fabric.drain()
    wait_no_leases(fs)
    return {
        "journal": bytes(fs.lease_journal._buf),
        "outstanding": fs.lease_journal.replay(),
        "stats": dataclasses.asdict(router.stats),
        "members": {n: (m.state, m.probe_failures) for n, m in router.members.items()},
        "targets": list(off.targets),
        "injected": dict(fabric.injected),
        "log": log,
        "files": {f"/f{i}": ([(e.block, e.nblocks, e.shard) for e in fs.stat(f"/f{i}").extents],
                             fs.read(f"/f{i}")) for i in range(6)},
    }


def test_router_same_seed_same_journal_stats_and_placement_as_jax():
    pytest.importorskip("jax")  # the JAX package is the reference
    want, got = _router_scenario("repro"), _router_scenario("repro_torch")
    assert got["stats"]["quarantined"] == 1 and got["targets"] == ["storage0", "storage1"]
    assert got == want
