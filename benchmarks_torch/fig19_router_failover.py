# Copied from benchmarks/fig19_router_failover.py; imports rewritten, history notes cut.
"""Fig. 19 — ClusterRouter failover: kill 1 of 4 targets, recover
(this repo's extension).

The paper's offload plane assumes a static, always-healthy target set.
``repro_torch.core.router.ClusterRouter`` is the front door that drops that
assumption: probe-driven quarantine, membership churn, priority queueing
and standby takeover. Three measurements:

  A. Kill-one-of-4 recovery (functional, wall-clock): a 4-target plane
     runs rounds of routed fill tasks through ``FaultyFabric``; one
     target is killed mid-run. Before the router notices, submissions
     landing on the corpse surface wire errors (the gray-failure window
     — the dead target completes its errors FAST, so least-outstanding
     keeps feeding it). ``probe()`` quarantines it within
     ``max_probe_failures`` rounds; the failed tasks are resubmitted and
     land on the survivors. Claims: quarantine within the bounded probe
     rounds, **post-kill throughput ≥ 0.7× the pre-kill 4-target rate**,
     every task (including the retried ones) lands byte-exact, and zero
     leases leak across the whole episode.

  B. Standby takeover (functional): the initiator "dies" with write
     leases outstanding; ``standby_takeover`` re-mounts the volume on a
     standby. Claims: 100% of the orphaned leases are fenced and the
     namespace reads back byte-identical — no data scanning.

  C. Health/failover plane cost (DES): one probe round at 4 targets and
     one standby takeover (journal replay + superblock fence) on the
     calibrated testbed, vs the full-volume scan a lease-journal-less
     design would need. Claims: the heartbeat round costs microseconds
     and takeover is ≤ 1% of scanning the data.

Run ``--smoke`` for the CI-sized subset (fewer rounds, claims unchanged).
"""
from __future__ import annotations

import sys
import time

from benchmarks_torch.common import check, emit
from repro_torch.core import (
    BlockDevice,
    ClusterRouter,
    FaultyFabric,
    OffloadFS,
    TaskOffloader,
    standby_takeover,
)
from repro_torch.core.admission import AcceptAll
from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.engine import OffloadEngine
from repro_torch.core.offloader import serve_engine
from repro_torch.core.router import QUARANTINED
from repro_torch.sim.cluster import GB, TESTBED, Cluster
from repro_torch.sim.des import Sim

N_TARGETS = 4
SERVICE_S = 0.002  # per-task target-side service time (keeps rounds honest)
SEED = 7


def stub_fill(io, block, nblocks, byte):
    time.sleep(SERVICE_S)
    io.offload_write(block, bytes([byte]) * (nblocks * BLOCK_SIZE))
    return nblocks


def build_plane():
    dev = BlockDevice(num_blocks=1 << 16)
    fs = OffloadFS(dev, node="init0")
    fabric = FaultyFabric(seed=SEED)
    engines = []
    for t in range(N_TARGETS):
        eng = OffloadEngine(fs, node=f"storage{t}", enable_cache=False)
        eng.register_stub("fill", stub_fill)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[e.node for e in engines],
                        lb_policy="least_outstanding")
    off.register_local_stub("fill", stub_fill)
    router = ClusterRouter(off, max_probe_failures=2)
    return dev, fs, fabric, engines, off, router


def wait_no_leases(fs, timeout=10.0):
    deadline = time.time() + timeout
    while fs._leases and time.time() < deadline:
        time.sleep(0.002)
    return not fs._leases


def run_round(fs, router, tag: str, k: int, byte: int):
    """Submit k routed fills against fresh files; wait for all of them.
    Returns (elapsed_s, ok_tasks, failures) where failures carry enough
    to resubmit: (path, extent, byte)."""
    work = []
    for i in range(k):
        path = f"/{tag}/f{i}"
        fs.create(path)
        fs.write(path, b"\x00" * BLOCK_SIZE, 0)
        ext = fs.stat(path).extents[0]
        work.append((path, ext))
    t0 = time.perf_counter()
    reqs = [(path, ext,
             router.submit("fill", ext.block, ext.nblocks, byte,
                           write_extents=[ext]))
            for path, ext in work]
    ok, failures = 0, []
    for path, ext, req in reqs:
        try:
            req.result(timeout=30.0)
            ok += 1
        except Exception:  # noqa: BLE001 - injected death on the wire
            failures.append((path, ext, byte))
    return time.perf_counter() - t0, ok, failures


def kill_one_of_four(rounds: int, k: int) -> None:
    dev, fs, fabric, engines, off, router = build_plane()
    victim = "storage1"

    run_round(fs, router, "warm", k, 0x01)  # first-touch costs land here
    t_pre, ok = 0.0, 0
    for r in range(rounds):
        t, n, fails = run_round(fs, router, f"pre{r}", k, 0x10 + r)
        t_pre += t
        ok += n
        assert not fails
    rate_pre = ok / t_pre

    fabric.kill(victim)
    t_deg, ok_deg, failures = run_round(fs, router, "deg", k, 0x77)
    emit("fig19/gray_window",
         f"ok={ok_deg};failed={len(failures)}",
         f"wire errors before the router notices {victim} is dead")
    check("fig19/kill_surfaces_errors", len(failures) > 0,
          f"{len(failures)}/{k} submissions hit the corpse (gray failure)")

    probes = 0
    while router.members[victim].state != QUARANTINED and probes < 5:
        router.probe()
        probes += 1
    check("fig19/quarantine_bounded_rounds",
          router.members[victim].state == QUARANTINED
          and probes <= router.max_probe_failures,
          f"quarantined after {probes} probe rounds "
          f"(bound {router.max_probe_failures})")

    # the failed work is resubmitted once the corpse is out of the set
    retried = [router.submit("fill", ext.block, ext.nblocks, byte,
                             write_extents=[ext])
               for _, ext, byte in failures]
    for req in retried:
        req.result(timeout=30.0)

    t_post, ok_post = 0.0, 0
    for r in range(rounds):
        t, n, fails = run_round(fs, router, f"post{r}", k, 0x20 + r)
        t_post += t
        ok_post += n
        assert not fails
    rate_post = ok_post / t_post
    ratio = rate_post / rate_pre if rate_pre else 0.0

    emit("fig19/throughput",
         f"pre={rate_pre:.0f};post={rate_post:.0f}",
         f"tasks/s at {N_TARGETS} targets then {N_TARGETS - 1}, "
         f"{ratio:.2f}x")
    check("fig19/recovered_throughput", ratio >= 0.7,
          f"{ratio:.2f}x of the pre-kill 4-target rate (floor 0.7x)")

    bad = [p for p, _, b in failures
           if fs.read(p) != bytes([b]) * BLOCK_SIZE]
    check("fig19/retried_tasks_land_exact", not bad,
          f"{len(bad)} retried fills mismatch" if bad
          else f"all {len(failures)} retried fills byte-exact on survivors")
    check("fig19/no_leaked_leases", wait_no_leases(fs),
          f"{len(fs._leases)} leases outstanding after the episode")


def takeover(n_files: int) -> None:
    dev = BlockDevice(num_blocks=1 << 16)
    fs = OffloadFS(dev, node="init0")
    byte_map = {}
    for i in range(n_files):
        p = f"/data/f{i}"
        fs.create(p)
        byte_map[p] = bytes([i % 251 + 1]) * BLOCK_SIZE
        fs.write(p, byte_map[p], 0)
    fs.flush_metadata()
    # reprolint: allow[lease-raw] deliberate orphans: failover bench measures takeover fencing
    orphans = [fs.grant_lease([], [fs.stat(f"/data/f{i}").extents[0]])
               for i in range(min(4, n_files))]
    # initiator dies here: leases journaled but never released
    fs2, fenced = standby_takeover(dev, node="standby0")
    check("fig19/takeover_fences_all_orphans",
          sorted(fenced) == sorted(o.task_id for o in orphans),
          f"{len(fenced)}/{len(orphans)} orphaned write leases fenced")
    same = all(fs2.read(p) == v for p, v in byte_map.items())
    check("fig19/takeover_reads_identical", same,
          f"{n_files} files byte-identical on the standby, no data scan")


def des_plane_cost() -> None:
    sim = Sim()
    cl = Cluster(sim, TESTBED, n_storage=N_TARGETS)
    sim.spawn(cl.probe(0, n_targets=N_TARGETS))
    t_probe = sim.run()
    emit("fig19/des/probe_us", f"{t_probe * 1e6:.1f}",
         f"one heartbeat round, {N_TARGETS} targets")
    check("fig19/des_probe_cheap", t_probe < 1e-3,
          f"{t_probe * 1e6:.1f} us — the health plane is noise")

    sim = Sim()
    cl = Cluster(sim, TESTBED, n_storage=N_TARGETS)
    sim.spawn(cl.takeover(0, journal_records=512))
    t_take = sim.run()
    sim = Sim()
    cl = Cluster(sim, TESTBED, n_storage=N_TARGETS)
    sim.spawn(cl.storage_read(0, 2 * GB))  # journal-less: rescan the data
    t_scan = sim.run()
    emit("fig19/des/takeover_ms",
         f"takeover={t_take * 1e3:.3f};scan={t_scan * 1e3:.1f}",
         "512 journaled leases vs rescanning 2 GB of data")
    check("fig19/des_takeover_metadata_only", t_take <= 0.01 * t_scan,
          f"{t_take / t_scan:.4f} of the scan cost (bound 0.01)")


def main():
    smoke = "--smoke" in sys.argv
    kill_one_of_four(rounds=1 if smoke else 2, k=24 if smoke else 48)
    takeover(n_files=8 if smoke else 24)
    des_plane_cost()


if __name__ == "__main__":
    main()
