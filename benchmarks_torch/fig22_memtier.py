# Copied from benchmarks/fig22_memtier.py; imports rewritten, history notes cut.
"""Fig. 22 — MemTier: lease-coherent disaggregated-memory block cache
between initiator DRAM and NVMe (this repo's extension).

The paper pushes *computation* to the storage nodes; MemTier pushes a
second *memory tier* there: each storage/peer engine node donates a DRAM
partition that caches recently-served blocks, so a hot working set is
re-read at fabric-DRAM latency instead of re-crossing the NVMe flash
path. Coherence is the lease plane's, not a DLM's: every journaled
write-lease grant, free/trim, migration and orphan reclaim fences the
cached copies. Four measurements:

  A. Hot-working-set read throughput (functional, wall-clock): a zipf
     read loop over striped files on a device with a modeled NVMe fetch
     latency, tier-attached vs NVMe-only, 4 targets. Claims: **tier
     read throughput ≥ 1.3× NVMe-only at 4 targets**, bytes identical.

  B. Interference partitioning (functional): per-I/O-class partitions +
     ghost-list admission. A one-pass background scan ≫ cache capacity
     runs between foreground phases. Claims: **foreground entries
     survive the scan (hit rate ≥ 0.9 after)**, the scan itself stays
     admission-filtered (scan hit rate ≈ 0).

  C. Coherence under fire (functional): (C1) an invalidation storm —
     interleaved overwrites + reads — serves zero stale bytes; (C2) a
     cache node is killed mid-workload, revived WITH its stale DRAM
     state, and the taint protocol still serves byte-identical reads;
     (C3) an initiator dies holding a journaled write lease, the
     standby takes over with ``standby_takeover(memtier=...)``.
     Claims: **zero stale reads, 100% of orphaned leases fenced,
     standby reads byte-identical through the inherited (wiped) tier**.

  D. Fleet-scale DES: ``run_memtier`` drives one functional
     ``MemTierNode`` per storage node under zipf + diurnal tenant load.
     Claims: **≥128 storage nodes and ≥1000 tenants simulated**, tier
     mean latency beats NVMe-only, foreground hit rate ≥ 0.25 while the
     background-scanner hit rate stays ≤ 0.02.

Run ``--smoke`` for the CI-sized subset (fewer timed reads, claims
unchanged).
"""
from __future__ import annotations

import sys
import time
from dataclasses import replace

from benchmarks_torch.common import check, emit
from repro_torch.core import (
    BlockDevice,
    FaultyFabric,
    MemTier,
    OffloadEngine,
    OffloadFS,
    standby_takeover,
)
from repro_torch.core.admission import AcceptAll
from repro_torch.core.fs import MigrationCrash
from repro_torch.core.offloader import serve_engine
from repro_torch.sim.kvmodel import MemTierParams, run_memtier

N_TARGETS = 4
SEED = 22
BLOCK = 4096
FILE_BLOCKS = 8  # 32 KiB per file — one extent run on a fresh volume


def build_plane(n_targets: int = N_TARGETS, *, read_latency_s: float = 0.0,
                memtier_blocks: int = 4096, attach: bool = True):
    """An offload plane whose engine nodes each host a MemTier partition
    (``serve_engine`` registers the cache_* endpoints). ``attach=False``
    builds the same plane but leaves the FS NVMe-only — the baseline."""
    dev = BlockDevice(num_blocks=1 << 16, read_latency_s=read_latency_s)
    fs = OffloadFS(dev, node="init0", shards=n_targets)
    fabric = FaultyFabric(seed=SEED)
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}",
                            memtier_blocks=memtier_blocks)
        serve_engine(eng, fabric, AcceptAll())
        engines.append(eng)
    tier = MemTier(fabric, [e.node for e in engines], node="init0")
    if attach:
        fs.attach_memtier(tier)
    return dev, fs, fabric, engines, tier


def zipf_seq(n_ops: int, n_files: int, *, s: float = 1.1,
             seed: int = 7) -> list:
    """Deterministic zipf-popular file indices (xorshift, no wall clock)."""
    tot = sum((k + 1) ** -s for k in range(n_files))
    cdf, acc = [], 0.0
    for k in range(n_files):
        acc += (k + 1) ** -s / tot
        cdf.append(acc)
    out, x = [], seed
    for _ in range(n_ops):
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        u = x / 0xFFFFFFFF
        out.append(next((k for k, c in enumerate(cdf) if u <= c),
                        n_files - 1))
    return out


def payload(i: int) -> bytes:
    return bytes([i % 251] * (FILE_BLOCKS * BLOCK))


# ------------------------------------------------------------------ A
def hot_set_throughput(smoke: bool) -> None:
    n_files = 16 if smoke else 32
    n_ops = 300 if smoke else 1200
    lat = 400e-6 if smoke else 500e-6
    seq = zipf_seq(n_ops, n_files)
    elapsed = {}
    for mode in ("nvme_only", "tier"):
        dev, fs, fabric, engines, tier = build_plane(
            read_latency_s=lat, attach=(mode == "tier"))
        for i in range(n_files):
            fs.create(f"/hot/{i}")
            fs.write(f"/hot/{i}", payload(i))
        # warm: two passes take the hot set through the ghost list
        # (first touch → ghost, second → admitted); identical work for
        # the baseline, which just pays the NVMe latency twice
        for _ in range(2):
            for i in range(n_files):
                fs.read(f"/hot/{i}")
        t0 = time.perf_counter()
        ok = all(fs.read(f"/hot/{i}") == payload(i) for i in seq)
        elapsed[mode] = time.perf_counter() - t0
        check(f"fig22/{mode}_bytes_identical", ok,
              f"{n_ops} zipf reads returned the written payloads")
        if mode == "tier":
            hr = tier.hit_rate("foreground")
            emit("fig22/tier_hit_rate", f"{hr:.3f}",
                 f"foreground, {n_files} files x {FILE_BLOCKS} blocks, "
                 f"{N_TARGETS} cache nodes")
    mb = n_ops * FILE_BLOCKS * BLOCK / 1e6
    ratio = elapsed["nvme_only"] / elapsed["tier"] if elapsed["tier"] else 0.0
    emit("fig22/read_throughput_mbps",
         f"nvme={mb / elapsed['nvme_only']:.0f};tier={mb / elapsed['tier']:.0f}",
         f"zipf hot set, NVMe fetch latency {lat * 1e6:.0f}us, {ratio:.1f}x")
    check("fig22/tier_beats_nvme_1p3x", ratio >= 1.3,
          f"tier {ratio:.1f}x NVMe-only read throughput (floor 1.3x)")


# ------------------------------------------------------------------ B
def partition_isolation(smoke: bool) -> None:
    n_fg = 8
    cap = 64  # per-node per-partition capacity, in blocks
    n_scan = 64 if smoke else 128  # scan footprint >> total cache capacity
    dev, fs, fabric, engines, tier = build_plane(memtier_blocks=cap)
    for i in range(n_fg):
        fs.create(f"/fg/{i}")
        fs.write(f"/fg/{i}", payload(i))
    for i in range(n_scan):
        fs.create(f"/scan/{i}")
        fs.write(f"/scan/{i}", payload(100 + i))
    # foreground warm: ghost → admit
    for _ in range(2):
        for i in range(n_fg):
            fs.read(f"/fg/{i}")
    # one-pass background scan, twice the cache capacity: the ghost list
    # admits second touches, but a one-pass scan never re-touches — and
    # whatever it does admit lands in the background partition only
    for _ in range(2):
        for i in range(n_scan):
            fs.read(f"/scan/{i}", io_class="background")
    before = tier.stats()
    ok = all(fs.read(f"/fg/{i}") == payload(i) for i in range(n_fg))
    after = tier.stats()
    fg_gets = after["gets"] - before["gets"]
    fg_rate = (after["hits"] - before["hits"]) / fg_gets if fg_gets else 0.0
    scan_rate = tier.hit_rate("background")
    emit("fig22/partition_hit_rates",
         f"foreground_after_scan={fg_rate:.3f};background={scan_rate:.3f}",
         f"{n_scan * FILE_BLOCKS}-block scan vs {cap}-block partitions")
    check("fig22/scan_does_not_evict_foreground",
          ok and fg_rate >= 0.9,
          f"foreground hit rate {fg_rate:.2f} after a "
          f"{n_scan * FILE_BLOCKS}-block background scan (floor 0.9)")
    check("fig22/scan_stays_admission_filtered", scan_rate <= 0.5,
          f"one-pass scan hit rate {scan_rate:.3f} — the ghost filter "
          "keeps single-touch blocks out of the resident set")


# ------------------------------------------------------------------ C
def coherence_under_fire(smoke: bool) -> None:
    rounds = 4 if smoke else 10
    n_files = 6

    # C1: invalidation storm — overwrites interleaved with reads
    dev, fs, fabric, engines, tier = build_plane()
    for i in range(n_files):
        fs.create(f"/c/{i}")
        fs.write(f"/c/{i}", payload(i))
    stale = 0
    for r in range(rounds):
        for i in range(n_files):
            fs.read(f"/c/{i}")  # populate / re-touch the tier
        for i in range(n_files):
            fs.write(f"/c/{i}", payload(r * n_files + i))
            if fs.read(f"/c/{i}") != payload(r * n_files + i):
                stale += 1
    inv = tier.stats()["invalidated_blocks"]
    emit("fig22/invalidation_storm",
         f"stale_reads={stale};invalidated_blocks={inv}",
         f"{rounds} rounds x {n_files} overwrite+read pairs")
    check("fig22/storm_zero_stale_reads", stale == 0 and inv > 0,
          f"{stale} stale reads across {rounds * n_files} overwrites "
          f"({inv} blocks invalidated)")

    # C2: kill a cache node mid-workload, revive it WITH its stale DRAM
    # state — the taint protocol must reset-before-reuse
    victim = engines[0].node
    fabric.kill(victim)
    stale = sum(fs.read(f"/c/{i}") != payload((rounds - 1) * n_files + i)
                for i in range(n_files))
    for i in range(n_files):  # writes while the node is down
        fs.write(f"/c/{i}", payload(200 + i))
    fabric.revive(victim)  # revives with pre-kill cache contents
    stale += sum(fs.read(f"/c/{i}") != payload(200 + i)
                 for i in range(n_files))
    for _ in range(2):  # re-warm: puts to the tainted node reset it first
        for i in range(n_files):
            fs.read(f"/c/{i}")
    stale += sum(fs.read(f"/c/{i}") != payload(200 + i)
                 for i in range(n_files))
    st = tier.stats()
    emit("fig22/cache_node_kill",
         f"stale_reads={stale};taints={st['taints']};resets={st['resets']}",
         f"killed+revived {victim} with stale DRAM state")
    check("fig22/node_kill_byte_identical",
          stale == 0 and st["taints"] >= 1 and not tier.tainted_nodes(),
          f"{stale} stale reads through kill/revive; node re-admitted "
          f"after {st['resets']} wipe(s)")

    # C3: initiator dies holding a journaled write lease mid-invalidation;
    # the standby inherits the tier (conservatively wiped) and fences
    dev, fs, fabric, engines, tier = build_plane(2)
    for i in range(n_files):
        fs.create(f"/c/{i}")
        fs.write(f"/c/{i}", payload(i))
        fs.read(f"/c/{i}")
    fs.flush_metadata()
    try:
        with fs.write_lease("/c/0"):
            raise MigrationCrash("initiator died mid-offloaded-write")
    except MigrationCrash:
        pass
    orphans = len(fs._leases)
    fs2, fenced = standby_takeover(dev, shards=2, memtier=tier)
    ok = all(fs2.read(f"/c/{i}") == payload(i) for i in range(n_files))
    check("fig22/takeover_fences_all_orphans",
          orphans >= 1 and len(fenced) == orphans and not fs2._leases,
          f"{len(fenced)}/{orphans} orphaned write leases fenced "
          "through the inherited tier")
    check("fig22/standby_reads_byte_identical",
          ok and tier.stats()["fences"] >= 1,
          "standby reads byte-identical through the wiped+fenced tier")


# ------------------------------------------------------------------ D
def des_fleet_sweep(smoke: bool) -> None:
    p = MemTierParams()  # 128 storage nodes, 1000 tenants
    tier = run_memtier(p)
    base = run_memtier(replace(p, tier=False))
    ratio = (base.mean_latency / tier.mean_latency
             if tier.mean_latency else 0.0)
    emit("fig22/des/fleet",
         f"nodes={tier.n_storage};tenants={tier.n_tenants};"
         f"events={tier.events}",
         f"zipf s={p.zipf_s}, diurnal amp={p.diurnal_amp}, "
         f"{p.scan_tenants:.0%} scanners")
    emit("fig22/des/latency_us",
         f"tier={tier.mean_latency * 1e6:.0f};base={base.mean_latency * 1e6:.0f};"
         f"tier_p99={tier.p99_latency * 1e6:.0f}",
         f"mean read+write op latency, {ratio:.2f}x")
    emit("fig22/des/hit_rates",
         f"foreground={tier.hit_rate:.3f};scanners={tier.scan_hit_rate:.3f}",
         f"{tier.invalidations} write invalidations")
    check("fig22/des_fleet_scale",
          tier.n_storage >= 128 and tier.n_tenants >= 1000
          and tier.events >= 100_000,
          f"{tier.n_storage} storage nodes, {tier.n_tenants} tenants, "
          f"{tier.events} DES events")
    check("fig22/des_tier_beats_nvme",
          tier.mean_latency < base.mean_latency,
          f"tier mean {tier.mean_latency * 1e6:.0f}us vs NVMe-only "
          f"{base.mean_latency * 1e6:.0f}us ({ratio:.2f}x)")
    check("fig22/des_admission_isolates_scanners",
          tier.hit_rate >= 0.25 and tier.scan_hit_rate <= 0.02,
          f"foreground hit {tier.hit_rate:.3f} (floor 0.25), scanner hit "
          f"{tier.scan_hit_rate:.3f} (cap 0.02)")


def main():
    smoke = "--smoke" in sys.argv
    hot_set_throughput(smoke)
    partition_isolation(smoke)
    coherence_under_fire(smoke)
    des_fleet_sweep(smoke)


if __name__ == "__main__":
    main()
