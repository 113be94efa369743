# Copied from src/repro/core/rebalance.py; imports rewritten, changelog notes cut from comments.
"""Dynamic stripe rebalancer — placement follows computation, online.

Striped placement pins files and DB instances to stripes statically,
so a skewed workload saturates one NVMe FIFO while its neighbours idle —
exactly the load-imbalance problem the paper's initiator-centric block
management (OffloadFS §4) leaves open. BPF-oF's pushdown placement and
Farview's operator offloading show the same thing from the other side:
near-data wins evaporate when data placement no longer matches where the
computation runs. The rebalancer restores that alignment while the system
is serving traffic:

  1. **Detect** — consume the offloader's per-target queue-depth EWMA
     telemetry (``TaskOffloader.shard_utilization``). A stripe is *hot*
     when its pressure exceeds ``skew_threshold`` × the fleet mean. When
     the telemetry carries no signal (cold start, drained plane), the
     static placement load — blocks whose dominant stripe is k — is the
     fallback: it is what drives FIFO traffic under placement-affinity
     routing.
  2. **Pick** — hot files are the files whose dominant stripe is the hot
     one, largest first (moving the most blocks realigns the most traffic
     per journaled migration).
  3. **Migrate** — ``OffloadFS.migrate_file`` runs the copy → swap → free
     cycle under a write lease journaled through ``LeaseJournal``: a crash
     mid-migration is fenced by ``reclaim_orphans()`` on re-mount, and the
     superblock flush at the swap is the commit point — remount sees the
     old or the new placement, never a mix. Files whose blocks are under
     an in-flight lease are skipped (never forced) and retried on a later
     round.

The greedy loop moves files hot → coldest stripe only while each move
strictly reduces the imbalance, so it terminates and never ping-pongs.
``OffloadDB.drain_cold_tables`` scopes a round to an instance's L1+
SSTables (cold data — L0, the immutable memtables and the active WAL are
write-hot) between compaction rounds.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.fs import LeaseViolation, OffloadFS
from repro_torch.core.offloader import TaskOffloader


@dataclass
class Migration:
    """One completed file migration (returned for observability)."""

    path: str
    src: int
    dst: int
    blocks: int


@dataclass
class RebalanceStats:
    rounds: int = 0
    migrations: int = 0
    blocks_moved: int = 0
    skipped_leased: int = 0
    deferred_budget: int = 0  # candidates deferred by the per-round budget
    steered: int = 0  # output allocations steered off an overloaded stripe
    by_dst: Dict[int, int] = field(default_factory=dict)
    # every completed move as (src, dst, blocks) — the DES replay charges
    # this exact copy traffic through the per-stripe FIFOs (fig17)
    moves: List[Tuple[int, int, int]] = field(default_factory=list)


class StripeRebalancer:
    """One per initiator (it mutates metadata, so it must live where the
    single metadata writer lives).

    ``skew_threshold`` — a stripe is hot when its pressure exceeds this
    multiple of the mean (1.5 = 50% above fair share).
    ``free_headroom`` — fraction of the destination stripe that must stay
    free after a migration (don't fill the cold stripe to the brim: its
    own tenants still allocate there).
    ``migration_budget_blocks`` — the migration-rate limiter: at most this
    many blocks copied per round (``rebalance()`` or ``spread()`` call).
    The copy traffic shares the NVMe FIFOs with foreground I/O, so an
    unbounded round can starve the very workload it is trying to help;
    the budget spreads a large backlog over several rounds (candidates
    over budget are counted ``deferred_budget`` and retried next round).
    None = unlimited (one unthrottled burst).
    """

    def __init__(self, fs: OffloadFS, offloader: Optional[TaskOffloader] = None,
                 *, skew_threshold: float = 1.5, free_headroom: float = 0.05,
                 migration_budget_blocks: Optional[int] = None):
        if skew_threshold < 1.0:
            raise ValueError("skew_threshold must be >= 1.0")
        if migration_budget_blocks is not None and migration_budget_blocks < 1:
            raise ValueError("migration_budget_blocks must be >= 1")
        self.fs = fs
        self.off = offloader
        self.skew_threshold = skew_threshold
        self.free_headroom = free_headroom
        self.migration_budget_blocks = migration_budget_blocks
        self.stats = RebalanceStats()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ telemetry
    def shard_pressure(self, *, source: str = "auto") -> Dict[int, float]:
        """Per-stripe pressure driving hot/cold selection and the skew
        gate. ``source="telemetry"`` reads the offloader's queue-depth
        EWMAs (live FIFO pressure — what the autonomous between-compaction
        hook wants); ``"load"`` uses the static placement load (blocks per
        dominant stripe — what a one-shot drain of a misplaced backlog
        wants, since EWMAs are stale once the plane idles); ``"auto"``
        prefers telemetry when it carries signal."""
        if source not in ("auto", "telemetry", "load"):
            raise ValueError(f"unknown pressure source {source!r}")
        if source != "load" and self.off is not None:
            util = self.off.shard_utilization()
            if max(util.values(), default=0.0) > 1e-9 or source == "telemetry":
                return util
        return {k: float(v) for k, v in self.placement_load().items()}

    def placement_load(self) -> Dict[int, int]:
        """Blocks per stripe attributed by each file's *dominant* stripe —
        the routing key placement-affinity uses, hence the traffic each
        stripe's FIFO will serve."""
        load = {k: 0 for k in range(self.fs.shards)}
        for _path, (shard, nblocks) in self._file_placement().items():
            load[shard] += nblocks
        return load

    def _file_placement(self) -> Dict[str, Tuple[int, int]]:
        """{path: (dominant_shard, nblocks)} for every non-empty file."""
        out: Dict[str, Tuple[int, int]] = {}
        for path in self.fs.listdir():
            inode = self.fs.stat(path)
            shard = self.fs.shard_of_extents(inode.extents)
            if shard is None:
                continue
            out[path] = (shard, sum(e.nblocks for e in inode.extents))
        return out

    def skewed(self, *, source: str = "auto") -> bool:
        """The gate: is any stripe's pressure above threshold × mean?"""
        pressure = self.shard_pressure(source=source)
        mean = sum(pressure.values()) / max(1, len(pressure))
        if mean <= 0:
            return False
        return max(pressure.values()) > self.skew_threshold * mean

    # ------------------------------------------------------------- steering
    def steer(self, shard: int) -> int:
        """Placement steering for NEW output allocations (the prevention
        half; the drain hook cures data already placed): keep the job's
        dominant stripe unless its placed load is past the skew threshold,
        in which case route the outputs to the least-loaded stripe.
        Without this, an unpinned instance re-concentrates its whole L1
        onto one stripe at every L0 round (outputs follow the dominant
        input) and no amount of after-the-fact migration can keep up."""
        if not 0 <= shard < self.fs.shards:
            raise ValueError(f"shard {shard} out of range")
        if self.fs.shards <= 1:
            return shard
        # physical stripe occupancy (allocated blocks) — O(shards) from the
        # allocator's own accounting; steering sits on the per-job placement
        # hot path, so a full-filesystem placement scan here would make
        # every flush/compaction O(total files)
        used = {}
        for k in range(self.fs.shards):
            lo, hi = self.fs.extmgr.stripe_range(k)
            used[k] = (hi - lo) - self.fs.extmgr.free_blocks_in(k)
        mean = sum(used.values()) / self.fs.shards
        if mean <= 0 or used[shard] <= self.skew_threshold * mean:
            return shard
        self.stats.steered += 1
        return min(used, key=lambda k: (used[k], k))

    # ------------------------------------------------------------ rebalance
    def rebalance(self, *, max_files: int = 8,
                  paths: Optional[Iterable[str]] = None,
                  source: str = "auto",
                  force: bool = False) -> List[Migration]:
        """One rebalancing round: while a stripe's pressure exceeds the
        skew threshold, migrate the largest movable file off it onto the
        least-pressured stripe. Moves are planned against a *projected*
        pressure map — migrating a fraction f of a stripe's placed blocks
        is assumed to move ~f of its pressure — so one round converges
        instead of dumping everything on a single cold stripe, and a move
        that would just swap which stripe is hot is never made. ``paths``
        scopes the *candidates* (e.g. a DB instance's cold SSTables); the
        pressure/load view stays global. ``force=True`` skips the skew
        gate (callers that already detected skew by other means)."""
        if self.fs.shards <= 1:
            return []
        with self._lock:
            pressure = dict(self.shard_pressure(source=source))
            mean = sum(pressure.values()) / max(1, len(pressure))
            if mean <= 0:
                return []
            if not force and max(pressure.values()) <= self.skew_threshold * mean:
                return []
            self.stats.rounds += 1
            allowed = None if paths is None else set(paths)
            # one filesystem scan per round; moves update the maps in place
            placement = self._file_placement()
            load = {k: 0 for k in range(self.fs.shards)}
            for shard, nblocks in placement.values():
                load[shard] += nblocks
            done: List[Migration] = []
            budget = self.migration_budget_blocks
            # every _one_move call re-scans the candidate list, so a
            # per-round set keeps an over-budget file from being counted
            # deferred once per completed migration
            deferred: set = set()
            while len(done) < max_files:
                m = self._one_move(allowed, pressure, load, placement,
                                   budget=budget, deferred=deferred)
                if m is None:
                    break
                done.append(m)
                self._record(m)
                if budget is not None:
                    budget -= m.blocks
                    if budget <= 0:
                        break
            self.stats.deferred_budget += len(deferred)
            return done

    def spread(self, paths: Iterable[str], *,
               max_files: int = 64) -> List[Migration]:
        """Rehome an explicit file set across stripes (the operator /
        OffloadDB unpinned a tenant: its existing files' placement is
        wrong by decree, so no skew gate applies). Largest files first,
        each to the least-loaded stripe with headroom; files already on
        their destination stay put, leased files are skipped."""
        if self.fs.shards <= 1:
            return []
        with self._lock:
            self.stats.rounds += 1
            load = self.placement_load()
            placement = self._file_placement()
            done: List[Migration] = []
            cands = sorted(
                ((placement[p][1], p) for p in paths if p in placement),
                key=lambda t: (-t[0], t[1]),
            )
            budget = self.migration_budget_blocks
            for nblocks, path in cands:
                if len(done) >= max_files:
                    break
                if budget is not None and nblocks > budget:
                    self.stats.deferred_budget += 1
                    continue  # over this round's copy budget: retry later
                src = placement[path][0]
                dst = min(load, key=lambda k: (load[k], k))
                if dst == src:
                    continue
                headroom = int(self.free_headroom * self._stripe_blocks(dst))
                if nblocks > self.fs.extmgr.free_blocks_in(dst) - headroom:
                    continue
                try:
                    res = self.fs.migrate_file(path, dst)
                except LeaseViolation:
                    self.stats.skipped_leased += 1
                    continue
                except FileNotFoundError:
                    continue  # deleted since the placement scan
                load[src] -= nblocks
                load[dst] += nblocks
                m = Migration(path, src, dst, res["blocks"])
                done.append(m)
                self._record(m)
                if budget is not None:
                    budget -= m.blocks
                    # budget 0 → every remaining candidate trips the
                    # nblocks > budget check above and is counted deferred
            return done

    def _record(self, m: Migration) -> None:
        self.stats.migrations += 1
        self.stats.blocks_moved += m.blocks
        self.stats.by_dst[m.dst] = self.stats.by_dst.get(m.dst, 0) + 1
        self.stats.moves.append((m.src, m.dst, m.blocks))

    def _one_move(self, allowed, pressure: Dict[int, float],
                  load: Dict[int, int],
                  placement: Dict[str, Tuple[int, int]], *,
                  budget: Optional[int] = None,
                  deferred: Optional[set] = None) -> Optional[Migration]:
        hot = max(pressure, key=lambda k: (pressure[k], -k))  # ties → low id
        cold = min(pressure, key=lambda k: (pressure[k], k))
        gap = pressure[hot] - pressure[cold]
        if gap <= 0 or load[hot] <= 0:
            return None
        cands = sorted(
            ((n, p) for p, (sh, n) in placement.items()
             if sh == hot and (allowed is None or p in allowed)),
            key=lambda t: (-t[0], t[1]),
        )
        headroom = int(self.free_headroom * self._stripe_blocks(cold))
        for nblocks, path in cands:
            if budget is not None and nblocks > budget:
                if deferred is not None:
                    deferred.add(path)
                continue  # over this round's copy budget: retry later
            # projected pressure carried by this file: its share of the
            # hot stripe's placed blocks
            moved = pressure[hot] * nblocks / load[hot]
            if moved >= gap:
                continue  # would just swap which stripe is hot
            if nblocks > self.fs.extmgr.free_blocks_in(cold) - headroom:
                continue  # destination too full (spills would defeat us)
            try:
                res = self.fs.migrate_file(path, cold)
            except LeaseViolation:
                self.stats.skipped_leased += 1
                continue  # mid-flight task on the file: retry next round
            except FileNotFoundError:
                continue  # deleted since the placement scan: nothing to move
            pressure[hot] -= moved
            pressure[cold] += moved
            load[hot] -= nblocks
            load[cold] += nblocks
            placement[path] = (cold, nblocks)
            return Migration(path, res.get("src", hot), cold, res["blocks"])
        return None

    def _stripe_blocks(self, shard: int) -> int:
        lo, hi = self.fs.extmgr.stripe_range(shard)
        return hi - lo
