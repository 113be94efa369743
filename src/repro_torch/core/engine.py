# Copied from src/repro/core/engine.py; only the repro. imports are rewritten.
"""Offload Engine — target-side executor + Offload Cache (paper §III-A).

Runs registered task stubs (compaction, log recycling, preprocessing, …) on
the storage node against leased blocks, through a pinned block cache that
exploits the storage node's under-utilized DRAM:

  * ``offload_read`` consults the Offload Cache first; a miss reads NVMe and
    inserts + pins the block until the task completes.
  * Coherence is initiator-centric: no invalidation messages. The request
    carries the file's mtime; cached blocks older than it are bypassed
    (coarse-grained) — or the caller passes bypass_cache=True to decide at
    the application level (fine-grained, zero-message).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set, Tuple

from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.fs import Lease, OffloadFS
from repro_torch.core.memtier import MemTierNode


@dataclass
class QueueStats:
    """Bounded work-queue accounting (multi-initiator backpressure)."""

    capacity: int = 0
    inflight: int = 0
    inflight_peak: int = 0
    stalls: int = 0  # submissions that had to wait for a slot
    completed: int = 0


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    bypasses: int = 0
    evictions: int = 0
    pinned_peak: int = 0

    @property
    def hit_ratio(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


class OffloadCache:
    """Block cache with task-lifetime pinning + LRU eviction."""

    def __init__(self, capacity_blocks: int):
        self.capacity = capacity_blocks
        self._data: "OrderedDict[int, Tuple[bytes, float]]" = OrderedDict()
        self._pins: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def lookup(self, block: int, min_version: float) -> Optional[bytes]:
        with self._lock:
            ent = self._data.get(block)
            if ent is None:
                self.stats.misses += 1
                return None
            data, version = ent
            if version < min_version:
                self.stats.bypasses += 1  # stale: coarse mtime coherence
                return None
            self._data.move_to_end(block)
            self.stats.hits += 1
            return data

    def insert(self, block: int, data: bytes, version: float, *, pin: bool):
        with self._lock:
            while len(self._data) >= self.capacity:
                victim = next(
                    (b for b in self._data if self._pins.get(b, 0) == 0), None
                )
                if victim is None:
                    break  # everything pinned: over-admit (bounded by leases)
                del self._data[victim]
                self.stats.evictions += 1
            self._data[block] = (data, version)
            if pin:
                self._pins[block] = self._pins.get(block, 0) + 1
                self.stats.pinned_peak = max(
                    self.stats.pinned_peak, len(self._pins)
                )

    def pin(self, block: int):
        with self._lock:
            if block in self._data:
                self._pins[block] = self._pins.get(block, 0) + 1

    def unpin_all(self, blocks) -> None:
        with self._lock:
            for b in blocks:
                c = self._pins.get(b)
                if c is not None:
                    if c <= 1:
                        del self._pins[b]
                    else:
                        self._pins[b] = c - 1

    def invalidate(self, blocks) -> None:
        with self._lock:
            for b in blocks:
                self._data.pop(b, None)

    def __len__(self):
        with self._lock:
            return len(self._data)


class OffloadEngine:
    """Target-side skeleton: executes offloaded stubs with offload_read/write."""

    def __init__(self, fs: OffloadFS, *, node: str = "storage0",
                 cache_blocks: int = 4096, enable_cache: bool = True,
                 max_inflight: int = 16, memtier_blocks: int = 1024):
        self.fs = fs
        self.node = node
        self.cache = OffloadCache(cache_blocks)
        self.enable_cache = enable_cache
        # remote-memory block-cache partition hosted in this node's DRAM
        # (the MemTier pool's shard on this node): pure local store, wired
        # onto the fabric by serve_engine; coherence is the initiator's job
        self.memtier_node = MemTierNode(capacity_blocks=memtier_blocks)
        self._stubs: Dict[str, Callable] = {}
        self.busy_ns = 0  # accumulated simulated work units (DES hook)
        self.tasks_run = 0
        self.wal_segments = 0  # async WAL segments landed near-data
        # pushdown operator plane telemetry: scans executed, rows walked
        # vs rows that actually crossed the wire (the selectivity win)
        self.pushdown_scans = 0
        self.pushdown_rows_in = 0
        self.pushdown_rows_out = 0
        # bounded work queue: with many initiators submitting concurrently,
        # admission caps what the policy lets in, and this caps what the
        # engine lets RUN — excess submissions block (backpressure) so the
        # pinned working set stays bounded by max_inflight leases
        self._q_lock = threading.Lock()
        self._q_cond = threading.Condition(self._q_lock)
        self.queue = QueueStats(capacity=max(1, max_inflight))

    # ------------------------------------------------------------- stubs
    def register_stub(self, name: str, fn: Callable) -> None:
        """fn(engine_io, *args) — engine_io provides offload_read/write."""
        self._stubs[name] = fn

    # -------------------------------------------------------- work queue
    def _acquire_slot(self) -> None:
        with self._q_cond:
            if self.queue.inflight >= self.queue.capacity:
                self.queue.stalls += 1
                self._q_cond.wait_for(
                    lambda: self.queue.inflight < self.queue.capacity
                )
            self.queue.inflight += 1
            self.queue.inflight_peak = max(
                self.queue.inflight_peak, self.queue.inflight
            )

    def _release_slot(self) -> None:
        with self._q_cond:
            self.queue.inflight -= 1
            self.queue.completed += 1
            self._q_cond.notify()

    def run_task(self, name: str, lease: Lease, *args,
                 mtime: float = 0.0, bypass_cache: bool = False, **kwargs):
        self._acquire_slot()
        io = EngineIO(self, lease, mtime=mtime, bypass_cache=bypass_cache)
        try:
            result = self._stubs[name](io, *args, **kwargs)
        finally:
            self.cache.unpin_all(io.pinned)
            self._release_slot()
        with self._q_lock:
            self.tasks_run += 1
        return result


class EngineIO:
    """The offload_read()/offload_write() facade handed to task stubs."""

    def __init__(self, engine: OffloadEngine, lease: Lease, *, mtime: float,
                 bypass_cache: bool):
        self.engine = engine
        self.lease = lease
        self.mtime = mtime
        self.bypass = bypass_cache or not engine.enable_cache
        self.pinned: Set[int] = set()

    def offload_read(self, block: int, nblocks: int = 1) -> bytes:
        eng = self.engine
        if self.bypass:
            return eng.fs.authorized_read(self.lease, block, nblocks, node=eng.node)
        out = []
        run_start, run_len = None, 0

        def flush_run():
            nonlocal run_start, run_len
            if run_len:
                data = eng.fs.authorized_read(
                    self.lease, run_start, run_len, node=eng.node
                )
                for i in range(run_len):
                    blk = run_start + i
                    chunk = data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]
                    eng.cache.insert(blk, chunk, self.mtime, pin=True)
                    self.pinned.add(blk)
                out.append(data)
                run_start, run_len = None, 0

        for b in range(block, block + nblocks):
            hit = eng.cache.lookup(b, self.mtime)
            if hit is not None:
                flush_run()
                eng.cache.pin(b)
                self.pinned.add(b)
                out.append(hit)
            else:
                if run_start is None:
                    run_start = b
                    run_len = 1
                elif run_start + run_len == b:
                    run_len += 1
                else:
                    flush_run()
                    run_start, run_len = b, 1
        flush_run()
        return b"".join(out)

    def offload_write(self, block: int, data: bytes) -> None:
        eng = self.engine
        eng.fs.authorized_write(self.lease, block, data, node=eng.node)
        # write-through: keep the engine's cached view fresh for this task
        if not self.bypass:
            n = (len(data) + BLOCK_SIZE - 1) // BLOCK_SIZE
            for i in range(n):
                eng.cache.insert(
                    block + i,
                    data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE].ljust(BLOCK_SIZE, b"\x00"),
                    self.mtime,
                    pin=False,
                )
