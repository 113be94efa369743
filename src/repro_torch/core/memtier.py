# Copied from src/repro/core/memtier.py; only the repro. imports are rewritten.
"""MemTier — lease-coherent remote-memory block cache (second tier).

A block-cache pool hosted in the under-utilized DRAM of storage/peer engine
nodes, sitting between the initiator's page cache and NVMe in the
``OffloadFS`` read path. Three properties, in the order the paper's cache
story demands them:

  * **Admission-filtered.** Each partition keeps a ghost list (keys only,
    no data) of recently rejected blocks: the FIRST touch of a block only
    records it in the ghost list; a block is admitted on its SECOND touch
    within the ghost window. One-pass scans therefore never displace the
    resident working set — they only churn the (data-free) ghost list.

  * **Interference-partitioned per I/O class.** The router's I/O classes
    (``foreground`` / ``pushdown`` / ``background``) each get their own
    LRU partition with its own capacity and ghost list, extending the
    paper's intra-node cache-interference design across the fabric: a
    background compaction scan cannot evict a foreground entry because it
    never shares a partition with one.

  * **Lease-coherent without a DLM.** There are no invalidation timeouts
    and no lock manager: the initiator that owns the metadata is the only
    writer of record, so it fences cached copies exactly where it already
    fences extents — every journaled write-lease grant fences the leased
    blocks out of the tier, every free/trim path (delete, truncate,
    rename-over, migrate) invalidates the freed blocks, and orphan reclaim
    after a crash fences the orphans' write sets the same way it fences
    their extents. Stale bytes are impossible by construction.

**Node-failure protocol (taint).** The fabric can kill a cache node and
revive it later WITH its old contents (``FaultyFabric.kill``/``revive``).
An invalidation that fails to deliver would leave such a node holding
pre-fence bytes, so the client tracks a *tainted* set: any failed cache
RPC taints the node, gets from a tainted node short-circuit to a miss,
and the first put to a tainted node issues ``cache_reset`` (full wipe)
first — only a successful wipe un-taints. A node is therefore always in
one of two safe states: untainted (has seen every invalidation since its
last wipe) or tainted (serves nothing until wiped).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.admission import EwmaGauge
from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.rpc import RpcError, RpcFabric

# The router's priority classes, restated here so the cache layer does not
# import the routing layer (repro.core.router imports memtier, not vice
# versa — see the reprolint layering rule).
IO_CLASSES = ("foreground", "pushdown", "background")


class MemTierNode:
    """Node-side partitioned block store (lives in an engine node's DRAM).

    Pure local state behind one lock; every operation is idempotent so a
    duplicated RPC delivery (``FaultyFabric.duplicate``) is harmless. No
    fabric calls are made from here — coherence is the client's job.
    """

    def __init__(self, *, capacity_blocks: int = 1024,
                 ghost_factor: float = 2.0,
                 partitions: Sequence[str] = IO_CLASSES):
        if capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self.capacity = capacity_blocks
        self.ghost_capacity = max(1, int(capacity_blocks * ghost_factor))
        self.partitions = tuple(partitions)
        self._lock = threading.Lock()
        self._data: Dict[str, "OrderedDict[int, bytes]"] = {
            p: OrderedDict() for p in self.partitions
        }
        self._ghost: Dict[str, "OrderedDict[int, None]"] = {
            p: OrderedDict() for p in self.partitions
        }
        self.hits = 0
        self.misses = 0
        self.admitted = 0
        self.rejected = 0
        self.evictions = 0
        self.invalidated = 0
        self.resets = 0

    def _part(self, partition: str) -> str:
        return partition if partition in self._data else self.partitions[0]

    def get(self, partition: str, block: int) -> Optional[bytes]:
        p = self._part(partition)
        with self._lock:
            store = self._data[p]
            data = store.get(block)
            if data is None:
                self.misses += 1
                return None
            store.move_to_end(block)
            self.hits += 1
            return data

    def put(self, partition: str, block: int, data: bytes) -> bool:
        """Insert under the ghost-list admission filter; returns whether
        the block was admitted (a resident block is always refreshed)."""
        p = self._part(partition)
        with self._lock:
            store = self._data[p]
            if block in store:
                store[block] = bytes(data)
                store.move_to_end(block)
                return True
            ghost = self._ghost[p]
            if block not in ghost:
                # first touch: frequency credit only, no data admitted
                ghost[block] = None
                while len(ghost) > self.ghost_capacity:
                    ghost.popitem(last=False)
                self.rejected += 1
                return False
            del ghost[block]
            store[block] = bytes(data)
            self.admitted += 1
            while len(store) > self.capacity:
                store.popitem(last=False)
                self.evictions += 1
            return True

    def invalidate(self, blocks: Iterable[int]) -> int:
        """Drop cached copies of ``blocks`` from EVERY partition. Ghost
        entries (keys, no data) survive: frequency history is not stale
        data. Returns the number of data entries dropped."""
        dropped = 0
        with self._lock:
            for b in blocks:
                for store in self._data.values():
                    if store.pop(b, None) is not None:
                        dropped += 1
            self.invalidated += dropped
        return dropped

    def reset(self) -> int:
        """Wipe everything (data + ghosts). The client's recovery protocol
        for a node that may have missed invalidations."""
        with self._lock:
            dropped = sum(len(s) for s in self._data.values())
            for p in self.partitions:
                self._data[p].clear()
                self._ghost[p].clear()
            self.resets += 1
            return dropped

    def __len__(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._data.values())

    def counters(self) -> dict:
        with self._lock:
            return {
                "blocks": sum(len(s) for s in self._data.values()),
                "hits": self.hits,
                "misses": self.misses,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "evictions": self.evictions,
                "invalidated": self.invalidated,
                "resets": self.resets,
            }


class MemTier:
    """Initiator-side client of the remote cache pool.

    Blocks home to ``nodes[block % len(nodes)]``; gets/puts/invalidations
    travel the RPC fabric to the owning node's ``MemTierNode``. Keeps
    per-I/O-class hit-rate EWMAs (the router folds the foreground miss
    rate into ``fleet_pressure``) and the taint set described in the
    module docstring. The internal lock only guards counters/taint state —
    never held across a fabric call (see the ``blocking-under-lock``
    reprolint pass).
    """

    def __init__(self, fabric: RpcFabric, nodes: Sequence[str], *,
                 node: str = "initiator0", alpha: float = 0.2,
                 clock=None):
        if not nodes:
            raise ValueError("MemTier needs at least one cache node")
        self.fabric = fabric
        self.nodes = list(nodes)
        self.node = node
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._tainted = set()
        self._hit_rate: Dict[str, EwmaGauge] = {
            c: EwmaGauge(alpha=alpha) for c in IO_CLASSES
        }
        self.gets = 0
        self.hits = 0
        self.puts = 0
        self.fences = 0
        self.fenced_blocks = 0
        self.invalidated_blocks = 0
        self.taints = 0
        self.resets = 0

    # ------------------------------------------------------------ placement
    def home(self, block: int) -> str:
        return self.nodes[block % len(self.nodes)]

    def _is_tainted(self, node: str) -> bool:
        with self._lock:
            return node in self._tainted

    def _taint(self, node: str) -> None:
        with self._lock:
            if node not in self._tainted:
                self._tainted.add(node)
                self.taints += 1

    def tainted_nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._tainted)

    # ------------------------------------------------------------ data path
    def _record_get(self, io_class: str, hit: bool) -> None:
        c = io_class if io_class in self._hit_rate else IO_CLASSES[0]
        with self._lock:
            self.gets += 1
            if hit:
                self.hits += 1
            self._hit_rate[c].update(1.0 if hit else 0.0, now=self._clock())

    def get(self, block: int, *, io_class: str = "foreground") -> Optional[bytes]:
        dst = self.home(block)
        if self._is_tainted(dst):
            # the node may hold pre-fence bytes: it serves nothing until a
            # put wipes it
            self._record_get(io_class, False)
            return None
        try:
            data = self.fabric.call(self.node, dst, "cache_get",
                                    io_class, block)
        except RpcError:
            self._taint(dst)
            self._record_get(io_class, False)
            return None
        self._record_get(io_class, data is not None)
        return data

    def put(self, block: int, data: bytes, *,
            io_class: str = "foreground") -> bool:
        dst = self.home(block)
        if self._is_tainted(dst):
            # wipe-before-reuse: only a successful reset clears the taint
            try:
                self.fabric.call(self.node, dst, "cache_reset")
            except RpcError:
                return False
            with self._lock:
                self._tainted.discard(dst)
                self.resets += 1
        try:
            admitted = self.fabric.call(self.node, dst, "cache_put",
                                        io_class, block, bytes(data))
        except RpcError:
            self._taint(dst)
            return False
        with self._lock:
            self.puts += 1
        return bool(admitted)

    # ----------------------------------------------------- run conveniences
    def get_run(self, block: int, nblocks: int, *,
                io_class: str = "foreground") -> Optional[bytes]:
        """Assemble a physical run from the tier; None unless EVERY block
        hits (a partial hit still pays the device seek, so it is a miss)."""
        parts = []
        for b in range(block, block + nblocks):
            data = self.get(b, io_class=io_class)
            if data is None:
                return None
            parts.append(data)
        return b"".join(parts)

    def fill_run(self, block: int, nblocks: int, data: bytes, *,
                 io_class: str = "foreground") -> int:
        """Offer a run just read from NVMe to the tier; returns how many
        blocks the admission filter accepted."""
        admitted = 0
        for i in range(nblocks):
            chunk = data[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
            if self.put(block + i, chunk, io_class=io_class):
                admitted += 1
        return admitted

    # ------------------------------------------------------------ coherence
    def invalidate(self, blocks: Iterable[int]) -> None:
        """Drop cached copies of ``blocks`` on their home nodes. A node
        that cannot be reached is tainted — it will be wiped before it can
        serve again, so a missed invalidation can never surface."""
        by_node: Dict[str, List[int]] = {}
        for b in blocks:
            by_node.setdefault(self.home(b), []).append(b)
        for dst in sorted(by_node):
            blks = by_node[dst]
            with self._lock:
                self.invalidated_blocks += len(blks)
            if self._is_tainted(dst):
                continue  # wipe-before-reuse already covers it
            try:
                self.fabric.call(self.node, dst, "cache_invalidate", blks)
            except RpcError:
                self._taint(dst)

    def fence(self, blocks: Iterable[int]) -> None:
        """Lease-driven invalidation: a write-lease grant (or an orphan
        reclaim after a crash) fences cached copies exactly like it fences
        the extents themselves."""
        blks = list(blocks)
        with self._lock:
            self.fences += 1
            self.fenced_blocks += len(blks)
        self.invalidate(blks)

    def reset(self) -> None:
        """Conservatively wipe the whole tier (mount / standby takeover:
        the new initiator cannot know which invalidations its predecessor
        still owed)."""
        for dst in self.nodes:
            try:
                self.fabric.call(self.node, dst, "cache_reset")
            except RpcError:
                self._taint(dst)
                continue
            with self._lock:
                self._tainted.discard(dst)
                self.resets += 1

    # ------------------------------------------------------------ telemetry
    def hit_rate(self, io_class: str = "foreground") -> float:
        with self._lock:
            return self._hit_rate[io_class].value

    def aged_hit_rate(self, io_class: str, now: float,
                      half_life: float) -> float:
        with self._lock:
            return self._hit_rate[io_class].aged_value(now, half_life)

    def stats(self) -> dict:
        with self._lock:
            return {
                "gets": self.gets,
                "hits": self.hits,
                "puts": self.puts,
                "fences": self.fences,
                "fenced_blocks": self.fenced_blocks,
                "invalidated_blocks": self.invalidated_blocks,
                "taints": self.taints,
                "resets": self.resets,
                "tainted": sorted(self._tainted),
                "hit_rate": {
                    c: g.value for c, g in self._hit_rate.items()
                },
            }


def serve_memtier(store: MemTierNode, fabric: RpcFabric, node: str) -> None:
    """Register a node's cache endpoints on the fabric (``serve_engine``
    calls this for every engine; a dedicated cache node can call it
    directly)."""
    fabric.register(node, "cache_get", store.get)
    fabric.register(node, "cache_put", store.put)
    fabric.register(node, "cache_invalidate", store.invalidate)
    fabric.register(node, "cache_reset", store.reset)
