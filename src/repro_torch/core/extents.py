# Copied from src/repro/core/extents.py; only the repro. imports are rewritten.
"""Extent allocator + per-file extent trees — initiator-owned metadata.

The paper's *initiator-centric block management policy*: only the initiator
allocates/frees blocks; offloaded tasks receive pre-allocated physical block
addresses as RPC arguments. Invariants (property-tested):
  * no double allocation, no overlap;
  * free-space accounting exact (globally AND per shard); adjacent free
    runs merge;
  * file extent trees map disjoint file ranges to disjoint block runs;
  * an extent allocated on shard k lies inside shard k's stripe unless it
    was an accounted *spill* (stripe exhausted).

Shard striping: with ``shards=N`` the usable block range is partitioned
into N contiguous stripes, one free list each. ``alloc(nblocks, shard=k)``
serves shard k's stripe first so files placed on shard k occupy blocks that
shard k's NVMe FIFO owns — compaction reads for different shards then hit
disjoint device queues (the placement half of near-data offload). A full
stripe spills to its neighbours (counted in ``spills``) rather than
failing: placement is a performance affinity, never a correctness gate.
"""
from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class Extent:
    """A contiguous run of physical blocks backing a file range.

    ``shard`` is the stripe the run was allocated from (0 on unsharded
    volumes). It is carried through the file extent tree and the metadata
    pickle so placement-affinity routing never has to re-derive it, but the
    allocator's ``shard_of`` stays the authority for raw block numbers.
    """

    file_offset: int  # in blocks
    block: int  # physical start block
    nblocks: int
    shard: int = 0

    @property
    def end(self) -> int:
        return self.block + self.nblocks


class ExtentManager:
    """First-fit free-list allocator over a block volume, optionally
    striped into per-shard block ranges (one free list per stripe)."""

    def __init__(self, num_blocks: int, reserved: int = 0, *, shards: int = 1):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        usable = num_blocks - reserved
        if usable < shards:
            raise ValueError(
                f"volume too small for {shards} shards ({usable} usable blocks)"
            )
        self.num_blocks = num_blocks
        self.reserved = reserved
        self.shards = shards
        # stripe k covers [bounds[k], bounds[k+1])
        self._bounds: List[int] = [
            reserved + k * usable // shards for k in range(shards)
        ] + [num_blocks]
        # per-shard sorted lists of (start, length) free runs
        self._free: List[List[Tuple[int, int]]] = [
            [(self._bounds[k], self._bounds[k + 1] - self._bounds[k])]
            for k in range(shards)
        ]
        self._lock = threading.Lock()
        self.spills = 0  # allocations that overflowed their preferred stripe

    # ------------------------------------------------------------ stripes
    def shard_of(self, block: int) -> int:
        """The stripe owning a physical block (authoritative mapping)."""
        if not self.reserved <= block < self.num_blocks:
            raise ValueError(f"block {block} outside volume")
        return bisect.bisect_right(self._bounds, block) - 1

    def stripe_range(self, shard: int) -> Tuple[int, int]:
        """[start, end) block range of a stripe."""
        return self._bounds[shard], self._bounds[shard + 1]

    # ------------------------------------------------------------ alloc
    def alloc(self, nblocks: int, *, shard: Optional[int] = None) -> List[Extent]:
        """Allocate nblocks (possibly as multiple extents). Raises when the
        volume is full. With ``shard=k`` the allocation is served from
        stripe k first and spills to the other stripes only when k is
        exhausted (counted). ``shard=None`` scans stripes in order (the
        flat-volume behaviour; identical to the seed when shards == 1).
        Returned extents carry file_offset=0 — the caller (fs.py) rebases
        them into the file's extent tree."""
        if nblocks <= 0:
            raise ValueError("alloc of non-positive size")
        if shard is not None and not 0 <= shard < self.shards:
            raise ValueError(f"shard {shard} out of range [0, {self.shards})")
        out: List[Extent] = []
        need = nblocks
        with self._lock:
            order = (
                range(self.shards)
                if shard is None
                else [shard] + [k for k in range(self.shards) if k != shard]
            )
            spilled = False
            for k in order:
                if need <= 0:
                    break
                free = self._free[k]
                i = 0
                while need > 0 and i < len(free):
                    start, length = free[i]
                    take = min(length, need)
                    out.append(Extent(0, start, take, k))
                    if shard is not None and k != shard:
                        # a spill is blocks actually TAKEN from a foreign
                        # stripe — merely visiting an exhausted stripe with
                        # need outstanding contributes nothing and must not
                        # count (it would inflate the placement-miss metric)
                        spilled = True
                    if take == length:
                        free.pop(i)
                    else:
                        free[i] = (start + take, length - take)
                        i += 1
                    need -= take
            if need > 0:
                # roll back
                for e in out:
                    self._free_run(e.block, e.nblocks)
                raise IOError(f"volume full: wanted {nblocks} blocks")
            if spilled:
                self.spills += 1
        return out

    def _free_run(self, start: int, length: int):
        """Insert a free run, merging neighbours within its stripe (lock
        held). Runs never cross stripe boundaries by construction."""
        free = self._free[self._shard_of_unlocked(start)]
        i = bisect.bisect_left(free, (start, 0))
        # check overlap with predecessor/successor
        if i > 0:
            ps, pl = free[i - 1]
            if ps + pl > start:
                raise ValueError(f"double free: [{start},{start+length}) overlaps [{ps},{ps+pl})")
        if i < len(free):
            ns, nl = free[i]
            if start + length > ns:
                raise ValueError(f"double free: [{start},{start+length}) overlaps [{ns},{ns+nl})")
        free.insert(i, (start, length))
        # merge with next
        if i + 1 < len(free):
            s2, l2 = free[i + 1]
            if start + length == s2:
                free[i] = (start, length + l2)
                free.pop(i + 1)
        # merge with prev
        if i > 0:
            s0, l0 = free[i - 1]
            s1, l1 = free[i]
            if s0 + l0 == s1:
                free[i - 1] = (s0, l0 + l1)
                free.pop(i)

    def _shard_of_unlocked(self, block: int) -> int:
        return bisect.bisect_right(self._bounds, block) - 1

    def free(self, extents: List[Extent]):
        """Return runs to their stripes' free lists. A run persisted under
        an older stripe layout and freed after a re-mount with a different
        ``shards=`` may cross today's boundaries — split per stripe the way
        ``carve`` does, or the whole run would land in the stripe of its
        start block and corrupt per-shard accounting."""
        with self._lock:
            for e in extents:
                start, length = e.block, e.nblocks
                while length > 0:
                    k = self._shard_of_unlocked(start)
                    piece = min(length, self._bounds[k + 1] - start)
                    self._free_run(start, piece)
                    start += piece
                    length -= piece

    def carve(self, start: int, length: int) -> None:
        """Remove a specific run from the free list (mount-time rebuild).
        A run persisted by a previous generation with a different stripe
        layout may cross today's boundaries — split and carve per stripe."""
        with self._lock:
            while length > 0:
                k = self._shard_of_unlocked(start)
                stripe_end = self._bounds[k + 1]
                piece = min(length, stripe_end - start)
                self._carve_one(k, start, piece)
                start += piece
                length -= piece

    def _carve_one(self, k: int, start: int, length: int) -> None:
        free = self._free[k]
        for i, (s, l) in enumerate(free):
            if s <= start and start + length <= s + l:
                free.pop(i)
                if s < start:
                    free.insert(i, (s, start - s))
                    i += 1
                if start + length < s + l:
                    free.insert(i, (start + length, s + l - (start + length)))
                return
        raise ValueError(f"carve [{start},{start+length}) not free")

    # ------------------------------------------------------------ stats
    @property
    def free_blocks(self) -> int:
        with self._lock:
            return sum(l for free in self._free for _, l in free)

    def free_blocks_in(self, shard: int) -> int:
        """Free blocks in one stripe (per-shard accounting invariant)."""
        with self._lock:
            return sum(l for _, l in self._free[shard])

    def fragmentation(self, shard: Optional[int] = None) -> int:
        with self._lock:
            if shard is not None:
                return len(self._free[shard])
            return sum(len(free) for free in self._free)

    def defragment_hint(self) -> Optional[Tuple[int, int]]:
        """Largest free run (defrag target metric)."""
        with self._lock:
            runs = [r for free in self._free for r in free]
            if not runs:
                return None
            return max(runs, key=lambda t: t[1])
