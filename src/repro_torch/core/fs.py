# Copied from src/repro/core/fs.py; only the repro. imports are rewritten.
"""OffloadFS — initiator-centric user-level file system.

The initiator node exclusively owns the inode table and extent trees.
Offloaded tasks access data ONLY through ``offload_read``/``offload_write``
with block addresses the initiator authorized (leases). While a lease is
outstanding, the initiator itself must not touch those blocks — this is the
paper's replacement for a distributed lock manager: there is never
concurrent conflicting access by construction.

No directory-task offloading; inode/extent mutations (create, truncate,
fallocate, stat) happen only on the initiator.

Striping (``shards=N``): files pin to an extent-allocator stripe at
``create(path, shard=k)`` and all their allocations come from it;
``file_shard``/``shard_of_extents`` expose the (dominant) stripe so the
offload plane can route each task to the target owning its blocks. The
shard count, per-file pins and per-extent shard ids persist through the
superblock (``flush_metadata``/``mount``), with pre-striping superblocks
mounting as flat single-stripe volumes.
"""
from __future__ import annotations

import itertools
import struct
import threading
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.blockdev import BLOCK_SIZE, BlockDevice
from repro_torch.core.extents import Extent, ExtentManager


@dataclass
class Inode:
    ino: int
    path: str
    size: int = 0  # bytes
    mtime: float = 0.0  # logical clock
    extents: List[Extent] = field(default_factory=list)  # sorted by file_offset
    # placement affinity: all of this file's future allocations are served
    # from this stripe (None = flat allocation, the seed behaviour)
    shard: Optional[int] = None


@dataclass
class Lease:
    """Authorization for an offloaded task to touch specific blocks."""

    task_id: int
    read_blocks: frozenset
    write_blocks: frozenset
    done: bool = False
    # physical (block, nblocks) runs for scoped leases (``write_lease`` /
    # ``read_lease``) so the holder can address its bytes without re-walking
    # the extent tree; None for plain ``grant_lease`` grants
    runs: Optional[List[Tuple[int, int]]] = None


class LeaseViolation(Exception):
    pass


class MigrationCrash(BaseException):
    """Raised by a migration failpoint to simulate a mid-migration crash.

    Derives from BaseException so ``migrate_file``'s rollback handler (which
    catches Exception) does NOT run: the process state is abandoned exactly
    as a real crash would leave it, and recovery happens through re-mount +
    lease-journal replay — which is what the failpoint tests verify.
    """


SB_BLOCKS = 64  # superblock area (metadata + lease journal), 256 KiB
SB_META_BLOCKS = 48  # metadata pickle lives in blocks [0, 48)
SB_JOURNAL_BLOCK = SB_META_BLOCKS  # lease journal lives in blocks [48, 64)
SB_JOURNAL_BLOCKS = SB_BLOCKS - SB_META_BLOCKS

_JHDR = struct.Struct("<HI")  # record length, crc32(payload)
_JREC = struct.Struct("<BII")  # op, task_id, n_runs
_JRUN = struct.Struct("<II")  # block, nblocks
_J_GRANT, _J_RELEASE = 1, 2


def _coalesce_runs(blocks) -> List[Tuple[int, int]]:
    """Compress a block set into sorted (start, nblocks) runs."""
    runs: List[Tuple[int, int]] = []
    for b in sorted(blocks):
        if runs and runs[-1][0] + runs[-1][1] == b:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((b, 1))
    return runs


class LeaseJournal:
    """Crash-recoverable journal of write-lease grants/releases, persisted in
    the superblock area (blocks [SB_JOURNAL_BLOCK, SB_BLOCKS)).

    Record format: ``[len u16 | crc32 u32 | payload]`` with payload
    ``[op u8 | task_id u32 | n_runs u32 | (block u32, nblocks u32)*]``.
    Appends are durable immediately (only the dirty tail blocks are
    rewritten). Replay stops at the first record whose crc fails, whose
    length runs past the journaled area, or whose payload is malformed —
    torn-tail tolerance matching the superblock's "last commit wins" rule.

    When the area fills up the journal compacts itself: it rewrites only the
    still-outstanding grants (and zeroes the tail so stale records can never
    resurrect on a later mount).
    """

    CAPACITY = SB_JOURNAL_BLOCKS * BLOCK_SIZE

    def __init__(self, dev: BlockDevice, *, node: str = "initiator0"):
        self.dev = dev
        self.node = node
        self._buf = bytearray()
        self._outstanding: Dict[int, Tuple[Tuple[int, int], ...]] = {}
        self._wiped = False  # fresh journal: zero stale on-device tail once
        self.max_task_id = 0
        self.appends = 0
        self.compactions = 0
        self.torn_records = 0

    # ------------------------------------------------------------ encoding
    @staticmethod
    def _encode(op: int, task_id: int, runs: Sequence[Tuple[int, int]]) -> bytes:
        payload = _JREC.pack(op, task_id, len(runs)) + b"".join(
            _JRUN.pack(b, n) for b, n in runs
        )
        if len(payload) > 0xFFFF:
            raise IOError(
                f"lease journal record too large ({len(runs)} runs): "
                "write set too fragmented"
            )
        return _JHDR.pack(len(payload), zlib.crc32(payload)) + payload

    # ------------------------------------------------------------- appends
    def append_grant(self, task_id: int, blocks) -> None:
        runs = _coalesce_runs(blocks)
        rec = self._encode(_J_GRANT, task_id, runs)  # may raise: no state yet
        self._outstanding[task_id] = tuple(runs)
        self.max_task_id = max(self.max_task_id, task_id)
        try:
            self._append(rec)
        except BaseException:
            # journal and fs state must agree: an unjournaled grant is no
            # grant (the caller rolls its lease maps back too)
            del self._outstanding[task_id]
            raise

    def append_release(self, task_id: int) -> None:
        self._outstanding.pop(task_id, None)
        self.max_task_id = max(self.max_task_id, task_id)
        self._append(self._encode(_J_RELEASE, task_id, ()))

    def drop_outstanding(self, task_id: int) -> None:
        """Forget a grant without journaling a release (orphan reclaim: one
        compact() afterwards rewrites the whole area anyway)."""
        self._outstanding.pop(task_id, None)

    def _append(self, rec: bytes) -> None:
        if len(self._buf) + len(rec) > self.CAPACITY:
            self._compact()
            if len(self._buf) + len(rec) > self.CAPACITY:
                raise IOError("lease journal overflow (too many live leases)")
        start = len(self._buf)
        self._buf += rec
        self.appends += 1
        if not self._wiped:
            # first write on a fresh volume: zero the whole area so stale
            # records from a previous filesystem generation can't resurrect
            self._write_all()
            return
        first = start // BLOCK_SIZE
        last = (len(self._buf) + BLOCK_SIZE - 1) // BLOCK_SIZE
        chunk = bytes(self._buf[first * BLOCK_SIZE : last * BLOCK_SIZE])
        self.dev.write_blocks(SB_JOURNAL_BLOCK + first, chunk, node=self.node)
        if len(self._buf) % BLOCK_SIZE == 0 and last < SB_JOURNAL_BLOCKS:
            # zero-terminate: replay must never run into stale bytes that a
            # previous journal generation left in the next block
            self.dev.write_blocks(SB_JOURNAL_BLOCK + last,
                                  b"\x00" * BLOCK_SIZE, node=self.node)

    def _write_all(self) -> None:
        blob = bytes(self._buf).ljust(self.CAPACITY, b"\x00")
        self.dev.write_blocks(SB_JOURNAL_BLOCK, blob, node=self.node)
        self._wiped = True

    def _compact(self) -> None:
        self._buf = bytearray()
        for tid, runs in sorted(self._outstanding.items()):
            self._buf += self._encode(_J_GRANT, tid, runs)
        self._write_all()
        self.compactions += 1

    def compact(self) -> None:
        """Rewrite the journal keeping only outstanding grants."""
        self._compact()

    # -------------------------------------------------------------- replay
    def replay(self) -> Dict[int, Tuple[Tuple[int, int], ...]]:
        """Load the on-device journal; returns {task_id: write-block runs}
        for every grant without a matching release (the orphans)."""
        raw = self.dev.read_blocks(SB_JOURNAL_BLOCK, SB_JOURNAL_BLOCKS,
                                   node=self.node)
        out: Dict[int, Tuple[Tuple[int, int], ...]] = {}
        off = 0
        while off + _JHDR.size <= len(raw):
            ln, crc = _JHDR.unpack_from(raw, off)
            if ln == 0:  # zeroed tail: end of journal
                break
            payload = raw[off + _JHDR.size : off + _JHDR.size + ln]
            if len(payload) < ln or zlib.crc32(payload) != crc:
                self.torn_records += 1
                break  # torn tail: committed prefix wins
            if ln < _JREC.size:
                self.torn_records += 1
                break
            op, tid, n_runs = _JREC.unpack_from(payload, 0)
            if ln != _JREC.size + n_runs * _JRUN.size or op not in (
                _J_GRANT, _J_RELEASE
            ):
                self.torn_records += 1
                break
            runs = tuple(
                _JRUN.unpack_from(payload, _JREC.size + i * _JRUN.size)
                for i in range(n_runs)
            )
            if op == _J_GRANT:
                out[tid] = runs
            else:
                out.pop(tid, None)
            self.max_task_id = max(self.max_task_id, tid)
            off += _JHDR.size + ln
        self._buf = bytearray(raw[:off])
        self._outstanding = dict(out)
        # normalize the on-device state: keep the committed prefix, zero the
        # rest (drops torn-record bytes so they can't be re-parsed later)
        self._write_all()
        return out


class OffloadFS:
    """One instance per initiator node (single-writer metadata)."""

    def __init__(self, dev: BlockDevice, *, node: str = "initiator0",
                 reserved_blocks: int = SB_BLOCKS, shards: int = 1):
        self.dev = dev
        self.node = node
        self.shards = shards
        self.extmgr = ExtentManager(dev.num_blocks, reserved=reserved_blocks,
                                    shards=shards)
        self._inodes: Dict[int, Inode] = {}
        self._names: Dict[str, int] = {}
        self._ino_counter = itertools.count(1)
        self._task_counter = itertools.count(1)
        self._leases: Dict[int, Lease] = {}
        self._leased_blocks: Dict[int, int] = {}  # block -> task_id
        self._lock = threading.RLock()
        self._clock = 0.0
        # crash-recoverable lease journal (superblock area): every WRITE
        # lease grant/release is journaled so a re-mounted initiator can
        # reclaim orphaned leases without scanning
        self.lease_journal = LeaseJournal(dev, node=node)
        self._orphans: Dict[int, Lease] = {}  # journaled leases from a crash
        # stripe migration (copy → swap → free) accounting + test failpoint:
        # when set, called with a stage name ("pre_copy" / "post_copy" /
        # "post_swap"); raising MigrationCrash simulates a crash there
        self.migrations = 0
        self.migrated_blocks = 0
        self._migration_failpoint = None
        # optional remote-memory block cache (repro.core.memtier.MemTier):
        # consulted in the read path, fenced by every write-lease grant and
        # invalidated on every free/trim path — attach_memtier() wires it
        self.memtier = None

    # -------------------------------------------------------- memory tier
    def attach_memtier(self, tier) -> None:
        """Attach a remote block-cache tier to the read path. The tier is
        conservatively wiped on attach: this initiator cannot know which
        invalidations a predecessor (crashed instance, failed-over peer)
        still owed the pool, so a takeover inherits an EMPTY — therefore
        trivially coherent — tier rather than a possibly-stale one."""
        with self._lock:
            self.memtier = tier
        if tier is not None:
            tier.reset()

    # --------------------------------------------------------------- clock
    def _tick(self) -> float:
        self._clock += 1.0
        return self._clock

    # ----------------------------------------------------------- superblock
    # The initiator's metadata (inode table + extent trees) persists in the
    # reserved block area so a crashed initiator can re-mount the volume.
    def flush_metadata(self) -> None:
        import pickle as _pkl
        import zlib

        with self._lock:
            blob = _pkl.dumps(
                {
                    "names": dict(self._names),
                    "inodes": {
                        i: (n.path, n.size, n.mtime,
                            [(e.file_offset, e.block, e.nblocks, e.shard)
                             for e in n.extents],
                            n.shard)
                        for i, n in self._inodes.items()
                    },
                    "clock": self._clock,
                    "shards": self.shards,
                }
            )
            hdr = len(blob).to_bytes(8, "little") + zlib.crc32(blob).to_bytes(4, "little")
            buf = hdr + blob
            cap = SB_META_BLOCKS * BLOCK_SIZE
            if len(buf) > cap:
                raise IOError(f"superblock overflow ({len(buf)} > {cap})")
            self.dev.write_blocks(0, buf, node=self.node)
            if not self.lease_journal._wiped:
                # first metadata persist of a FRESH (mkfs) filesystem: zero
                # the journal area now, or a crash before the first write
                # lease would resurrect the previous generation's journal
                # on mount and quiesce blocks it never leased
                self.lease_journal._write_all()

    @classmethod
    def mount(cls, dev: BlockDevice, *, node: str = "initiator0",
              shards: Optional[int] = None) -> "OffloadFS":
        """Re-mount a persisted volume. ``shards=None`` restores the stripe
        count the superblock recorded (pre-striping superblocks mount flat);
        an explicit ``shards=N`` RE-STRIPES the volume online: the allocator
        is rebuilt with N stripes, persisted extents keep their data (runs
        from the old layout may straddle the new boundaries — ``carve`` and
        ``free`` both split per stripe), and stale per-extent shard ids and
        per-file pins are re-derived from the new authoritative map."""
        import pickle as _pkl
        import zlib

        fs = cls(dev, node=node, shards=shards or 1)
        raw = dev.read_blocks(0, SB_META_BLOCKS, node=node)
        size = int.from_bytes(raw[:8], "little")
        if size == 0 or size > SB_META_BLOCKS * BLOCK_SIZE:
            fs._replay_lease_journal()
            return fs  # fresh volume
        blob = raw[12 : 12 + size]
        if zlib.crc32(blob) != int.from_bytes(raw[8:12], "little"):
            # torn superblock: fresh mount (last commit wins upstream)
            fs._replay_lease_journal()
            return fs
        meta = _pkl.loads(blob)
        fs._names = dict(meta["names"])
        fs._clock = meta["clock"]
        persisted = meta.get("shards", 1)  # pre-striping superblocks: flat
        fs.shards = persisted if shards is None else shards
        restripe = shards is not None and shards != persisted
        # rebuild the free lists: everything minus used extents
        fs.extmgr = ExtentManager(dev.num_blocks, reserved=SB_BLOCKS,
                                  shards=fs.shards)
        max_ino = 0
        used: List[Extent] = []
        for i, rec in meta["inodes"].items():
            # pre-striping records are (path, size, mtime, 3-tuple extents)
            path, size_, mtime, exts = rec[:4]
            file_shard = rec[4] if len(rec) > 4 else None
            extents = []
            for t in exts:
                off_, blk, n = t[0], t[1], t[2]
                if not restripe:
                    extents.append(Extent(off_, blk, n,
                                          t[3] if len(t) > 3
                                          else fs.extmgr.shard_of(blk)))
                    continue
                # an old-layout run may straddle the NEW boundaries: split
                # it per stripe (like carve/free do) so every extent's
                # carried shard id stays honest — one start-derived id for
                # the whole run would mis-route placement affinity and make
                # the foreign-stripe tail unmigratable
                while n > 0:
                    k = fs.extmgr.shard_of(blk)
                    take = min(n, fs.extmgr.stripe_range(k)[1] - blk)
                    extents.append(Extent(off_, blk, take, k))
                    off_ += take
                    blk += take
                    n -= take
            if restripe:
                # the old pin indexes a layout that no longer exists:
                # re-derive from where the blocks actually sit today
                file_shard = fs.shard_of_extents(extents)
            elif file_shard is not None and file_shard >= fs.shards:
                file_shard = None  # defensive: never pin out of range
            fs._inodes[i] = Inode(i, path, size_, mtime, extents, file_shard)
            used.extend(extents)
            max_ino = max(max_ino, i)
        fs._ino_counter = itertools.count(max_ino + 1)
        for e in sorted(used, key=lambda e: e.block):
            # carve out of the free list by allocating exactly that run
            fs.extmgr.carve(e.block, e.nblocks)
        fs._replay_lease_journal()
        return fs

    def _replay_lease_journal(self) -> None:
        """Rebuild orphaned write leases from the journal (no scanning): the
        blocks stay quiesced — a crashed-away target task might still be
        mid-write — until ``reclaim_orphans`` fences them back."""
        with self._lock:
            for tid, runs in self.lease_journal.replay().items():
                wb = frozenset(
                    b for blk, n in runs for b in range(blk, blk + n)
                )
                lease = Lease(tid, frozenset(), wb)
                self._leases[tid] = lease
                self._orphans[tid] = lease
                for b in wb:
                    self._leased_blocks[b] = tid
            self._task_counter = itertools.count(
                self.lease_journal.max_task_id + 1
            )

    def orphan_leases(self) -> List[Lease]:
        """Write leases journaled by a previous incarnation, not yet fenced."""
        with self._lock:
            return list(self._orphans.values())

    def reclaim_orphans(self) -> List[int]:
        """Fence and reclaim every orphaned write lease (the grantee died
        with the previous initiator process). Returns the reclaimed task
        ids; afterwards the blocks are writable by the initiator again."""
        with self._lock:
            tids = sorted(self._orphans)
            fenced_blocks = set()
            for tid in tids:
                lease = self._orphans.pop(tid)
                lease.done = True
                self._leases.pop(tid, None)
                for b in lease.write_blocks:
                    if self._leased_blocks.get(b) == tid:
                        del self._leased_blocks[b]
                fenced_blocks.update(lease.write_blocks)
                # no per-orphan release record: the single compact() below
                # rewrites the area with only the still-outstanding grants
                self.lease_journal.drop_outstanding(tid)
            if tids:
                if self.memtier is not None:
                    # a crashed initiator's orphans fence the cache tier the
                    # same way they fence extents: the dead grantee may have
                    # written any subset of these blocks
                    self.memtier.fence(fenced_blocks)
                self.lease_journal.compact()
            return tids

    # ------------------------------------------------------------ metadata
    def create(self, path: str, *, shard: Optional[int] = None) -> int:
        """Create a file; ``shard`` pins all of its allocations to one
        stripe (placement affinity for the offload target that will compute
        on it). None = flat allocation."""
        with self._lock:
            if path in self._names:
                raise FileExistsError(path)
            if shard is not None and not 0 <= shard < self.shards:
                raise ValueError(f"shard {shard} out of range [0, {self.shards})")
            ino = next(self._ino_counter)
            self._inodes[ino] = Inode(ino, path, mtime=self._tick(), shard=shard)
            self._names[path] = ino
            return ino

    def open(self, path: str) -> int:
        with self._lock:
            if path not in self._names:
                raise FileNotFoundError(path)
            return self._names[path]

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._names

    def listdir(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(p for p in self._names if p.startswith(prefix))

    def stat(self, path: str) -> Inode:
        with self._lock:
            return self._inodes[self._names[path]]

    def leased(self, path: str) -> bool:
        """Is any block backing ``path`` under an outstanding lease (read
        OR write)? Cache-eviction planes use this to SKIP in-use entries
        instead of racing ``delete()``'s lease check."""
        with self._lock:
            inode = self._inodes[self._names[path]]
            blocks = {
                b for e in inode.extents
                for b in range(e.block, e.block + e.nblocks)
            }
            if blocks & set(self._leased_blocks):
                return True
            return any(lease.read_blocks & blocks
                       for lease in self._leases.values())

    def delete(self, path: str) -> None:
        with self._lock:
            ino = self._names[path]
            inode = self._inodes[ino]
            self._check_not_leased(
                b for e in inode.extents for b in range(e.block, e.block + e.nblocks)
            )
            del self._names[path]
            del self._inodes[ino]
            self.extmgr.free(inode.extents)
            for e in inode.extents:
                self.dev.trim(e.block, e.nblocks)
            if self.memtier is not None:
                # freed blocks can be re-allocated to another file: cached
                # copies of the OLD bytes must not survive the trim
                self.memtier.invalidate(
                    b for e in inode.extents
                    for b in range(e.block, e.block + e.nblocks)
                )

    def rename(self, old: str, new: str) -> None:
        """POSIX-style rename: an existing destination is replaced and its
        inode + blocks are freed like ``delete()`` (previously they leaked
        forever), guarded by the same lease check — clobbering a file whose
        blocks a task is still writing would corrupt the lease discipline."""
        with self._lock:
            if old not in self._names:
                raise FileNotFoundError(old)
            if new == old:
                return
            if new in self._names:
                victim = self._inodes[self._names[new]]
                victim_blocks = {
                    b for e in victim.extents
                    for b in range(e.block, e.block + e.nblocks)
                }
                self._check_not_leased(victim_blocks)  # write leases
                for other in self._leases.values():
                    held = other.read_blocks & victim_blocks
                    if held:
                        # freeing + trimming under an active reader would
                        # corrupt its input (same hazard migrate_file fences)
                        raise LeaseViolation(
                            f"block {min(held)} read-leased to task "
                            f"{other.task_id}: rename would free it under "
                            "the reader"
                        )
                del self._names[new]
                del self._inodes[victim.ino]
                self.extmgr.free(victim.extents)
                for e in victim.extents:
                    self.dev.trim(e.block, e.nblocks)
                if self.memtier is not None:
                    self.memtier.invalidate(victim_blocks)
            ino = self._names.pop(old)
            self._names[new] = ino
            self._inodes[ino].path = new

    def truncate(self, path: str, size: int) -> None:
        with self._lock:
            inode = self._inodes[self._names[path]]
            nblocks = (size + BLOCK_SIZE - 1) // BLOCK_SIZE
            keep, drop = [], []
            for e in inode.extents:
                if e.file_offset + e.nblocks <= nblocks:
                    keep.append(e)
                elif e.file_offset >= nblocks:
                    drop.append(e)
                else:
                    cut = nblocks - e.file_offset
                    keep.append(Extent(e.file_offset, e.block, cut, e.shard))
                    drop.append(Extent(e.file_offset + cut, e.block + cut,
                                       e.nblocks - cut, e.shard))
            drop_blocks = {
                b for e in drop for b in range(e.block, e.block + e.nblocks)
            }
            self._check_not_leased(drop_blocks)  # write leases
            for other in self._leases.values():
                held = other.read_blocks & drop_blocks
                if held:
                    # freeing + trimming under an active reader would
                    # corrupt its input (same hazard rename/migrate fence)
                    raise LeaseViolation(
                        f"block {min(held)} read-leased to task "
                        f"{other.task_id}: truncate would free it under "
                        "the reader"
                    )
            self.extmgr.free(drop)
            for e in drop:
                # trim like delete() does: freed blocks must read as zeros,
                # or a crashed WAL that reused them could replay the stale
                # record-encoded bytes as committed data on reopen
                self.dev.trim(e.block, e.nblocks)
            if self.memtier is not None:
                self.memtier.invalidate(drop_blocks)
            inode.extents = keep
            inode.size = min(inode.size, size)
            inode.mtime = self._tick()

    def fallocate(self, path: str, size: int) -> List[Extent]:
        """Preallocate blocks so their physical addresses can be handed to an
        offloaded task (the paper's pre-allocation step for output files)."""
        with self._lock:
            inode = self._inodes[self._names[path]]
            have = sum(e.nblocks for e in inode.extents)
            need = (size + BLOCK_SIZE - 1) // BLOCK_SIZE - have
            if need > 0:
                new = self.extmgr.alloc(need, shard=inode.shard)
                off = have
                for e in new:
                    inode.extents.append(Extent(off, e.block, e.nblocks, e.shard))
                    off += e.nblocks
            inode.size = max(inode.size, size)
            inode.mtime = self._tick()
            return list(inode.extents)

    # --------------------------------------------------------- placement
    def file_shard(self, path: str) -> Optional[int]:
        """The stripe a file's blocks live on: the pinned placement shard
        if one was set at create(), else the dominant shard of its extents
        (spills can leave a minority elsewhere), else None (empty file on a
        flat volume)."""
        with self._lock:
            inode = self._inodes[self._names[path]]
            if inode.shard is not None:
                return inode.shard
            return self.shard_of_extents(inode.extents)

    def shard_of_extents(self, extents: Sequence[Extent]) -> Optional[int]:
        """Dominant stripe of an extent list, by block count (placement-
        affinity routing key). None when the list is empty."""
        weights: Dict[int, int] = {}
        for e in extents:
            weights[e.shard] = weights.get(e.shard, 0) + e.nblocks
        if not weights:
            return None
        # most blocks wins; ties break to the smaller shard id (determinism)
        return min(weights, key=lambda k: (-weights[k], k))

    def migrate_file(self, path: str, dst_shard: int) -> Dict[str, int]:
        """Move a file's blocks onto stripe ``dst_shard`` and re-pin it
        there (the rebalancer's copy → swap → free cycle). Crash-safe
        through the lease journal:

          1. destination extents are allocated (``alloc(n, shard=dst)``)
             and a WRITE lease over them is journaled;
          2. every block is copied source → destination under that lease
             (reads of the file keep working: its extents still point at
             the source);
          3. the inode's extent tree + pin swap to the destination and the
             superblock is flushed — THE commit point;
          4. the lease is released and the source runs are freed + trimmed.

        A crash before step 3 re-mounts to the old placement: the copied
        blocks belong to no inode (they return to the free list on rebuild)
        and ``reclaim_orphans()`` fences their journaled lease. A crash
        after step 3 re-mounts to the new placement: the source blocks
        belong to no inode, and the orphaned destination lease is fenced
        the same way. Either way the file is byte-identical — remount sees
        old or new placement, never a mix.
        """
        with self._lock:
            if not 0 <= dst_shard < self.shards:
                raise ValueError(
                    f"shard {dst_shard} out of range [0, {self.shards})"
                )
            if path not in self._names:
                # the caller's placement scan can race a delete (e.g. a
                # compaction dropping an SSTable): surface it typed so the
                # rebalancer can skip the vanished file, not crash the round
                raise FileNotFoundError(path)
            inode = self._inodes[self._names[path]]
            old_extents = list(inode.extents)
            nblocks = sum(e.nblocks for e in old_extents)
            if nblocks == 0 or (
                inode.shard == dst_shard
                and all(e.shard == dst_shard for e in old_extents)
            ):
                inode.shard = dst_shard  # nothing to move: just re-pin
                return {"blocks": 0, "dst": dst_shard}
            src_shard = self.shard_of_extents(old_extents)
            old_pin = inode.shard
            # the source must be quiescent: a writer would race the copy,
            # and a READER would see its leased blocks freed + trimmed
            # after the swap (the caller skips leased files, never forces)
            src_blocks = {
                b for e in old_extents
                for b in range(e.block, e.block + e.nblocks)
            }
            self._check_not_leased(src_blocks)  # write leases
            for other in self._leases.values():
                held = other.read_blocks & src_blocks
                if held:
                    raise LeaseViolation(
                        f"block {min(held)} read-leased to task "
                        f"{other.task_id}: migration would free it under "
                        "the reader"
                    )
            new_raw = self.extmgr.alloc(nblocks, shard=dst_shard)
            # rebase the destination runs onto the file's offsets and pair
            # each (src, dst) copy run
            new_extents: List[Extent] = []
            copies: List[Tuple[int, int, int]] = []  # (src, dst, nblocks)
            queue = [(e.block, e.nblocks) for e in new_raw]
            for oe in sorted(old_extents, key=lambda e: e.file_offset):
                off, src, rem = oe.file_offset, oe.block, oe.nblocks
                while rem > 0:
                    blk, avail = queue[0]
                    take = min(rem, avail)
                    new_extents.append(
                        Extent(off, blk, take, self.extmgr.shard_of(blk))
                    )
                    copies.append((src, blk, take))
                    queue[0] = (blk + take, avail - take)
                    if queue[0][1] == 0:
                        queue.pop(0)
                    off += take
                    src += take
                    rem -= take
            committed = False
            try:
                # scoped journaled grant: released on exit or plain failure;
                # a MigrationCrash (BaseException) leaves it outstanding for
                # remount fencing, exactly as a real crash would
                with self.lease_scope((), new_raw) as lease:
                    if self._migration_failpoint:
                        self._migration_failpoint("pre_copy")
                    for src, dst, n in copies:
                        data = self.dev.read_blocks(src, n, node=self.node)
                        self.authorized_write(lease, dst, data, node=self.node)
                    if self._migration_failpoint:
                        self._migration_failpoint("post_copy")
                    inode.extents = new_extents
                    inode.shard = dst_shard
                    inode.mtime = self._tick()
                    self.flush_metadata()  # commit point: placement durable
                    committed = True
                    if self._migration_failpoint:
                        self._migration_failpoint("post_swap")
            except Exception:
                if not committed:
                    # failed migration (not a simulated crash): roll back —
                    # old placement restored, copy reclaimed (trimmed: the
                    # partial copy must not leak file bytes into blocks a
                    # later fallocate hands someone else)
                    inode.extents = old_extents
                    inode.shard = old_pin
                    self.extmgr.free(new_raw)
                    for e in new_raw:
                        self.dev.trim(e.block, e.nblocks)
                    if self.memtier is not None:
                        self.memtier.invalidate(
                            b for e in new_raw
                            for b in range(e.block, e.block + e.nblocks)
                        )
                    raise
                # past the commit point the swap is already durable: rolling
                # back in memory would free blocks the on-disk superblock
                # references — finish the cycle instead, then propagate
                self.extmgr.free(old_extents)
                for e in old_extents:
                    self.dev.trim(e.block, e.nblocks)
                if self.memtier is not None:
                    self.memtier.invalidate(src_blocks)
                raise
            self.extmgr.free(old_extents)
            for e in old_extents:
                self.dev.trim(e.block, e.nblocks)
            if self.memtier is not None:
                self.memtier.invalidate(src_blocks)
            self.migrations += 1
            self.migrated_blocks += nblocks
            return {
                "blocks": nblocks,
                "src": -1 if src_shard is None else src_shard,
                "dst": dst_shard,
            }

    # ------------------------------------------------------------ file IO
    def _extent_blocks(self, inode: Inode, offset: int, length: int):
        """Yield (physical_block, nblocks) runs covering [offset, offset+length)."""
        first = offset // BLOCK_SIZE
        last = (offset + length + BLOCK_SIZE - 1) // BLOCK_SIZE
        for e in inode.extents:
            lo = max(first, e.file_offset)
            hi = min(last, e.file_offset + e.nblocks)
            if lo < hi:
                yield e.block + (lo - e.file_offset), hi - lo

    def write(self, path: str, data: bytes, offset: int = 0) -> int:
        """Initiator-side write (foreground I/O — e.g. WAL, MANIFEST).
        Block-aligned offsets only (the LSM layer writes aligned)."""
        with self._lock:
            # metadata half is shared with the remote-data path
            runs = self.prepare_write(path, offset, len(data))
            pos = 0
            for blk, n in runs:
                chunk = data[pos : pos + n * BLOCK_SIZE]
                self.dev.write_blocks(blk, chunk, node=self.node)
                pos += n * BLOCK_SIZE
                if pos >= len(data):
                    break
            return len(data)

    def prepare_write(self, path: str, offset: int, length: int, *,
                      lease: bool = False):
        """Metadata half of a write whose DATA half lands remotely (async
        WAL segment shipping): allocate covering blocks, bump size/mtime,
        and return the physical runs. With ``lease=True`` a write lease over
        exactly those runs is granted atomically (same lock hold) and
        ``(runs, lease)`` is returned — the shipped segment's authorization.
        """
        if offset % BLOCK_SIZE:
            raise ValueError("unaligned write")
        with self._lock:
            inode = self._inodes[self._names[path]]
            end = offset + length
            self.fallocate(path, max(inode.size, end))
            runs = list(self._extent_blocks(inode, offset, length))
            self._check_not_leased(
                b for blk, n in runs for b in range(blk, blk + n)
            )
            if self.memtier is not None:
                # the covering blocks are about to be overwritten (locally
                # or by a remote WAL append): drop any cached copies now so
                # the unleased write path can never leave stale tier bytes
                self.memtier.invalidate(
                    b for blk, n in runs for b in range(blk, blk + n)
                )
            inode.size = max(inode.size, end)
            inode.mtime = self._tick()
            if not lease:
                return runs
            # reprolint: allow[lease-raw] lease intentionally escapes to the caller, who owns release
            grant = self.grant_lease(
                (), [Extent(0, blk, n) for blk, n in runs]
            )
            return runs, grant

    def read(self, path: str, offset: int = 0, length: Optional[int] = None,
             *, io_class: str = "foreground") -> bytes:
        with self._lock:
            inode = self._inodes[self._names[path]]
            if length is None:
                length = inode.size - offset
            length = max(0, min(length, inode.size - offset))
            if length == 0:
                return b""
            if self._leased_blocks:
                # quiesce discipline: while a task holds a WRITE lease the
                # initiator must not even read those blocks (the target may
                # be mid-write; there is no DLM to order the access)
                self._check_not_leased(
                    b for blk, n in self._extent_blocks(inode, offset, length)
                    for b in range(blk, blk + n)
                )
            first_blk = offset // BLOCK_SIZE
            skip = offset - first_blk * BLOCK_SIZE
            out = []
            for blk, n in self._extent_blocks(inode, offset, length):
                data = None
                if self.memtier is not None:
                    # remote-DRAM tier first: a full-run hit skips NVMe; a
                    # miss reads the device and offers the run back (the
                    # tier's admission filter decides whether to keep it)
                    data = self.memtier.get_run(blk, n, io_class=io_class)
                if data is None:
                    data = self.dev.read_blocks(blk, n, node=self.node)
                    if self.memtier is not None:
                        self.memtier.fill_run(blk, n, data, io_class=io_class)
                out.append(data)
            buf = b"".join(out)
            return buf[skip : skip + length]

    # ----------------------------------------------------------- leases
    def _check_not_leased(self, blocks) -> None:
        for b in blocks:
            if b in self._leased_blocks:
                raise LeaseViolation(
                    f"block {b} leased to task {self._leased_blocks[b]}"
                )

    def grant_lease(self, read_extents: Sequence[Extent],
                    write_extents: Sequence[Extent]) -> Lease:
        """Authorize an offloaded task; initiator loses access to the write
        set (and will not mutate the read set) until release."""
        with self._lock:
            rb = frozenset(
                b for e in read_extents for b in range(e.block, e.block + e.nblocks)
            )
            wb = frozenset(
                b for e in write_extents for b in range(e.block, e.block + e.nblocks)
            )
            overlap = wb & set(self._leased_blocks)
            if overlap:
                raise LeaseViolation(f"blocks already leased: {sorted(overlap)[:4]}…")
            tid = next(self._task_counter)
            lease = Lease(tid, rb, wb)
            for b in wb:
                self._leased_blocks[b] = tid
            self._leases[tid] = lease
            if wb:
                # read-only leases die harmlessly with the process; WRITE
                # leases must be journaled so a re-mount can reclaim them
                try:
                    self.lease_journal.append_grant(tid, wb)
                except BaseException:
                    # unjournaled grant is no grant: roll the maps back so
                    # the blocks don't stay quiesced with no Lease to free
                    for b in wb:
                        if self._leased_blocks.get(b) == tid:
                            del self._leased_blocks[b]
                    self._leases.pop(tid, None)
                    raise
                if self.memtier is not None:
                    # the journaled grant fences cached copies too: the
                    # grantee will write these blocks and the tier must not
                    # serve the pre-write bytes afterwards (reads are
                    # quiesced for the lease's lifetime, so nothing can
                    # re-fill them until release)
                    self.memtier.fence(wb)
            return lease

    def release_lease(self, lease: Lease) -> None:
        with self._lock:
            lease.done = True
            existed = self._leases.pop(lease.task_id, None) is not None
            for b in lease.write_blocks:
                if self._leased_blocks.get(b) == lease.task_id:
                    del self._leased_blocks[b]
            if existed and lease.write_blocks:
                self.lease_journal.append_release(lease.task_id)

    # ------------------------------------------------- scoped (CM) leases
    @contextmanager
    def lease_scope(self, read_extents: Sequence[Extent],
                    write_extents: Sequence[Extent]):
        """Context-manager lease: grant on entry, release on exit — so
        release-on-error is structural, not a convention every call site
        re-implements. One deliberate asymmetry: a ``BaseException`` that
        is not an ``Exception`` (``MigrationCrash``-style simulated process
        death) propagates WITHOUT releasing, leaving the journaled grant
        outstanding exactly as a real crash would — remount replay +
        ``reclaim_orphans()`` is the path that cleans it up."""
        lease = self.grant_lease(read_extents, write_extents)
        try:
            yield lease
        except Exception:
            self.release_lease(lease)
            raise
        else:
            self.release_lease(lease)

    @contextmanager
    def write_lease(self, path: str, *, offset: int = 0,
                    length: Optional[int] = None):
        """``with fs.write_lease(path) as lease:`` — the
        ``prepare_write``/grant/release triple as one scoped construct.
        Allocates covering blocks (growing the file to ``offset+length``),
        grants a journaled write lease over exactly those runs, and
        releases it on exit (crash-simulation semantics as
        ``lease_scope``). The physical runs ride on ``lease.runs``."""
        with self._lock:
            if length is None:
                inode = self._inodes[self._names[path]]
                length = max(0, inode.size - offset)
            runs, lease = self.prepare_write(path, offset, length, lease=True)
            lease.runs = runs
        try:
            yield lease
        except Exception:
            self.release_lease(lease)
            raise
        else:
            self.release_lease(lease)

    @contextmanager
    def read_lease(self, path: str, *, offset: int = 0,
                   length: Optional[int] = None):
        """Scoped READ lease over the blocks backing ``path`` — decode-side
        attach: the holder may ``authorized_read`` them, and migration /
        delete are fenced off for the duration. Read-only leases are not
        journaled (they die harmlessly with the process), so release is
        unconditional on exit. Runs ride on ``lease.runs``."""
        with self._lock:
            inode = self._inodes[self._names[path]]
            if length is None:
                length = max(0, inode.size - offset)
            runs = list(self._extent_blocks(inode, offset, length))
        lease = self.grant_lease(
            [Extent(0, blk, n) for blk, n in runs], ()
        )
        lease.runs = runs
        try:
            yield lease
        finally:
            self.release_lease(lease)

    # ---------------------------------------------- target-side block APIs
    # (called by the Offload Engine on behalf of an authorized task; the
    #  device is shared via NVMeoF so both nodes address the same blocks)
    def _live_lease(self, lease: Lease) -> Lease:
        """The REGISTERED lease for this task id — the fencing check. A
        wire-reconstructed Lease is just a claim; authorization comes from
        the initiator's live registry, so a task whose lease was released
        (cancellation), reclaimed (``reclaim_orphans`` after failover), or
        never granted is fenced here with ``LeaseViolation`` instead of
        scribbling on re-owned blocks. This is the no-DLM story's other
        half: leases don't only quiesce the initiator, they also fence the
        *target* once revoked."""
        with self._lock:
            live = self._leases.get(lease.task_id)
        if live is None or live.done:
            raise LeaseViolation(
                f"task {lease.task_id} lease is not registered "
                "(released, cancelled, or fenced)"
            )
        return live

    def authorized_read(self, lease: Lease, block: int, nblocks: int,
                        *, node: str) -> bytes:
        live = self._live_lease(lease)
        ok = live.read_blocks | live.write_blocks
        for b in range(block, block + nblocks):
            if b not in ok:
                raise LeaseViolation(f"task {lease.task_id} read of unauthorized block {b}")
        return self.dev.read_blocks(block, nblocks, node=node)

    def authorized_write(self, lease: Lease, block: int, data: bytes,
                         *, node: str) -> None:
        live = self._live_lease(lease)
        n = (len(data) + BLOCK_SIZE - 1) // BLOCK_SIZE
        for b in range(block, block + n):
            if b not in live.write_blocks:
                raise LeaseViolation(f"task {lease.task_id} write of unauthorized block {b}")
        self.dev.write_blocks(block, data, node=node)
