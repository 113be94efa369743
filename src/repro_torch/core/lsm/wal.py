# Copied from src/repro/core/lsm/wal.py; only the repro. imports are rewritten.
"""Write-ahead log on OffloadFS, with an asynchronous durability plane.

Record format: [crc32 u32 | klen u16 | vlen u32 | key | value]. Appends go
through an in-memory tail buffer. Three durability modes:

  * legacy lazy (``sync=False``, no shipper): flush on 64-block boundaries
    via initiator-side ``fs.write`` (RocksDB default).
  * legacy sync (``sync=True``, no shipper): flush every record (the
    SpanDB-comparison mode, Fig. 10 ODB(sync)).
  * **async shipping** (``shipper`` set): ``append`` only touches the
    in-memory tail; block-aligned segments are sealed off the tail and
    shipped to shard targets via ``RpcFabric.call_async`` — a segment ring
    with bounded in-flight futures. ``durable_lsn`` is the
    completion-ordered watermark: it advances over the contiguous prefix of
    completed segments, whatever order the shards finish in. ``sync=True``
    degrades to await-on-watermark (seal + wait) rather than per-record
    initiator flush.

``record_offset`` returned by append() feeds the MemTable for Log
Recycling; ``replay``/``replay_raw`` are torn-tail tolerant (a half-shipped
segment after a crash decodes as garbage past the last intact record and is
dropped — last durable prefix wins).

On a striped volume (``OffloadFS(shards=N)``) the shipper routes each
sealed segment to the target whose stripe owns the segment's blocks
(placement affinity) instead of round-robin, so WAL traffic for different
shards never shares an NVMe FIFO — the durability half of the Fig. 16
placement story.
"""
from __future__ import annotations

import struct
import threading
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.fs import OffloadFS

_HDR = struct.Struct("<IHI")

DEFAULT_SEGMENT_BYTES = 16 * BLOCK_SIZE


def encode_record(key: bytes, value: bytes) -> bytes:
    body = key + value
    crc = zlib.crc32(body)
    return _HDR.pack(crc, len(key), len(value)) + body


def decode_record(buf: bytes, off: int) -> Tuple[bytes, bytes, int]:
    crc, klen, vlen = _HDR.unpack_from(buf, off)
    start = off + _HDR.size
    key = buf[start : start + klen]
    val = buf[start + klen : start + klen + vlen]
    if zlib.crc32(key + val) != crc:
        raise IOError(f"WAL record crc mismatch at {off}")
    return key, val, off + _HDR.size + klen + vlen


class WalShipper:
    """Ships sealed WAL segments to shard targets for near-data durable
    writes (one per initiator, shared across WAL generations).

    The metadata half of each segment write happens on the initiator
    (``fs.prepare_write``: allocation + size bump + a journaled write
    lease); the data half is a single ``wal_append`` RPC to a target picked
    round-robin, which lands the bytes via ``authorized_write``. The lease
    is released as the future resolves, so a crash mid-flight leaves a
    journaled orphan lease the re-mounted initiator reclaims.
    """

    def __init__(self, fs: OffloadFS, fabric, targets: Sequence[str], *,
                 node: str):
        if not targets:
            raise ValueError("WalShipper needs at least one target")
        self.fs = fs
        self.fabric = fabric
        self.targets = list(targets)
        self.node = node
        self._rr = 0
        self._lock = threading.Lock()
        self.segments_shipped = 0
        self.bytes_shipped = 0

    def _pick(self, runs=None) -> str:
        # placement affinity on striped volumes: land the segment on the
        # target whose NVMe FIFO owns its blocks, so WAL traffic for
        # different shards never shares a device queue; flat volumes keep
        # the seed round-robin
        if runs and self.fs.shards > 1:
            shard = self.fs.extmgr.shard_of(runs[0][0])
            return self.targets[shard % len(self.targets)]
        with self._lock:
            t = self.targets[self._rr % len(self.targets)]
            self._rr += 1
            return t

    def ship(self, path: str, offset: int, payload: bytes):
        """Submit one sealed segment; returns the RpcFuture. `offset` must
        be block-aligned; `payload` carries the (head-spliced) bytes."""
        # reprolint: allow[lease-raw] released by the _release done-callback when the append lands
        runs, lease = self.fs.prepare_write(
            path, offset, len(payload), lease=True
        )
        wire = {
            "task_id": lease.task_id,
            "read_blocks": [],
            "write_blocks": sorted(lease.write_blocks),
        }
        fut = self.fabric.call_async(
            self.node, self._pick(runs), "wal_append", wire, runs,
            bytes(payload)
        )

        def _release(_f):
            self.fs.release_lease(lease)

        fut.add_done_callback(_release)
        with self._lock:
            self.segments_shipped += 1
            self.bytes_shipped += len(payload)
        return fut


class WriteAheadLog:
    def __init__(self, fs: OffloadFS, path: str, *, sync: bool = False,
                 shipper: Optional[WalShipper] = None,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_inflight: int = 8):
        self.fs = fs
        self.path = path
        self.sync = sync
        if not fs.exists(path):
            fs.create(path)
        self._buf = bytearray()
        self._flushed = 0  # bytes durable via the legacy (initiator) path
        self._size = 0  # logical size including buffered tail
        self.flushes = 0
        # ------------------------------------------- async durability plane
        self.shipper = shipper
        self.segment_bytes = max(BLOCK_SIZE, segment_bytes)
        self.max_inflight = max(1, max_inflight)
        self.segments = 0  # segments sealed+shipped by this WAL
        self._sealed = 0  # LSN up to which bytes were sealed into segments
        self._head_cache = b""  # content of the partial block at _sealed
        self._durable = 0  # completion-ordered durability watermark
        self._ring: List[dict] = []  # in-flight segments, seal order
        self._ship_error: Optional[BaseException] = None
        self._dlock = threading.Lock()
        self._dcond = threading.Condition(self._dlock)

    # ------------------------------------------------------------- appends
    def append(self, key: bytes, value: bytes) -> int:
        rec = encode_record(key, value)
        off = self._size
        self._buf += rec
        self._size += len(rec)
        if self.shipper is not None:
            if self.sync:
                # degrade to await-on-watermark, not per-record flush
                self.seal(all=True)
                self.wait_durable(self._size)
            elif len(self._buf) >= self.segment_bytes:
                self.seal()
        elif self.sync:
            self.flush()
        elif len(self._buf) >= 64 * BLOCK_SIZE:
            self.flush()
        return off

    @property
    def durable_lsn(self) -> int:
        """Bytes of WAL prefix guaranteed on the device. Legacy modes flush
        synchronously (watermark == flushed); with a shipper the watermark
        advances in completion order over the contiguous segment prefix."""
        if self.shipper is None:
            return self._flushed
        with self._dlock:
            return self._durable

    def inflight_segments(self) -> int:
        with self._dlock:
            return sum(1 for s in self._ring if not s["done"])

    # ------------------------------------------------------- async sealing
    def seal(self, *, all: bool = False) -> None:
        """Seal the buffered tail into a shipped segment. By default only
        the block-aligned prefix is sealed (the partial tail block stays
        buffered so consecutive segments never write the same block);
        ``all=True`` ships the partial tail too (sync mode / drain)."""
        if self.shipper is None:
            if all:
                self.flush()
            return
        self._raise_ship_error()
        start = self._sealed
        avail = len(self._buf)
        if all:
            length = avail
        else:
            length = (start + avail) // BLOCK_SIZE * BLOCK_SIZE - start
        if length <= 0:
            return
        pad = start % BLOCK_SIZE
        if pad:
            # this segment rewrites a block an in-flight predecessor may
            # still hold a lease on: wait for the watermark to cover it
            self.wait_durable(start)
            payload = self._head_cache[-pad:] + bytes(self._buf[:length])
        else:
            payload = bytes(self._buf[:length])
        end = start + length
        tail_pad = end % BLOCK_SIZE
        # bounded in-flight ring: backpressure on the oldest future
        with self._dcond:
            while (
                sum(1 for s in self._ring if not s["done"])
                >= self.max_inflight
            ):
                self._dcond.wait()
            self._raise_ship_error_locked()
            seg = {"end": end, "done": False, "exc": None}
            self._ring.append(seg)
        del self._buf[:length]
        self._sealed = end
        self._head_cache = payload[-tail_pad:] if tail_pad else b""
        self.segments += 1
        try:
            fut = self.shipper.ship(self.path, start - pad, payload)
        except BaseException as e:
            # synchronous ship failure (e.g. volume full in prepare_write):
            # mark the ring entry failed so the watermark raises loudly on
            # the next wait instead of wedging behind a segment that will
            # never complete
            with self._dcond:
                seg["done"] = True
                seg["exc"] = e
                if self._ship_error is None:
                    self._ship_error = e
                self._dcond.notify_all()
            raise
        fut.add_done_callback(lambda f, seg=seg: self._segment_done(f, seg))

    def _segment_done(self, fut, seg: dict) -> None:
        with self._dcond:
            exc = fut.exception()
            if exc is not None:
                seg["exc"] = exc
                if self._ship_error is None:
                    self._ship_error = exc
            seg["done"] = True
            # completion-ordered watermark: contiguous done prefix only
            while self._ring and self._ring[0]["done"] \
                    and self._ring[0]["exc"] is None:
                self._durable = self._ring.pop(0)["end"]
            self._dcond.notify_all()

    def _raise_ship_error(self) -> None:
        with self._dlock:
            self._raise_ship_error_locked()

    def _raise_ship_error_locked(self) -> None:
        if self._ship_error is not None:
            raise IOError(
                f"WAL segment ship failed: {self._ship_error!r}"
            ) from self._ship_error

    def wait_durable(self, lsn: Optional[int] = None,
                     timeout: float = 30.0) -> int:
        """Block until ``durable_lsn >= lsn`` (default: everything appended
        so far, sealing the tail first). Returns the watermark."""
        if self.shipper is None:
            self.flush()
            return self._flushed
        if lsn is None:
            self.seal(all=True)
            lsn = self._size
        with self._dcond:
            ok = self._dcond.wait_for(
                lambda: self._durable >= lsn or self._ship_error is not None,
                timeout,
            )
            if self._durable >= lsn:
                return self._durable
            self._raise_ship_error_locked()
            if not ok:
                raise TimeoutError(f"durability watermark stuck below {lsn}")
            return self._durable

    # ------------------------------------------------------- legacy flush
    def flush(self) -> None:
        if self.shipper is not None:
            # async plane: flush == drain (seal the tail, await watermark)
            self.wait_durable()
            return
        if not self._buf:
            return  # empty flush is a no-op (keeps Fig. 10 accounting honest)
        # write the (block-aligned) tail: start at the flushed block boundary
        start_block = self._flushed // BLOCK_SIZE
        pad_head = self._flushed - start_block * BLOCK_SIZE
        if pad_head:
            # re-read the partial head block to splice (rare: sync mode)
            head = self.fs.read(
                self.path, start_block * BLOCK_SIZE, pad_head
            )
        else:
            head = b""
        self.fs.write(self.path, head + bytes(self._buf), start_block * BLOCK_SIZE)
        self._flushed = self._size
        self._buf.clear()
        self.flushes += 1

    @property
    def size(self) -> int:
        return self._size

    # ------------------------------------------------- recovery / recycle
    def replay(self) -> Iterable[Tuple[bytes, bytes, int]]:
        """Yield (key, value, offset) for every intact record (recovery)."""
        self.flush()
        buf = self.fs.read(self.path, 0, self._size)
        yield from self.replay_raw(buf)

    @classmethod
    def reopen(cls, fs: OffloadFS, path: str, *, sync: bool = False,
               shipper: Optional[WalShipper] = None,
               segment_bytes: int = DEFAULT_SEGMENT_BYTES,
               max_inflight: int = 8,
               ) -> Tuple["WriteAheadLog", List[Tuple[bytes, bytes, int]]]:
        """Re-open an existing WAL after a crash/re-mount: scan the device
        content, keep only the intact record prefix (async shipping leaves
        allocated-but-unwritten tail blocks; they decode as torn and are
        dropped), and position the tail so new appends land right after the
        last intact record. Returns ``(wal, records)``."""
        wal = cls(fs, path, sync=sync, shipper=shipper,
                  segment_bytes=segment_bytes, max_inflight=max_inflight)
        ino = fs.stat(path)
        buf = fs.read(path, 0, ino.size)
        records = list(cls.replay_raw(buf))
        if records:
            k, v, off = records[-1]
            end = off + _HDR.size + len(k) + len(v)
        else:
            end = 0
        wal._size = wal._flushed = wal._sealed = wal._durable = end
        pad = end % BLOCK_SIZE
        wal._head_cache = buf[end - pad : end] if pad else b""
        return wal, records

    @staticmethod
    def replay_raw(data: bytes) -> Iterable[Tuple[bytes, bytes, int]]:
        off = 0
        while off + _HDR.size <= len(data):
            try:
                key, val, nxt = decode_record(data, off)
            except (IOError, struct.error):
                break
            if not key and not val:
                break
            yield key, val, off
            off = nxt
