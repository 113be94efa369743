# Copied from src/repro/core/lsm/sstable.py; only the repro. imports are rewritten.
"""SSTable format on OffloadFS extents.

Layout: [records…][index][footer]. Records are WAL-format (crc|klen|vlen|
key|value) so the Log Recycler can copy them verbatim. The index is a
sorted array of (key, offset); the footer carries counts, key range and a
crc. Tables are immutable once committed to the MANIFEST.

Both sides can materialize a table: the initiator via fs.read, the target
via offload_read (EngineIO) — ``build_bytes``/``parse`` are side-agnostic.
"""
from __future__ import annotations

import struct
import zlib
from bisect import bisect_left
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from repro_torch.core.lsm.wal import decode_record, encode_record

_FOOTER = struct.Struct("<QQIHH")  # index_off, n, crc, min_len, max_len
MAGIC = b"OFS1"


@dataclass
class TableMeta:
    table_id: int
    path: str
    level: int
    n: int
    size: int
    min_key: bytes
    max_key: bytes


def build_bytes(items: Iterable[Tuple[bytes, bytes]]) -> bytes:
    """items: sorted (key, value) pairs → serialized table bytes."""
    recs = []
    index: List[Tuple[bytes, int]] = []
    off = 0
    for k, v in items:
        rec = encode_record(k, v)
        index.append((k, off))
        recs.append(rec)
        off += len(rec)
    body = b"".join(recs)
    idx = b"".join(
        struct.pack("<HQ", len(k), o) + k for k, o in index
    )
    min_key = index[0][0] if index else b""
    max_key = index[-1][0] if index else b""
    footer = (
        idx
        + min_key
        + max_key
        + _FOOTER.pack(len(body), len(index), zlib.crc32(body), len(min_key), len(max_key))
        + MAGIC
    )
    return body + footer


def parse(buf: bytes) -> Tuple[List[Tuple[bytes, int]], bytes, bytes, int]:
    """→ (index, min_key, max_key, body_len). Raises on corruption."""
    if buf[-4:] != MAGIC:
        raise IOError("bad SSTable magic")
    fo = len(buf) - 4 - _FOOTER.size
    index_off, n, crc, mlen, xlen = _FOOTER.unpack_from(buf, fo)
    if zlib.crc32(buf[:index_off]) != crc:
        raise IOError("SSTable body crc mismatch")
    max_key = buf[fo - xlen : fo]
    min_key = buf[fo - xlen - mlen : fo - xlen]
    idx = []
    off = index_off
    end = fo - xlen - mlen
    while off < end:
        (klen,) = struct.unpack_from("<H", buf, off)
        (o,) = struct.unpack_from("<Q", buf, off + 2)
        k = buf[off + 10 : off + 10 + klen]
        idx.append((k, o))
        off += 10 + klen
    return idx, min_key, max_key, index_off


class SSTableReader:
    """Random access over a fully-materialized table buffer."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.index, self.min_key, self.max_key, self.body_len = parse(buf)
        self._keys = [k for k, _ in self.index]

    def get(self, key: bytes) -> Optional[bytes]:
        i = bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            k, v, _ = decode_record(self.buf, self.index[i][1])
            return v
        return None

    def items(self) -> Iterable[Tuple[bytes, bytes]]:
        for _k, o in self.index:
            key, val, _ = decode_record(self.buf, o)
            yield key, val

    def range_items(self, lo: bytes, hi: Optional[bytes]) -> Iterable[Tuple[bytes, bytes]]:
        i = bisect_left(self._keys, lo)
        for k, o in self.index[i:]:
            if hi is not None and k >= hi:
                break
            key, val, _ = decode_record(self.buf, o)
            yield key, val

    def __len__(self):
        return len(self.index)
