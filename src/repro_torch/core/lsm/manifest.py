# Copied from src/repro/core/lsm/manifest.py; only the repro. imports are rewritten.
"""MANIFEST: append-only version log — the commit point for flush and
compaction (paper §IV-A: "updating the MANIFEST file serves as the commit
mark"). Records are length-prefixed JSON lines with a crc.

Record kinds:
  add     {level, table_id, path, n, size, min, max}
  drop    {table_id}
  l0log   {gen, wal_path, count, min, max}   — deferred-L0 (Log Recycling +
           L0 cache: the L0 exists as WAL + offsets until L0→L1 commits)
  wal     {gen, path}                        — active WAL switch
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Iterable

from repro_torch.core.fs import OffloadFS

_LHDR = struct.Struct("<II")  # length, crc


class Manifest:
    def __init__(self, fs: OffloadFS, path: str = "/MANIFEST", *,
                 shard=None):
        self.fs = fs
        self.path = path
        if not fs.exists(path):
            # on striped volumes the owning instance pins its MANIFEST to
            # its stripe so foreground commits stay off co-tenant FIFOs
            fs.create(path, shard=shard)
        self._buf = bytearray()
        self._size = 0
        self.commits = 0

    def append(self, record: dict) -> None:
        blob = json.dumps(record, separators=(",", ":")).encode()
        self._buf += _LHDR.pack(len(blob), zlib.crc32(blob)) + blob
        self._size += _LHDR.size + len(blob)

    def commit(self) -> None:
        """Flush buffered records + persist FS metadata (the commit mark)."""
        if self._buf:
            data = self.fs.read(self.path)  # existing content
            self.fs.write(self.path, data + bytes(self._buf), 0)
            self._buf.clear()
        self.fs.flush_metadata()
        self.commits += 1

    def replay(self) -> Iterable[dict]:
        buf = self.fs.read(self.path)
        off = 0
        while off + _LHDR.size <= len(buf):
            ln, crc = _LHDR.unpack_from(buf, off)
            blob = buf[off + _LHDR.size : off + _LHDR.size + ln]
            if len(blob) < ln or zlib.crc32(blob) != crc:
                break  # torn tail: records after last commit are ignored
            yield json.loads(blob.decode())
            off += _LHDR.size + ln
