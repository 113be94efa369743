# Copied from src/repro/core/lsm/compaction.py; only the repro. imports are rewritten.
"""Compaction + Log-Recycling task stubs — the code that RUNS ON THE
TARGET NODE (or locally when the offload is rejected). Stubs receive only
an EngineIO (offload_read/offload_write over leased blocks) and plain-data
arguments: block runs, sizes, offset arrays. No file-system metadata ever
crosses the wire (initiator-centric block management).
"""
from __future__ import annotations

import heapq
from typing import Iterable, List, Tuple

from repro_torch.core.blockdev import BLOCK_SIZE
from repro_torch.core.lsm.memtable import TOMBSTONE
from repro_torch.core.lsm.sstable import SSTableReader, build_bytes
from repro_torch.core.lsm.wal import decode_record


def _read_runs(io, runs: List[Tuple[int, int]], size: int) -> bytes:
    buf = b"".join(io.offload_read(b, n) for b, n in runs)
    return buf[:size]


def _write_runs(io, runs: List[Tuple[int, int]], data: bytes) -> None:
    pos = 0
    for b, n in runs:
        if pos >= len(data):
            break
        io.offload_write(b, data[pos : pos + n * BLOCK_SIZE])
        pos += n * BLOCK_SIZE


def _merge(sources: List[Iterable[Tuple[bytes, bytes]]], *, drop_tombstones: bool):
    """K-way merge; duplicate keys resolve to the LOWEST source index
    (callers order sources newest → oldest)."""
    heap = []
    iters = [iter(s) for s in sources]
    for i, it in enumerate(iters):
        for k, v in it:
            heap.append((k, i, v))
            break
    heapq.heapify(heap)
    last_key = None
    while heap:
        k, i, v = heapq.heappop(heap)
        for k2, v2 in iters[i]:
            heapq.heappush(heap, (k2, i, v2))
            break
        if k == last_key:
            continue
        last_key = k
        if drop_tombstones and v == TOMBSTONE:
            continue
        yield k, v


def wal_records(io, runs, size, offsets) -> Iterable[Tuple[bytes, bytes]]:
    """Log Recycling (paper Fig. 6): read WAL blocks, emit records in the
    order of the initiator-supplied sorted offset array."""
    buf = _read_runs(io, runs, size)
    for off in offsets:
        k, v, _ = decode_record(buf, off)
        yield k, v


# ------------------------------------------------------------------ stubs
def stub_log_recycle(io, wal: dict, outputs: List[dict]) -> List[dict]:
    """Rebuild a sorted L0 SSTable from WAL blocks + offset array."""
    items = list(wal_records(io, wal["runs"], wal["size"], wal["offsets"]))
    return _emit_tables(io, [items], outputs, drop_tombstones=False, split=True)


def stub_compact(
    io,
    inputs: List[dict],  # newest → oldest: {"runs", "size"} SSTables
    recycle: List[dict],  # newest → oldest: {"runs","size","offsets"} WALs
    outputs: List[dict],  # {"runs", "cap"} preallocated output files
    drop_tombstones: bool,
) -> List[dict]:
    """Merge WAL-recycled runs + victim SSTables into level-(n+1) tables.

    Returns per-output {"idx", "used", "n", "min", "max"} for outputs that
    received data (the initiator commits these to the MANIFEST and reclaims
    unused blocks)."""
    sources: List[Iterable[Tuple[bytes, bytes]]] = []
    for w in recycle:
        sources.append(wal_records(io, w["runs"], w["size"], w["offsets"]))
    for t in inputs:
        buf = _read_runs(io, t["runs"], t["size"])
        sources.append(SSTableReader(buf).items())
    merged = _merge(sources, drop_tombstones=drop_tombstones)
    return _emit_tables(io, [merged], outputs, split=True)


def _emit_tables(io, sources, outputs: List[dict], *, drop_tombstones=False,
                 split=False) -> List[dict]:
    """Serialize merged items into the preallocated outputs, splitting at
    each output's capacity when `split`."""
    results = []
    out_idx = 0
    batch: List[Tuple[bytes, bytes]] = []
    batch_bytes = 0

    def flush_batch():
        nonlocal out_idx, batch, batch_bytes
        if not batch:
            return
        data = build_bytes(batch)
        out = outputs[out_idx]
        assert len(data) <= out["cap"], (len(data), out["cap"])
        _write_runs(io, out["runs"], data)
        results.append(
            {
                "idx": out_idx,
                "used": len(data),
                "n": len(batch),
                "min": batch[0][0],
                "max": batch[-1][0],
            }
        )
        out_idx += 1
        batch = []
        batch_bytes = 0

    # per-record overhead: header 10B + index entry (10 + klen) + footer amortized
    for src in sources:
        for k, v in src:
            rec = len(k) * 2 + len(v) + 24
            cap = outputs[out_idx]["cap"] - 4096  # footer headroom
            if split and batch and batch_bytes + rec > cap:
                flush_batch()
            batch.append((k, v))
            batch_bytes += rec
    flush_batch()
    return results
